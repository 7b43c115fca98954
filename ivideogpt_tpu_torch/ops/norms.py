"""GroupNorm with the JAX package's statistics.

Statistics are fp32 whatever the input dtype, with
var = max(E[x^2] - E[x]^2, 0) (``ivideogpt_tpu/ops/norms.py``); the output
is cast to the module's compute dtype. Input layout is torch's
[N, C, *spatial]; every axis after C is reduced.
"""

from __future__ import annotations

import torch
from torch import nn


class GroupNorm(nn.Module):
    def __init__(self, num_groups: int, num_channels: int, eps: float = 1e-6,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if num_channels % num_groups:
            raise ValueError(f"{num_channels} channels in {num_groups} groups")
        self.num_groups = num_groups
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        N, C = x.shape[:2]
        G = self.num_groups
        cg = C // G
        red = tuple(range(2, x.ndim))
        xf = x.float()
        s1 = xf.sum(red)                                   # (N, C)
        s2 = (xf * xf).sum(red)
        g1 = s1.view(N, G, cg).sum(-1)                     # (N, G)
        g2 = s2.view(N, G, cg).sum(-1)
        cnt = float(x[0, 0].numel() * cg)
        mean = g1 / cnt
        var = torch.clamp(g2 / cnt - mean * mean, min=0.0)
        inv = torch.rsqrt(var + self.eps)
        mean_c = mean.repeat_interleave(cg, dim=-1)        # (N, C)
        inv_c = inv.repeat_interleave(cg, dim=-1)
        w = inv_c * self.weight.float()
        b = (-mean_c * inv_c) * self.weight.float() + self.bias.float()
        shape = (N, C) + (1,) * len(red)
        return (xf * w.view(shape) + b.view(shape)).to(self.dtype)
