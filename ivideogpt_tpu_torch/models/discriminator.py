"""PatchGAN-style discriminator with spectral norm, the port of
``ivideogpt_tpu/models/discriminator.py``: stride-2 3x3 spectral-norm convs,
InstanceNorm (no affine, eps 1e-5) + LeakyReLU(0.2), a 1x1 ``shuffle`` conv
to a logits map. Pixels in and logits out are NHWC, as in the JAX package.

Spectral norm is Flax's ``nn.SpectralNorm``, written out, not
``torch.nn.utils.spectral_norm``: the kernel, in Flax's HWIO layout,
reshaped to (H*W*I, O), is divided by sigma from ONE power iteration that
runs on every call from the stored ``u`` [1, O] (eps 1e-12); ``u`` and ``v``
carry no gradient, sigma's dependence on the kernel does. ``update_stats``
only decides whether the new ``u`` and sigma are stored (buffers ``u`` and
``sigma``, Flax's ``batch_stats``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ivideogpt_tpu_torch.configs import DiscriminatorConfig
from ivideogpt_tpu_torch.models.layers import Conv


def _l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return x * torch.rsqrt((x * x).sum() + eps)


class SpectralNormConv(Conv):
    """3x3 stride-2 conv (padding 1) whose kernel is spectrally normalised
    as Flax's ``SpectralNorm`` does it."""

    def __init__(self, in_channels: int, out_channels: int,
                 dtype: torch.dtype = torch.float32, eps: float = 1e-12):
        super().__init__(in_channels, out_channels, 3, stride=2, padding=1,
                         dtype=dtype)
        self.eps = eps
        self.register_buffer("u", torch.randn(1, out_channels))
        self.register_buffer("sigma", torch.ones(()))

    def normalized_weight(self, update_stats: bool) -> torch.Tensor:
        O, I, H, W = self.weight.shape
        w = self.weight.permute(2, 3, 1, 0).reshape(H * W * I, O)
        with torch.no_grad():
            v = _l2_normalize(self.u @ w.t(), self.eps)
            u = _l2_normalize(v @ w, self.eps)
        sigma = (v @ w @ u.t())[0, 0]
        w_bar = w / torch.where(sigma != 0, sigma, torch.ones_like(sigma))
        if update_stats:
            self.u.copy_(u)
            self.sigma.copy_(sigma.detach())
        return w_bar.reshape(H, W, I, O).permute(3, 2, 0, 1)

    def forward(self, x: torch.Tensor,
                update_stats: bool = False) -> torch.Tensor:
        dt = self.dtype
        return F.conv2d(x.to(dt), self.normalized_weight(update_stats).to(dt),
                        self.bias.to(dt), self.stride, self.padding)


def _instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Per sample and channel over H, W, in x's dtype."""
    mean = x.mean(dim=(2, 3), keepdim=True)
    var = ((x - mean) ** 2).mean(dim=(2, 3), keepdim=True)
    return (x - mean) / torch.sqrt(var + eps)


class Discriminator(nn.Module):
    def __init__(self, config: DiscriminatorConfig = DiscriminatorConfig(),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        c = config
        self.config = c
        d = max(c.depth - 3, 3)
        ch = c.hidden_channels // (2 ** d)
        self.conv_in = SpectralNormConv(c.in_channels, ch, dtype)
        self.convs = nn.ModuleList()
        for i in range(c.depth - 1):
            c_out = c.hidden_channels // (2 ** max(d - 1 - i, 0))
            self.convs.append(SpectralNormConv(ch, c_out, dtype))
            ch = c_out
        self.shuffle = Conv(ch, 1, 1, dtype=dtype)

    def forward(self, x: torch.Tensor, update_stats: bool = False
                ) -> torch.Tensor:
        """x [N, H, W, C] -> logits [N, h, w, 1]."""
        h = self.conv_in(x.permute(0, 3, 1, 2), update_stats)
        h = F.leaky_relu(h, 0.2)
        for conv in self.convs:
            h = F.leaky_relu(_instance_norm(conv(h, update_stats)), 0.2)
        return self.shuffle(h).permute(0, 2, 3, 1)


def hinge_d_loss(real_logits: torch.Tensor,
                 fake_logits: torch.Tensor) -> torch.Tensor:
    return (F.relu(1.0 + fake_logits) + F.relu(1.0 - real_logits)).mean()


def gen_loss(fake_logits: torch.Tensor) -> torch.Tensor:
    return -fake_logits.mean()
