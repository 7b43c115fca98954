"""Linear and conv layers that compute in a set dtype, and dropout.

Parameters stay in whatever dtype they hold (fp32 masters, or bf16 after
``generation.cast_matmul_params`` / ``cast_conv_params``) and are cast to
the layer's compute dtype at use, with the input: the promotion rule of a
Flax ``Dense``/``Conv`` built with ``dtype=``. A cast that is already done
costs nothing.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ivideogpt_tpu_torch.ops import qconv


def dropout(x: torch.Tensor, rate: float, deterministic: bool,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Flax ``nn.Dropout``: keep each element with probability 1 - rate and
    scale the kept ones by 1 / (1 - rate). The draws come from
    ``generator`` (on x's device); they cannot be JAX's."""
    if deterministic or rate == 0.0:
        return x
    keep_prob = 1.0 - rate
    keep = torch.rand(x.shape, device=x.device, generator=generator) < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype,
                                                        device=x.device))


class Dense(nn.Linear):
    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features, bias=bias)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


class Conv(nn.Conv2d):
    """NCHW conv; ``padding`` is symmetric, as Flax's ``padding=1``. Under
    ``ops.qconv.int8_convs`` it runs as an int8 conv (Q1) with its output
    in the input's dtype; under ``ops.qconv.calibrate_convs`` it records
    its input's absmax under ``qconv_key`` (``ops.qconv.name_convs``)."""

    qconv_key = None

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, padding: int = 0,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_channels, out_channels, kernel_size, stride=stride,
                         padding=padding)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = qconv.intercepted(self, x)
        if out is not None:
            return out
        dt = self.dtype
        return F.conv2d(x.to(dt), self.weight.to(dt), self.bias.to(dt),
                        self.stride, self.padding)
