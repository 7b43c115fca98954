"""Conv encoder/decoder backbone (NCHW), the port of ``ivideogpt_tpu/models/vae.py``.

- ResnetBlock: GN(eps=1e-6) -> SiLU -> 3x3 -> GN -> SiLU -> 3x3, with a 1x1
  shortcut when channels change
- Downsample: asymmetric (0, 1) x (0, 1) pad + 3x3 stride-2 conv
- Upsample: nearest 2x + 3x3 conv
- MidBlock: resnet, [single-head self-attention], resnet
- Encoder/Decoder return their feature pyramids when ``return_features``,
  for the cross-attention conditioning.

Every forward takes ``deterministic`` (dropout off, the default) and the
``generator`` its dropout draws from; the ResnetBlock dropout sits before
conv2, as in the JAX package. With ``remat`` the Encoder's down and mid
blocks and the Decoder's mid and up blocks recompute their activations in
the backward (:func:`call_block`), the blocks ``nn.remat`` wraps in the
JAX package. Module and parameter names follow the torch names of
``ivideogpt_tpu.utils.checkpoint.flax_to_torch_tokenizer``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ivideogpt_tpu_torch.models.layers import Conv, Dense, dropout
from ivideogpt_tpu_torch.ops.norms import GroupNorm


def call_block(block: nn.Module, remat: bool, x: torch.Tensor,
               deterministic: bool,
               generator: Optional[torch.Generator]) -> torch.Tensor:
    """``block(x, deterministic, generator)``; with ``remat`` (and autograd
    on) its activations are recomputed in the backward
    (``torch.utils.checkpoint``, non-reentrant) instead of kept. The
    recomputation draws the forward's dropout masks: checkpoint restores
    the global RNG itself, and an explicit ``generator`` is rewound to its
    state before the forward for the recomputation, then set back where the
    rest of the model's draws have left it."""
    if not (remat and torch.is_grad_enabled()):
        return block(x, deterministic, generator)
    if deterministic or generator is None:
        return checkpoint(block, x, deterministic, generator,
                          use_reentrant=False)
    start = []

    def run(x):
        if not start:  # the forward
            start.append(generator.get_state())
            return block(x, deterministic, generator)
        now = generator.get_state()
        generator.set_state(start[0])
        try:
            return block(x, deterministic, generator)
        finally:
            generator.set_state(now)

    return checkpoint(run, x, use_reentrant=False)


class ResnetBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, groups: int = 32,
                 eps: float = 1e-6, dropout: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dropout = dropout
        self.norm1 = GroupNorm(groups, in_channels, eps, dtype)
        self.conv1 = Conv(in_channels, out_channels, 3, padding=1, dtype=dtype)
        self.norm2 = GroupNorm(groups, out_channels, eps, dtype)
        self.conv2 = Conv(out_channels, out_channels, 3, padding=1, dtype=dtype)
        self.conv_shortcut = (Conv(in_channels, out_channels, 1, dtype=dtype)
                              if in_channels != out_channels else None)

    def forward(self, x, deterministic: bool = True, generator=None):
        h = self.conv1(F.silu(self.norm1(x)))
        h = dropout(F.silu(self.norm2(h)), self.dropout, deterministic,
                    generator)
        h = self.conv2(h)
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class Downsample(nn.Module):
    def __init__(self, channels: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = Conv(channels, channels, 3, stride=2, dtype=dtype)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class Upsample(nn.Module):
    def __init__(self, channels: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = Conv(channels, channels, 3, padding=1, dtype=dtype)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class AttnBlock(nn.Module):
    """Single-head self-attention over spatial positions, residual."""

    def __init__(self, channels: int, groups: int = 32, eps: float = 1e-6,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.group_norm = GroupNorm(groups, channels, eps, dtype)
        self.to_q = Dense(channels, channels, dtype=dtype)
        self.to_k = Dense(channels, channels, dtype=dtype)
        self.to_v = Dense(channels, channels, dtype=dtype)
        self.to_out = nn.ModuleList([Dense(channels, channels, dtype=dtype)])

    def forward(self, x):
        B, C, H, W = x.shape
        h = self.group_norm(x).flatten(2).transpose(1, 2)   # [B, HW, C]
        q, k, v = self.to_q(h), self.to_k(h), self.to_v(h)
        attn = torch.einsum("bqc,bkc->bqk", q, k).float()
        attn = torch.softmax(attn * (C ** -0.5), dim=-1).to(self.dtype)
        out = self.to_out[0](torch.einsum("bqk,bkc->bqc", attn, v))
        return x + out.transpose(1, 2).reshape(B, C, H, W)


class MidBlock(nn.Module):
    def __init__(self, channels: int, add_attention: bool = True,
                 groups: int = 32, dropout: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock(channels, channels, groups, dropout=dropout,
                        dtype=dtype)
            for _ in range(2)])
        self.attentions = (nn.ModuleList([AttnBlock(channels, groups,
                                                    dtype=dtype)])
                           if add_attention else None)

    def forward(self, x, deterministic: bool = True, generator=None):
        x = self.resnets[0](x, deterministic, generator)
        if self.attentions is not None:
            x = self.attentions[0](x)
        return self.resnets[1](x, deterministic, generator)


class DownBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, num_layers: int,
                 add_downsample: bool, groups: int = 32,
                 dropout: float = 0.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock(in_channels if i == 0 else out_channels, out_channels,
                        groups, dropout=dropout, dtype=dtype)
            for i in range(num_layers)])
        self.downsamplers = (nn.ModuleList([Downsample(out_channels, dtype)])
                             if add_downsample else None)

    def forward(self, x, deterministic: bool = True, generator=None):
        for r in self.resnets:
            x = r(x, deterministic, generator)
        if self.downsamplers is not None:
            x = self.downsamplers[0](x)
        return x


class UpBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, num_layers: int,
                 add_upsample: bool, groups: int = 32,
                 dropout: float = 0.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock(in_channels if i == 0 else out_channels, out_channels,
                        groups, dropout=dropout, dtype=dtype)
            for i in range(num_layers)])
        self.upsamplers = (nn.ModuleList([Upsample(out_channels, dtype)])
                           if add_upsample else None)

    def forward(self, x, deterministic: bool = True, generator=None):
        for r in self.resnets:
            x = r(x, deterministic, generator)
        if self.upsamplers is not None:
            x = self.upsamplers[0](x)
        return x


class Encoder(nn.Module):
    """Feature pyramid = [conv_in, *down_blocks, mid]."""

    def __init__(self, in_channels: int, out_channels: int,
                 block_out_channels: Sequence[int] = (128, 256, 512),
                 layers_per_block: int = 2, norm_num_groups: int = 32,
                 mid_block_add_attention: bool = True, dropout: float = 0.0,
                 remat: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.remat = remat
        ch = list(block_out_channels)
        n = len(ch)
        blk = dict(groups=norm_num_groups, dropout=dropout, dtype=dtype)
        self.conv_in = Conv(in_channels, ch[0], 3, padding=1, dtype=dtype)
        self.down_blocks = nn.ModuleList([
            DownBlock(ch[max(i - 1, 0)], c, layers_per_block, i != n - 1,
                      **blk) for i, c in enumerate(ch)])
        self.mid_block = MidBlock(ch[-1], mid_block_add_attention, **blk)
        self.conv_norm_out = GroupNorm(norm_num_groups, ch[-1], 1e-6, dtype)
        self.conv_out = Conv(ch[-1], out_channels, 3, padding=1, dtype=dtype)

    def forward(self, sample, return_features: bool = False,
                deterministic: bool = True, generator=None):
        features: List[torch.Tensor] = []
        sample = self.conv_in(sample)
        features.append(sample)
        drop = (deterministic, generator)
        for block in self.down_blocks:
            sample = call_block(block, self.remat, sample, *drop)
            features.append(sample)
        sample = call_block(self.mid_block, self.remat, sample, *drop)
        features.append(sample)
        sample = self.conv_out(F.silu(self.conv_norm_out(sample)))
        return (sample, features) if return_features else sample


class Decoder(nn.Module):
    """Feature pyramid = [conv_in, mid, *up_blocks]."""

    def __init__(self, in_channels: int, out_channels: int,
                 block_out_channels: Sequence[int] = (128, 256, 512),
                 layers_per_block: int = 2, norm_num_groups: int = 32,
                 mid_block_add_attention: bool = True, dropout: float = 0.0,
                 remat: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.remat = remat
        rev = list(reversed(block_out_channels))
        n = len(rev)
        blk = dict(groups=norm_num_groups, dropout=dropout, dtype=dtype)
        self.conv_in = Conv(in_channels, rev[0], 3, padding=1, dtype=dtype)
        self.mid_block = MidBlock(rev[0], mid_block_add_attention, **blk)
        self.up_blocks = nn.ModuleList([
            UpBlock(rev[max(i - 1, 0)], c, layers_per_block + 1, i != n - 1,
                    **blk) for i, c in enumerate(rev)])
        self.conv_norm_out = GroupNorm(norm_num_groups, rev[-1], 1e-6, dtype)
        self.conv_out = Conv(rev[-1], out_channels, 3, padding=1, dtype=dtype)

    def forward(self, sample, return_features: bool = False,
                deterministic: bool = True, generator=None):
        features: List[torch.Tensor] = []
        sample = self.conv_in(sample)
        features.append(sample)
        drop = (deterministic, generator)
        sample = call_block(self.mid_block, self.remat, sample, *drop)
        features.append(sample)
        for block in self.up_blocks:
            sample = call_block(block, self.remat, sample, *drop)
            features.append(sample)
        sample = self.conv_out(F.silu(self.conv_norm_out(sample)))
        return (sample, features) if return_features else sample
