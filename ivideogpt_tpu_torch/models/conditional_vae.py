"""Context-conditional encoder/decoder with cross-attention injection, the
port of ``ivideogpt_tpu/models/conditional_vae.py`` (NCHW).

The dynamics branch attends to the context branch's feature pyramid at
every resolution <= ``max_att_resolution``, with learned q/kv positional
embeddings. The cross-attention keeps the packed ``att.in_proj_*`` /
``att.out_proj`` parameters of the torch checkpoints and computes plain
attention from them. Dropout (the ResnetBlocks' ``dropout`` and the
cross-attention's ``cross_attn_dropout`` on the attention weights and on the
output) applies when a forward is called with ``deterministic=False``, drawn
from its ``generator``. With ``remat`` the down blocks of the encoder and
the up blocks of the decoder recompute their activations in the backward
(``vae.call_block``), as ``nn.remat`` wraps them in the JAX package; the
cross-attention and mid blocks keep theirs.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ivideogpt_tpu_torch.models.layers import Conv, Dense, dropout
from ivideogpt_tpu_torch.models.vae import (DownBlock, MidBlock, UpBlock,
                                             call_block)
from ivideogpt_tpu_torch.ops.norms import GroupNorm


class _PackedAttention(nn.Module):
    """Parameter holder in ``nn.MultiheadAttention``'s naming."""

    def __init__(self, channels: int, dtype: torch.dtype):
        super().__init__()
        self.in_proj_weight = nn.Parameter(torch.empty(3 * channels, channels))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * channels))
        self.out_proj = Dense(channels, channels, dtype=dtype)
        nn.init.xavier_uniform_(self.in_proj_weight)


class CrossAttentionBlock(nn.Module):
    """q from the dynamics path, kv from context features:

      kv = GN(addin) + kv_pos_emb ; q = GN(z) + q_pos_emb
      z  = silu(z + dropout(out_proj(MHA(q, kv, kv))))

    with dropout on the softmax weights inside MHA as well.

    The residual uses the un-normalised z; GroupNorm eps is 1e-5.
    """

    def __init__(self, channels: int, resolution: int, kv_frames: int = 1,
                 num_heads: int = 4, norm_groups: int = 32,
                 dropout: float = 0.1, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.dropout = dropout
        self.dtype = dtype
        r2 = resolution * resolution
        self.kv_pos_emb = nn.Parameter(torch.zeros(kv_frames * r2, channels))
        self.q_pos_emb = nn.Parameter(torch.zeros(r2, channels))
        self.kv_norm = GroupNorm(norm_groups, channels, 1e-5, dtype)
        self.q_norm = GroupNorm(norm_groups, channels, 1e-5, dtype)
        self.att = _PackedAttention(channels, dtype)

    def forward(self, z, addin, deterministic: bool = True, generator=None):
        """z [B, C, H, W]; addin [B, C, H, W] or [B, t, C, H, W]."""
        B, C, H, W = z.shape
        dt = self.dtype
        if addin.ndim == 5:  # kv tokens in (t, h, w) row-major order
            addin = addin.transpose(1, 2)
        kv = self.kv_norm(addin).flatten(2).transpose(1, 2)   # [B, S, C]
        kv = kv + self.kv_pos_emb.to(kv.dtype)
        q = self.q_norm(z).flatten(2).transpose(1, 2)         # [B, HW, C]
        q = q + self.q_pos_emb.to(q.dtype)

        w = self.att.in_proj_weight.to(dt).chunk(3)
        b = self.att.in_proj_bias.to(dt).chunk(3)
        nh, hd = self.num_heads, C // self.num_heads
        qh = F.linear(q.to(dt), w[0], b[0]).view(B, -1, nh, hd)
        kh = F.linear(kv.to(dt), w[1], b[1]).view(B, -1, nh, hd)
        vh = F.linear(kv.to(dt), w[2], b[2]).view(B, -1, nh, hd)

        attn = torch.einsum("bqhd,bkhd->bhqk", qh, kh).float()
        attn = torch.softmax(attn * (hd ** -0.5), dim=-1)
        attn = dropout(attn, self.dropout, deterministic, generator)
        out = torch.einsum("bhqk,bkhd->bqhd", attn.to(dt), vh).reshape(B, -1, C)
        out = dropout(self.att.out_proj(out), self.dropout, deterministic,
                      generator)
        return F.silu(z + out.transpose(1, 2).reshape(B, C, H, W))


class ConditionalEncoder(nn.Module):
    """Encoder whose down path cross-attends to context features."""

    def __init__(self, in_channels: int, out_channels: int,
                 block_out_channels: Sequence[int] = (128, 256, 512),
                 layers_per_block: int = 2, norm_num_groups: int = 32,
                 max_att_resolution: int = 16, init_resolution: int = 64,
                 context_length: int = 1, cross_attn_heads: int = 4,
                 dropout: float = 0.0, cross_attn_dropout: float = 0.1,
                 remat: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.remat = remat
        ch = list(block_out_channels)
        n = len(ch)
        blk = dict(groups=norm_num_groups, dropout=dropout, dtype=dtype)
        self.conv_in = Conv(in_channels, ch[0], 3, padding=1, dtype=dtype)
        self.down_blocks = nn.ModuleList()
        self.cross_att_blocks = nn.ModuleList()
        self._att_after = []  # down-block index -> uses a cross block
        resolution = init_resolution
        for i, c in enumerate(ch):
            self.down_blocks.append(DownBlock(
                ch[max(i - 1, 0)], c, layers_per_block, i != n - 1, **blk))
            if i != n - 1:
                resolution //= 2
            use = resolution <= max_att_resolution
            self._att_after.append(use)
            if use:
                self.cross_att_blocks.append(CrossAttentionBlock(
                    c, resolution, context_length, cross_attn_heads,
                    norm_num_groups, cross_attn_dropout, dtype))
        self.mid_block = MidBlock(ch[-1], True, **blk)
        self.conv_norm_out = GroupNorm(norm_num_groups, ch[-1], 1e-6, dtype)
        self.conv_out = Conv(ch[-1], out_channels, 3, padding=1, dtype=dtype)

    def forward(self, sample, cond_features, deterministic: bool = True,
                generator=None):
        drop = (deterministic, generator)
        sample = self.conv_in(sample)
        att = iter(self.cross_att_blocks)
        for i, block in enumerate(self.down_blocks):
            sample = call_block(block, self.remat, sample, *drop)
            if self._att_after[i]:
                sample = next(att)(sample, cond_features[i + 1], *drop)
        sample = self.mid_block(sample, *drop)
        return self.conv_out(F.silu(self.conv_norm_out(sample)))


class ConditionalDecoder(nn.Module):
    """Decoder whose up path cross-attends to context decoder features."""

    def __init__(self, in_channels: int, out_channels: int,
                 block_out_channels: Sequence[int] = (128, 256, 512),
                 layers_per_block: int = 2, norm_num_groups: int = 32,
                 max_att_resolution: int = 16, init_resolution: int = 16,
                 context_length: int = 1, cross_attn_heads: int = 4,
                 dropout: float = 0.0, cross_attn_dropout: float = 0.1,
                 remat: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.remat = remat
        rev = list(reversed(block_out_channels))
        n = len(rev)
        blk = dict(groups=norm_num_groups, dropout=dropout, dtype=dtype)
        self.conv_in = Conv(in_channels, rev[0], 3, padding=1, dtype=dtype)
        self.mid_block = MidBlock(rev[0], True, **blk)
        # the first cross block always exists at init_resolution, fed by the
        # context decoder's mid feature
        self.cross_att_blocks = nn.ModuleList([CrossAttentionBlock(
            rev[0], init_resolution, context_length, cross_attn_heads,
            norm_num_groups, cross_attn_dropout, dtype)])
        self.up_blocks = nn.ModuleList()
        self._att_after = []
        resolution = init_resolution
        for i, c in enumerate(rev):
            self.up_blocks.append(UpBlock(
                rev[max(i - 1, 0)], c, layers_per_block + 1, i != n - 1,
                **blk))
            if i != n - 1:
                resolution *= 2
            use = resolution <= max_att_resolution
            self._att_after.append(use)
            if use:
                self.cross_att_blocks.append(CrossAttentionBlock(
                    c, resolution, context_length, cross_attn_heads,
                    norm_num_groups, cross_attn_dropout, dtype))
        self.conv_norm_out = GroupNorm(norm_num_groups, rev[-1], 1e-6, dtype)
        self.conv_out = Conv(rev[-1], out_channels, 3, padding=1, dtype=dtype)

    def forward(self, sample, cond_features, deterministic: bool = True,
                generator=None, return_pre_out: bool = False):
        """``return_pre_out`` also returns the input of ``conv_out`` (the
        trainer's adaptive GAN weight differentiates through it)."""
        drop = (deterministic, generator)
        sample = self.conv_in(sample)
        sample = self.mid_block(sample, *drop)
        sample = self.cross_att_blocks[0](sample, cond_features[1], *drop)
        att = iter(self.cross_att_blocks[1:])
        for i, block in enumerate(self.up_blocks):
            sample = call_block(block, self.remat, sample, *drop)
            if self._att_after[i]:
                sample = next(att)(sample, cond_features[i + 2], *drop)
        pre_out = F.silu(self.conv_norm_out(sample))
        out = self.conv_out(pre_out)
        return (out, pre_out) if return_pre_out else out
