"""Compressive (conditional) VQGAN tokenizer, the port of
``ivideogpt_tpu/models/tokenizer.py``.

Context frames are encoded at full spatial detail (16x16 tokens a frame at
64px); future frames pass through a context-cross-attention encoder and a
4x4 patchify into a 16-token dynamics grid. The pixel API is [B, T, H, W, C]
as in the JAX package; the conv stacks run NCHW inside.

The inference paths are ``encode_context``, ``tokenize`` and ``detokenize``,
and, for the MBRL rollout's frame-by-frame decode, ``build_decode_cache``
and ``decode_dyn_frame``; ``forward`` is the training forward
(straight-through quantize, commit losses, dropout). All run with TF32
off, so an fp32 model computes in IEEE fp32 (token-id parity with the JAX
package); a bf16 model is unaffected.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ivideogpt_tpu_torch import tokens as token_lib
from ivideogpt_tpu_torch.configs import CompressiveVQConfig
from ivideogpt_tpu_torch.models.conditional_vae import (ConditionalDecoder,
                                                        ConditionalEncoder)
from ivideogpt_tpu_torch.models.layers import Conv, Dense
from ivideogpt_tpu_torch.models.vae import Decoder, Encoder
from ivideogpt_tpu_torch.ops import vq as vq_ops
from ivideogpt_tpu_torch.utils.platform import full_fp32


class _TiledFeatures(Sequence):
    """Per-context features repeated across future frames, tiled on access:

    ctx > 1: (B*ctx, C, H, W) -> (B*F, ctx, C, H, W)
    ctx == 1: (B, C, H, W)    -> (B*F, C, H, W)

    Tiling on access means a feature that no cross-attention block reads
    (every one above ``max_att_resolution``) is never copied F times.
    """

    def __init__(self, features, batch: int, context_length: int,
                 future_length: int):
        self._features = list(features)
        self._b, self._ctx, self._f = batch, context_length, future_length

    def __len__(self):
        return len(self._features)

    def __getitem__(self, i):
        f = self._features[i]
        B, ctx, F = self._b, self._ctx, self._f
        if ctx > 1:
            g = f.reshape(B, ctx, *f.shape[1:])[:, None]
            return g.expand(B, F, *g.shape[2:]).reshape(B * F, ctx,
                                                        *f.shape[1:])
        g = f[:, None].expand(f.shape[0], F, *f.shape[1:])
        return g.reshape(f.shape[0] * F, *f.shape[1:])


def _tile_cond_features(features, batch: int, context_length: int,
                        future_length: int) -> _TiledFeatures:
    """Repeat per-context features across future frames (see _TiledFeatures)."""
    return _TiledFeatures(features, batch, context_length, future_length)


def patchify(x: torch.Tensor, p: int) -> torch.Tensor:
    """[B, H, W, C] -> [B, (H/p)*(W/p), p*p*C] with (p_h, p_w, c) inner order."""
    B, H, W, C = x.shape
    x = x.reshape(B, H // p, p, W // p, p, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, (H // p) * (W // p), p * p * C)


def depatchify(x: torch.Tensor, h: int, w: int, p: int, c: int) -> torch.Tensor:
    """[B, L, p*p*c] -> [B, h, w, c]."""
    B = x.shape[0]
    x = x.reshape(B, h // p, w // p, p, p, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, h, w, c)


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


class _Codebook(nn.Module):
    """``quantize.embedding.weight`` holder, uniform(-1/K, 1/K) at init."""

    def __init__(self, num: int, dim: int):
        super().__init__()
        self.embedding = nn.Embedding(num, dim)
        nn.init.uniform_(self.embedding.weight, -1.0 / num, 1.0 / num)


class CompressiveVQModel(nn.Module):
    def __init__(self, config: CompressiveVQConfig,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        c = config
        self.config = c
        self.dtype = dtype
        blocks = dict(block_out_channels=c.block_out_channels,
                      layers_per_block=c.layers_per_block,
                      norm_num_groups=c.norm_num_groups, dropout=c.dropout,
                      remat=c.remat, dtype=dtype)
        cond = dict(max_att_resolution=c.max_att_resolution,
                    context_length=c.context_length,
                    cross_attn_heads=c.cross_attn_heads,
                    cross_attn_dropout=c.cross_attn_dropout, **blocks)
        self.encoder = Encoder(c.in_channels, c.latent_channels,
                               mid_block_add_attention=c.mid_block_add_attention,
                               **blocks)
        self.cond_encoder = ConditionalEncoder(
            c.in_channels, c.latent_channels, init_resolution=c.resolution,
            **cond)
        self.decoder = Decoder(c.latent_channels, c.out_channels,
                               mid_block_add_attention=c.mid_block_add_attention,
                               **blocks)
        self.cond_decoder = ConditionalDecoder(
            c.latent_channels, c.out_channels,
            init_resolution=c.latent_resolution, **cond)
        d = c.embed_dim
        p2 = c.patch_size * c.patch_size
        self.quant_conv = Conv(c.latent_channels, d, 1, dtype=dtype)
        self.post_quant_conv = Conv(d, c.latent_channels, 1, dtype=dtype)
        self.quant_linear = Dense(c.latent_channels * p2, d, dtype=dtype)
        self.post_quant_linear = Dense(d, c.latent_channels * p2, dtype=dtype)
        self.quantize = _Codebook(c.num_vq_embeddings, d)
        self.dynamics_quantize = _Codebook(c.num_dyn_embeddings, d)

    # ------------------------------------------------------------------

    def encode_context(self, context_frames: torch.Tensor) -> torch.Tensor:
        """[B, ctx, H, W, C] -> context token grid [B, ctx, ctx_tokens]."""
        c = self.config
        B, ctx = context_frames.shape[:2]
        with full_fp32():
            h = self.encoder(_nchw(context_frames.flatten(0, 1)))
            h = _nhwc(self.quant_conv(h))
            idx = vq_ops.vq_lookup(h.reshape(-1, c.embed_dim),
                                   self.quantize.embedding.weight)
        return idx.view(B, ctx, c.ctx_tokens_per_frame)

    def tokenize(self, pixel_values: torch.Tensor, context_length: int):
        """[B, T, H, W, C] pixels -> (indices [B, L], labels [B, L])."""
        c = self.config
        if context_length != c.context_length:
            raise ValueError(f"context_length {context_length} != config's "
                             f"{c.context_length}")
        B, T = pixel_values.shape[:2]
        F = T - context_length
        with full_fp32():
            h, feats = self.encoder(
                _nchw(pixel_values[:, :context_length].flatten(0, 1)),
                return_features=True)
            h = _nhwc(self.quant_conv(h))
            d = self.cond_encoder(
                _nchw(pixel_values[:, context_length:].flatten(0, 1)),
                _tile_cond_features(feats, B, context_length, F))
            d = self.quant_linear(patchify(_nhwc(d), c.patch_size))
            idx_c = vq_ops.vq_lookup(h.reshape(-1, c.embed_dim),
                                     self.quantize.embedding.weight)
            idx_d = vq_ops.vq_lookup(d.reshape(-1, c.embed_dim),
                                     self.dynamics_quantize.embedding.weight)
        return token_lib.assemble(
            idx_c.view(B, context_length, c.ctx_tokens_per_frame),
            idx_d.view(B, F, c.dyn_tokens_per_frame),
            c.num_vq_embeddings, c.num_dyn_embeddings)

    def detokenize(self, indices: torch.Tensor, context_length: int
                   ) -> torch.Tensor:
        """indices [B, L] -> frames [B, T, H, W, C]."""
        c = self.config
        if context_length != c.context_length:
            raise ValueError(f"context_length {context_length} != config's "
                             f"{c.context_length}")
        B = indices.shape[0]
        idx_c, idx_d = token_lib.disassemble(
            indices, context_length, c.num_vq_embeddings, c.num_dyn_embeddings,
            ctx_tokens=c.ctx_tokens_per_frame,
            dyn_tokens=c.dyn_tokens_per_frame)
        F = idx_d.shape[1]
        with full_fp32():
            context_dec, feats = self._decode_context(idx_c)
            dec = self.cond_decoder(
                self._dyn_latent(idx_d.reshape(B * F, -1)),
                _tile_cond_features(feats, B, context_length, F))
        H = context_dec.shape[-1]
        return torch.cat([
            _nhwc(context_dec).reshape(B, context_length, H, H, c.out_channels),
            _nhwc(dec).reshape(B, F, H, H, c.out_channels),
        ], dim=1)

    def build_decode_cache(self, ctx_indices: torch.Tensor):
        """Decode the context grid [B, ctx, ctx_tokens] once: (context_dec
        [B*ctx, H, W, C], cache), the cache holding context_dec and the
        decoder's features tiled for one future frame, as
        :meth:`decode_dyn_frame` reads them."""
        B, ctx = ctx_indices.shape[:2]
        with full_fp32():
            context_dec, feats = self._decode_context(ctx_indices)
        context_dec = _nhwc(context_dec)
        return context_dec, {
            "context_dec": context_dec,
            "cond_features": _tile_cond_features(feats, B, ctx, 1)}

    def decode_dyn_frame(self, dyn_indices: torch.Tensor, cache
                         ) -> torch.Tensor:
        """[B, dyn_tokens] raw (un-offset) dynamics ids -> one frame
        [B, H, W, C], cross-attending into the features of
        :meth:`build_decode_cache`."""
        with full_fp32():
            dec = self.cond_decoder(self._dyn_latent(dyn_indices),
                                    cache["cond_features"])
        return _nhwc(dec)

    def _decode_context(self, idx_c: torch.Tensor):
        """Raw context ids [B, ctx, ctx_tokens] -> (decoded context frames
        [B*ctx, C, H, W], the decoder's features); TF32 off by the caller."""
        c = self.config
        r = c.latent_resolution
        quant = self.quantize.embedding.weight[idx_c.reshape(-1)]
        quant = quant.view(-1, r, r, c.embed_dim)
        return self.decoder(self.post_quant_conv(_nchw(quant.to(self.dtype))),
                            return_features=True)

    def _dyn_latent(self, idx_d: torch.Tensor) -> torch.Tensor:
        """Raw dynamics ids [N, dyn_tokens] -> the cond decoder's input
        [N, latent_channels, r, r]; TF32 off by the caller."""
        c = self.config
        r = c.latent_resolution
        quant_d = self.dynamics_quantize.embedding.weight[idx_d.reshape(-1)]
        quant_d = quant_d.view(-1, c.dyn_tokens_per_frame, c.embed_dim)
        quant2_d = self.post_quant_linear(quant_d.to(self.dtype))
        return _nchw(depatchify(quant2_d, r, r, c.patch_size,
                                c.latent_channels))

    def forward(self, sample: torch.Tensor, dyn_sample: torch.Tensor,
                segment_len: int, deterministic: bool = True,
                return_pre_out: bool = False,
                generator: Optional[torch.Generator] = None):
        """Training forward, the JAX model's ``__call__``.

        sample: context frames [B*ctx, H, W, C]; dyn_sample: future frames
        [B*F, H, W, C]; segment_len: F. Dropout applies unless
        ``deterministic``, drawn from ``generator``. Returns, in NHWC,
        (dec [B*F, H, W, C], ref_dec [B*ctx, H, W, C], commit_loss,
        dyn_commit_loss[, pre_out [B*F, H, W, C0]]), pre_out being the input
        of ``cond_decoder.conv_out``. The forward runs with TF32 off; run the
        backward under ``utils.platform.full_fp32`` too for IEEE fp32 (with
        ``config.remat`` the conv blocks' recomputation runs there)."""
        c = self.config
        B = dyn_sample.shape[0] // segment_len
        drop = dict(deterministic=deterministic, generator=generator)
        r = c.latent_resolution
        with full_fp32():
            h, feats = self.encoder(_nchw(sample), return_features=True,
                                    **drop)
            h = _nhwc(self.quant_conv(h))
            d = self.cond_encoder(
                _nchw(dyn_sample),
                _tile_cond_features(feats, B, c.context_length, segment_len),
                **drop)
            d = self.quant_linear(patchify(_nhwc(d), c.patch_size))
            q = vq_ops.quantize(h, self.quantize.embedding.weight)
            q_d = vq_ops.quantize(d, self.dynamics_quantize.embedding.weight)
            quant2 = self.post_quant_conv(_nchw(q.quantized))
            quant2_d = _nchw(depatchify(self.post_quant_linear(q_d.quantized),
                                        r, r, c.patch_size, c.latent_channels))
            ref_dec, dec_feats = self.decoder(quant2, return_features=True,
                                              **drop)
            out = self.cond_decoder(
                quant2_d, _tile_cond_features(dec_feats, B, c.context_length,
                                              segment_len),
                return_pre_out=return_pre_out, **drop)
        dec, pre_out = out if return_pre_out else (out, None)
        res = (_nhwc(dec), _nhwc(ref_dec), q.commit_loss, q_d.commit_loss)
        return res + (_nhwc(pre_out),) if return_pre_out else res
