"""The compressive VQ tokenizer of iVideoGPT, written plainly from its
description (Wu et al., 2024, §3.1; thuml/iVideoGPT ``ivideogpt/vq_model``):
a conv encoder and decoder for the context frames, a conditional pair for
the future frames that cross-attends to the context branch's features at
every resolution up to ``max_att_resolution``, 4 x 4 patches of the
future latents mixed into 16 tokens a frame, and nearest-codebook
quantisation.

Pixels are [N, H, W, C] in [0, 1]; the convolutions run NCHW. Every
product goes through a :class:`numerics.Precision`; GroupNorm, softmax
and the distances are fp32 (the distances fp64). The weights are a dict
of tensors by the names of ``params.tokenizer_spec``.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from benchmark.reference.numerics import Precision
from benchmark.reference.params import cross_levels, tok_dims
from benchmark.reference.stream import split_stream

W = Dict[str, torch.Tensor]


class Tokenizer:
    def __init__(self, weights: W, config: dict, prec: Precision):
        self.w, self.c, self.p = weights, config, prec
        self.groups = config["norm_num_groups"]
        self.dims = tok_dims(config)

    # -- layers -----------------------------------------------------------

    def _conv(self, x, name, stride=1, padding=None):
        k = self.w[name + ".weight"]
        pad = k.shape[-1] // 2 if padding is None else padding
        return self.p.conv(x, k, self.w[name + ".bias"], stride, pad)

    def _gn(self, x, name, eps=1e-6):
        return F.group_norm(x, self.groups, self.w[name + ".weight"],
                            self.w[name + ".bias"], eps)

    def _dense(self, x, name):
        return self.p.linear(x, self.w[name + ".weight"],
                             self.w[name + ".bias"])

    def _resnet(self, x, p):
        h = self._conv(F.silu(self._gn(x, p + "norm1")), p + "conv1")
        h = self._conv(F.silu(self._gn(h, p + "norm2")), p + "conv2")
        if p + "conv_shortcut.weight" in self.w:
            x = self._conv(x, p + "conv_shortcut")
        return x + h

    def _self_attention(self, x, p):
        B, C, H, Wd = x.shape
        h = self._gn(x, p + "group_norm").flatten(2).transpose(1, 2)
        q, k, v = (self._dense(h, p + n) for n in ("to_q", "to_k", "to_v"))
        a = torch.softmax(self.p.matmul(q, k.transpose(1, 2)) * C ** -0.5, -1)
        out = self._dense(self.p.matmul(a, v), p + "to_out.0")
        return x + out.transpose(1, 2).reshape(B, C, H, Wd)

    def _mid(self, x, p, attention):
        x = self._resnet(x, p + "resnets.0.")
        if attention:
            x = self._self_attention(x, p + "attentions.0.")
        return self._resnet(x, p + "resnets.1.")

    def _cross(self, z, feat, p, ctx):
        """z [N, C, H, W] attends to the context features feat
        [N / F * ctx, C, H, W] of its sample (keys in (frame, row, column)
        order): every future frame sees all its sample's context frames."""
        N, C, H, Wd = z.shape
        B = feat.shape[0] // ctx
        g = feat.reshape(B, 1, ctx, *feat.shape[1:])
        addin = g.expand(B, N // B, *g.shape[2:]).reshape(N, ctx,
                                                          *feat.shape[1:])
        nh = self.c["cross_attn_heads"]
        hd = C // nh
        kv = self._gn(addin.transpose(1, 2), p + "kv_norm", 1e-5)
        kv = kv.flatten(2).transpose(1, 2) + self.w[p + "kv_pos_emb"]
        q = self._gn(z, p + "q_norm", 1e-5).flatten(2).transpose(1, 2)
        q = q + self.w[p + "q_pos_emb"]
        wq, wk, wv = self.w[p + "att.in_proj_weight"].chunk(3)
        bq, bk, bv = self.w[p + "att.in_proj_bias"].chunk(3)

        def heads(x, w, b):
            return self.p.linear(x, w, b).view(N, -1, nh, hd).transpose(1, 2)

        qh, kh, vh = heads(q, wq, bq), heads(kv, wk, bk), heads(kv, wv, bv)
        a = torch.softmax(self.p.matmul(qh, kh.transpose(-1, -2))
                          * hd ** -0.5, -1)
        out = self.p.matmul(a, vh).transpose(1, 2).reshape(N, -1, C)
        out = self._dense(out, p + "att.out_proj")
        return F.silu(z + out.transpose(1, 2).reshape(N, C, H, Wd))

    def _out(self, x, p):
        return self._conv(F.silu(self._gn(x, p + "conv_norm_out")),
                          p + "conv_out")

    # -- the four networks ------------------------------------------------

    def encoder(self, x) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        c, p = self.c, "encoder."
        n = len(c["block_out_channels"])
        x = self._conv(x, p + "conv_in")
        feats = [x]
        for i in range(n):
            for j in range(c["layers_per_block"]):
                x = self._resnet(x, f"{p}down_blocks.{i}.resnets.{j}.")
            if i != n - 1:
                x = self._conv(F.pad(x, (0, 1, 0, 1)),
                               f"{p}down_blocks.{i}.downsamplers.0.conv", 2, 0)
            feats.append(x)
        x = self._mid(x, p + "mid_block.", c["mid_block_add_attention"])
        feats.append(x)
        return self._out(x, p), feats

    def cond_encoder(self, x, feats, ctx):
        c, p = self.c, "cond_encoder."
        n = len(c["block_out_channels"])
        cross = dict(cross_levels(c, True))
        x = self._conv(x, p + "conv_in")
        k = 0
        for i in range(n):
            for j in range(c["layers_per_block"]):
                x = self._resnet(x, f"{p}down_blocks.{i}.resnets.{j}.")
            if i != n - 1:
                x = self._conv(F.pad(x, (0, 1, 0, 1)),
                               f"{p}down_blocks.{i}.downsamplers.0.conv", 2, 0)
            if i in cross:
                x = self._cross(x, feats[i + 1], f"{p}cross_att_blocks.{k}.",
                                ctx)
                k += 1
        x = self._mid(x, p + "mid_block.", True)
        return self._out(x, p)

    def decoder(self, x):
        c, p = self.c, "decoder."
        n = len(c["block_out_channels"])
        x = self._conv(x, p + "conv_in")
        feats = [x]
        x = self._mid(x, p + "mid_block.", c["mid_block_add_attention"])
        feats.append(x)
        for i in range(n):
            for j in range(c["layers_per_block"] + 1):
                x = self._resnet(x, f"{p}up_blocks.{i}.resnets.{j}.")
            if i != n - 1:
                x = self._conv(F.interpolate(x, scale_factor=2.0,
                                             mode="nearest"),
                               f"{p}up_blocks.{i}.upsamplers.0.conv")
            feats.append(x)
        return self._out(x, p), feats

    def cond_decoder(self, x, feats, ctx):
        c, p = self.c, "cond_decoder."
        n = len(c["block_out_channels"])
        cross = dict(cross_levels(c, False))
        x = self._conv(x, p + "conv_in")
        x = self._mid(x, p + "mid_block.", True)
        x = self._cross(x, feats[1], p + "cross_att_blocks.0.", ctx)
        k = 1
        for i in range(n):
            for j in range(c["layers_per_block"] + 1):
                x = self._resnet(x, f"{p}up_blocks.{i}.resnets.{j}.")
            if i != n - 1:
                x = self._conv(F.interpolate(x, scale_factor=2.0,
                                             mode="nearest"),
                               f"{p}up_blocks.{i}.upsamplers.0.conv")
            if i in cross:
                x = self._cross(x, feats[i + 2], f"{p}cross_att_blocks.{k}.",
                                ctx)
                k += 1
        return self._out(x, p)

    # -- tokens -----------------------------------------------------------

    def _patchify(self, x):
        """[N, C, r, r] -> [N, (r/p)^2, p*p*C], inner order (row, col, C)."""
        p = self.c["patch_size"]
        x = x.permute(0, 2, 3, 1)
        N, H, Wd, C = x.shape
        x = x.reshape(N, H // p, p, Wd // p, p, C).permute(0, 1, 3, 2, 4, 5)
        return x.reshape(N, (H // p) * (Wd // p), p * p * C)

    def _depatchify(self, x):
        p, r = self.c["patch_size"], self.dims["latent_res"]
        C = self.c["latent_channels"]
        N = x.shape[0]
        x = x.reshape(N, r // p, r // p, p, p, C).permute(0, 1, 3, 2, 4, 5)
        return x.reshape(N, r, r, C).permute(0, 3, 1, 2)

    def context_latents(self, frames):
        """Context frames [N, H, W, C] -> (z [N*r*r, D], encoder features)."""
        h, feats = self.encoder(frames.permute(0, 3, 1, 2))
        z = self._conv(h, "quant_conv").permute(0, 2, 3, 1)
        return z.reshape(-1, self.dims["embed_dim"]), feats

    def dynamics_latents(self, frames, feats, ctx):
        """Future frames [B*F, H, W, C] -> z [B*F*dyn_tokens, D]."""
        d = self.cond_encoder(frames.permute(0, 3, 1, 2), feats, ctx)
        d = self._dense(self._patchify(d), "quant_linear")
        return d.reshape(-1, self.dims["embed_dim"])

    def render(self, ctx_ids, dyn_ids):
        """Raw ids [B, ctx, ctx_tokens] and [B, F, dyn_tokens] -> frames
        [B, ctx + F, H, W, C]."""
        B, ctx = ctx_ids.shape[:2]
        F_ = dyn_ids.shape[1]
        r, D = self.dims["latent_res"], self.dims["embed_dim"]
        q = self.w["quantize.embedding.weight"][ctx_ids.reshape(-1)]
        q = q.view(-1, r, r, D).permute(0, 3, 1, 2)
        ctx_dec, feats = self.decoder(self._conv(q, "post_quant_conv"))
        qd = self.w["dynamics_quantize.embedding.weight"][dyn_ids.reshape(-1)]
        qd = self._dense(qd.view(B * F_, -1, D), "post_quant_linear")
        dec = self.cond_decoder(self._depatchify(qd), feats, ctx)
        H = dec.shape[-1]
        C = dec.shape[1]
        return torch.cat([
            ctx_dec.permute(0, 2, 3, 1).reshape(B, ctx, H, H, C),
            dec.permute(0, 2, 3, 1).reshape(B, F_, H, H, C)], dim=1)

    def render_stream(self, stream, ctx):
        """The token stream [B, L] -> frames, the ids clamped into their
        codebooks as the published ``detokenize`` does."""
        ctx_ids, dyn_ids = split_stream(stream, ctx, self.c, self.dims)
        return self.render(ctx_ids, dyn_ids)


def nearest(z: torch.Tensor, codebook: torch.Tensor, block: int = 4096
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ids [N], squared distances to them [N]): each row of z's nearest
    code, in fp64, in blocks of rows."""
    e = codebook.double()
    en = (e * e).sum(1)
    ids, dmin = [], []
    for i in range(0, z.shape[0], block):
        zb = z[i:i + block].double()
        d = (zb * zb).sum(1, keepdim=True) - 2 * zb @ e.t() + en
        m = d.min(1)
        ids.append(m.indices)
        dmin.append(m.values)
    return torch.cat(ids), torch.cat(dmin)


def distance_to(z: torch.Tensor, codebook: torch.Tensor,
                ids: torch.Tensor) -> torch.Tensor:
    """Squared distance [N] of each row of z to the code ``ids`` names,
    in fp64."""
    return ((z.double() - codebook[ids].double()) ** 2).sum(1)
