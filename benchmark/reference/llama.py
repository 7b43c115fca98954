"""The LLaMA of iVideoGPT's LM (HF ``LlamaForCausalLM``: RMSNorm,
rotate-half RoPE, SwiGLU, no biases) with its action head: a linear map of
each frame's action added to the embedding of the sdf that opens the
frame. Written plainly from the published description, fp32 throughout
but for the products a :class:`numerics.Precision` rounds.

Attention dropout (training) multiplies the softmax probabilities by the
mask of :mod:`philox`.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from benchmark.reference import philox
from benchmark.reference.numerics import Precision
from benchmark.reference.stream import IGNORE, sdf_positions

W = Dict[str, torch.Tensor]


def _rms(x, w, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def _rope(x, pos, theta):
    """x [B, H, S, hd] at positions pos [S]."""
    hd = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float64,
                                       device=x.device) / hd)
    ang = pos.double()[:, None] * inv
    ang = torch.cat([ang, ang], -1)
    cos, sin = ang.cos().float(), ang.sin().float()
    x1, x2 = x.chunk(2, -1)
    return x * cos + torch.cat([-x2, x1], -1) * sin


class LM:
    """``head`` = (context_length, segment_length, tokenizer dims)."""

    def __init__(self, weights: W, config: dict, head, prec: Precision):
        self.w, self.c, self.p = weights, config, prec
        self.ctx, self.seg, self.dims = head

    def embed(self, ids, action=None):
        x = self.w["llm.model.embed_tokens.weight"][ids]
        if action is not None:
            pos = sdf_positions(self.ctx, self.seg - self.ctx,
                                self.dims).to(ids.device)
            a = self.p.linear(action[:, self.ctx - 1:-1],
                              self.w["action_linear.weight"],
                              self.w["action_linear.bias"])
            x = x.index_add(1, pos, a)
        return x

    def forward(self, ids, action=None, dropout=None, b0: int = 0):
        """Logits [B, S, V] fp32 of a stream; ``dropout`` = (p, seed, step)
        drops with the masks of global rows b0 on."""
        c, w, P = self.c, self.w, self.p
        B, S = ids.shape
        H = c["num_attention_heads"]
        Hkv = c["num_key_value_heads"]
        hd = c["hidden_size"] // H
        eps = c["rms_norm_eps"]
        pos = torch.arange(S, device=ids.device)
        causal = pos[None, :] > pos[:, None]
        x = self.embed(ids, action)
        for i in range(c["num_hidden_layers"]):
            p = f"llm.model.layers.{i}."
            h = _rms(x, w[p + "input_layernorm.weight"], eps)

            def proj(name, n):
                y = P.linear(h, w[p + "self_attn." + name + ".weight"])
                return y.view(B, S, n, hd).transpose(1, 2)

            q = _rope(proj("q_proj", H), pos, c["rope_theta"])
            k = _rope(proj("k_proj", Hkv), pos, c["rope_theta"])
            v = proj("v_proj", Hkv)
            if Hkv != H:
                k = k.repeat_interleave(H // Hkv, 1)
                v = v.repeat_interleave(H // Hkv, 1)
            s = P.matmul(q, k.transpose(-1, -2)) * hd ** -0.5
            a = torch.softmax(s.masked_fill(causal, float("-inf")), -1)
            if dropout is not None:
                p_, seed, step = dropout
                a = a * philox.keep_scale(p_, seed,
                                          philox.layer_offset(step, i), b0,
                                          B, H, S, ids.device)
            o = P.matmul(a, v).transpose(1, 2).reshape(B, S, H * hd)
            x = x + P.linear(o, w[p + "self_attn.o_proj.weight"])
            h = _rms(x, w[p + "post_attention_layernorm.weight"], eps)
            g = F.silu(P.linear(h, w[p + "mlp.gate_proj.weight"]))
            u = P.linear(h, w[p + "mlp.up_proj.weight"])
            x = x + P.linear(g * u, w[p + "mlp.down_proj.weight"])
        x = _rms(x, w["llm.model.norm.weight"], eps)
        head = w.get("llm.lm_head.weight", w["llm.model.embed_tokens.weight"])
        return P.linear(x, head)


def loss_sum(logits, labels):
    """Sum over labelled positions of the next-token cross-entropy, and the
    count of labelled positions."""
    t = labels[:, 1:]
    ok = t != IGNORE
    logp = torch.log_softmax(logits[:, :-1], -1)
    nll = -logp.gather(-1, t.clamp_min(0)[..., None])[..., 0]
    return (nll * ok).sum(), ok.sum()


def loss_and_grads(lm: LM, ids, labels, action, dropout, rows: int,
                   params: Dict[str, torch.Tensor]):
    """The batch's mean loss and its gradient in every tensor of
    ``params`` (name -> leaf with requires_grad), summed over blocks of
    ``rows`` rows, each block's loss weighted by its share of the labelled
    tokens."""
    count = int((labels[:, 1:] != IGNORE).sum())
    total = 0.0
    for r0 in range(0, ids.shape[0], rows):
        sl = slice(r0, r0 + rows)
        logits = lm.forward(ids[sl], None if action is None else action[sl],
                            dropout, r0)
        s, _ = loss_sum(logits, labels[sl])
        (s / count).backward()
        total += float(s.detach())
        del logits, s
    grads = {n: (t.grad if t.grad is not None else torch.zeros_like(t))
             for n, t in params.items()}
    for t in params.values():
        t.grad = None
    return total / count, grads
