"""The yardstick's counts: the H100's published peaks, the bytes and
operations K3 (decode attention) and K4-K6 (causal flash attention, forward,
dK/dV and dQ) need for a call, and the model FLOPs of the tokenizer and the
LM at a cell's shapes.

Every count comes from the configuration and the shapes, never from what
a kernel does: each input byte is read once and each output byte written
once, causal attention counts the keys at or before each query, and the
model FLOPs are those of the products (matrix multiplications and
convolutions; two FLOPs a multiply-add). The tokenizer's are counted by
running the plain reference on ``meta`` tensors under
``torch.utils.flop_counter.FlopCounterMode``.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from benchmark.reference.numerics import Precision
from benchmark.reference.params import tok_dims
from benchmark.reference.stream import prelude_len

# NVIDIA H100 SXM data sheet, dense rates (no sparsity), at 700 W
BF16_PEAK = 989e12     # FLOP/s on the tensor cores
FP32_PEAK = 67e12      # FLOP/s outside the tensor cores
HBM_RATE = 3.35e12     # bytes/s


def bound_s(nbytes: float, flops: float, peak: float = BF16_PEAK) -> float:
    """The least time of a call: the larger of its bytes over the memory's
    rate and its operations over the peak."""
    return max(nbytes / HBM_RATE, flops / peak)


# -- K3: one-token attention over the int8 KV cache ------------------------

def k3_call(B: int, H: int, Hkv: int, hd: int, valid: int
            ) -> Tuple[float, float]:
    """(bytes, FLOP) of one K3 call: the live int8 K and V with their bf16
    scales read once, the bf16 query read and the output written once; q.K
    and P.V, 2 FLOP a cached value each."""
    nbytes = B * valid * Hkv * (2 * hd + 2 * 2) + 2 * B * H * hd * 2
    return nbytes, 4.0 * B * H * valid * hd


def decode_valid_lengths(ctx: int, segment: int, dims: dict) -> List[int]:
    """The cache length each one-token decode step of a rollout attends
    over: an sdf step opening every frame but the first (the prefill
    writes the first), then one step a sampled token but the last."""
    D = dims["dyn_tokens"]
    p1 = prelude_len(ctx, dims) + 1
    out = []
    F_ = segment - ctx
    for f in range(F_):
        s0 = p1 + f * (D + 1)
        if f:
            out.append(s0)
        for j in range(D):
            if f == F_ - 1 and j == D - 1:
                break
            out.append(s0 + j + 1)
    return out


def k3_rollout_bound_s(cfg: dict, B: int) -> float:
    """Σ over a rollout's K3 calls (every decode step, every layer) of the
    bound."""
    m = cfg["transformer"]
    H, Hkv = m["num_attention_heads"], m["num_key_value_heads"]
    hd = m["hidden_size"] // H
    dims = tok_dims(cfg["tokenizer"])
    per_layer = sum(bound_s(*k3_call(B, H, Hkv, hd, v))
                    for v in decode_valid_lengths(cfg["context_length"],
                                                  cfg["segment_length"], dims))
    return per_layer * m["num_hidden_layers"]


# -- K4, K5, K6: causal attention of a training step -----------------------

def causal_pairs(S: int) -> int:
    """(query, key) pairs with key <= query."""
    return S * (S + 1) // 2


def flash_calls(B: int, S: int, H: int, hd: int, io_bytes: int = 2
                ) -> Dict[str, Tuple[float, float]]:
    """(bytes, FLOP) of K4 (O and the row lse from q, k, v), K5 (dK, dV
    from q, k, v, dO, lse and di) and K6 (dQ from the same) at one layer.
    Products over the causal pairs: K4 two (QK^T, PV), K5 four (QK^T,
    dO V^T, P^T dO, dS^T Q), K6 three (QK^T, dO V^T, dS K)."""
    t = B * S * H * hd * io_bytes       # one of q, k, v, o, dO, dq, dk, dv
    row = B * H * S * 4                 # lse or di, fp32
    mm = 2.0 * B * H * hd * causal_pairs(S)
    return {"fwd": (4 * t + row, 2 * mm),
            "bwd_dkv": (6 * t + 2 * row, 4 * mm),
            "bwd_dq": (5 * t + 2 * row, 3 * mm)}


def flash_step_bound_s(cfg: dict, B: int, S: int) -> float:
    """Σ over a training step's K4, K5 and K6 calls (one of each a layer)
    of the bound, bf16 inputs."""
    m = cfg["transformer"]
    H = m["num_attention_heads"]
    calls = flash_calls(B, S, H, m["hidden_size"] // H)
    return m["num_hidden_layers"] * sum(bound_s(b, f)
                                        for b, f in calls.values())


# -- model FLOPs -----------------------------------------------------------

def lm_matmul_params(m: dict) -> int:
    """Weights a token's hidden state is multiplied by, the unembedding
    apart."""
    h, f = m["hidden_size"], m["intermediate_size"]
    kv = m["num_key_value_heads"] * (h // m["num_attention_heads"])
    return m["num_hidden_layers"] * (2 * h * h + 2 * h * kv + 3 * h * f)


def lm_forward_flops(m: dict, B: int, S: int, unembedded: int) -> float:
    """A causal forward over B rows of S fresh tokens, ``unembedded``
    positions a row through the LM head."""
    h = m["hidden_size"]
    att = 4.0 * h * causal_pairs(S) * m["num_hidden_layers"]
    return B * (2.0 * lm_matmul_params(m) * S + att
                + 2.0 * h * m["vocab_size"] * unembedded)


def lm_decode_flops(m: dict, B: int, valid: int, unembed: bool) -> float:
    """One cached decode step of one token attending over ``valid``
    slots."""
    h = m["hidden_size"]
    att = 4.0 * h * valid * m["num_hidden_layers"]
    return B * (2.0 * lm_matmul_params(m) + att
                + (2.0 * h * m["vocab_size"] if unembed else 0.0))


def _counted(fn) -> float:
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as counter:
        fn()
    return float(counter.get_total_flops())


def _meta_tokenizer(t: dict):
    from benchmark.reference.params import tokenizer_spec
    from benchmark.reference.tokenizer import Tokenizer
    w = {n: torch.empty(s, device="meta")
         for n, (s, _, _) in tokenizer_spec(t).items()}
    return Tokenizer(w, t, Precision("fp32"))


def encode_context_flops(t: dict, frames: int) -> float:
    """The context encoder and quant_conv over ``frames`` frames (the VQ
    distances apart: :func:`vq_flops`)."""
    tok = _meta_tokenizer(t)
    r = t["resolution"]
    x = torch.empty(frames, r, r, t["in_channels"], device="meta")
    return _counted(lambda: tok.context_latents(x))


def encode_dynamics_flops(t: dict, B: int, ctx: int, future: int) -> float:
    """The conditional encoder and quant_linear over B x ``future`` frames
    (the context features it reads are :func:`encode_context_flops`')."""
    tok = _meta_tokenizer(t)
    r = t["resolution"]
    _, feats = tok.encoder(torch.empty(B * ctx, t["in_channels"], r, r,
                                       device="meta"))
    x = torch.empty(B * future, r, r, t["in_channels"], device="meta")
    return _counted(lambda: tok.dynamics_latents(x, feats, ctx))


def render_flops(t: dict, B: int, ctx: int, future: int) -> float:
    """Detokenizing B streams: both decoders."""
    tok = _meta_tokenizer(t)
    d = tok_dims(t)
    c = torch.zeros(B, ctx, d["ctx_tokens"], dtype=torch.long, device="meta")
    f = torch.zeros(B, future, d["dyn_tokens"], dtype=torch.long,
                    device="meta")
    return _counted(lambda: tok.render(c, f))


def vq_flops(t: dict, n_ctx: int, n_dyn: int) -> float:
    """Distances of n_ctx and n_dyn vectors to every code of their
    codebooks."""
    d = tok_dims(t)["embed_dim"]
    return 2.0 * d * (n_ctx * t["num_vq_embeddings"]
                      + n_dyn * t["num_dyn_embeddings"])


def rollout_flop_seconds(cfg: dict, B: int) -> float:
    """The least time a rollout's model FLOPs take, each part at its
    precision's peak: the bf16 encoder, LM and render at the bf16 rate,
    the fp32 VQ distances at the fp32 rate."""
    t, m = cfg["tokenizer"], cfg["transformer"]
    ctx, seg = cfg["context_length"], cfg["segment_length"]
    dims = tok_dims(t)
    F_ = seg - ctx
    p1 = prelude_len(ctx, dims) + 1
    bf16 = encode_context_flops(t, B * ctx)
    bf16 += lm_forward_flops(m, B, p1, 1)
    lens = decode_valid_lengths(ctx, seg, dims)
    # a frame's last token is followed by a forced sdf: its decode is
    # not unembedded
    last = {p1 + f * (dims["dyn_tokens"] + 1) - 1 for f in range(1, F_)}
    bf16 += sum(lm_decode_flops(m, B, v, v not in last) for v in lens)
    bf16 += render_flops(t, B, ctx, F_)
    fp32 = vq_flops(t, B * ctx * dims["ctx_tokens"], 0)
    return bf16 / BF16_PEAK + fp32 / FP32_PEAK


def train_step_flop_seconds(cfg: dict, B: int) -> float:
    """The least time a training step's model FLOPs take: the frozen fp32
    tokenize (encoders and VQ distances, TF32 off) at the fp32 rate, the
    LM's forward and backward (3 forwards, causal attention, every
    position through the head) at the bf16 rate."""
    t, m = cfg["tokenizer"], cfg["transformer"]
    ctx, seg = cfg["context_length"], cfg["segment_length"]
    dims = tok_dims(t)
    F_ = seg - ctx
    S = prelude_len(ctx, dims) + F_ * (dims["dyn_tokens"] + 1)
    fp32 = encode_context_flops(t, B * ctx)
    fp32 += encode_dynamics_flops(t, B, ctx, F_)
    fp32 += vq_flops(t, B * ctx * dims["ctx_tokens"],
                     B * F_ * dims["dyn_tokens"])
    bf16 = 3.0 * lm_forward_flops(m, B, S, S)
    return fp32 / FP32_PEAK + bf16 / BF16_PEAK
