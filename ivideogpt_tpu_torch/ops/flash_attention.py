"""Causal attention over fresh q/k/v: kernels K4 (forward), K5 (dK, dV) and
K6 (dQ), bf16 in ``csrc/flash_attention_sm90.cu`` and fp32 in
``csrc/flash_attention_tf32.cu``, and their plain PyTorch versions.

One function serves the KV-cached prefill and the training forward:

    q, k, v [B, S, H, hd] (RoPE applied, the port's bshd layout)
    out [B, S, H*hd] = softmax(q k^T * hd^-0.5, keys j <= query i) v

The kernels replace the stock TPU flash-attention kernel that
``ivideogpt_tpu/models/llama.py:97`` calls (its forward, dK/dV and dQ
``pallas_call``s); ``causal_attention_plain`` is the port of the chunked
``_prefill_causal_attention`` (``llama.py:63``), the JAX package's default.
On CPU tensors :func:`causal_attention` is the plain version and its
gradient comes from autograd; on CUDA tensors it is a
``torch.autograd.Function`` whose forward launches K4 and whose backward
computes di = rowsum(O * dO) in plain torch, as the TPU code does in XLA,
then launches K5 and K6.

The kernels keep the scores, the softmax and every sum in fp32, as the TPU
kernel does; on bf16 inputs they run on tensor cores and, like the TPU
kernel, round P and dS to bf16 before multiplying them. On fp32 inputs
nothing is rounded to bf16: the fp32 kernels run each product on the
tensor cores as three TF32 products (hi * hi + hi * lo + lo * hi, hi + lo
holding each operand to 2^-22 of its value), which stays within the fp32
tolerances. The plain version rounds the scores and P to bf16 on a bf16
input (``einsum`` of bf16 operands returns bf16), so in bf16 the two agree
to bf16 rounding, and in fp32 to fp32 rounding. All six kernels read q, k
and v by TMA, so :func:`flash_fwd` and the backward refuse a view whose
base or strides are not whole 16 bytes.

``flash_fwd_plain``, ``flash_bwd_dkv_plain`` and ``flash_bwd_dq_plain``
compute what each kernel computes, at its own interface (lse and di in,
lse out, natural log), in fp32 whatever the input type; the tests and
``chip_smoke.py`` hold the kernels against them.

Attention dropout (``dropout=(p, seed, offset)``, the training forward of
the published recipes): the probabilities P are multiplied by Z / keep,
keep = 1 - p, with Z the Philox mask of ``ops/philox.py`` (the kernels draw
the same bits from ``csrc/philox.cuh``). As in the JAX package's
``nn.Dropout`` after the fp32 softmax, the row max and lse come from the
undropped P, O = (P Z / keep) V, and the backward takes
dV = (P Z / keep)^T dO and dS = P (dP Z / keep - di), di = rowsum(dO O) on
the dropped O. K4 applies the mask to its fp32 P before rounding or
splitting it for the P V product; K5 and K6 regenerate the same mask, each
kernel drawing a 64 x 64 tile's bits once. Every plain version draws
its chunk's part of the mask by index, so its chunk size does not change
the mask. p = 0 (or None) launches the kernels without dropout, bit-equal to
a launch that never heard of it.

A shard (``dropout=(p, seed, offset, b0, h0, Hg)``, ``ops/philox.py``): a
data- or tensor-parallel rank's call over its B rows from global row b0
and its H heads from global head h0 of Hg draws the global rows' bits, so
the concatenated shards' outputs equal one launch over the whole batch.
Each kernel maps its CTA's local head to the global one once, before its
loop; the plain versions take the same shard.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from ivideogpt_tpu_torch import _build
from ivideogpt_tpu_torch.ops import philox
from ivideogpt_tpu_torch.ops.philox import Dropout

HEAD_DIM = 64
MAX_SEQ = 1024


def _keep(dropout, q, q0, cs, nk):
    """Z / keep [B, H, cs, nk] fp32 of queries q0 .. q0+cs-1 and keys
    0 .. nk-1, or None without dropout."""
    if dropout is None or dropout[0] == 0:
        return None
    B, S, H, _ = q.shape
    z = philox.keep_mask(dropout, B, H, S, q0, cs, 0, nk, device=q.device)
    return z.float() / (1.0 - dropout[0])


def causal_attention_plain(q, k, v, dtype, chunk: int = 128,
                           dropout: Optional[Dropout] = None):
    """Causal attention over fresh q/k/v [B, S, H, hd], in query chunks: the
    chunk at q0 attends keys [0, q0 + cs) only, and the fp32 score temp is
    [B, H, chunk, S] rather than [B, H, S, S]. With ``dropout``, the fp32
    probabilities are masked and scaled before the cast to ``dtype``, as the
    JAX package's ``nn.Dropout`` does (``llama.py:339``)."""
    dropout = philox.check_dropout(dropout)
    B, S, H, hd = q.shape
    outs = []
    for q0 in range(0, S, chunk):
        cs = min(chunk, S - q0)
        kb, vb = k[:, :q0 + cs], v[:, :q0 + cs]
        attn = torch.einsum("bqhd,bkhd->bhqk", q[:, q0:q0 + cs], kb).float()
        attn = attn * (hd ** -0.5)
        kpos = torch.arange(q0 + cs, device=q.device)[None, :]
        qpos = (q0 + torch.arange(cs, device=q.device))[:, None]
        attn = attn.masked_fill(kpos > qpos, torch.finfo(torch.float32).min)
        attn = torch.softmax(attn, dim=-1)
        z = _keep(dropout, q, q0, cs, q0 + cs)
        if z is not None:
            attn = attn * z
        outs.append(torch.einsum("bhqk,bkhd->bqhd", attn.to(dtype), vb))
    return torch.cat(outs, dim=1).reshape(B, S, H * hd)


def _chunks(q, k, chunk=128):
    """(q0, cs, scores [B, H, cs, q0 + cs] fp32 * hd^-0.5, causal mask) by
    query chunk: a chunk's scores reach only the keys it may attend."""
    B, S, H, hd = q.shape
    qf, kf = q.float(), k.float()
    for q0 in range(0, S, chunk):
        cs = min(chunk, S - q0)
        s = torch.einsum("bqhd,bkhd->bhqk", qf[:, q0:q0 + cs],
                         kf[:, :q0 + cs]) * (hd ** -0.5)
        live = (torch.arange(q0 + cs, device=q.device)[None, :]
                <= (q0 + torch.arange(cs, device=q.device))[:, None])
        yield q0, cs, s, live


def flash_fwd_plain(q, k, v, dropout: Optional[Dropout] = None,
                    chunk: int = 128):
    """K4's function: (O [B, S, H, hd] in q's dtype, lse [B, H, S] fp32,
    the natural log of each row's sum of exp(scores), of the undropped
    probabilities), in fp32."""
    dropout = philox.check_dropout(dropout)
    o, lse = torch.empty(q.shape, dtype=q.dtype, device=q.device), []
    vf = v.float()
    for q0, cs, s, live in _chunks(q, k, chunk):
        s = s.masked_fill(~live, float("-inf"))
        lse.append(torch.logsumexp(s, dim=-1))
        p = torch.exp(s - lse[-1][..., None])
        z = _keep(dropout, q, q0, cs, q0 + cs)
        if z is not None:
            p = p * z
        o[:, q0:q0 + cs] = torch.einsum("bhqk,bkhd->bqhd", p,
                                        vf[:, :q0 + cs]).to(q.dtype)
    return o, torch.cat(lse, dim=-1)


def _plain_p_ds(s, live, q0, cs, q, v, do, lse, di, dropout):
    """(P Z / keep, dS = P (dO V^T Z / keep - di)) of one query chunk,
    P = exp(s - lse); Z / keep = 1 without dropout."""
    p = torch.exp(s - lse[:, :, q0:q0 + cs, None]) * live
    dp = torch.einsum("bqhd,bkhd->bhqk", do[:, q0:q0 + cs].float(),
                      v[:, :q0 + cs].float())
    z = _keep(dropout, q, q0, cs, q0 + cs)
    if z is None:
        return p, p * (dp - di[:, :, q0:q0 + cs, None])
    return p * z, p * (dp * z - di[:, :, q0:q0 + cs, None])


def flash_bwd_dkv_plain(q, k, v, do, lse, di,
                        dropout: Optional[Dropout] = None, chunk: int = 128):
    """K5's function: (dK, dV) [B, S, H, hd] in q's dtype from lse and di
    [B, H, S] fp32, in fp32."""
    dropout = philox.check_dropout(dropout)
    dk = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    for q0, cs, s, live in _chunks(q, k, chunk):
        p, ds = _plain_p_ds(s, live, q0, cs, q, v, do, lse, di, dropout)
        dv[:, :q0 + cs] += torch.einsum("bhqk,bqhd->bkhd", p,
                                        do[:, q0:q0 + cs].float())
        dk[:, :q0 + cs] += torch.einsum("bhqk,bqhd->bkhd", ds,
                                        q[:, q0:q0 + cs].float())
    return (dk * q.shape[-1] ** -0.5).to(q.dtype), dv.to(q.dtype)


def flash_bwd_dq_plain(q, k, v, do, lse, di,
                       dropout: Optional[Dropout] = None, chunk: int = 128):
    """K6's function: dQ [B, S, H, hd] in q's dtype, in fp32."""
    dropout = philox.check_dropout(dropout)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    for q0, cs, s, live in _chunks(q, k, chunk):
        _, ds = _plain_p_ds(s, live, q0, cs, q, v, do, lse, di, dropout)
        dq[:, q0:q0 + cs] = (torch.einsum("bhqk,bkhd->bqhd", ds,
                                          k[:, :q0 + cs].float())
                             * q.shape[-1] ** -0.5).to(q.dtype)
    return dq


def causal_attention(q, k, v, dtype, dropout: Optional[Dropout] = None):
    """q/k/v [B, S, H, hd] -> [B, S, H*hd] in ``dtype``; ``dropout`` is
    (p, seed, offset[, b0, h0, Hg]) or None.

    On CPU tensors this is :func:`causal_attention_plain` with the Philox
    mask; otherwise it runs K4 forward and K5/K6 backward with the same
    mask, or raises (``_check``)."""
    dropout = philox.check_dropout(dropout)
    if all(t.device.type == "cpu" for t in (q, k, v)):
        return causal_attention_plain(q, k, v, dtype, dropout=dropout)
    B, S, H, hd = q.shape
    return _CausalFlash.apply(q, k, v, dropout).view(B, S, H * hd).to(dtype)


class _CausalFlash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, dropout):
        # flash_fwd refuses, before its launch, what no kernel reads
        o, lse = flash_fwd(q, k, v, dropout)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.dropout = dropout
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()
        # di on the dropped O: rowsum(dO O) = rowsum(P (dP Z / keep))
        di = (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous()
        dk, dv = flash_bwd_dkv(q, k, v, do, lse, di, ctx.dropout)
        return flash_bwd_dq(q, k, v, do, lse, di, ctx.dropout), dk, dv, None


def _check(q, k, v):
    """Refuse what the kernels do not take; returns (B, S, H)."""
    ts = (q, k, v)
    if q.device.type != "cuda" or any(t.device != q.device for t in ts):
        raise ValueError(
            f"causal_attention: q on {q.device}, k on {k.device}, v on "
            f"{v.device}; all must be on one CUDA device")
    if q.ndim != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"causal_attention: shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)} are not one "
                         f"[B, S, H, hd]")
    B, S, H, hd = q.shape
    if hd != HEAD_DIM:
        raise ValueError(f"causal_attention: the kernels take hd={HEAD_DIM}, "
                         f"got {hd}")
    if not 1 <= S <= MAX_SEQ:
        raise ValueError(f"causal_attention: S={S} outside [1, {MAX_SEQ}]")
    if (q.dtype not in (torch.bfloat16, torch.float32)
            or any(t.dtype != q.dtype for t in ts)):
        raise ValueError("causal_attention: q, k, v must all be bf16 or all "
                         "fp32")
    if any(t.stride(-1) != 1 for t in ts):
        raise ValueError("causal_attention: the head dim must be contiguous")
    if not all(_aligned(t) for t in ts):
        raise ValueError("causal_attention: q, k and v must be 16-byte "
                         "aligned, with strides in multiples of 16 bytes")
    return B, S, H


def _aligned(t):
    """TMA reads a tensor only from a 16-byte aligned base through strides
    of whole 16-byte units (8 bf16 or 4 fp32 elements)."""
    return t.data_ptr() % 16 == 0 and all(
        t.stride(i) * t.element_size() % 16 == 0 for i in range(3))


def _strides(*ts):
    return [s for t in ts for s in (t.stride(0), t.stride(1), t.stride(2))]


def _drop_args(dropout, B, H):
    """The kernels' (p_drop, seed, offset, b0, h0, Hg) arguments for a call
    over B rows and H heads; p_drop 0 launches the kernels without
    dropout."""
    dropout = philox.check_dropout(dropout)
    shard = philox.shard_of(dropout, B, H)
    return ((0.0, 0, 0) if dropout is None else dropout[:3]) + shard


def _launch(fn, name, *args):
    err = fn(*args)
    if err:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


def flash_fwd(q, k, v, dropout: Optional[Dropout] = None):
    """K4: (O [B, S, H, hd] in q's dtype, lse [B, H, S] fp32)."""
    B, S, H = _check(q, k, v)
    o = torch.empty((B, S, H, HEAD_DIM), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    _launch(_entry("fwd", q.dtype), "flash_fwd", q.data_ptr(), k.data_ptr(),
            v.data_ptr(), o.data_ptr(), lse.data_ptr(), B, S, H, HEAD_DIM,
            *_strides(q, k, v), *_drop_args(dropout, B, H),
            torch.cuda.current_stream(q.device).cuda_stream)
    flash_fwd.launches += 1
    return o, lse


def _check_bwd(q, k, v, do, lse, di):
    B, S, H = _check(q, k, v)
    if (do.shape != q.shape or do.dtype != q.dtype or do.device != q.device
            or not do.is_contiguous() or not _aligned(do)):
        raise ValueError("flash backward: dO must be contiguous, 16-byte "
                         "aligned, of q's shape, dtype and device")
    for name, t in (("lse", lse), ("di", di)):
        if (t.shape != (B, H, S) or t.dtype != torch.float32
                or t.device != q.device or not t.is_contiguous()):
            raise ValueError(f"flash backward: {name} must be contiguous "
                             f"fp32 [B, H, S] on q's device")
    return B, S, H


def flash_bwd_dkv(q, k, v, do, lse, di, dropout: Optional[Dropout] = None):
    """K5: (dK, dV), contiguous [B, S, H, hd] in q's dtype."""
    B, S, H = _check_bwd(q, k, v, do, lse, di)
    dk = torch.empty((B, S, H, HEAD_DIM), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    _launch(_entry("bwd_dkv", q.dtype), "flash_bwd_dkv", q.data_ptr(),
            k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            di.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, S, H, HEAD_DIM,
            *_strides(q, k, v), *_drop_args(dropout, B, H),
            torch.cuda.current_stream(q.device).cuda_stream)
    flash_bwd_dkv.launches += 1
    return dk, dv


def flash_bwd_dq(q, k, v, do, lse, di, dropout: Optional[Dropout] = None):
    """K6: dQ, contiguous [B, S, H, hd] in q's dtype."""
    B, S, H = _check_bwd(q, k, v, do, lse, di)
    dq = torch.empty((B, S, H, HEAD_DIM), dtype=q.dtype, device=q.device)
    _launch(_entry("bwd_dq", q.dtype), "flash_bwd_dq", q.data_ptr(),
            k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            di.data_ptr(), dq.data_ptr(), B, S, H, HEAD_DIM,
            *_strides(q, k, v), *_drop_args(dropout, B, H),
            torch.cuda.current_stream(q.device).cuda_stream)
    flash_bwd_dq.launches += 1
    return dq


flash_fwd.launches = 0
flash_bwd_dkv.launches = 0
flash_bwd_dq.launches = 0


def _library(kernel, dtype):
    """(library, C symbol) of kernel "fwd", "bwd_dkv" or "bwd_dq" for
    ``dtype`` inputs: bf16 in ``csrc/flash_attention_sm90.cu`` (TMA +
    ``wgmma``), fp32 in ``csrc/flash_attention_tf32.cu`` (TMA + three-term
    TF32 ``wgmma``)."""
    if dtype == torch.bfloat16:
        return "flash_attention_sm90", f"ivg_flash_{kernel}_bf16"
    return "flash_attention_tf32", f"ivg_flash_{kernel}_fp32"


@functools.lru_cache(maxsize=None)
def _entry(kernel, dtype):
    """The C entry point of :func:`_library`, its argument types set:
    pointers, B, S, H, hd, 9 strides, p_drop, seed, offset, the shard's
    b0, h0 and Hg, stream."""
    lib, sym = _library(kernel, dtype)
    fn = getattr(_build.load(lib), sym)
    p, i = ctypes.c_void_p, ctypes.c_int
    n_ptrs = {"fwd": 5, "bwd_dkv": 8, "bwd_dq": 7}[kernel]
    fn.argtypes = ([p] * n_ptrs + [i] * 4 + [ctypes.c_int64] * 9
                   + [ctypes.c_double, ctypes.c_uint64, ctypes.c_uint64]
                   + [i] * 3 + [p])
    fn.restype = ctypes.c_int
    return fn
