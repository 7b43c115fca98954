"""Single-token attention over the int8 KV cache: kernel K3
(``csrc/decode_attention.cu``) and its plain PyTorch version.

Every generated token re-reads the whole cache once per layer, so this is
the decode hot op. Layout is the port's default ``bshd`` cache:

    q [B, H, hd] (RoPE applied), k/v [B, M, H, hd] int8,
    ks/vs [B, M, H] bf16 per-(slot, head) scales, valid = live slots.

    out = softmax((q . K) * ks * hd^-0.5 over slots < valid) . (vs * V)

K3 replaces the TPU kernel
``ivideogpt_tpu/ops/decode_attention.py::_decode_attn_kernel``, which served
the TPU-only transposed ``[B*H, hd, M]`` layout. It is memory-bound on the
H100 (it reads the live int8 cache and scales once); see the source for
its design.
"""

from __future__ import annotations

import ctypes

import torch

from ivideogpt_tpu_torch import _build


def decode_attention_plain(q, k_cache, ks, v_cache, vs, valid: int):
    """Plain version of :func:`decode_attention` in fp32 (the math of
    ``decode_attention_xla``), returning q's dtype."""
    qf = q.float()
    k = k_cache[:, :valid].float()                     # [B, m, H, hd]
    s = torch.einsum("bhd,bmhd->bhm", qf, k)
    s = s * ks[:, :valid].float().transpose(1, 2) * (q.shape[-1] ** -0.5)
    p = torch.softmax(s, dim=-1)
    pv = p * vs[:, :valid].float().transpose(1, 2)    # [B, H, m]
    out = torch.einsum("bhm,bmhd->bhd", pv, v_cache[:, :valid].float())
    return out.to(q.dtype)


def decode_attention(q, k_cache, ks, v_cache, vs, valid: int):
    """One decode step of attention over the int8 ``bshd`` cache.

    On CPU tensors this is :func:`decode_attention_plain`; on CUDA tensors
    it launches K3 or raises."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, ks, v_cache, vs, valid)
    B, H, hd = q.shape
    M = k_cache.shape[1]
    tensors = (q, k_cache, ks, v_cache, vs)
    if any(t.device != q.device for t in tensors) or q.device.type != "cuda":
        raise ValueError("decode_attention: all inputs must be on one CUDA "
                         "device")
    if (k_cache.shape != (B, M, H, hd) or v_cache.shape != (B, M, H, hd)
            or ks.shape != (B, M, H) or vs.shape != (B, M, H)):
        raise ValueError(
            f"decode_attention: shapes q {tuple(q.shape)}, k "
            f"{tuple(k_cache.shape)}, ks {tuple(ks.shape)}, v "
            f"{tuple(v_cache.shape)}, vs {tuple(vs.shape)} do not match")
    if (k_cache.dtype != torch.int8 or v_cache.dtype != torch.int8
            or ks.dtype != torch.bfloat16 or vs.dtype != torch.bfloat16
            or q.dtype not in (torch.bfloat16, torch.float32)):
        raise ValueError("decode_attention: takes int8 k/v, bf16 scales and "
                         "a bf16 or fp32 query")
    if hd != 64:
        raise ValueError(f"decode_attention: the kernel takes hd=64, got {hd}")
    if not 1 <= valid <= M:
        raise ValueError(f"decode_attention: valid={valid} outside [1, {M}]")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0
               for t in tensors):
        raise ValueError("decode_attention: inputs must be contiguous and "
                         "16-byte aligned")
    out = torch.empty_like(q)
    lib = _attn_lib()
    err = lib.ivg_decode_attention(
        q.data_ptr(), k_cache.data_ptr(), ks.data_ptr(), v_cache.data_ptr(),
        vs.data_ptr(), out.data_ptr(), B, M, H, hd, int(valid),
        int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(
            f"decode_attention kernel launch failed: cudaError {err}")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0


def _attn_lib() -> ctypes.CDLL:
    lib = _build.load("decode_attention")
    fn = lib.ivg_decode_attention
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib
