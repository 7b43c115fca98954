"""Single-token attention over the int8 KV cache: kernel K3
(``csrc/decode_attention.cu``), its plain PyTorch version, and a plain
version of the kernel's split-then-merge algorithm.

Every generated token re-reads the whole cache once per layer, so this is
the decode hot op. Layout is the port's default ``bshd`` cache:

    q [B, H, hd] (RoPE applied), k/v [B, M, H, hd] int8,
    ks/vs [B, M, H] bf16 per-(slot, head) scales, valid = live slots.

    out = softmax((q . K) * ks * hd^-0.5 over slots < valid) . (vs * V)

K3 replaces the TPU kernel
``ivideogpt_tpu/ops/decode_attention.py::_decode_attn_kernel``, which served
the TPU-only transposed ``[B*H, hd, M]`` layout. It is memory-bound on the
H100: it reads the live int8 cache and its scales once. A block holds one
batch row's heads and walks one split of its slots. The split count
comes from :func:`decode_splits`, one block an SM: 4 splits at the MBRL
rollout's B=32 and 1 at the main rollout's B=256. The splits run side by
side and merge inside the one launch: the last block of a row to finish
folds the splits' partial softmax states together in split order, so two
launches give the same bits. :func:`decode_attention_split_plain` is that
algorithm in plain PyTorch.

``valid`` is a host int or a one-element int32 tensor on the card. A
CUDA graph of the call can change the tensor between replays, because the
launch depends on B, H and M only. See the source for the design.

Two variants of K3 serve the JAX package's other caches (the source's
``kKInt8`` instances and its ``Hkv`` argument):
- grouped KV heads: k/v [B, M, Hkv, hd] and scales [B, M, Hkv] with H a
  multiple of Hkv; query head h reads KV head h // (H / Hkv);
- the ``"mixed"`` cache: k bf16 and ``ks`` None, the scores q . K in fp32
  without a K scale; v int8 with ``vs`` as before.
Each wrapper call counts one launch on the variant it launched:
``decode_attention.launches`` (int8 K, one KV head a query head, the
rollout's), ``decode_attention.grouped_launches`` (int8 K over fewer KV
heads) or ``decode_attention.mixed_launches`` (bf16 K, any KV heads).
A launch inside a CUDA graph's capture runs nothing and is not counted;
inside :func:`capture_launches` the capture's launches are recorded
instead, and :func:`count_replay` counts them for each replay, so the
counters read what the card ran.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import functools
import math
import threading

import torch

from ivideogpt_tpu_torch import _build
from ivideogpt_tpu_torch.ops.vq import _sms

K3_SPLIT_SLOTS = 16    # splits are whole runs of this many slots
K3_MAX_HEADS = 12      # heads a block; more go to head groups (kMaxHeads)
K3_PARTIAL = 66        # floats of a split's state a head: max, sum, 64 sums
H100_SMS = 132


def _heads(x: torch.Tensor, h: int) -> torch.Tensor:
    """[B, m, Hkv, ...] fp32 -> [B, m, h, ...], KV head g serving query
    heads g * rep .. (g + 1) * rep - 1."""
    return x.float().repeat_interleave(h // x.shape[2], dim=2)


def _scores(qf, k, ks, lo: int, hi: int):
    """fp32 q . K over slots [lo, hi), times ks where K is int8 (``ks``
    None: the mixed cache's bf16 K), [B, H, hi - lo]."""
    H = qf.shape[1]
    s = torch.einsum("bhd,bmhd->bhm", qf, _heads(k[:, lo:hi], H))
    if ks is not None:
        s = s * _heads(ks[:, lo:hi], H).transpose(1, 2)
    return s


def _values(p, vs, v, lo: int, hi: int):
    """sum over slots [lo, hi) of p * vs * V in fp32, [B, H, hd]."""
    H = p.shape[1]
    pv = p * _heads(vs[:, lo:hi], H).transpose(1, 2)
    return torch.einsum("bhm,bmhd->bhd", pv, _heads(v[:, lo:hi], H))


def decode_attention_plain(q, k_cache, ks, v_cache, vs, valid):
    """Plain version of :func:`decode_attention` in fp32 (the math of
    ``decode_attention_xla``), both variants, returning q's dtype."""
    valid = _host_valid(valid)
    s = _scores(q.float(), k_cache, ks, 0, valid) * (q.shape[-1] ** -0.5)
    p = torch.softmax(s, dim=-1)
    return _values(p, vs, v_cache, 0, valid).to(q.dtype)


def head_groups(h: int) -> int:
    """Blocks a batch row's heads take: ceil(H / ``K3_MAX_HEADS``)."""
    return -(-h // K3_MAX_HEADS)


def decode_splits(b: int, h: int, m: int, sms: int = H100_SMS) -> int:
    """How many runs of slots K3 cuts a cache of m slots into: as many as
    leave one block of (batch row, head group, split) an SM, at least 1,
    at most one run of ``K3_SPLIT_SLOTS`` a split, and none left empty at
    valid = m. Depends on the shapes only, never on ``valid``. (Measured
    on an H100 by ``chip_smoke.py --k3-splits``: at B=32 one block an SM
    and two came within 5 % of each other, one ahead at the full cache;
    at B=256 one split beat more.)"""
    runs = -(-m // K3_SPLIT_SLOTS)
    want = max(1, min(runs, sms // (b * head_groups(h))))
    return -(-runs // -(-runs // want))


def split_len(m: int, splits: int) -> int:
    """Slots a split: whole runs of ``K3_SPLIT_SLOTS``, ``splits *
    split_len >= m``."""
    runs = -(-m // K3_SPLIT_SLOTS)
    return K3_SPLIT_SLOTS * -(-runs // splits)


def decode_attention_split_plain(q, k_cache, ks, v_cache, vs, valid,
                                 splits: int | None = None):
    """K3's algorithm in plain PyTorch, both variants: each split's partial
    state (max and denominator of base-2 scores, fp32 sums of P . V) over
    its live slots, then the lse merge in split order. ``splits`` defaults
    to :func:`decode_splits`."""
    B, H, hd = q.shape
    M = k_cache.shape[1]
    valid = _host_valid(valid)
    if splits is None:
        splits = decode_splits(B, H, M)
    per = split_len(M, splits)
    qf = q.float()
    scale = hd ** -0.5 * math.log2(math.e)
    states = []
    for i in range(splits):
        lo, hi = i * per, min((i + 1) * per, valid)
        if hi <= lo:
            continue       # an empty split weighs nothing in the merge
        s = _scores(qf, k_cache, ks, lo, hi) * scale
        m = s.amax(-1)
        p = torch.exp2(s - m[..., None])
        states.append((m, p.sum(-1), _values(p, vs, v_cache, lo, hi)))
    m_all = torch.stack([m for m, _, _ in states]).amax(0)
    l_all = torch.zeros_like(m_all)
    o = torch.zeros_like(qf)
    for m, l, acc in states:
        c = torch.exp2(m - m_all)
        l_all = l_all + l * c
        o = o + acc * c[..., None]
    return (o / l_all[..., None]).to(q.dtype)


def decode_attention(q, k_cache, ks, v_cache, vs, valid):
    """One decode step of attention over the int8 or mixed ``bshd`` cache,
    with H query heads over Hkv KV heads (H a multiple of Hkv).

    ``ks`` is None for the mixed cache (bf16 K). ``valid`` is a Python int
    or a one-element int32 tensor on q's device (read by the kernel;
    outside [1, M] it traps the card). On CPU tensors this is
    :func:`decode_attention_plain`; on CUDA tensors it launches K3 or
    raises."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, ks, v_cache, vs, valid)
    B, H, hd = q.shape
    M, Hkv = k_cache.shape[1], k_cache.shape[2]
    mixed = ks is None
    tensors = tuple(t for t in (q, k_cache, ks, v_cache, vs) if t is not None)
    if any(t.device != q.device for t in tensors) or q.device.type != "cuda":
        raise ValueError("decode_attention: all inputs must be on one CUDA "
                         "device")
    if (H % Hkv or k_cache.shape != (B, M, Hkv, hd)
            or v_cache.shape != (B, M, Hkv, hd) or vs.shape != (B, M, Hkv)
            or (not mixed and ks.shape != (B, M, Hkv))):
        raise ValueError(
            f"decode_attention: shapes q {tuple(q.shape)}, k "
            f"{tuple(k_cache.shape)}, ks "
            f"{None if mixed else tuple(ks.shape)}, v "
            f"{tuple(v_cache.shape)}, vs {tuple(vs.shape)} do not match")
    k_dtype = torch.bfloat16 if mixed else torch.int8
    if (k_cache.dtype != k_dtype or v_cache.dtype != torch.int8
            or (not mixed and ks.dtype != torch.bfloat16)
            or vs.dtype != torch.bfloat16
            or q.dtype not in (torch.bfloat16, torch.float32)):
        raise ValueError("decode_attention: takes int8 k (bf16 without ks), "
                         "int8 v, bf16 scales and a bf16 or fp32 query")
    if hd != 64:
        raise ValueError(f"decode_attention: the kernel takes hd=64, got {hd}")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0
               for t in tensors):
        raise ValueError("decode_attention: inputs must be contiguous and "
                         "16-byte aligned")
    if isinstance(valid, torch.Tensor):
        if (valid.dtype != torch.int32 or valid.numel() != 1
                or valid.device != q.device):
            raise ValueError("decode_attention: a valid tensor must be one "
                             "int32 on q's device")
    elif not 1 <= valid <= M:
        raise ValueError(f"decode_attention: valid={valid} outside [1, {M}]")
    key = (q.device, B, H, M)
    splits = _plans.get(key)
    if splits is None:
        splits = _plans[key] = decode_splits(B, H, M, _sms(q.device))
    return _launch(q, k_cache, ks, v_cache, vs, valid, splits)


decode_attention.launches = 0
decode_attention.grouped_launches = 0
decode_attention.mixed_launches = 0


def _launch(q, k_cache, ks, v_cache, vs, valid, splits: int):
    """K3 on checked inputs with a given split count (the wrapper passes
    :func:`decode_splits`; ``chip_smoke.py --k3-splits`` times others)."""
    B, H, hd = q.shape
    M, Hkv = k_cache.shape[1], k_cache.shape[2]
    per, partials, counters = _workspace(q.device, B, H, M, splits)
    if isinstance(valid, torch.Tensor):
        valid_dev, valid_host = valid.data_ptr(), 0
    else:
        valid_dev, valid_host = None, int(valid)
    out = torch.empty_like(q)
    err = _entry()(
        q.data_ptr(), k_cache.data_ptr(),
        None if ks is None else ks.data_ptr(), v_cache.data_ptr(),
        vs.data_ptr(), out.data_ptr(), partials, counters, B, M, H, Hkv, hd,
        splits, per, valid_dev, valid_host, int(q.dtype == torch.bfloat16),
        int(ks is not None), torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(
            f"decode_attention kernel launch failed: cudaError {err}")
    name = ("mixed_launches" if ks is None else
            "grouped_launches" if Hkv != H else "launches")
    if not torch.cuda.is_current_stream_capturing():
        setattr(decode_attention, name, getattr(decode_attention, name) + 1)
    elif getattr(_capture, "launches", None) is not None:
        _capture.launches[name] += 1
    return out


_capture = threading.local()   # .launches: the open capture_launches()


@contextlib.contextmanager
def capture_launches():
    """Record this thread's K3 launches made under a CUDA graph capture
    inside the block, by counter name (``"launches"``,
    ``"grouped_launches"``, ``"mixed_launches"``), into the yielded
    Counter: the graph's launches a replay, for :func:`count_replay`."""
    _capture.launches = launches = collections.Counter()
    try:
        yield launches
    finally:
        _capture.launches = None


def count_replay(launches: collections.Counter):
    """Count one replay of a graph whose capture recorded ``launches``
    (:func:`capture_launches`)."""
    for name, n in launches.items():
        setattr(decode_attention, name, getattr(decode_attention, name) + n)


_plans: dict = {}       # (device, B, H, M) -> splits
_workspaces: dict = {}  # (device, B, H, M, splits) -> (per, pointers, tensors)


def _workspace(device, b: int, h: int, m: int, splits: int):
    """(slots a split, partials pointer, counters pointer) of K3 at a shape:
    with splits > 1, partials fp32 [B*H, splits, 66] and counters int32
    [B, head groups] for the merge, made once per device and shape and
    kept (the kernel leaves the counters at 0). Calls on one device share
    them, so they must not run on two streams at once. The first call at
    a shape must not be inside a CUDA graph capture (the counters' zeroing
    would only be captured)."""
    key = (device, b, h, m, splits)
    ws = _workspaces.get(key)
    if ws is None:
        tensors = ()
        if splits > 1:
            if torch.cuda.is_current_stream_capturing():
                raise RuntimeError("decode_attention: call once at this "
                                   "shape before capturing it in a CUDA "
                                   "graph")
            tensors = (torch.empty(b * h * splits * K3_PARTIAL,
                                   dtype=torch.float32, device=device),
                       torch.zeros(b * head_groups(h), dtype=torch.int32,
                                   device=device))
        ptrs = tuple(t.data_ptr() for t in tensors) or (None, None)
        ws = _workspaces[key] = (split_len(m, splits), *ptrs, tensors)
    return ws[:3]


def _host_valid(valid) -> int:
    if isinstance(valid, torch.Tensor):
        if valid.dtype != torch.int32 or valid.numel() != 1:
            raise ValueError("decode_attention: a valid tensor must hold one "
                             "int32")
        return int(valid.item())
    return int(valid)


@functools.lru_cache(maxsize=None)
def _entry():
    fn = _build.load("decode_attention").ivg_decode_attention
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
                   + [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                      ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def kernel_max_heads() -> int:
    """The heads a block holds, as the built library has it."""
    return _build.load("decode_attention").ivg_decode_attention_max_heads()
