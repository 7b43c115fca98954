"""Vector quantisation: kernels K1 (``csrc/vq_argmin.cu``) and K2
(``csrc/vq_argmin_tiled.cu``), their plain PyTorch version, the routing
between them, and the VQ training step ``quantize``.

For queries z (N, D) and a codebook E (K, D),

    argmin_k ||z - E_k||^2 = argmin_k (||E_k||^2 - 2 z . E_k)

computed in fp32 whatever the input dtype, with exact ties going to the
smallest index (the semantics of ``ivideogpt_tpu/ops/vq.py``).

K1 replaces the TPU kernel ``ivideogpt_tpu/ops/vq.py::_vq_argmin_kernel_flash``
and K2 ``_vq_argmin_kernel``. Both split the codebook across CTAs where N
alone does not fill the card (:func:`k1_splits`, :func:`k2_splits`) and
take the same fp32 arithmetic, so they give the same ids bit for bit.
:func:`vq_lookup` routes as the JAX package does (``vq.py:271-276``): K1
where the JAX package takes its flash kernel (padded fp32 codebook of at
most 6 MB) and K1 takes the width, K2 everywhere else. Both are
compute-bound on the H100's fp32 FMA rate (2*N*K*D FLOP); see the sources
for their designs. The ids carry no gradient: ``quantize``
sends the codebook's gradient through the gather, as the JAX package's
``custom_vjp`` does.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from ivideogpt_tpu_torch import _build

K1_WIDTHS = (8, 16, 32, 64)
K1_ROWS = 128      # rows of z a K1 CTA
K1_CODES = 128     # codes a K1 chunk; splits are whole chunks
K1_CTAS_PER_SM = 1  # K1's residency (167 registers a thread at D=64)
K1_MIN_CTAS_PER_SM = 2  # the grid's floor, where the codebook allows it
K2_MAX_D = 512
K2_ROWS = 64       # rows of z a K2 block
K2_CODES = 64      # codes a K2 tile; splits are whole tiles
FLASH_LIMIT_BYTES = 6 * 1024 * 1024   # the JAX package's VMEM rule


class QuantizeResult(NamedTuple):
    quantized: torch.Tensor    # same shape as z, straight-through gradient
    indices: torch.Tensor      # [...], int64 codebook ids
    commit_loss: torch.Tensor  # scalar


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def vq_lookup_plain(z: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """Plain version: z (N, D), codebook (K, D) -> (N,) int64 ids.

    fp32, ||z||^2 omitted, first index on exact ties (``torch.argmin``).
    Call with TF32 off (``utils.platform.full_fp32``) on a CUDA tensor."""
    zf = z.float()
    ef = codebook.float()
    dist = (ef * ef).sum(1)[None, :] - 2.0 * (zf @ ef.t())
    return dist.argmin(dim=1)


def uses_k1(k: int, d: int) -> bool:
    """Whether :func:`vq_lookup` sends a (K, D) codebook to K1: where the
    JAX package takes the flash kernel (``kp * dp * 4 <= 6 MB`` with K and D
    padded to 128, ``vq.py:274``) and K1 takes the width."""
    fits = _round_up(k, 128) * _round_up(d, 128) * 4 <= FLASH_LIMIT_BYTES
    return fits and d in K1_WIDTHS


@functools.lru_cache(maxsize=None)
def k1_splits(n: int, k: int, sms: int) -> Tuple[int, int]:
    """(splits, codes_per_split) of K1's codebook, in whole chunks of
    ``K1_CODES``, none empty. Of the plans whose grid of (row tiles,
    splits) holds at least ``K1_MIN_CTAS_PER_SM`` CTAs an SM (or, where
    the codebook has too few chunks for that, one chunk a split), the one
    whose waves of ``K1_CTAS_PER_SM`` CTAs an SM take the least time,
    counting a CTA as its chunks plus half a chunk for its z tile and
    first copy; on a tie the fewer splits."""
    row_tiles = -(-n // K1_ROWS)
    chunks = -(-k // K1_CODES)
    slots = K1_CTAS_PER_SM * sms
    plan, cost = (chunks, 1), None
    for per in range(chunks, 0, -1):
        splits = -(-chunks // per)
        if row_tiles * splits < K1_MIN_CTAS_PER_SM * sms and per > 1:
            continue
        c = -(-row_tiles * splits // slots) * (per + 0.5)
        if cost is None or c < cost:
            plan, cost = (splits, per), c
    return plan[0], plan[1] * K1_CODES


def k2_splits(n: int, k: int, sms: int) -> Tuple[int, int]:
    """(splits, codes_per_split) of K2's codebook: enough splits that the
    grid of (row tiles, splits) has at least 2 blocks an SM, in whole tiles
    of codes, none empty."""
    row_tiles = -(-n // K2_ROWS)
    tiles = -(-k // K2_CODES)
    want = max(1, min(tiles, -(-2 * sms // row_tiles)))
    per = -(-tiles // want)
    return -(-tiles // per), per * K2_CODES


def _check(name: str, z: torch.Tensor, codebook: torch.Tensor) -> None:
    if z.device.type != "cuda" or codebook.device != z.device:
        raise ValueError(f"{name}: z on {z.device}, codebook on "
                         f"{codebook.device}; both must be on one CUDA device")
    if z.ndim != 2 or codebook.ndim != 2 or z.shape[1] != codebook.shape[1]:
        raise ValueError(f"{name}: shapes {tuple(z.shape)} and "
                         f"{tuple(codebook.shape)} are not (N, D) and (K, D)")


def _aligned(name: str, *tensors: torch.Tensor) -> None:
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: inputs must be 16-byte aligned")


def vq_argmin(z: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """z (N, D), codebook (K, D) -> (N,) int64 nearest-codebook ids.

    On a CPU tensor this is :func:`vq_lookup_plain`; on a CUDA tensor it
    launches K1 or raises."""
    if z.device.type == "cpu":
        return vq_lookup_plain(z, codebook)
    _check("vq_argmin", z, codebook)
    n, d = z.shape
    k = codebook.shape[0]
    if d not in K1_WIDTHS or k < 1:
        raise ValueError(f"vq_argmin: the kernel takes D in {K1_WIDTHS} and "
                         f"K >= 1, got D={d}, K={k}")
    out = torch.empty(n, dtype=torch.int64, device=z.device)
    if n == 0:
        return out
    zf = z.float().contiguous()
    ef = codebook.float().contiguous()
    en = (ef * ef).sum(1)   # the plain version's and K2's ||E||^2
    _aligned("vq_argmin", zf)
    splits, per_split = k1_splits(n, k, _sms(z.device))
    # one scratch allocation: E^T [D, K rounded up to 4] (written by the
    # library), then, with splits, their fp32 distances and int32 ids
    et_size = d * _round_up(k, 4)
    part_size = 2 * splits * n if splits > 1 else 0
    scratch = torch.empty(et_size + part_size, dtype=torch.float32,
                          device=z.device)
    et = scratch.data_ptr()
    part_d = et + 4 * et_size if splits > 1 else None
    part_i = part_d + 4 * splits * n if splits > 1 else None
    err = _k1_entry()(zf.data_ptr(), ef.data_ptr(), et, en.data_ptr(),
                      part_d, part_i, out.data_ptr(), n, k, d, splits,
                      per_split,
                      torch.cuda.current_stream(z.device).cuda_stream)
    if err:
        raise RuntimeError(f"vq_argmin kernel launch failed: cudaError {err}")
    vq_argmin.launches += 1
    return out


vq_argmin.launches = 0


def vq_argmin_tiled(z: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """z (N, D), codebook (K, D) -> (N,) int64 nearest-codebook ids, for
    any K >= 1 and D <= 512.

    On a CPU tensor this is :func:`vq_lookup_plain`; on a CUDA tensor it
    launches K2 or raises."""
    if z.device.type == "cpu":
        return vq_lookup_plain(z, codebook)
    _check("vq_argmin_tiled", z, codebook)
    n, d = z.shape
    k = codebook.shape[0]
    if k < 1 or not 1 <= d <= K2_MAX_D:
        raise ValueError(f"vq_argmin_tiled: the kernel takes K >= 1 and "
                         f"1 <= D <= {K2_MAX_D}, got K={k}, D={d}")
    out = torch.empty(n, dtype=torch.int64, device=z.device)
    if n == 0:
        return out
    zf = z.float()
    ef = codebook.float()
    en = (ef * ef).sum(1)   # the plain version's ||E||^2, before any padding
    dp = _round_up(d, 4)    # zero columns leave every distance unchanged
    zf = F.pad(zf, (0, dp - d)).contiguous()
    ef = F.pad(ef, (0, dp - d)).contiguous()
    _aligned("vq_argmin_tiled", zf, ef)
    splits, per_split = k2_splits(n, k, _sms(z.device))
    part_d = torch.empty(splits, n, dtype=torch.float32, device=z.device)
    part_i = torch.empty(splits, n, dtype=torch.int32, device=z.device)
    lib = _vq_tiled_lib()
    err = lib.ivg_vq_argmin_tiled(
        zf.data_ptr(), ef.data_ptr(), en.data_ptr(), part_d.data_ptr(),
        part_i.data_ptr(), out.data_ptr(), n, k, dp, splits, per_split,
        torch.cuda.current_stream(z.device).cuda_stream)
    if err:
        raise RuntimeError(f"vq_argmin_tiled kernel launch failed: "
                           f"cudaError {err}")
    vq_argmin_tiled.launches += 1
    return out


vq_argmin_tiled.launches = 0


@functools.lru_cache(maxsize=None)
def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=None)
def _k1_entry():
    fn = _build.load("vq_argmin").ivg_vq_argmin
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _vq_tiled_lib() -> ctypes.CDLL:
    lib = _build.load("vq_argmin_tiled")
    fn = lib.ivg_vq_argmin_tiled
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


def vq_lookup(z: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """Nearest-codebook ids for z [..., D] against codebook [K, D], through
    K1 or K2 as :func:`uses_k1` says."""
    shape = z.shape[:-1]
    k, d = codebook.shape
    argmin = vq_argmin if uses_k1(k, d) else vq_argmin_tiled
    return argmin(z.reshape(-1, z.shape[-1]), codebook).reshape(shape)


def quantize(z: torch.Tensor, codebook: torch.Tensor,
             beta: float = 1.0) -> QuantizeResult:
    """Lookup, straight-through estimator and commit loss (diffusers'
    VectorQuantizer with legacy=False, as the JAX package's ``quantize``):

        commit = beta * mean((sg[z_q] - z)^2) + mean((z_q - sg[z])^2)
        z_q    = z + sg[z_q - z]

    z_q is gathered from the codebook and cast to z's dtype; the codebook's
    gradient flows through that gather only."""
    indices = vq_lookup(z.detach(), codebook.detach())
    z_q = codebook[indices].to(z.dtype)
    commit = (beta * ((z_q.detach() - z) ** 2).mean()
              + ((z_q - z.detach()) ** 2).mean())
    return QuantizeResult(z + (z_q - z).detach(), indices, commit)
