"""Vector quantisation: kernels K1 (``csrc/vq_argmin.cu``) and K2
(``csrc/vq_argmin_tiled.cu``), their plain PyTorch version, the routing
between them, and the VQ training step ``quantize``.

For queries z (N, D) and a codebook E (K, D),

    argmin_k ||z - E_k||^2 = argmin_k (||E_k||^2 - 2 z . E_k)

computed in fp32 whatever the input dtype, with exact ties going to the
smallest index (the semantics of ``ivideogpt_tpu/ops/vq.py``).

K1 replaces the TPU kernel ``ivideogpt_tpu/ops/vq.py::_vq_argmin_kernel_flash``
and K2 ``_vq_argmin_kernel``. Both tile z in 128 rows and the codebook in
128 codes, split the codebook across CTAs where N alone does not fill the
card (:func:`vq_splits`) and take the same fp32 arithmetic, so they give
the same ids bit for bit. K1 holds D whole (D in ``K1_WIDTHS``); K2 streams
it and takes any D up to 512. :func:`vq_lookup` routes by :func:`uses_k1`.
Both are compute-bound on the H100's fp32 FMA rate (2*N*K*D FLOP); see the
sources for their designs. The ids carry no gradient: ``quantize`` sends
the codebook's gradient through the gather, as the JAX package's
``custom_vjp`` does.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch

from ivideogpt_tpu_torch import _build

K1_WIDTHS = (8, 16, 32, 64)
VQ_ROWS = 128       # rows of z a CTA, K1 and K2
VQ_CODES = 128      # codes a tile; splits are whole tiles
VQ_CTAS_PER_SM = 1  # both kernels' residency (K1 167, K2 141-149 registers)
VQ_MIN_CTAS_PER_SM = 2  # the grid's floor, where the codebook allows it
K1_FIXED_TILES = 0.5    # a K1 CTA's z tile and first copy, in tiles
K2_MAX_D = 512
K2_STAGE_DIMS = 32  # dimensions a K2 stage; D is padded to a multiple


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


def uses_k1(d: int) -> bool:
    """Whether :func:`vq_lookup` sends a codebook of width D to K1: every D
    that K1 takes, whatever K and N (on an H100, K1 was the faster at every
    D in {8, 16, 32, 64}, K up to 32768 and N up to 131072 that
    ``chip_smoke.py --vq-routing`` times; PERF.md section 6); K2 takes
    every other D."""
    return d in K1_WIDTHS


@functools.lru_cache(maxsize=None)
def vq_splits(n: int, k: int, sms: int, fixed: float) -> Tuple[int, int]:
    """(splits, codes_per_split) of K1's or K2's codebook, in whole tiles of
    ``VQ_CODES``, none empty. Of the plans whose grid of (row tiles,
    splits) holds at least ``VQ_MIN_CTAS_PER_SM`` CTAs an SM (or, where
    the codebook has too few tiles for that, one tile a split), the one
    whose waves of ``VQ_CTAS_PER_SM`` CTAs an SM take the least time,
    counting a CTA as its tiles plus ``fixed`` tiles of fixed cost (K1:
    ``K1_FIXED_TILES``; K2: one stage, ``K2_STAGE_DIMS`` over the padded
    D); on a tie the fewer splits."""
    row_tiles = -(-n // VQ_ROWS)
    tiles = -(-k // VQ_CODES)
    slots = VQ_CTAS_PER_SM * sms
    plan, cost = (tiles, 1), None
    for per in range(tiles, 0, -1):
        splits = -(-tiles // per)
        if row_tiles * splits < VQ_MIN_CTAS_PER_SM * sms and per > 1:
            continue
        c = -(-row_tiles * splits // slots) * (per + fixed)
        if cost is None or c < cost:
            plan, cost = (splits, per), c
    return plan[0], plan[1] * VQ_CODES


def k2_fixed(d: int) -> float:
    """K2's fixed cost a CTA for :func:`vq_splits`: one stage, in tiles."""
    return K2_STAGE_DIMS / _round_up(d, K2_STAGE_DIMS)


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
    splits, per_split = vq_splits(n, k, _sms(z.device), K1_FIXED_TILES)
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
    launches K2 or raises. K2 keeps the z tile in shared memory where it
    fits (D <= 320) and streams it beside the codebook otherwise
    (:func:`k2_route`)."""
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
    # the library reads rows through their stride: no copy of an fp32 view
    # whose columns are contiguous
    zf = _unit_columns(z.float())
    ef = _unit_columns(codebook.float())
    en = (ef * ef).sum(1)   # the plain version's and K1's ||E||^2
    splits, per_split = vq_splits(n, k, _sms(z.device), k2_fixed(d))
    # one scratch allocation: z^T [Dp, N rounded up to 4] and E^T [Dp, K
    # rounded up to 4] (written by the library), then, with splits, their
    # fp32 distances and int32 ids
    dp = _round_up(d, K2_STAGE_DIMS)
    zt_size, et_size = dp * _round_up(n, 4), dp * _round_up(k, 4)
    part_size = 2 * splits * n if splits > 1 else 0
    scratch = torch.empty(zt_size + et_size + part_size, dtype=torch.float32,
                          device=z.device)
    zt = scratch.data_ptr()
    et = zt + 4 * zt_size
    part_d = et + 4 * et_size if splits > 1 else None
    part_i = part_d + 4 * splits * n if splits > 1 else None
    err = _k2_entry()(zf.data_ptr(), zf.stride(0), ef.data_ptr(),
                      ef.stride(0), zt, et, en.data_ptr(), part_d, part_i,
                      out.data_ptr(), n, k, d, splits, per_split,
                      torch.cuda.current_stream(z.device).cuda_stream)
    if err:
        raise RuntimeError(f"vq_argmin_tiled kernel launch failed: "
                           f"cudaError {err}")
    vq_argmin_tiled.launches += 1
    return out


vq_argmin_tiled.launches = 0


def _unit_columns(t: torch.Tensor) -> torch.Tensor:
    return t if t.stride(1) == 1 else t.contiguous()


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


@functools.lru_cache(maxsize=None)
def _k2_entry():
    fn = _build.load("vq_argmin_tiled").ivg_vq_argmin_tiled
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int64] * 2
                   + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def k2_route(d: int) -> Tuple[bool, int]:
    """(z resident, dynamic shared memory bytes of a CTA) of K2 at width d,
    as the library decides them."""
    fn = _build.load("vq_argmin_tiled").ivg_vq_argmin_tiled_route
    fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    smem = ctypes.c_int()
    resident = fn(d, ctypes.byref(smem))
    return bool(resident), smem.value


def vq_lookup(z: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """Nearest-codebook ids for z [..., D] against codebook [K, D], through
    K1 or K2 as :func:`uses_k1` says."""
    shape = z.shape[:-1]
    argmin = vq_argmin if uses_k1(codebook.shape[1]) else vq_argmin_tiled
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
