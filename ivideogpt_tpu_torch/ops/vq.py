"""Vector-quantisation lookup: kernel K1 (``csrc/vq_argmin.cu``) and its
plain PyTorch version.

For queries z (N, D) and a codebook E (K, D),

    argmin_k ||z - E_k||^2 = argmin_k (||E_k||^2 - 2 z . E_k)

computed in fp32 whatever the input dtype, with exact ties going to the
smallest index (the semantics of ``ivideogpt_tpu/ops/vq.py``).

K1 replaces the TPU kernel ``ivideogpt_tpu/ops/vq.py::_vq_argmin_kernel_flash``.
It is compute-bound on the H100's fp32 FMA rate (2*N*K*D FLOP); see the
source for its design. No gradient flows through the ids, so no
``autograd.Function`` is needed until the training slice.
"""

from __future__ import annotations

import ctypes

import torch

from ivideogpt_tpu_torch import _build


def vq_lookup_plain(z: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """Plain version: z (N, D), codebook (K, D) -> (N,) int64 ids.

    fp32, ||z||^2 omitted, first index on exact ties (``torch.argmin``).
    Call with TF32 off (``utils.platform.full_fp32``) on a CUDA tensor."""
    zf = z.float()
    ef = codebook.float()
    dist = (ef * ef).sum(1)[None, :] - 2.0 * (zf @ ef.t())
    return dist.argmin(dim=1)


def vq_argmin(z: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """z (N, D), codebook (K, D) -> (N,) int64 nearest-codebook ids.

    On a CPU tensor this is :func:`vq_lookup_plain`; on a CUDA tensor it
    launches K1 or raises."""
    if z.device.type == "cpu":
        return vq_lookup_plain(z, codebook)
    if z.device.type != "cuda" or codebook.device != z.device:
        raise ValueError(f"vq_argmin: z on {z.device}, codebook on "
                         f"{codebook.device}; both must be on one CUDA device")
    if z.ndim != 2 or codebook.ndim != 2 or z.shape[1] != codebook.shape[1]:
        raise ValueError(f"vq_argmin: shapes {tuple(z.shape)} and "
                         f"{tuple(codebook.shape)} are not (N, D) and (K, D)")
    n, d = z.shape
    k = codebook.shape[0]
    if d not in (8, 16, 32, 64):
        raise ValueError(f"vq_argmin: the kernel takes D in (8, 16, 32, 64), "
                         f"got {d}")
    zf = z.float().contiguous()
    ef = codebook.float().contiguous()
    en = (ef * ef).sum(1)
    out = torch.empty(n, dtype=torch.int64, device=z.device)
    for t in (zf, ef):
        if t.data_ptr() % 16:
            raise ValueError("vq_argmin: inputs must be 16-byte aligned")
    lib = _vq_lib()
    err = lib.ivg_vq_argmin(zf.data_ptr(), ef.data_ptr(), en.data_ptr(),
                            out.data_ptr(), n, k, d,
                            torch.cuda.current_stream(z.device).cuda_stream)
    if err:
        raise RuntimeError(f"vq_argmin kernel launch failed: cudaError {err}")
    vq_argmin.launches += 1
    return out


vq_argmin.launches = 0


def _vq_lib() -> ctypes.CDLL:
    lib = _build.load("vq_argmin")
    fn = lib.ivg_vq_argmin
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def vq_lookup(z: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """Nearest-codebook ids for z [..., D] against codebook [K, D]."""
    shape = z.shape[:-1]
    return vq_argmin(z.reshape(-1, z.shape[-1]), codebook).reshape(shape)
