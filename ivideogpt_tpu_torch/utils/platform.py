"""Device selection, float32 precision and host-to-card staging for the
port's entry points."""

from __future__ import annotations

import contextlib
from typing import Optional, Union

import numpy as np
import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    another. Raises when CUDA is wanted and absent, so a run never drops
    to the CPU without being asked to."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU")
    return dev


@contextlib.contextmanager
def full_fp32():
    """Turn TF32 off for matmuls and cuDNN convolutions inside the block.

    cuDNN runs float32 convolutions in TF32 by default on Hopper, which
    keeps ~3 decimal digits and flips VQ ids near codebook boundaries.
    bf16 computation is unaffected."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    cudnn = torch.backends.cudnn
    try:
        # the other cuDNN settings stay as the caller has them
        with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                         deterministic=cudnn.deterministic,
                         allow_tf32=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def to_device(x, dev: torch.device) -> torch.Tensor:
    """An array or tensor on ``dev`` without waiting for the card: a host
    array is staged through pinned memory, whose copy is queued on the
    stream (a copy from pageable memory would first wait for everything
    queued before it)."""
    t = x.detach() if torch.is_tensor(x) else torch.from_numpy(
        np.ascontiguousarray(x))
    if dev.type != "cuda" or t.is_cuda:
        return t.to(dev)
    return t.contiguous().pin_memory().to(dev, non_blocking=True)
