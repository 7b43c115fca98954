"""The fused host crop-resize-normalize of a video segment: ``csrc/
segment_ops.cpp``, built by ``_build`` with the system C++ compiler on
first use and called through ``ctypes`` (a call releases the GIL, so
loader threads run side by side). ``data/augment.augment_segment``
resizes every augmented segment through it.

    out = segment_crop_resize(images, i, j, h, w, 64)   # [T, 64, 64, C]

It computes ``augment.resized_crop(img / 255, i, j, h, w, size)`` on each
frame, cv2's INTER_LINEAR taps, but interpolates each output pixel's two
rows and then between them, where ``augment.resize`` interpolates the rows
first: the two agree within 2e-6, not bit for bit, and within 3e-5 after
the colour jitter.

No fallback: a failed build or load raises with the compiler's log, and
arguments that would make the C code read out of bounds raise
``ValueError`` before the call.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

from ivideogpt_tpu_torch import _build

_lock = threading.Lock()
_fn = None


def _library():
    """``segment_crop_resize_normalize_u8`` with its ctypes signature, the
    library built and loaded on the first call."""
    global _fn
    with _lock:
        if _fn is None:
            fn = _build.load("segment_ops").segment_crop_resize_normalize_u8
            i, f = ctypes.c_int, ctypes.c_float
            fn.argtypes = [ctypes.c_void_p, i, i, i, i, i, i, i, i,
                           ctypes.c_void_p, i, i, f, f]
            fn.restype = None
            _fn = fn
        return _fn


def segment_crop_resize(images: np.ndarray, ci: int, cj: int, ch: int,
                        cw: int, size: int) -> np.ndarray:
    """[T, H, W, C] uint8 -> [T, size, size, C] float32 in [0, 1]: the crop
    ``[ci:ci+ch, cj:cj+cw]`` of every frame resized bilinearly over 255.
    Frames of another dtype are refused, where the JAX binding casts them
    to uint8."""
    images = np.asarray(images)
    if images.dtype != np.uint8 or images.ndim != 4:
        raise ValueError(f"images must be uint8 [T, H, W, C], got "
                         f"{images.dtype} {images.shape}")
    t, h, w, c = images.shape
    ci, cj, ch, cw, size = map(int, (ci, cj, ch, cw, size))
    if not (0 <= ci and 1 <= ch and ci + ch <= h
            and 0 <= cj and 1 <= cw and cj + cw <= w):
        raise ValueError(f"crop rows {ci}:{ci + ch}, columns {cj}:{cj + cw} "
                         f"is empty or outside a {h} x {w} frame")
    if size < 1:
        raise ValueError(f"size must be at least 1, got {size}")
    fn = _library()
    images = np.ascontiguousarray(images)
    out = np.empty((t, size, size, c), np.float32)
    fn(images.ctypes.data, t, h, w, c, ci, cj, ch, cw, out.ctypes.data,
       size, size, 1.0, 0.0)
    return out
