"""Host-side image helpers of the inference path: the port's own copy of
``center_crop_square`` and ``resize`` (``ivideogpt_tpu/data/augment.py:51-59``),
in numpy. ``resize`` computes what ``cv2.resize(img, (size, size),
interpolation=cv2.INTER_LINEAR)`` computes on a float32 image: bilinear
taps at half-pixel centres, clamped at the borders, no antialias, the rows
interpolated first and then the columns (an exact 2x downscale, which cv2
sends to its area path, gives the same average of four).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def center_crop_square(img: np.ndarray) -> np.ndarray:
    h, w = img.shape[:2]
    s = min(h, w)
    i, j = (h - s) // 2, (w - s) // 2
    return img[i:i + s, j:j + s]


def _taps(src: int, dst: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(left index, right index, right weight) of each output position,
    with cv2's arithmetic: the source coordinate in float64 rounded to
    float32, its fraction taken in float32, clamped at both borders."""
    f = ((np.arange(dst) + 0.5) * (src / dst) - 0.5).astype(np.float32)
    i0 = np.floor(f).astype(np.int64)
    w = f - i0.astype(np.float32)
    below, above = i0 < 0, i0 >= src - 1
    w[below | above] = 0
    i0 = np.clip(i0, 0, src - 1)
    return i0, np.minimum(i0 + 1, src - 1), w


def resize(img: np.ndarray, size: int) -> np.ndarray:
    """[H, W, C] float32 -> [size, size, C] float32, bilinear (cv2's
    INTER_LINEAR)."""
    img = np.asarray(img, np.float32)
    h, w = img.shape[:2]
    if (h, w) == (size, size):
        return img.copy()
    x0, x1, wx = _taps(w, size)
    y0, y1, wy = _taps(h, size)
    wx = wx[:, None]
    one = np.float32(1)
    rows = img[:, x0] * (one - wx) + img[:, x1] * wx
    wy = wy[:, None, None]
    return rows[y0] * (one - wy) + rows[y1] * wy
