"""Host-side image augmentation in numpy, without ``cv2``: the port's own
copy of ``ivideogpt_tpu/data/augment.py`` (the random resized crop, the
colour jitter and ``augment_segment``, one parameter draw shared by every
frame of a segment, the jitter ops in a random order), consuming the numpy
``Generator`` in the same order, so a seed gives the same crop and jitter.

``resize`` computes what ``cv2.resize(img, (size, size),
interpolation=cv2.INTER_LINEAR)`` computes on a float32 image: bilinear
taps at half-pixel centres, clamped at the borders, no antialias, the rows
interpolated first and then the columns (an exact 2x downscale, which cv2
sends to its area path, gives the same average of four). ``adjust_hue``
goes through cv2's float RGB <-> HSV formulas (H in degrees, S and V in
[0, 1]), written out in numpy.

``augment_segment`` crops, resizes and normalizes the whole uint8 segment
in one C call (``data/native.py``) and then applies the jitter: the same
draws as the JAX package's, within 2e-6 of ``resized_crop`` on
``img / 255`` before the jitter and 3e-5 after it. The JAX package takes
this fused pass only under ``IVG_NATIVE_PREPROC=1`` and otherwise, or when
its library is not built, resizes with cv2; the port has no such switch:
it builds the library or raises. ``resize`` stays for the unaugmented
paths (``no_aug``, the SSv2 reader).
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np

from ivideogpt_tpu_torch.data import native


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


def get_crop_params(height: int, width: int, scale, ratio,
                    rng: np.random.Generator) -> Tuple[int, int, int, int]:
    """(i, j, h, w) for a random resized crop; area based on min(h, w)^2
    (``ivideogpt_tpu/data/augment.py:18``)."""
    area = min(height, width) ** 2
    log_ratio = (math.log(ratio[0]), math.log(ratio[1]))
    for _ in range(10):
        target_area = area * rng.uniform(scale[0], scale[1])
        aspect = math.exp(rng.uniform(*log_ratio))
        w = int(round(math.sqrt(target_area * aspect)))
        h = int(round(math.sqrt(target_area / aspect)))
        if 0 < w <= width and 0 < h <= height:
            i = int(rng.integers(0, height - h + 1))
            j = int(rng.integers(0, width - w + 1))
            return i, j, h, w
    # central fallback
    in_ratio = width / height
    if in_ratio < min(ratio):
        w, h = width, int(round(width / min(ratio)))
    elif in_ratio > max(ratio):
        h, w = height, int(round(height * max(ratio)))
    else:
        w, h = width, height
    return (height - h) // 2, (width - w) // 2, h, w


def resized_crop(img: np.ndarray, i: int, j: int, h: int, w: int,
                 size: int) -> np.ndarray:
    """img [H, W, C] float -> [size, size, C], bilinear."""
    return resize(img[i:i + h, j:j + w], size)


def _blend(a: np.ndarray, b: np.ndarray, f: float) -> np.ndarray:
    return np.clip(f * a + (1.0 - f) * b, 0.0, 1.0)


def _grayscale(img: np.ndarray) -> np.ndarray:
    g = img[..., 0] * 0.299 + img[..., 1] * 0.587 + img[..., 2] * 0.114
    return g[..., None]


def adjust_brightness(img: np.ndarray, f: float) -> np.ndarray:
    return _blend(img, np.zeros_like(img), f)


def adjust_contrast(img: np.ndarray, f: float) -> np.ndarray:
    mean = _grayscale(img).mean()
    return _blend(img, np.full_like(img, mean), f)


def adjust_saturation(img: np.ndarray, f: float) -> np.ndarray:
    return _blend(img, np.broadcast_to(_grayscale(img), img.shape), f)


_EPS = np.float32(np.finfo(np.float32).eps)


def rgb_to_hsv(img: np.ndarray) -> np.ndarray:
    """cv2.cvtColor(img, cv2.COLOR_RGB2HSV) on float32 RGB: H in [0, 360)
    degrees, S and V in [0, 1], cv2's arithmetic in float32."""
    img = np.asarray(img, np.float32)
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    v = np.maximum(np.maximum(r, g), b)
    vmin = np.minimum(np.minimum(r, g), b)
    diff = v - vmin
    s = diff / (np.abs(v) + _EPS)
    scale = np.float32(60.0) / (diff + _EPS)
    h = np.where(v == r, (g - b) * scale,
                 np.where(v == g, (b - r) * scale + np.float32(120.0),
                          (r - g) * scale + np.float32(240.0)))
    h = np.where(h < 0, h + np.float32(360.0), h).astype(np.float32)
    return np.stack([h, s, v], axis=-1)


# cv2's sector table: for sector k, the (b, g, r) entries of
# tab = (v, v (1 - s), v (1 - s f), v (1 - s (1 - f)))
_SECTORS = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3],
                     [2, 1, 0]])


def hsv_to_rgb(hsv: np.ndarray) -> np.ndarray:
    """cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB) on float32 HSV (H in degrees)."""
    hsv = np.asarray(hsv, np.float32)
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    h = h * np.float32(6.0 / 360.0)
    h = h - np.float32(6.0) * np.floor(h / np.float32(6.0))
    h = np.where(h >= 6, h - np.float32(6.0), h)
    sector = np.floor(h).astype(np.int64)
    bad = (sector < 0) | (sector >= 6)
    f = np.where(bad, np.float32(0.0), h - sector.astype(np.float32))
    sector = np.where(bad, 0, sector)
    one = np.float32(1.0)
    tab = np.stack([v, v * (one - s), v * (one - s * f),
                    v * (one - s * (one - f))], axis=-1)
    idx = _SECTORS[sector]                               # [..., 3] = b, g, r
    bgr = np.take_along_axis(tab, idx, axis=-1)
    rgb = bgr[..., ::-1]
    return np.where((s == 0)[..., None], v[..., None], rgb).astype(np.float32)


def adjust_hue(img: np.ndarray, f: float) -> np.ndarray:
    """f in [-0.5, 0.5], fraction of the hue circle."""
    hsv = rgb_to_hsv(img)
    hsv[..., 0] = (hsv[..., 0] + f * 360.0) % 360.0
    return np.clip(hsv_to_rgb(hsv), 0.0, 1.0)


def jitter_params(brightness, contrast, saturation, hue,
                  rng: np.random.Generator):
    order = rng.permutation(4)
    b = None if brightness is None else float(rng.uniform(*brightness))
    c = None if contrast is None else float(rng.uniform(*contrast))
    s = None if saturation is None else float(rng.uniform(*saturation))
    h = None if hue is None else float(rng.uniform(*hue))
    return order, b, c, s, h


def apply_jitter(img: np.ndarray, order, b, c, s, h) -> np.ndarray:
    for fn in order:
        if fn == 0 and b is not None:
            img = adjust_brightness(img, b)
        elif fn == 1 and c is not None:
            img = adjust_contrast(img, c)
        elif fn == 2 and s is not None:
            img = adjust_saturation(img, s)
        elif fn == 3 and h is not None:
            img = adjust_hue(img, h)
    return img


def augment_segment(images: np.ndarray, image_size: int,
                    crop_scale, crop_ratio,
                    brightness, contrast, saturation, hue,
                    rng: np.random.Generator) -> np.ndarray:
    """images [T, H, W, C] uint8 -> [T, size, size, C] float32 in [0, 1],
    one shared parameter draw across the segment."""
    T, H, W, _ = images.shape
    i, j, h, w = get_crop_params(H, W, crop_scale or (1.0, 1.0),
                                 crop_ratio or (1.0, 1.0), rng)
    order, b, c, s, hu = jitter_params(brightness, contrast, saturation, hue,
                                       rng)
    out = native.segment_crop_resize(images, i, j, h, w, image_size)
    for t in range(T):
        out[t] = apply_jitter(out[t], order, b, c, s, hu)
    return out
