"""PNG and GIF files written with the standard library and numpy only.

    write_png("grid.png", rgb)                      # uint8 [H, W, 3], exact
    write_gif("clip.gif", frames, duration_ms=250)  # uint8 [H, W, 3] each

- PNG: the signature, IHDR (8-bit RGB), one zlib IDAT of the rows, each
  row behind filter byte 0, and IEND, every chunk with its CRC-32. The
  pixels decode back exactly.
- GIF: GIF89a with one fixed global palette of 6 x 7 x 6 = 252 colours
  (red and blue in 6 levels, green in 7, each level ``round(i * 255 /
  (n - 1))``; entries 252-255 black), the NETSCAPE2.0 loop block, and per
  frame a graphic control extension with the delay and an image
  descriptor over LZW data written here (codes of 9 to 12 bits, a clear
  code whenever the table fills). Each channel is rounded to its nearest
  level, so a decoded pixel is off by at most 255 / 10 = 25.5 in red and
  blue and 255 / 12 = 21.25 in green (``quantize`` gives the decoded
  frame exactly). The palette is fixed so that every frame of every file
  shares it and the writer needs no colour search.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Sequence

import numpy as np

LEVELS = (6, 7, 6)


def _levels(n: int) -> np.ndarray:
    return np.round(np.arange(n) * 255.0 / (n - 1)).astype(np.uint8)


def palette() -> np.ndarray:
    """The GIF's global palette, uint8 [256, 3]: entry (r * 7 + g) * 6 + b
    holds level r of red, g of green and b of blue."""
    r, g, b = (_levels(n) for n in LEVELS)
    pal = np.zeros((256, 3), np.uint8)
    rr, gg, bb = np.meshgrid(r, g, b, indexing="ij")
    pal[:252] = np.stack([rr, gg, bb], -1).reshape(-1, 3)
    return pal


def palette_indices(frame: np.ndarray) -> np.ndarray:
    """uint8 [H, W, 3] -> the palette index of each pixel, uint8 [H, W]:
    each channel at its nearest level."""
    f = frame.astype(np.float32)
    idx = [np.floor(f[..., c] * (n - 1) / 255.0 + 0.5).astype(np.int32)
           for c, n in enumerate(LEVELS)]
    return ((idx[0] * LEVELS[1] + idx[1]) * LEVELS[2] + idx[2]).astype(
        np.uint8)


def quantize(frame: np.ndarray) -> np.ndarray:
    """The frame as a GIF of :func:`write_gif` decodes: uint8 [H, W, 3]."""
    return palette()[palette_indices(frame)]


def _rgb8(image: np.ndarray, what: str) -> np.ndarray:
    image = np.asarray(image)
    if image.dtype != np.uint8 or image.ndim != 3 or image.shape[2] != 3:
        raise ValueError(f"{what}: want uint8 [H, W, 3], got {image.dtype} "
                         f"{image.shape}")
    if not (0 < image.shape[0] < 65536 and 0 < image.shape[1] < 65536):
        raise ValueError(f"{what}: size {image.shape[:2]} out of range")
    return np.ascontiguousarray(image)


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path: str, image: np.ndarray):
    """Write uint8 [H, W, 3] as an 8-bit RGB PNG; makes the directory."""
    image = _rgb8(image, "write_png")
    h, w = image.shape[:2]
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           image.reshape(h, w * 3)], axis=1)
    data = (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))
    _write(path, data)


def _lzw(indices: bytes) -> bytes:
    """GIF LZW of 8-bit palette indices (minimum code size 8), packed
    least significant bit first. The code width grows when the next table
    entry no longer fits it, after the code that adds that entry is
    written, which is when a decoder widens; at 4096 entries a clear code
    resets the table."""
    clear, end = 256, 257
    out = bytearray()
    acc = nacc = 0
    table = {}
    next_code, width = 258, 9

    def emit(code):
        nonlocal acc, nacc
        acc |= code << nacc
        nacc += width
        while nacc >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            nacc -= 8

    emit(clear)
    prefix = indices[0]
    for b in indices[1:]:
        key = (prefix << 8) | b
        code = table.get(key)
        if code is not None:
            prefix = code
            continue
        emit(prefix)
        if next_code == 1 << width and width < 12:
            width += 1
        if next_code < 4096:
            table[key] = next_code
            next_code += 1
        else:
            emit(clear)
            table.clear()
            next_code, width = 258, 9
        prefix = b
    emit(prefix)
    if next_code == 1 << width and width < 12:
        width += 1
    emit(end)
    if nacc:
        out.append(acc & 0xFF)
    return bytes(out)


def _sub_blocks(data: bytes) -> bytes:
    parts = [bytes([len(data[i:i + 255])]) + data[i:i + 255]
             for i in range(0, len(data), 255)]
    return b"".join(parts) + b"\x00"


def write_gif(path: str, frames: Sequence[np.ndarray], duration_ms: int = 250,
              loop: int = 0):
    """Write uint8 [H, W, 3] frames, all of one size, as an animated GIF
    over the fixed palette: ``duration_ms`` a frame (kept in hundredths of
    a second, as GIF stores it) and ``loop`` repeats (0: forever). Makes
    the directory."""
    frames = [_rgb8(f, "write_gif") for f in frames]
    if not frames:
        raise ValueError("write_gif: no frames")
    h, w = frames[0].shape[:2]
    if any(f.shape != frames[0].shape for f in frames):
        raise ValueError("write_gif: frames of different sizes")
    delay = int(round(duration_ms / 10))
    parts = [b"GIF89a", struct.pack("<HHBBB", w, h, 0xF7, 0, 0),
             palette().tobytes(),
             b"\x21\xff\x0bNETSCAPE2.0"
             + struct.pack("<BBH", 3, 1, loop) + b"\x00"]
    for f in frames:
        parts.append(b"\x21\xf9\x04" + struct.pack("<BHB", 0x04, delay, 0)
                     + b"\x00")
        parts.append(b"\x2c" + struct.pack("<HHHHB", 0, 0, w, h, 0))
        parts.append(b"\x08" + _sub_blocks(_lzw(
            palette_indices(f).tobytes())))
    parts.append(b"\x3b")
    _write(path, b"".join(parts))


def _write(path: str, data: bytes):
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "wb") as f:
        f.write(data)
