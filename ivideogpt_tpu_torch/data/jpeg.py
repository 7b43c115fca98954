"""JPEG frames decoded without PIL: the baseline decoder of
``csrc/jpeg_decode.cpp``, built by ``_build`` with the system C++ compiler
on first use and called through ``ctypes`` (a call releases the GIL, so
loader threads decode side by side).

    rgb = read_jpeg("000001.jpg")   # np.uint8 [H, W, 3]

Its pixels are libjpeg's at the defaults PIL leaves in place (islow IDCT,
fancy upsampling), so they equal ``np.asarray(Image.open(path)
.convert("RGB"))`` bit for bit: grayscale is replicated to three channels.
Baseline and extended sequential Huffman files of one or three components
at 4:4:4, 4:2:2 or 4:2:0 are read; anything else (progressive, lossless or
arithmetic coding, CMYK, other sampling, more than one scan, data that ends
early) raises :class:`JpegError` naming the file and the feature. Nothing
falls back to another decoder.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

from ivideogpt_tpu_torch import _build

_MSG_BYTES = 256
_lock = threading.Lock()
_fns = None


class JpegError(ValueError):
    """A file the decoder refuses: ``code`` 1 corrupt data, 2 a feature it
    does not support, 3 data that ends early."""

    def __init__(self, name: str, code: int, msg: str):
        kind = {1: "corrupt JPEG data", 2: "unsupported JPEG",
                3: "truncated JPEG"}.get(code, "JPEG error")
        super().__init__(f"{name}: {kind}: {msg}")
        self.code = code


def _library():
    """(header, decode) with their ctypes signatures, the library built and
    loaded on the first call."""
    global _fns
    with _lock:
        if _fns is None:
            lib = _build.load("jpeg_decode")
            size_t, ptr = ctypes.c_size_t, ctypes.c_void_p
            header = lib.ivg_jpeg_header
            header.restype = ctypes.c_int
            header.argtypes = [ctypes.c_char_p, size_t,
                               ctypes.POINTER(ctypes.c_int),
                               ctypes.POINTER(ctypes.c_int),
                               ctypes.POINTER(ctypes.c_int),
                               ctypes.POINTER(size_t), ctypes.c_char_p,
                               size_t]
            decode = lib.ivg_jpeg_decode
            decode.restype = ctypes.c_int
            decode.argtypes = [ctypes.c_char_p, size_t, ptr, size_t, ptr,
                               size_t, ctypes.c_char_p, size_t]
            _fns = header, decode
        return _fns


def decode_jpeg(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """The RGB pixels of a JPEG file's bytes: np.uint8 [H, W, 3]. ``name``
    goes into the error message."""
    header, decode = _library()
    h, w, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    scratch_bytes = ctypes.c_size_t()
    msg = ctypes.create_string_buffer(_MSG_BYTES)
    rc = header(data, len(data), ctypes.byref(h), ctypes.byref(w),
                ctypes.byref(c), ctypes.byref(scratch_bytes), msg,
                _MSG_BYTES)
    if rc:
        raise JpegError(name, rc, msg.value.decode())
    out = np.empty((h.value, w.value, 3), np.uint8)
    scratch = np.empty(scratch_bytes.value, np.uint8)
    rc = decode(data, len(data), out.ctypes.data, out.nbytes,
                scratch.ctypes.data, scratch.nbytes, msg, _MSG_BYTES)
    if rc:
        raise JpegError(name, rc, msg.value.decode())
    return out


def read_jpeg(path: str) -> np.ndarray:
    """The RGB pixels of the JPEG file at ``path``: np.uint8 [H, W, 3]."""
    with open(path, "rb") as f:
        data = f.read()
    return decode_jpeg(data, path)
