"""The safetensors file format, read and written by hand.

The port's stand-in for ``safetensors.numpy.load_file`` / ``save_file``,
which ``ivideogpt_tpu/utils/checkpoint.py`` calls (the card's machine has
no ``safetensors``). A file is

    8 bytes    N, little-endian unsigned
    N bytes    JSON: {name: {"dtype": "F32", "shape": [...],
                             "data_offsets": [begin, end]}, ...,
                      "__metadata__": {str: str}}  (optional)
    the rest   the tensors' bytes, little-endian, row-major; offsets count
               from the end of the header

Tensors come back as torch tensors that own their memory, so a tensor whose
offset is not a multiple of its item size reads as well as any other (numpy
has no bf16; torch has). The writer makes every tensor contiguous first (a
transposed view would otherwise be written as its base buffer's bytes) and
pads the header with spaces to a multiple of 8 bytes, as the format wants.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Dict, Optional, Tuple

import numpy as np
import torch

DTYPES = {"F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
          "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
          "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
          "BOOL": torch.bool}
_NAMES = {v: k for k, v in DTYPES.items()}


def _header(raw: bytes, path: str):
    if len(raw) < 8:
        raise ValueError(f"{path}: {len(raw)} bytes, too short for a header")
    (n,) = struct.unpack("<Q", raw[:8])
    if 8 + n > len(raw):
        raise ValueError(f"{path}: header of {n} bytes runs past the file")
    return json.loads(raw[8:8 + n].decode("utf-8")), 8 + n


def load_file(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of one ``.safetensors`` file, by name, on the CPU."""
    with open(path, "rb") as f:
        raw = bytearray(f.read())
    header, start = _header(raw, path)
    body = len(raw) - start
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        if info["dtype"] not in DTYPES:
            raise ValueError(f"{path}: {name} has dtype {info['dtype']}, "
                             f"not one of {sorted(DTYPES)}")
        dtype = DTYPES[info["dtype"]]
        shape = tuple(int(s) for s in info["shape"])
        begin, end = (int(o) for o in info["data_offsets"])
        size = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
        if not 0 <= begin <= end <= body or end - begin != size:
            raise ValueError(f"{path}: {name} {info['dtype']}{shape} has "
                             f"data_offsets [{begin}, {end}] in a body of "
                             f"{body} bytes")
        if size == 0:
            out[name] = torch.empty(shape, dtype=dtype)
            continue
        data = torch.frombuffer(raw, dtype=torch.uint8, count=size,
                                offset=start + begin).clone()
        out[name] = data.view(dtype).reshape(shape)
    return out


def load(path: str, skip: Tuple[str, ...] = ()) -> Dict[str, torch.Tensor]:
    """A file, or every ``*.safetensors`` file of a directory but those
    named in ``skip``, merged in sorted order (a later file's tensor
    replaces an earlier one's of the same name)."""
    if not os.path.isdir(path):
        return load_file(path)
    merged: Dict[str, torch.Tensor] = {}
    for f in sorted(os.listdir(path)):
        if f.endswith(".safetensors") and f not in skip:
            merged.update(load_file(os.path.join(path, f)))
    if not merged:
        raise FileNotFoundError(f"no .safetensors under {path}")
    return merged


def save_file(tensors: Dict[str, torch.Tensor], path: str,
              metadata: Optional[Dict[str, str]] = None):
    """Write ``tensors`` (torch tensors or numpy arrays) to ``path``."""
    header: dict = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    blobs, offset = [], 0
    for name in sorted(tensors):
        t = torch.as_tensor(tensors[name]).detach().cpu().contiguous()
        if t.dtype not in _NAMES:
            raise ValueError(f"{name}: dtype {t.dtype} has no safetensors "
                             f"name")
        blob = t.reshape(-1).view(torch.uint8).numpy().tobytes()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(blob)]}
        blobs.append(blob)
        offset += len(blob)
    text = json.dumps(header, separators=(",", ":")).encode("utf-8")
    text += b" " * (-len(text) % 8)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(text)))
        f.write(text)
        for blob in blobs:
            f.write(blob)
