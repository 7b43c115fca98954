"""Build the hand-written sources under ``csrc/`` and load them.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on first
use by ``nvcc`` for ``sm_90a`` into its own shared library; each host source
``csrc/<name>.cpp`` (``HOST_SOURCES``) by the system C++ compiler (``c++``,
else ``g++``). Both are loaded with ``ctypes``, so a call releases the GIL.
Libraries go to ``csrc/build/`` (listed in ``.gitignore``) under a name that
carries a hash of the source, the shared headers (``*.cuh``, for the CUDA
sources) and the flags, so an edited source or header is rebuilt and an
unchanged one is loaded as it is. :func:`build_all` starts one compiler per
source, all at once. A missing compiler or a failed build raises with the
compiler's log.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(CSRC, "build")
SOURCES = ("vq_argmin", "vq_argmin_tiled", "decode_attention",
           "flash_attention_sm90", "flash_attention_tf32", "qconv")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# host C++ with a plain C interface (the JPEG decoder of data/jpeg.py, the
# fused crop-resize of data/native.py); IEEE float arithmetic, no FMA
# contraction, so a host source gives the same floats on every host
HOST_SOURCES = ("jpeg_decode", "segment_ops")
HOST_FLAGS = ("-O2", "-std=c++17", "-ffp-contract=off", "-shared", "-fPIC")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _cxx() -> str:
    for cand in ("c++", "g++"):
        path = shutil.which(cand)
        if path:
            return path
    raise RuntimeError("no C++ compiler (c++ or g++) found: the host sources "
                       f"{HOST_SOURCES} cannot be built")


def _source(name: str) -> str:
    return f"{name}.cpp" if name in HOST_SOURCES else f"{name}.cu"


def _lib_path(name: str) -> str:
    host = name in HOST_SOURCES
    digest = hashlib.sha256(" ".join(HOST_FLAGS if host else NVCC_FLAGS)
                            .encode())
    headers = [] if host else sorted(f for f in os.listdir(CSRC)
                                     if f.endswith(".cuh"))
    for src in [_source(name), *headers]:
        with open(os.path.join(CSRC, src), "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:12]}.so")


def _start(name: str):
    """Start the compiler for one source; None when its library is already
    built."""
    out = _lib_path(name)
    if os.path.exists(out):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    compiler = ([_cxx(), *HOST_FLAGS] if name in HOST_SOURCES
                else [_nvcc(), *NVCC_FLAGS])
    cmd = [*compiler, "-o", tmp, os.path.join(CSRC, _source(name))]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, started) -> str:
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tool = "c++" if name in HOST_SOURCES else "nvcc"
        raise RuntimeError(f"{tool} failed for {_source(name)}:\n{log}")
    os.replace(tmp, out)
    return log


def build_all() -> Dict[str, str]:
    """Compile every kernel source and every host source in parallel;
    returns the compiler's log (nvcc's with the ``-Xptxas -v`` register and
    shared-memory lines) for each source built now, and an empty string for
    one found already built."""
    with _lock:
        started = {name: _start(name) for name in SOURCES + HOST_SOURCES}
        return {name: (_finish(name, s) if s is not None else "")
                for name, s in started.items()}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu`` (or ``.cpp``, a host
    source), built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            started = _start(name)
            if started is not None:
                _finish(name, started)
            lib = ctypes.CDLL(_lib_path(name))
            _libs[name] = lib
        return lib
