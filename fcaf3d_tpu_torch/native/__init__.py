"""The host-side C++ evaluation IoU of the port (a copy of the JAX package's
`native/`), built at first use with the system g++ and bound with ctypes.

`src/iou3d.cc` is compiled with the JAX side's flags (`g++ -O3 -shared
-fPIC -std=c++17`, no `-march` or fast-math flag), so its float32 results
are bitwise those of the JAX package's library, into `_build/` (git-ignored)
under a name that hashes the flags and the source: a changed source never
loads a stale build.

`core.eval.pairwise_iou_3d_np` dispatches here unless `FCAF3D_NATIVE=0`
(read at each call), which selects the numpy path, the plain version.
Unlike the JAX package, a failed build or load raises with the compiler's
output: it never degrades silently to numpy.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "src", "iou3d.cc")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib = None


def enabled() -> bool:
    """False when `FCAF3D_NATIVE=0` selects the numpy IoU."""
    return os.environ.get("FCAF3D_NATIVE", "1") != "0"


def library_path() -> str:
    """Where the library of this exact source and these flags lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode() + b"\0")
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libfcaf3d_native_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile `src/iou3d.cc` unless this exact build exists; returns the
    library's path. Raises RuntimeError when there is no g++ or the
    compiler fails (with its output)."""
    path = library_path()
    if os.path.isfile(path):
        return path
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("cannot build the native IoU: no g++ on PATH")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    out = subprocess.run([cxx, *CXX_FLAGS, SOURCE, "-o", tmp],
                         capture_output=True, text=True, timeout=300)
    if out.returncode != 0:
        raise RuntimeError(f"g++ failed on {SOURCE} with exit code "
                           f"{out.returncode}:\n{out.stdout}{out.stderr}")
    os.replace(tmp, path)  # atomic: a concurrent loader sees all or nothing
    return path


def load() -> ctypes.CDLL:
    """The bound library, built on the first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            f32p = ctypes.POINTER(ctypes.c_float)
            lib.iou3d_pairwise.argtypes = [f32p, ctypes.c_int64, f32p,
                                           ctypes.c_int64, f32p]
            lib.iou3d_pairwise.restype = None
            _lib = lib
    return _lib


def pairwise_iou_3d(boxes1: np.ndarray, boxes2: np.ndarray) -> np.ndarray:
    """[N, M] float32 rotated 3D IoU of bottom-centred box7 arrays."""
    lib = load()
    b1 = np.ascontiguousarray(boxes1, np.float32).reshape(-1, 7)
    b2 = np.ascontiguousarray(boxes2, np.float32).reshape(-1, 7)
    out = np.empty((len(b1), len(b2)), np.float32)
    if out.size:
        f32p = ctypes.POINTER(ctypes.c_float)
        lib.iou3d_pairwise(b1.ctypes.data_as(f32p), len(b1),
                           b2.ctypes.data_as(f32p), len(b2),
                           out.ctypes.data_as(f32p))
    return out
