"""Build and bind the port's hand-written CUDA kernels (`csrc/*.cu`).

At first use the sources (every `csrc/*.cu`) are compiled by `nvcc` for
`sm_90a`, one process per source, all at once, and linked into ONE shared
library with a plain C interface, under `_build/` (git-ignored), named by a
hash of the flags and of every file under `csrc/` (`*.cu` and the shared
`*.cuh` headers), so a changed source or header never loads a stale build.
The library is bound with `ctypes`: no PyTorch headers are compiled, so a
cold build takes seconds rather than the minutes of
`torch.utils.cpp_extension.load`.

Each C entry point launches on the stream it is given and returns the
`cudaError_t` of the launch; the wrappers in `ops/` raise on a non-zero
value. Each operation has one kernel for each class of shapes, which its
wrapper picks from the shapes alone. `LAUNCHES` counts the launches of each
kernel (the wrappers add one per launch), so a run can show which kernels
its path went through; `VARIANT_LAUNCHES` counts them by (kernel, variant,
dtype), so a run can show which shape classes it met: its bf16 convs on the
tensor cores, its f32 convs on the narrow and tiled SIMT kernels, its
max-pool's vector widths, its farthest-point sampling on the cluster or the
single-CTA kernel, and so on.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas=-v",
)
SMS = 132  # streaming multiprocessors of an H100 SXM (launch plans)

# kernel name -> launches since the last `reset_launches()`
LAUNCHES = {"searchsorted": 0, "gather_gemm": 0, "gather_max": 0,
            "gather_dw": 0, "fps": 0, "ball_query": 0, "masked_norm": 0,
            "clip_adamw": 0}

# (kernel, variant, dtype name) -> launches since the last `reset_launches()`
VARIANT_LAUNCHES: dict = {}

_lock = threading.Lock()
_lib = None


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    VARIANT_LAUNCHES.clear()


def count_launch(kernel: str, variant: str, dtype) -> None:
    """One launch of `kernel` through `variant` on `dtype` tensors."""
    LAUNCHES[kernel] += 1
    key = (kernel, variant, str(dtype).replace("torch.", ""))
    VARIANT_LAUNCHES[key] = VARIANT_LAUNCHES.get(key, 0) + 1


def sources(csrc_dir: str = CSRC_DIR):
    """The compilation units: every `*.cu` under `csrc_dir`, sorted."""
    return sorted(f for f in os.listdir(csrc_dir) if f.endswith(".cu"))


def hashed_files(csrc_dir: str = CSRC_DIR):
    """Every file the build reads: the `*.cu` and `*.cuh` under `csrc_dir`,
    sorted."""
    return sorted(f for f in os.listdir(csrc_dir)
                  if f.endswith((".cu", ".cuh")))


def library_path(csrc_dir: str = CSRC_DIR, build_dir: str = BUILD_DIR):
    """Where the library of these exact sources, headers and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in hashed_files(csrc_dir):
        h.update(name.encode() + b"\0")
        with open(os.path.join(csrc_dir, name), "rb") as f:
            h.update(f.read())
        h.update(b"\0")
    return os.path.join(build_dir,
                        f"libfcaf3d_kernels_{h.hexdigest()[:16]}.so")


def find_nvcc():
    """Path of `nvcc`: on PATH, else under $CUDA_HOME / $CUDA_PATH, else the
    toolkit's default install prefix. None when there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    return None


def build():
    """Compile the kernels if this exact source set is not built yet.

    Returns (path of the shared library, compiler log; empty when the
    library was already built). Raises RuntimeError when there is no `nvcc`
    or the build fails."""
    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError(
            "cannot build the CUDA kernels: no nvcc on PATH, $CUDA_HOME or "
            "$CUDA_PATH")
    names = sources()
    srcs = [os.path.join(CSRC_DIR, s) for s in names]
    lib_path = library_path()
    if os.path.isfile(lib_path):
        return lib_path, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib_path}.{os.getpid()}.tmp"
    # one nvcc per source, all at once, then one link
    objs = [f"{tmp}.{i}.o" for i in range(len(srcs))]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", obj, src],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for src, obj in zip(srcs, objs)]
    logs = [p.communicate()[0] for p in procs]
    try:
        for src, p, out in zip(names, procs, logs):
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src} with exit code "
                                   f"{p.returncode}:\n{out}")
        link = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed with exit code "
                               f"{link.returncode}:\n{link.stderr}")
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    os.replace(tmp, lib_path)  # atomic: a concurrent loader sees all or nothing
    return lib_path, "".join(logs) + link.stdout + link.stderr


def _bind(lib):
    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.fcaf3d_searchsorted_gallop.argtypes = [
        p, p, p, i64, i64, i64, i64, i64, i, p]
    lib.fcaf3d_searchsorted_gallop.restype = i
    lib.fcaf3d_gather_gemm_simt.argtypes = [
        p, p, p, p, p, p, p, p, p, i64, i64, i64, i64, i64, i64, i64, i64, i,
        i, i, i, i, i, p]
    lib.fcaf3d_gather_gemm_simt.restype = i
    lib.fcaf3d_gather_gemm_tc.argtypes = [
        p, p, p, p, p, p, p, p, p, i64, i64, i64, i64, i64, i64, i, i, i, i,
        i, i64, i64, p]
    lib.fcaf3d_gather_gemm_tc.restype = i
    lib.fcaf3d_gather_max_vec.argtypes = [
        p, p, p, i64, i64, i64, i64, i64, i, i, i, ctypes.c_float, p]
    lib.fcaf3d_gather_max_vec.restype = i
    lib.fcaf3d_gather_dw.argtypes = [
        p, p, p, p, p, i64, i64, i64, i64, i64, i64, i64, i64, i, p]
    lib.fcaf3d_gather_dw.restype = i
    lib.fcaf3d_gather_dw_tc.argtypes = [
        p, p, p, p, p, i64, i64, i64, i64, i64, i64, i64, i64, i, i, i, p]
    lib.fcaf3d_gather_dw_tc.restype = i
    lib.fcaf3d_fps.argtypes = [p, p, p, p, i64, i64, i64, p]
    lib.fcaf3d_fps.restype = i
    lib.fcaf3d_fps_cluster.argtypes = [p, p, p, i64, i64, i64, i, i, i, p]
    lib.fcaf3d_fps_cluster.restype = i
    lib.fcaf3d_fps_cluster_occupancy.argtypes = [
        i, i, i, ctypes.POINTER(ctypes.c_int)]
    lib.fcaf3d_fps_cluster_occupancy.restype = i
    lib.fcaf3d_ball_query_tiled.argtypes = [
        p, p, p, p, i64, i64, i64, i64, ctypes.c_float, p]
    lib.fcaf3d_ball_query_tiled.restype = i
    f = ctypes.c_float
    geo = [i64, i64, i64, i64, i64]  # groups, rows, C, rows a CTA, CTAs
    tail = [i, i, i, p]  # dtype, vec, threads, stream
    lib.fcaf3d_masked_norm_stats.argtypes = [p] * 5 + geo + tail
    lib.fcaf3d_masked_norm_dev.argtypes = [p] * 6 + geo + tail
    lib.fcaf3d_masked_norm_apply.argtypes = (
        [p, p, p, p, p, i, p, p, p, p, f, f, p] + geo + [i, f] + tail)
    lib.fcaf3d_masked_norm_bwd_reduce.argtypes = (
        [p, p, p, p, p, p, i, p, p, p, p, p, p, p] + geo + [i, f] + tail)
    lib.fcaf3d_masked_norm_bwd_apply.argtypes = (
        [p, p, p, p, p, p, i, p, p, p, p, p] + geo + [i, f] + tail)
    for name in ("stats", "dev", "apply", "bwd_reduce", "bwd_apply"):
        getattr(lib, f"fcaf3d_masked_norm_{name}").restype = i
    lib.fcaf3d_clip_adamw_norm.argtypes = [p, i64, i64, p, p, p, p, p]
    lib.fcaf3d_clip_adamw_norm.restype = i
    lib.fcaf3d_clip_adamw_update.argtypes = [p, i64, i64, p, p] + [f] * 10 + [
        p]
    lib.fcaf3d_clip_adamw_update.restype = i


def load():
    """The bound kernel library, built on first call. Raises RuntimeError
    when it cannot be built."""
    global _lib
    with _lock:
        if _lib is None:
            path, _ = build()
            lib = ctypes.CDLL(path)
            _bind(lib)
            _lib = lib
    return _lib


def check(err: int, kernel: str) -> None:
    """Raise if a launch returned a non-zero cudaError_t."""
    if err != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: cudaError_t {err}")


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
