"""Farthest-point sampling, kernel K5 (port of the contract of
`fcaf3d_tpu/ops/pointnet/ops.py::furthest_point_sample` and its TPU kernel
`fps_kernel.py::fps_tpu`).

D-FPS from the first valid index: each step takes the valid point farthest
from the chosen set, the lowest index among equal distances. When S exceeds
the number of valid points, every distance is 0 after they are all chosen
and the selection repeats the first valid index, as the JAX package's does.

On a CUDA tensor the sampling is kernel K5 (`csrc/fps.cu`); on a CPU tensor
it is the plain PyTorch version, `furthest_point_sample_plain`. Both round
the distance as `(dx*dx + dy*dy) + dz*dz`, one operation at a time, so they
pick the same indices.

K5 has two CUDA kernels. `fps_plan` picks one, and its launch shape, from
the cloud's size alone:

- "registers", the cluster kernel: a thread-block cluster of `cs` CTAs per
  cloud, each thread holding `points_per_thread` points (x, y, z and the
  running minimum) in registers, one synchronisation across the cluster per
  step (each CTA waits on its own mbarrier for the candidates' st.async
  bytes). Clouds of up to SMALL_POINTS points take one CTA (cs = 1, __syncthreads);
  larger ones CLUSTER_SIZE.
- "shared" / "global", the single-CTA kernel, whose running minima live in
  shared memory or in a global scratch row (`single_plan`): only clouds
  beyond the cluster's register capacity (`cs * MAX_CTA_POINTS`).
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional

import torch

from ... import _native

_BIG = 1e10
# largest N whose running minima the single-CTA kernel keeps in shared
# memory (192 KB of the H100's 227 KB per block); larger clouds use a global
# scratch row
SMEM_POINTS = 48 * 1024
# the cluster kernel: points a thread may hold (its template instances, the
# cases of `launch_cluster_p` in csrc/fps.cu), the most threads a CTA may
# have for each (`max_threads`, MaxThreads there: registers, 80 floats of
# P = 20 fit the 128 a thread gets at 512 threads), the CTA size it aims
# at (4 warps: every warp reduces all cs x warps candidates each step, one
# a lane up to 32; the fastest at SA1 and SA2 on the H100: PERF.md), the
# largest cluster the card takes (16 needs the non-portable attribute)
POINTS_PER_THREAD = (1, 2, 4, 8, 12, 16, 20)
TARGET_THREADS = 128
MAX_CLUSTER = 16
MAX_CTA_POINTS = 512 * POINTS_PER_THREAD[-1]
# clouds up to SMALL_POINTS take one CTA; larger ones a cluster of
# CLUSTER_SIZE (the fastest of 2, 4, 8, 16 at SA1 on the H100: PERF.md)
SMALL_POINTS = 2048
CLUSTER_SIZE = 8
_SINGLE_THREADS = 1024


class FpsPlan(NamedTuple):
    cs: int  # CTAs per cloud (a cluster when > 1)
    threads: int  # per CTA
    points_per_thread: int
    where: str  # "registers" (cluster kernel); "shared" / "global" (single)


def max_threads(points_per_thread: int) -> int:
    """The most threads a CTA of the cluster kernel may have when each
    holds `points_per_thread` points (its `__launch_bounds__`)."""
    return 1024 if points_per_thread <= 4 else 512


def single_plan(n: int) -> FpsPlan:
    """The single-CTA kernel: one 1024-thread CTA per cloud, the running
    minima in shared memory up to SMEM_POINTS points, else in a global
    scratch row."""
    return FpsPlan(1, _SINGLE_THREADS, math.ceil(n / _SINGLE_THREADS),
                   "shared" if n <= SMEM_POINTS else "global")


def fps_plan(b: int, n: int, s: int,
             cluster: Optional[int] = None) -> FpsPlan:
    """The launch plan of K5 for B clouds of N points and S samples, from
    the shape alone (B clusters run side by side, and every step costs the
    same whatever S is, so the plan depends on N). `cluster` forces the
    cluster size (the sweep in `chip_smoke.py`).

    The cluster kernel takes the fewest points a thread (of
    POINTS_PER_THREAD) that keep a CTA within TARGET_THREADS threads, else
    the most, up to `max_threads`; a cloud beyond that capacity takes the
    single-CTA kernel."""
    cs = cluster or (1 if n <= SMALL_POINTS else CLUSTER_SIZE)
    if not 1 <= cs <= MAX_CLUSTER:
        raise ValueError(f"K5 cluster size {cs} outside 1..{MAX_CLUSTER}")
    per_cta = math.ceil(n / cs)
    for p in POINTS_PER_THREAD:
        threads = 32 * math.ceil(per_cta / p / 32)
        if threads <= TARGET_THREADS or (p == POINTS_PER_THREAD[-1]
                                         and threads <= max_threads(p)):
            return FpsPlan(cs, threads, p, "registers")
    return single_plan(n)


def max_active_clusters(plan: FpsPlan) -> int:
    """The clusters of a cluster-kernel `plan` that the current card can
    hold at once (`cudaOccupancyMaxActiveClusters`; no launch). Clouds
    beyond it wait for a cluster to finish: the kernel needs no
    co-residency across clusters."""
    clusters = ctypes.c_int(0)
    _native.check(_native.load().fcaf3d_fps_cluster_occupancy(
        plan.cs, plan.threads, plan.points_per_thread,
        ctypes.byref(clusters)), "fps cluster occupancy")
    return clusters.value


def furthest_point_sample_plain(points: torch.Tensor, num_samples: int,
                                valid: Optional[torch.Tensor] = None
                                ) -> torch.Tensor:
    """Plain PyTorch version of K5, same arguments and result. Each step's
    distance is written per column, so its order of operations is fixed."""
    b, n, _ = points.shape
    pts = points.float()
    x, y, z = (pts[..., c].contiguous() for c in range(3))
    if valid is None:
        valid = torch.ones((b, n), dtype=torch.bool, device=points.device)
    out = torch.zeros((b, num_samples), dtype=torch.int64,
                      device=points.device)
    if num_samples == 0:
        return out.int()
    # argmax of a bool row: its first True, 0 when there is none
    out[:, 0] = torch.argmax(valid.to(torch.uint8), dim=1)
    dcur = torch.full((b, n), _BIG, dtype=torch.float32, device=points.device)
    neg = torch.full((), -1.0, dtype=torch.float32, device=points.device)
    for i in range(1, num_samples):
        last = out[:, i - 1:i]
        dx = x - x.gather(1, last)
        dy = y - y.gather(1, last)
        dz = z - z.gather(1, last)
        d = (dx * dx + dy * dy) + dz * dz
        dcur = torch.minimum(dcur, d)
        out[:, i] = torch.argmax(torch.where(valid, dcur, neg), dim=1)
    return out.int()


def _fps_cuda(points, num_samples, valid, plan):
    lib = _native.load()
    dev = points.device
    if dev.type != "cuda" or (valid is not None and valid.device != dev):
        raise ValueError(f"K5 needs its tensors on one CUDA device, got "
                         f"{dev} and {None if valid is None else valid.device}")
    if points.dtype != torch.float32 or points.dim() != 3 \
            or points.shape[2] != 3:
        raise TypeError(f"K5 takes f32 points [B, N, 3], got {points.dtype} "
                        f"{tuple(points.shape)}")
    b, n, _ = points.shape
    if valid is not None and (valid.dtype != torch.bool
                              or tuple(valid.shape) != (b, n)):
        raise TypeError(f"K5 takes a bool valid mask [B, N], got "
                        f"{valid.dtype} {tuple(valid.shape)}")
    if not points.is_contiguous() or (valid is not None
                                      and not valid.is_contiguous()):
        raise ValueError("K5 takes contiguous points and valid mask")
    out = torch.empty((b, num_samples), dtype=torch.int32, device=dev)
    pts = points.data_ptr()
    vld = None if valid is None else valid.data_ptr()
    if plan.where == "registers":
        err = lib.fcaf3d_fps_cluster(
            pts, vld, out.data_ptr(), b, n, num_samples, plan.cs,
            plan.threads, plan.points_per_thread, _native.stream_ptr(dev))
    else:
        scratch = (torch.empty((b, n), dtype=torch.float32, device=dev)
                   if plan.where == "global" else None)
        err = lib.fcaf3d_fps(
            pts, vld, out.data_ptr(),
            None if scratch is None else scratch.data_ptr(), b, n,
            num_samples, _native.stream_ptr(dev))
    _native.count_launch("fps", "cluster" if plan.where == "registers"
                         else "single", points.dtype)
    _native.check(err, "fps")
    return out


def furthest_point_sample(points: torch.Tensor, num_samples: int,
                          valid: Optional[torch.Tensor] = None, *,
                          _plan: Optional[FpsPlan] = None) -> torch.Tensor:
    """Iterative farthest-point sampling.

    Args:
        points: [B, N, 3] f32.
        num_samples: S, the number of indices per cloud.
        valid: optional [B, N] bool; invalid points are never selected.
        _plan: forces a launch plan on the card (the cluster-size sweep,
            the serial floor and `single_plan(n)` of `chip_smoke.py`; the
            path never passes it).

    Returns:
        [B, S] int32, starting at the first valid index.
    """
    if points.device.type == "cpu":
        return furthest_point_sample_plain(points, num_samples, valid)
    if _plan is None:
        _plan = fps_plan(points.shape[0], points.shape[1], num_samples)
    return _fps_cuda(points, num_samples, valid, _plan)
