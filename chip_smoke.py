"""Smoke run of the PyTorch/CUDA port (`fcaf3d_tpu_torch`) on one GPU.

Run from the repository root, on a machine with an NVIDIA Hopper GPU, nvcc
and PyTorch built for CUDA:

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. Device: require CUDA; print the card's name and power limit.
2. Build: compile the CUDA kernels K1-K6 from `fcaf3d_tpu_torch/csrc/`
   (one nvcc per source, in parallel).
3. Kernels against their plain PyTorch versions on the card, at the shapes
   of the main path's maps on a real-size scan: K1 exact (with and without
   `with_miss`, also on edge clouds: N = 1, N < L, N = 1 mod L, runs of
   equal keys across every L-th key, a compaction cumsum, random-order and
   all-SENTINEL queries, both K1 variants), K2 in f32 and bf16 with every
   epilogue (f32, and bf16 off the tensor cores' granule, equal to the
   earlier kernel), K3 exact (`torch.equal`) and equal to the first,
   scalar kernel on the stem pool maps of batch 1 and batch 8 in f32 and
   bf16, and on edge cases (C off the 16-byte vector, all-miss rows, ties,
   K = 27). Device times (CUDA events behind a sleep
   kernel, so that the host's enqueue rate does not set them), timed in
   turns with the plain version and the yardsticks: for K1 the binary-search
   kernel and, for positions, `torch.searchsorted(out_int32=True)`;
   for f32 K2 the earlier kernel, for bf16 K2 and K4 the SIMT kernel, and one
   matmul on the pre-gathered rows (not the same function: it shows what
   the GEMM alone costs), for K3 the scalar kernel. Each time is printed
   beside its bound (FLOPs over the peak, bytes over the memory rate, from
   the real map's hits) and its share of it.
4. The backward kernels, the same way, on the maps of one scan (batch 1)
   and of the batch-8 training batch: K4 (weight gradient) at every
   (C, E, K) of the training path in f32 and bf16, bitwise equal over two
   runs; K2 as dFeats on a reversed self map and on an inverted k3 s2 map
   (the inverse map card vs CPU exactly), and K2's training forward at
   s16 C128 E128 (at batch 8 its 128 x 128 tile).
5. Inference: `init_detector(fcaf3d_scannet())` in bf16 and
   `inference_detector` on three 100 000-point scans, with zero overflow,
   every inference kernel launched, every bf16 K2 launch on the tensor
   cores, every f32 K2 launch on the narrow or tiled kernel, every K1
   launch on the gallop kernel and every K3 launch on the vector kernel
   (launches by variant printed); the warm-up
   scan's K1 calls, each distinct one exact against plain and the
   earlier kernel and timed beside them; then one scan in f32 on the card
   against the plain path on the CPU (voxel keys and backbone kernel maps exactly
   equal, detections equal within tolerance), and that scan's K2 calls
   replayed on the card, as the path runs them and on the earlier kernel.
6. Training: `create_train_state` / `make_train_step` at `fcaf3d_scannet`
   in bf16, batch 8 of crowded synthetic scenes (50 000 raw points each,
   sampled to 100 000): one warm-up step (its K1 calls checked and timed
   as in phase 5), five timed steps with finite losses, a live box loss,
   zero overflow, finite non-zero gradients on every conv kernel, K1-K4
   launched and the variant gate of phase 5; then f32 steps on the card
   against the CPU plain path: `fcaf3d_tiny` at batch 2 (every gradient
   element within 1e-3 of its leaf's largest) and `fcaf3d_scannet` at
   batch 1 (kernel maps and pruned neck maps exactly equal, losses within
   1e-5, each gradient leaf within 5% in L2 norm), their f32 K2 launches
   on the narrow or tiled kernel and K1 on the gallop kernel.
7. K5 (farthest-point sampling) and K6 (ball query) against their plain
   versions at every shape of the VoteNet-v2 path (SA1-SA4, the seeds and
   the vote aggregation on two 20 000-point scans), at batch 1 and at
   batch 2 with a valid mask: exactly equal; plus S above the valid count,
   N beyond shared memory, N beyond the K5 cluster's registers, lattice tie
   clouds (SA1 and each side of every `fps_plan` boundary), every K5
   cluster size of the sweep at SA1; K6 also equal to its first kernel at
   every shape, and on edge clouds (N % 4 != 0, N below one tile, M off
   the CTA's centres, nsample above N, points at exactly r^2, masked and
   not, centres without a hit). Times at batch 1; K5's beside its
   single-CTA kernel (the earlier one), the operations bound and the
   serial floor (the cluster kernel at the plan's cluster and CTA size
   with one point a thread, on a cloud with one valid point a CTA: S - 1
   steps of the protocol alone); K6's beside its first kernel (one warp a
   centre), summed over a scan's five calls, and each call's host enqueue
   time beside the first kernel's.
8. VoteNet-v2 inference: `init_votenet(votenet_sunrgbd())` in f32 and
   `inference_votenet` on three 20 000-point scans, non-empty detections,
   five K5 and five K6 launches per scan, every K5 launch on the cluster
   kernel and every K6 launch on the tiled kernel; then one scan in f32 on
   the card against the CPU (every FPS and SA1-SA4 group exactly equal,
   aggregation groups equal but for members within 1e-4 of r^2, detections
   within tolerance), one scan in "vote" mode, and the scans' wall, FPS and
   ball-query device time with K5 and K6 against the kernels they replaced,
   in turns.

Output: progress lines, then a JSON line of per-kernel results (launches
of each main path: FCAF3D inference, FCAF3D training, VoteNet inference;
K1-K6 also by variant; the recorded shape's times, bound and share; K1 at
every distinct call of the two FCAF3D paths, K2 at every f32 path shape and
over the f32 scan, K3 at both stem pool maps, K6 at every VoteNet shape),
the `nvidia-smi` name/power-limit line, and last `{"ok": true, ...}`.

Two further modes measure instead of checking (device and build first):

    python3 chip_smoke.py --profile         # kernel profile of a bf16
                                            # inference scan; stage split
                                            # and kernel profile of a
                                            # VoteNet scan and of the
                                            # batch-8 bf16 train step
    python3 chip_smoke.py --grad-control 3  # f32 ScanNet gradients, seeds
                                            # 0-2: card vs CPU against CPU vs
                                            # CPU with colours x (1 + 1e-6)
"""
import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
SCAN_POINTS = 50000  # raw points per synthetic ScanNet-like scan
K2_SHAPES = ((3, 64, 27), (1, 8, 27), (64, 64, 27), (256, 512, 1),
             (512, 512, 27), (128, 128, 27))
# K2 tolerances, relative to the largest reference value: f32 differs only
# by summation order; the bf16 plain version rounds each offset chunk and
# the pre-epilogue sum to bf16, the kernel only its output
K2_RTOL = {"float32": 1e-4, "bfloat16": 2e-2}
# the epilogue each K2 shape has on the main path (timed)
PATH_VARIANT = {(3, 64, 27): "plain sum", (1, 8, 27): "plain sum",
                (64, 64, 27): "act=relu add=True",
                (256, 512, 1): "act=None add=False",
                (512, 512, 27): "act=relu add=True",
                (128, 128, 27): "act=relu add=True"}
# the f32 slice on the card against the CPU plain path
BOX_ATOL, SCORE_ATOL = 1e-3, 1e-4
# K4 at every (C, E, K) of the training path, with the map that gives that
# shape its rows (neck levels: the backbone map of that stride padded to the
# neck budget, a subset of the pruned neck map)
K4_SHAPES = (
    ((3, 64, 27), "s1_k3s2"), ((64, 64, 27), "s8_k3s1"),
    ((64, 128, 27), "s8_k3s2"), ((128, 128, 27), "s16_k3s1"),
    ((128, 256, 27), "s16_k3s2"), ((256, 256, 27), "s32_k3s1"),
    ((256, 512, 27), "s32_k3s2"), ((512, 512, 27), "s64_k3s1"),
    ((64, 64, 1), "s4_k1s2"), ((64, 128, 1), "s8_k1s2"),
    ((128, 256, 1), "s16_k1s2"), ((256, 512, 1), "s32_k1s2"),
    ((64, 64, 27), "neck_s8"), ((128, 128, 27), "neck_s16"),
    ((256, 256, 27), "neck_s32"), ((64, 128, 27), "neck_s8"),
    ((128, 128, 27), "neck_s16"), ((256, 128, 27), "neck_s32"),
    ((512, 128, 27), "s64_k3s1"))
# K4 tolerance relative to the largest |dW|, both dtypes: both sides sum f32
# products of the same (bf16-exact) inputs, in another order
K4_RTOL = 1e-4
TRAIN_BATCH, TRAIN_STEPS = 8, 5
TRAIN_BOXES, TRAIN_BOX_POINTS, TRAIN_FLOOR_POINTS = 20, 2400, 2000
# f32 train steps on the card against the CPU plain path. At fcaf3d_tiny
# (batch 2) the gate is tight: every gradient element within 1e-3 of its
# leaf's largest |g|, as the CPU port holds to `jax.grad`. At ScanNet size
# the deep gradients at random init are chaotic in ReLU flips (on the CPU
# alone, colours x (1 + 1e-6) move whole leaves by ~1% in L2 norm:
# `--grad-control`), so that step is a loose sanity gate on each leaf's
# difference in L2 norm relative to the leaf's norm
TRAIN_LOSS_RTOL, TINY_GRAD_RTOL, TRAIN_GRAD_RTOL = 1e-5, 1e-3, 5e-2
TINY_EXTENT = (0.6, 0.6, 0.3)  # scene extent that the tiny budgets hold
VOTE_SCANS = 3  # VoteNet-v2 scans at votenet_sunrgbd
# the f32 VoteNet slice card vs CPU: aggregation-group members may flip
# within AGG_D2_TOL of r^2 (its centres are an MLP output); detections of
# proposals with equal groups within BOX_ATOL / SCORE_ATOL
AGG_D2_TOL = 1e-4
# published dense peaks of one H100 SXM: a kernel's bound is the larger of
# its operations over the peak of their type (bf16 on the tensor cores;
# float32 and integer work on the CUDA cores) and its bytes over the memory
# rate
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12
SLEEP_CYCLES = 20_000_000  # ~10 ms of device clock ahead of timed launches
# a sleep ahead of each timed FPS / ball query in a VoteNet scan, longer
# than the host's enqueue of one call
TURN_SLEEP_CYCLES = 1_000_000
FPS_OPS = 9  # per K5 distance update: 3 sub, 3 mul, 2 add, 1 min
FPS_SWEEP = (2, 4, 8, 16)  # K5 cluster sizes tried at SA1
K1_EDGE_RUN = 7  # K1 gallop rows a thread on the edge clouds
K1_EDGE_LINE = 16  # K1 edge clouds' L: N < L, N = 1 mod L, runs across L
FPS_TIE_S = 64  # samples of the K5 tie clouds at the plan's boundaries
BALLQ_OPS = 9  # per K6 point scanned: 3 sub, 3 mul, 2 add, 1 compare
# (what, kernel ms, SIMT ms, plain ms) of every bf16 K2/K4 path shape where
# the tensor-core kernel is not faster than its plain version and the SIMT
# one: printed at the end, for PERF.md
NOT_FASTER = []
# which kernels each main path runs
PATH_KERNELS = {
    "fcaf3d_inference": ("searchsorted", "gather_gemm", "gather_max"),
    "fcaf3d_training": ("searchsorted", "gather_gemm", "gather_max",
                        "gather_dw"),
    "votenet_inference": ("fps", "ball_query"),
}


_T0 = time.perf_counter()


def log(msg):
    """Print a progress line; phase headers ("== ...") carry the seconds
    since the script started."""
    if msg.startswith("== "):
        msg = f"{msg} [{time.perf_counter() - _T0:.1f} s]"
    print(msg, flush=True)


def device_phase(torch):
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(f"== 1 device: {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}; nvidia-smi: {smi}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


def build_phase():
    from fcaf3d_tpu_torch import _native

    t0 = time.perf_counter()
    path, build_log = _native.build()
    dt = time.perf_counter() - t0
    _native.load()
    log(f"== 2 build: {dt:.2f} s -> {os.path.relpath(path, REPO)}")
    for line in build_log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"   ptxas: {line.strip()}")


def scan(seed):
    """One synthetic ScanNet-like scan [SCAN_POINTS, 6] (xyz + rgb)."""
    from fcaf3d_tpu_torch.data.synth import synth_scene

    xyz, rgb = synth_scene(np.random.RandomState(seed), SCAN_POINTS)
    return np.concatenate([xyz, rgb], axis=1)


def sample(points, cfg, seed=0):
    """One scan's points sampled to `cfg.num_points` as `inference_detector`
    samples them."""
    rng = np.random.default_rng(seed)
    return points[rng.choice(len(points), cfg.num_points,
                             replace=len(points) < cfg.num_points)]


def backbone_maps(clouds, cfg, device):
    """The voxel keys and every kernel map the backbone builds for a batch
    of sampled clouds [B, N, 6] (xyz + rgb). The maps depend only on
    coordinates, so this replays `MEResNet3D`'s map construction."""
    import torch

    from fcaf3d_tpu_torch.ops.sparse import (
        SparseTensor, build_kernel_map, build_kernel_map_self, conv_plan,
        downsample_coords, kernel_offsets, voxelize)

    p = torch.as_tensor(clouds[..., :3].astype(np.float32), device=device)
    c = torch.as_tensor(clouds[..., 3:6].astype(np.float32), device=device)
    valid = torch.ones(p.shape[:2], dtype=torch.bool, device=device)
    st = voxelize(p, c, valid, cfg.voxel_size, cfg.input_budget)
    maps = {"voxel_keys": (st.keys, None)}

    def coords_only(coords, keys, stride, shift):
        empty = torch.empty(coords.shape[:2] + (0,), device=device)
        return SparseTensor(coords=coords, feats=empty, keys=keys,
                            shift=shift, stride=stride)

    b2, b4, *stage_budgets = cfg.backbone_budgets
    oc, ok, idx, _ = conv_plan(st, 3, 2, b2)
    maps["s1_k3s2"] = (idx, st.capacity)
    x = coords_only(oc, ok, 2, st.shift)
    oc, ok, _ = downsample_coords(x, 2, b4)
    maps["s2_pool_k2s2"] = (build_kernel_map(x.keys, oc,
                                             kernel_offsets(2, 2)), x.capacity)
    x = coords_only(oc, ok, 4, st.shift)
    for budget in stage_budgets[:cfg.n_outs]:
        s = x.stride
        oc, ok, idx, _ = conv_plan(x, 3, 2, budget)
        maps[f"s{s}_k3s2"] = (idx, x.capacity)
        maps[f"s{s}_k1s2"] = (build_kernel_map(x.keys, oc,
                                               kernel_offsets(1, s)),
                              x.capacity)
        maps[f"s{2 * s}_k3s1"] = (build_kernel_map_self(ok, oc, 2 * s),
                                  oc.shape[1])
        maps[f"s{2 * s}_keys"] = (ok, None)
        x = coords_only(oc, ok, 2 * s, st.shift)
    return maps


def neck_maps(torch, maps, cfg):
    """Self maps at the neck levels' shapes: the backbone keys of stride s
    (which the pruned neck map always keeps) padded to the neck budget."""
    from fcaf3d_tpu_torch.ops.sparse import (
        SENTINEL, build_kernel_map_self, decode_coords)

    out = {}
    for s, budget in zip((8, 16, 32), cfg.neck_budgets):
        keys = maps[f"s{s}_keys"][0]
        pad = torch.full((keys.shape[0], budget - keys.shape[1]), SENTINEL,
                         dtype=keys.dtype, device=keys.device)
        keys = torch.cat([keys, pad], dim=1)
        out[f"neck_s{s}"] = (build_kernel_map_self(keys, decode_coords(keys),
                                                   s), budget)
    return out


def cuda_ms(torch, fn, reps=10):
    """Mean device time of `fn` over `reps` launches (CUDA events), after
    one warm-up. A sleep kernel ahead of the timed launches holds the device
    while the host enqueues them, so that the time is the device's and not
    the host's enqueue rate (which sets the pace of back-to-back calls at
    shapes near launch latency), as long as the enqueue fits in the sleep."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def enqueue_us(torch, fn, reps=50):
    """Host microseconds that a call of `fn` takes to return (its enqueue),
    after one warm-up, while a sleep kernel holds the device so that no call
    waits for the card."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / reps * 1e6


def host_turns(torch, fns, reps=50):
    """`enqueue_us` of each of `fns` (name -> callable), in turns as
    `timed_turns` takes them. Returns name -> (mean, first, second)."""
    times = {name: [] for name in fns}
    for name in list(fns) + list(reversed(fns)):
        times[name].append(enqueue_us(torch, fns[name], reps))
    return {name: (sum(t) / len(t), t[0], t[1]) for name, t in times.items()}


def timed_turns(torch, fns, reps=10):
    """Device ms of each of `fns` (name -> callable), timed in turns: in
    order, then in reverse order (plain, kernel, ..., kernel, plain). Returns
    name -> (mean, first reading, second reading)."""
    times = {name: [] for name in fns}
    for name in list(fns) + list(reversed(fns)):
        times[name].append(cuda_ms(torch, fns[name], reps))
    return {name: (sum(t) / len(t), t[0], t[1]) for name, t in times.items()}


def count_hits(idx, n):
    """Hits (entries < N) of a kernel map [B, M, K], per offset."""
    return [int(v) for v in (idx < n).sum(dim=(0, 1)).tolist()]


def gemm_work(idx, n, c, e, elt, epilogue=False, add=False,
              weight_grad=False):
    """(operations, bytes) of K2 on a map [B, M, K] over N input rows, or of
    K4 with `weight_grad`: 2 * hits * C * E FLOPs, and each input read once
    and each output written once: feats [B, N, C] and the map, then for K2
    W [K, C, E], the epilogue's scale, shift and vmask, `add` [B, M, E] and
    out [B, M, E] (elt bytes an element), for K4 dout [B, M, E] and dW
    [K, C, E] in float32."""
    b, m, k = idx.shape
    flops = 2 * sum(count_hits(idx, n)) * c * e
    nbytes = b * n * c * elt + b * m * k * 4
    if weight_grad:
        return flops, nbytes + b * m * e * elt + k * c * e * 4
    nbytes += k * c * e * elt + b * m * e * elt
    if epilogue:
        nbytes += 2 * e * 4 + b * m
    if add:
        nbytes += b * m * e * elt
    return flops, nbytes


def bound(ops, nbytes, peak):
    """(bound_ms, what bounds it): the larger of `ops` over `peak` and
    `nbytes` over the memory rate."""
    t_ops, t_bytes = ops / peak * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def timing_record(times, work, peak):
    """The kernel's timing record: its ms, the yardsticks' ms, its bound
    and share of the bound, from `timed_turns` output and (ops, bytes)."""
    bound_ms, by = bound(*work, peak)
    rec = {"ms": times["kernel"][0], "bound_ms": bound_ms, "bound_by": by,
           "share": bound_ms / times["kernel"][0],
           "library_ms": times["library"][0] if "library" in times else None}
    for name in ("plain", "simt", "gemm_only", "earlier"):
        if name in times:
            rec[f"{name}_ms"] = times[name][0]
    if "floor" in times:
        rec["serial_floor_ms"] = times["floor"][0]
        rec["serial_share"] = times["floor"][0] / times["kernel"][0]
    return rec


def report(rec):
    """One log fragment of a timing record."""
    out = f"kernel {rec['ms']:.4f} ms"
    for name in ("earlier", "simt", "plain", "library", "gemm_only"):
        if rec.get(f"{name}_ms") is not None:
            out += f", {name} {rec[f'{name}_ms']:.4f}"
    if "gemm_only_ms" in rec:
        out += " (gemm_only: one matmul on the pre-gathered rows, not the " \
               "same function)"
    out += (f"; bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}), "
            f"share {rec['share']:.3f}")
    if "serial_floor_ms" in rec:
        out += (f"; serial floor {rec['serial_floor_ms']:.4f} ms, share "
                f"{rec['serial_share']:.3f}")
    return out


def tc_yardsticks(what, rec):
    """Record `what` in NOT_FASTER when a tensor-core kernel's time is not
    below its plain version's and the SIMT kernel's."""
    if rec["ms"] >= min(rec["plain_ms"], rec["simt_ms"]):
        NOT_FASTER.append((what, rec["ms"], rec["simt_ms"], rec["plain_ms"]))
        log(f"   NOT FASTER: {what}")


def k1_case(torch, name, kk, qq, miss, shapes=None, time_plain=True):
    """K1 (the gallop kernel) exactly equal to its plain version and to the
    earlier binary-search kernel on keys `kk` [B, N] and queries `qq`, timed in
    turns with the earlier kernel, the plain version unless `time_plain` is
    false and, for positions, `torch.searchsorted(out_int32=True)`
    (checked equal too). Returns the timing record (with the plan); adds it
    to `shapes` under `name`."""
    from fcaf3d_tpu_torch.ops.sparse import search

    got = search.searchsorted_segments(kk, qq, with_miss=miss, layout="ms")
    want = search.searchsorted_segments_plain(kk, qq, with_miss=miss)
    old = search.searchsorted_segments(kk, qq, with_miss=miss, layout="ms",
                                       _variant="binary")
    torch.cuda.synchronize()
    err = int((got.long() - want.long()).abs().max()) if got.numel() else 0
    if not (torch.equal(got, want) and torch.equal(old, want)):
        raise AssertionError(f"K1 {name}: kernel != plain (max abs diff "
                             f"{err}) or the earlier kernel != plain")
    fns = {"kernel": lambda: search.searchsorted_segments(
               kk, qq, with_miss=miss, layout="ms"),
           "earlier": lambda: search.searchsorted_segments(
               kk, qq, with_miss=miss, layout="ms", _variant="binary")}
    if time_plain:
        fns["plain"] = lambda: search.searchsorted_segments_plain(
            kk, qq, with_miss=miss)
    flat = qq.reshape(qq.shape[0], -1)
    if not miss:  # the positions alone: one library call computes them
        lib = torch.searchsorted(kk, flat, out_int32=True)
        if not torch.equal(lib.reshape(got.shape), got):
            raise AssertionError(f"K1 {name}: torch.searchsorted != K1")
        fns["library"] = lambda: torch.searchsorted(kk, flat, out_int32=True)
    times = timed_turns(torch, fns)
    # bytes: keys, queries (int64) and out (int32); operations: one
    # compare per step of a binary search, on the CUDA cores
    q_n, n_keys = flat.numel(), kk.numel()
    steps = int(np.ceil(np.log2(kk.shape[1] + 1)))
    r = timing_record(times, (q_n * steps, 8 * n_keys + 12 * q_n),
                      PEAK_OPS["float32"])
    r["max_abs_err"] = err
    b = kk.shape[0]
    m, s = (qq.shape[1], qq.shape[2]) if qq.dim() == 3 else (q_n // b, 1)
    r["plan"] = search.k1_gallop_plan(b, m, s)
    r["shape"] = [list(kk.shape), list(qq.shape), miss]
    spread = ", ".join(f"{k} {v[1]:.4f}/{v[2]:.4f}" for k, v in times.items())
    log(f"   K1 {name} {tuple(qq.shape)} in N={kk.shape[1]}"
        f"{', with_miss' if miss else ''}: exact (and the earlier kernel); "
        f"{r['plan']} rows a thread; {report(r)}; readings {spread}")
    if r["ms"] >= min(r["earlier_ms"], r.get("library_ms") or np.inf):
        NOT_FASTER.append((f"K1 {name}", r["ms"], r["earlier_ms"],
                           r.get("library_ms")))
        log(f"   NOT FASTER: K1 {name}")
    if shapes is not None:
        shapes[name] = {k: r.get(k) for k in (
            "shape", "plan", "ms", "earlier_ms", "plain_ms", "library_ms",
            "bound_ms", "share")}
    return r


def k1_edge_keys(line, rng):
    """(name, keys [2, N] int64) of K1's edge clouds for a line of `line`
    keys: N = 1, N < L, N = 1 mod L, runs of equal keys across every L-th
    key, a compaction cumsum with a long flat run and a flat tail."""
    sent = 0xFFFFFFFF
    n = 8 * line + 3
    mask = rng.random((2, 10 * line + 7)) < 0.3
    mask[:, 4 * line:6 * line] = False
    mask[:, -3 * line:] = False
    return [
        ("N = 1", np.array([[5], [sent]])),
        ("N < L", np.sort(rng.integers(1, 50, (2, line // 2 + 1)), axis=1)),
        ("N = 1 mod L", np.sort(rng.integers(1, 2 ** 20, (2, 3 * line + 1)),
                                axis=1)),
        ("runs across every L-th key", np.stack([
            (np.arange(n) + line // 2) // line + 1,
            (np.arange(n) + 5) // (3 * line) * 7 + 2])),
        ("compaction cumsum", np.cumsum(mask, axis=1)),
    ]


def k1_edge_queries(keys, rng, m=512):
    """[B, m, 3] queries on `keys`: the keys themselves and their
    neighbours, values below the first and above the last key, SENTINEL."""
    sent = 0xFFFFFFFF
    b, n = keys.shape
    pick = rng.integers(0, n, (b, m))
    q = rng.integers(0, sent, (b, m, 3)).astype(np.int64)
    q[:, :, 0] = np.take_along_axis(keys, pick, 1)
    q[:, :, 1] = q[:, :, 0] + rng.integers(-1, 2, (b, m))
    q[:, :3, 2] = [0, sent - 1, sent]
    q[:, -5:, :] = sent
    return np.clip(q, 0, sent)


def k1_phase(torch, cfg, maps):
    """K1 at the s8 self-map lookup (with_miss and positions) and the voxel
    compaction (`k1_case`); both variants on the edge clouds (random-order
    and all-SENTINEL queries), exactly equal to plain. Returns the s8
    positions record."""
    from fcaf3d_tpu_torch.ops.sparse import (
        SENTINEL, decode_coords, encode_coords, kernel_offsets)
    from fcaf3d_tpu_torch.ops.sparse import search

    dev = maps["voxel_keys"][0].device
    s8_keys = maps["s8_keys"][0]
    q = encode_coords(decode_coords(s8_keys)[:, :, None, :] + torch.as_tensor(
        kernel_offsets(3, 8), device=dev)).contiguous()
    # compaction: source row of the j-th valid voxel, as compact_positions
    csum = torch.cumsum((maps["voxel_keys"][0] != SENTINEL).int(), dim=1)
    csum = csum.long().contiguous()
    qc = torch.arange(1, cfg.backbone_budgets[0] + 1, device=dev)
    qc = qc[None, :, None].contiguous()
    shapes = {}
    k1_case(torch, "s8 self-map lookup", s8_keys, q, True, shapes)
    rec = k1_case(torch, "s8 self-map lookup, positions", s8_keys, q, False,
                  shapes)
    k1_case(torch, "voxel keys compaction", csum, qc, False, shapes)
    rec["shapes"] = shapes

    rng = np.random.default_rng(0)
    n_edge = 0
    for name, keys in k1_edge_keys(K1_EDGE_LINE, rng):
        kk = torch.as_tensor(keys.astype(np.int64), device=dev)
        for qq in (k1_edge_queries(keys, rng),
                   np.full((2, 64, 1), SENTINEL, np.int64)):
            qq = torch.as_tensor(qq, device=dev)
            for variant, plan in (("gallop", None), ("gallop", K1_EDGE_RUN),
                                  ("binary", None)):
                for miss in (False, True):
                    got = search.searchsorted_segments(
                        kk, qq, with_miss=miss, layout="ms",
                        _variant=variant, _plan=plan)
                    want = search.searchsorted_segments_plain(kk, qq, miss)
                    torch.cuda.synchronize()
                    if not torch.equal(got, want):
                        raise AssertionError(
                            f"K1 {variant} ({plan} rows a thread) edge "
                            f"{name}, L={K1_EDGE_LINE}, with_miss={miss}: "
                            "!= plain")
                    n_edge += 1
    log(f"   K1 edge clouds (N = 1, N < L, N = 1 mod L, runs across every "
        f"L-th key, a compaction cumsum; random-order and all-SENTINEL "
        f"queries) at L = {K1_EDGE_LINE}, gallop at the plan's and at "
        f"{K1_EDGE_RUN} rows a thread, binary: {n_edge} cases exact")
    return rec


def kernel_phase(torch, cfg, maps, maps8):
    from fcaf3d_tpu_torch.ops.sparse import gather_kernel as gk

    dev = maps["voxel_keys"][0].device
    gen = torch.Generator(device=dev).manual_seed(0)
    rec = {}

    rec["searchsorted"] = k1_phase(torch, cfg, maps)
    # K2 at every (C, E, K) of the path, on that shape's real map
    map_for = {(3, 64, 27): "s1_k3s2", (1, 8, 27): "s16_k3s1",
               (64, 64, 27): "s8_k3s1", (256, 512, 1): "s32_k1s2",
               (512, 512, 27): "s64_k3s1", (128, 128, 27): "s16_k3s1"}
    k2_err = {"float32": 0.0, "bfloat16": 0.0}
    f32_shapes = {}
    for (c, e, k) in K2_SHAPES:
        idx, n = maps[map_for[(c, e, k)]]
        b, m, _ = idx.shape
        for dname in ("float32", "bfloat16"):
            dt = getattr(torch, dname)
            feats = torch.randn(b, n, c, generator=gen, device=dev).to(dt)
            w = (torch.randn(k, c, e, generator=gen, device=dev)
                 / np.sqrt(k * c)).to(dt)
            scale = torch.rand(e, generator=gen, device=dev) + 0.5
            shift = torch.randn(e, generator=gen, device=dev) * 0.1
            add = torch.randn(b, m, e, generator=gen, device=dev).to(dt)
            vmask = torch.rand(b, m, generator=gen, device=dev) < 0.9
            variants = [("plain sum", {})]
            for act in (None, "relu", "elu"):
                for with_add in (False, True):
                    variants.append((f"act={act} add={with_add}", dict(
                        scale=scale, shift=shift, act=act, vmask=vmask,
                        add=add if with_add else None)))
            for vname, kw in variants:
                got = gk.fused_gather_gemm(feats, idx, w, **kw)
                want = gk.fused_gather_gemm_plain(feats, idx, w, **kw)
                torch.cuda.synchronize()
                ref = want.float()
                diff = float((got.float() - ref).abs().max())
                tol = K2_RTOL[dname] * max(float(ref.abs().max()), 1.0)
                if not (diff <= tol and torch.isfinite(got).all()):
                    raise AssertionError(
                        f"K2 C={c} E={e} K={k} {dname} {vname}: max abs "
                        f"diff {diff} > {tol}")
                if dname == "float32":
                    k2_equal_simt(torch, got, feats, idx, w, kw,
                                  f"C={c} E={e} K={k} {vname}")
                k2_err[dname] = max(k2_err[dname], diff)
            kw = dict(variants)[PATH_VARIANT[(c, e, k)]]
            r = k2_timing(torch, feats, idx, w, kw, dname)
            log(f"   K2 C={c} E={e} K={k} {dname} idx {tuple(idx.shape)} "
                f"N={n}: {len(variants)} variants ok (max abs diff so far "
                f"{k2_err[dname]:.3g}); {r['variant']}: {report(r)}")
            if dname == "bfloat16":
                tc_yardsticks(f"K2 C={c} E={e} K={k} "
                              f"{PATH_VARIANT[(c, e, k)]}", r)
            if dname == "float32":
                f32_shapes[f"C{c} E{e} K{k}"] = {key: r[key] for key in (
                    "variant", "tile", "ms", "earlier_ms", "plain_ms",
                    "gemm_only_ms", "bound_ms", "bound_by", "share")}
                if not r["ms"] < min(r["earlier_ms"], r["plain_ms"]):
                    NOT_FASTER.append((f"K2 f32 C={c} E={e} K={k}", r["ms"],
                                       r["earlier_ms"], r["plain_ms"]))
                    log(f"   NOT FASTER than the earlier kernel and plain: K2 "
                        f"f32 C={c} E={e} K={k}")
            if (c, e, k, dname) == (64, 64, 27, "bfloat16"):
                rec["gather_gemm"] = r
    rec["gather_gemm"]["max_abs_err"] = k2_err["bfloat16"]
    rec["gather_gemm"]["max_abs_err_f32"] = k2_err["float32"]
    rec["gather_gemm"]["f32_shapes"] = f32_shapes
    k2_off_granule(torch, maps, gen)

    rec["gather_max"] = k3_phase(torch, maps, maps8, gen)
    return rec


def k3_phase(torch, maps, maps8, gen):
    """K3 (the vector kernel) exactly equal (`torch.equal`) to its plain
    version and to the first kernel (`_variant="scalar"`) on the stem pool
    map at batch 1 and batch 8, in f32 and bf16, timed in turns beside both;
    then on edge cases: C off the 16-byte vector, all-miss rows and ties.
    Returns the batch-1 bf16 record with every shape's times."""
    from fcaf3d_tpu_torch.ops.sparse import gather_kernel as gk

    def exact(feats, idx, what):
        got = gk.fused_gather_max(feats, idx)
        want = gk.fused_gather_max_plain(feats, idx)
        old = gk.fused_gather_max(feats, idx, _variant="scalar")
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        if not (torch.equal(got, want) and torch.equal(old, want)):
            raise AssertionError(f"K3 {what}: kernel != plain (max abs diff "
                                 f"{err}) or the first kernel != plain")
        return err

    k3_err, shapes, rec = 0.0, {}, None
    for batch, (idx, n) in ((1, maps["s2_pool_k2s2"]),
                            (TRAIN_BATCH, maps8["s2_pool_k2s2"])):
        for dname in ("float32", "bfloat16"):
            dt = getattr(torch, dname)
            feats = torch.randn(idx.shape[0], n, 64, generator=gen,
                                device=idx.device).to(dt)
            k3_err = max(k3_err, exact(feats, idx, f"B={batch} {dname}"))
            times = timed_turns(torch, {
                "plain": lambda: gk.fused_gather_max_plain(feats, idx),
                "kernel": lambda: gk.fused_gather_max(feats, idx),
                "earlier": lambda: gk.fused_gather_max(feats, idx,
                                                       _variant="scalar")})
            # bytes: feats, the map and out; operations: one max per gathered
            # element, on the CUDA cores
            b, m, k = idx.shape
            elt = feats.element_size()
            r = timing_record(times, (b * m * k * 64, b * n * 64 * elt
                                      + b * m * k * 4 + b * m * 64 * elt),
                              PEAK_OPS["float32"])
            r["variant"] = gk.k3_plan(64, k, dt).variant
            log(f"   K3 {dname} idx {tuple(idx.shape)} N={n} C=64: exact (and "
                f"the first kernel); {r['variant']}: {report(r)}")
            shapes[f"B{batch} {dname}"] = {key: r[key] for key in (
                "variant", "ms", "earlier_ms", "plain_ms", "bound_ms",
                "bound_by", "share")}
            if r["ms"] >= r["earlier_ms"]:
                NOT_FASTER.append((f"K3 B={batch} {dname}", r["ms"],
                                   r["earlier_ms"], r["plain_ms"]))
                log(f"   NOT FASTER than the first kernel: K3 B={batch} "
                    f"{dname}")
            if (batch, dname) == (1, "bfloat16"):
                rec = r
    # edge cases on the batch-1 map: C off the 16-byte vector (every narrower
    # vector width), all-miss rows, ties (few distinct values), and K = 27
    idx, n = maps["s2_pool_k2s2"]
    idx27, n27 = maps["s1_k3s2"]
    cases = 0
    for dname, channels in (("float32", (1, 3, 6, 10, 64)),
                            ("bfloat16", (1, 3, 12, 20, 68))):
        dt = getattr(torch, dname)
        for c in channels:
            for kidx, kn in ((idx, n), (idx27, n27)):
                miss = kidx.clone()
                miss[:, ::7] = kn  # every 7th row: all miss
                ties = torch.randint(-2, 3, (1, kn, c), generator=gen,
                                     device=idx.device).to(dt)
                k3_err = max(k3_err, exact(ties, miss, f"{dname} C={c} K="
                                           f"{kidx.shape[2]} edge"))
                cases += 1
    log(f"   K3 edge cases exact (and the first kernel): {cases} (C off the "
        "16-byte vector, every 7th row all miss, values in -2..2, K 8 and 27)")
    rec["max_abs_err"] = k3_err
    rec["shapes"] = shapes
    return rec


def k2_equal_simt(torch, got, feats, idx, w, kw, what):
    """`got` (K2 as the path runs it) equal to the earlier kernel on the same
    inputs: the f32 kernels keep its arithmetic."""
    from fcaf3d_tpu_torch.ops.sparse import gather_kernel as gk

    old = gk.fused_gather_gemm(feats, idx, w, **kw, _variant="simt")
    torch.cuda.synchronize()
    if not torch.equal(got, old):
        diff = float((got.float() - old.float()).abs().max())
        k, c, e = w.shape
        raise AssertionError(f"K2 {feats.dtype} {what}: "
                             f"{gk.k2_variant(c, e, k, feats.dtype)} != the "
                             f"earlier kernel (max abs diff {diff})")


def k2_off_granule(torch, maps, gen):
    """K2 at shapes off the path's: bf16 where the tensor-core kernels do
    not take it (E or C off the 8-channel granule), on the narrow and tiled
    kernels, and the same shapes in f32 (C and E off 16 and 64, partial
    channel groups, C and E off the 4-channel granule of 16-byte copies):
    equal to the earlier kernel, within K2_RTOL of plain, three epilogues
    each."""
    from fcaf3d_tpu_torch.ops.sparse import gather_kernel as gk

    # (18, 30): f32 off 16-byte copies, staged 4 bytes at a time
    cases = ((3, 18, "s1_k3s2"), (5, 20, "s16_k3s1"), (20, 64, "s8_k3s1"),
             (64, 36, "s16_k3s1"), (18, 30, "s16_k3s1"))
    for c, e, name in cases:
        idx, n = maps[name]
        b, m, k = idx.shape
        dev = idx.device
        for dname in ("bfloat16", "float32"):
            dt = getattr(torch, dname)
            feats = torch.randn(b, n, c, generator=gen, device=dev).to(dt)
            w = (torch.randn(k, c, e, generator=gen, device=dev)
                 / np.sqrt(k * c)).to(dt)
            epi = dict(scale=torch.rand(e, generator=gen, device=dev) + 0.5,
                       shift=torch.randn(e, generator=gen, device=dev) * 0.1,
                       vmask=torch.rand(b, m, generator=gen, device=dev) < 0.9)
            add = torch.randn(b, m, e, generator=gen, device=dev).to(dt)
            variant = gk.k2_variant(c, e, k, dt)
            if not variant.startswith("simt_"):
                raise AssertionError(f"K2 {dname} C={c} E={e}: variant "
                                     f"{variant}")
            for kw in ({}, dict(epi, act="relu", add=add),
                       dict(epi, act="elu")):
                got = gk.fused_gather_gemm(feats, idx, w, **kw)
                want = gk.fused_gather_gemm_plain(feats, idx, w, **kw).float()
                torch.cuda.synchronize()
                diff = float((got.float() - want).abs().max())
                if not diff <= K2_RTOL[dname] * max(float(want.abs().max()),
                                                    1.0):
                    raise AssertionError(f"K2 {dname} C={c} E={e} {variant}:"
                                         f" max abs diff {diff}")
                k2_equal_simt(torch, got, feats, idx, w, kw, f"C={c} E={e}")
            log(f"   K2 {dname} off the path C={c} E={e} K={k} idx "
                f"{tuple(idx.shape)}: {variant}, 3 epilogues equal to the "
                "earlier kernel and within tolerance of plain")


def k2_timing(torch, feats, idx, w, kw, dname):
    """K2 timed in turns with its plain version, one matmul on the
    pre-gathered rows and the earlier kernel ("earlier" in f32, the f32
    variants' predecessor; "simt" in bf16, the tensor cores'); with its
    bound."""
    from fcaf3d_tpu_torch.ops.sparse import gather_kernel as gk

    b, n, c = feats.shape
    m, k = idx.shape[1:]
    e = w.shape[2]
    fns = {"plain": lambda: gk.fused_gather_gemm_plain(feats, idx, w, **kw),
           "kernel": lambda: gk.fused_gather_gemm(feats, idx, w, **kw)}
    variant = gk.k2_variant(c, e, k, feats.dtype)
    g = gk.gather_rows(feats, idx).reshape(b, m, k * c)
    w2 = w.reshape(k * c, e)
    fns["gemm_only"] = lambda: torch.matmul(g, w2)
    fns["simt" if dname == "bfloat16" else "earlier"] = (
        lambda: gk.fused_gather_gemm(feats, idx, w, **kw, _variant="simt"))
    times = timed_turns(torch, fns)
    work = gemm_work(idx, n, c, e, feats.element_size(),
                     epilogue="scale" in kw, add=kw.get("add") is not None)
    rec = timing_record(times, work, PEAK_OPS[dname])
    rec["variant"] = variant
    if variant != "simt":
        rec["tile"] = list(gk.k2_tiles(variant, b, m, e, k))
    return rec


def compare_f32(torch, cfg, points, device):
    """One scan in f32: the card against the plain path on the CPU, every
    f32 K2 launch on the narrow and tiled kernels and every K1 launch on
    the gallop kernel. Returns the scan's K2 device time (`k2_scan_times`)."""
    from fcaf3d_tpu_torch import _native
    from fcaf3d_tpu_torch.apis import inference_detector, init_detector

    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    cloud = sample(points, cfg32)[None]
    gpu_maps = backbone_maps(cloud, cfg32, device)
    cpu_maps = backbone_maps(cloud, cfg32, "cpu")
    for name, (m, _) in gpu_maps.items():
        if not torch.equal(m.cpu(), cpu_maps[name][0]):
            raise AssertionError(f"f32 slice: {name} differs card vs CPU")
    log(f"   f32: voxel keys and {len(gpu_maps) - 1} backbone maps equal "
        "card vs CPU")
    model = init_detector(cfg32, 0, device=device)
    _native.reset_launches()
    k2_calls = []
    with recorded_k2_calls(k2_calls):
        got, got_ovf = inference_detector(model, points)
    check_variants("f32 inference scan", f32=True)
    want, want_ovf = inference_detector(init_detector(cfg32, 0, device="cpu"),
                                        points)
    n_got, n_want = len(got["scores_3d"]), len(want["scores_3d"])
    if n_got != n_want or got_ovf != want_ovf:
        raise AssertionError(f"f32 slice: {n_got} detections on the card, "
                             f"{n_want} on the CPU (overflow {got_ovf} vs "
                             f"{want_ovf})")
    box_err = float(np.abs(got["boxes_3d"] - want["boxes_3d"]).max(initial=0))
    score_err = float(np.abs(got["scores_3d"] - want["scores_3d"]).max(
        initial=0))
    if not (np.array_equal(got["labels_3d"], want["labels_3d"])
            and box_err <= BOX_ATOL and score_err <= SCORE_ATOL):
        raise AssertionError(f"f32 slice: labels equal "
                             f"{np.array_equal(got['labels_3d'], want['labels_3d'])}"
                             f", box err {box_err} (tol {BOX_ATOL}), score "
                             f"err {score_err} (tol {SCORE_ATOL})")
    log(f"   f32: {n_got} detections equal card vs CPU; max box err "
        f"{box_err:.3g} (tol {BOX_ATOL}), max score err {score_err:.3g} "
        f"(tol {SCORE_ATOL})")
    return k2_scan_times(torch, k2_calls, "the f32 inference scan")


@contextlib.contextmanager
def recorded_k2_calls(calls):
    """Every K2 call of the sparse convs made inside (through
    `ops.sparse.conv`) is appended to `calls` as (args, kwargs)."""
    from fcaf3d_tpu_torch.ops.sparse import conv as sconv

    real = sconv.fused_gather_gemm

    def call(*args, **kw):
        calls.append((args, kw))
        return real(*args, **kw)

    sconv.fused_gather_gemm = call
    try:
        yield
    finally:
        sconv.fused_gather_gemm = real


def k2_scan_times(torch, calls, what):
    """Device ms of a run's recorded K2 calls replayed on their own inputs,
    as the path runs them and on the earlier kernel, in turns."""
    from fcaf3d_tpu_torch.ops.sparse import gather_kernel as gk

    def replay(variant):
        def run():
            with torch.inference_mode():  # as the scan ran them
                for args, kw in calls:
                    gk.fused_gather_gemm(*args, **kw, _variant=variant)
        return run

    times = timed_turns(torch, {"kernel": replay(None),
                                "earlier": replay("simt")}, reps=3)
    rec = {"calls": len(calls), "ms": times["kernel"][0],
           "earlier_ms": times["earlier"][0]}
    log(f"   K2 device time of {what}, its {len(calls)} calls replayed: "
        f"{rec['ms']:.4f} ms (the earlier kernel {rec['earlier_ms']:.4f}); "
        "readings " + ", ".join(f"{k} {v[1]:.4f}/{v[2]:.4f}"
                                for k, v in times.items()))
    return rec


def slice_phase(torch, cfg, scans, device):
    """bf16 inference on every scan after a warm-up scan whose K1 calls are
    checked and timed (`k1_path_phase`); returns launches per kernel, the
    launches by variant (`check_variants`) and the K1 record."""
    from fcaf3d_tpu_torch import _native
    from fcaf3d_tpu_torch.apis import inference_detector, init_detector

    model = init_detector(cfg, seed=0, device=device)
    calls = {}
    with recorded_k1_calls(calls):  # warm-up: cuBLAS and allocator
        inference_detector(model, scans[0])
    torch.cuda.synchronize()
    k1 = k1_path_phase(torch, calls, 1, "one bf16 inference scan")
    _native.reset_launches()
    results = []
    for pts in scans:
        t0 = time.perf_counter()
        dets, overflow = inference_detector(model, pts)
        results.append((time.perf_counter() - t0, dets, overflow))
    launches = dict(_native.LAUNCHES)
    for i, (dt, dets, overflow) in enumerate(results):
        n = len(dets["scores_3d"])
        log(f"   scan {i}: {dt * 1e3:.1f} ms wall, {n} detections, "
            f"overflow {overflow}")
        if any(overflow.values()):
            raise AssertionError(f"scan {i}: budgets dropped voxels "
                                 f"{overflow}")
        boxes = dets["boxes_3d"]
        if n == 0 or boxes.shape != (n, 7) or not np.isfinite(boxes).all() \
                or not np.isfinite(dets["scores_3d"]).all() \
                or not ((dets["labels_3d"] >= 0)
                        & (dets["labels_3d"] < cfg.n_classes)).all():
            raise AssertionError(f"scan {i}: malformed detections")
    log(f"   launches over {len(scans)} scans: {launches}")
    check_path_launches(launches, "fcaf3d_inference")
    return launches, check_variants("bf16 inference", ("gather_gemm",)), k1


def check_variants(what, tc_kernels=(), f32=False):
    """The launches since the last reset of the counts went through the
    path's kernels: every bf16 K2 and K4 launch through a tensor-core
    variant (and each of `tc_kernels` had one), every f32 K2 launch through
    "simt_narrow" / "simt_tiled" (never the first "simt"), every K1 launch
    through the gallop kernel, every K3 launch through the vector kernel
    (never the first "scalar"); with `f32`, at least one f32 K2 and one K1
    launch. Logs and returns the launches by "kernel/variant/dtype"."""
    from fcaf3d_tpu_torch import _native

    counts = {"/".join(key): n
              for key, n in sorted(_native.VARIANT_LAUNCHES.items())}
    log(f"   {what}: K1-K4 launches by variant: {counts}")
    off = {key: n for key, n in counts.items()
           if key.endswith("/simt/bfloat16")
           or key == "gather_gemm/simt/float32"
           or key.startswith("gather_max/scalar/")
           or (key.startswith("searchsorted/")
               and key != "searchsorted/gallop/int64")}
    if off:
        raise AssertionError(f"{what}: launches off the path's kernels: "
                             f"{off}")
    for kernel in tc_kernels:
        if not any(key.startswith(f"{kernel}/tc") and key.endswith("bfloat16")
                   for key in counts):
            raise AssertionError(f"{what}: no bf16 {kernel} launch on the "
                                 "tensor cores")
    if f32 and not (any(key.startswith("gather_gemm/simt_")
                        and key.endswith("/float32") for key in counts)
                    and "searchsorted/gallop/int64" in counts):
        raise AssertionError(f"{what}: no f32 K2 launch on the narrow or "
                             "tiled kernel, or no K1 launch")
    return counts


@contextlib.contextmanager
def recorded_k1_calls(calls):
    """Every K1 call (`search.searchsorted_segments`) made inside is
    counted in `calls` by (site, keys shape, queries shape, with_miss),
    with a copy of its first keys and queries: site is the chain of the
    three callers above it, e.g. "conv_plan/build_kernel_map/lookup"."""
    from fcaf3d_tpu_torch.ops.sparse import search

    real = search.searchsorted_segments

    def call(keys, queries, with_miss=False, layout="sm", **kw):
        f = sys._getframe(1)
        site = "/".join(g.f_code.co_name for g in (
            f.f_back.f_back, f.f_back, f))
        key = (site, tuple(keys.shape), tuple(queries.shape), with_miss)
        if key not in calls:
            calls[key] = [0, keys.clone(), queries.clone()]
        calls[key][0] += 1
        return real(keys, queries, with_miss, layout, **kw)

    search.searchsorted_segments = call
    try:
        yield
    finally:
        search.searchsorted_segments = real


def k1_path_phase(torch, calls, runs, what):
    """K1 at every distinct call of a path recorded over `runs` runs
    (`recorded_k1_calls`): exactly equal to plain and to the earlier kernel,
    timed beside the earlier kernel and `torch.searchsorted` (`k1_case`).
    Returns the
    records by call, each with its launches a run, and the device ms a run
    of K1 and of the earlier kernel summed over the calls."""
    shapes = {}
    for (site, kshape, qshape, miss), (n, kk, qq) in sorted(
            calls.items(), key=lambda kv: -kv[1][2].numel()):
        name = (f"{site} B{kshape[0]} N{kshape[1]} Q{list(qshape[1:])}"
                f"{' with_miss' if miss else ''}")
        k1_case(torch, name, kk, qq, miss, shapes, time_plain=False)
        shapes[name]["launches"] = n / runs
    total = {k: sum(r[k] * r["launches"] for r in shapes.values())
             for k in ("ms", "earlier_ms")}
    log(f"   K1 over the {len(shapes)} distinct calls of {what}: "
        f"{sum(r['launches'] for r in shapes.values()):g} launches a run, "
        f"{total['ms']:.4f} ms of device time a run (the earlier kernel "
        f"{total['earlier_ms']:.4f})")
    return {"calls": shapes, "ms_per_run": total["ms"],
            "earlier_ms_per_run": total["earlier_ms"]}


def check_path_launches(launches, path):
    missing = [k for k in PATH_KERNELS[path] if launches[k] == 0]
    if missing:
        raise AssertionError(f"{path}: kernels never launched: {missing}")


def backward_kernel_phase(torch, cfg, maps_by_batch):
    """K4 against its plain version at every (C, E, K) of the training path
    (f32 and bf16, bitwise repeatable), K2 as dFeats on a reversed self map
    and on an inverted k3 s2 map, and K2's training forward at s16 C128
    E128, on each batch's maps. The record is K4 at s8 C64 E64 bf16 on the
    largest batch."""
    rec = {}
    k4_err = {"float32": 0.0, "bfloat16": 0.0}
    for maps in maps_by_batch:
        maps = {**maps, **neck_maps(torch, maps, cfg)}
        for (c, e, k), name in K4_SHAPES:
            for dname in ("float32", "bfloat16"):
                r, diff = k4_case(torch, maps[name], c, e, dname,
                                  f"{name} C={c} E={e} K={k}")
                k4_err[dname] = max(k4_err[dname], diff)
                if (c, e, k, name, dname) == (64, 64, 27, "s8_k3s1",
                                              "bfloat16"):
                    rec["gather_dw"] = r
        k2_train_case(torch, maps["s8_k3s1"], 64, 64,
                      "dFeats reversed self map")
        k2_train_case(torch, maps["s8_k3s2"], 64, 128,
                      "dFeats inverted k3 s2 map")
        # at batch 8 the forward takes K2's 128 x 128 tile
        k2_train_case(torch, maps["s16_k3s1"], 128, 128, "forward")
    rec["gather_dw"]["max_abs_err"] = k4_err["bfloat16"]
    rec["gather_dw"]["max_abs_err_f32"] = k4_err["float32"]
    return rec


def k4_case(torch, idx_n, c, e, dname, what):
    """K4 against its plain version on one map: within K4_RTOL of the
    largest |dW|, bitwise equal over two runs; timed in turns with its
    plain version and, in bf16, with the SIMT kernel and one matmul on the
    pre-gathered rows. Returns (timing record, max abs diff)."""
    from fcaf3d_tpu_torch.ops.sparse import gather_kernel as gk

    idx, n = idx_n
    b, m, k = idx.shape
    gen = torch.Generator(device=idx.device).manual_seed(b * m + c + e)
    dt = getattr(torch, dname)
    feats = torch.randn(b, n, c, generator=gen, device=idx.device).to(dt)
    dout = torch.randn(b, m, e, generator=gen, device=idx.device).to(dt)
    got = gk.fused_gather_dw(feats, idx, dout)
    again = gk.fused_gather_dw(feats, idx, dout)
    want = gk.fused_gather_dw_plain(feats, idx, dout)
    torch.cuda.synchronize()
    diff = float((got - want).abs().max())
    tol = K4_RTOL * float(want.abs().max())
    if not (diff <= tol and torch.isfinite(got).all()):
        raise AssertionError(f"K4 {what} {dname} B={b}: max abs diff {diff} "
                             f"> {tol}")
    if not torch.equal(got, again):
        raise AssertionError(f"K4 {what} {dname} B={b}: two runs differ")
    fns = {"plain": lambda: gk.fused_gather_dw_plain(feats, idx, dout),
           "kernel": lambda: gk.fused_gather_dw(feats, idx, dout)}
    if dname == "bfloat16":
        g = gk.gather_rows(feats, idx).reshape(b * m, k * c)
        d2 = dout.reshape(b * m, e)
        fns["simt"] = lambda: gk.fused_gather_dw(feats, idx, dout,
                                                 _variant="simt")
        fns["gemm_only"] = lambda: torch.matmul(g.t(), d2)
    times = timed_turns(torch, fns)
    r = timing_record(times, gemm_work(idx, n, c, e, feats.element_size(),
                                       weight_grad=True), PEAK_OPS[dname])
    r["variant"] = gk.k4_variant(c, e, k, dt)
    log(f"   K4 {what} {dname} idx {tuple(idx.shape)} N={n}: ok, bitwise "
        f"repeatable (max abs diff {diff:.3g}, tol {tol:.3g}); "
        f"{r['variant']}: {report(r)}")
    if dname == "bfloat16":
        tc_yardsticks(f"K4 {what} B={b}", r)
    return r, diff


def k2_train_case(torch, idx_n, c, e, how):
    """K2 as the training path calls it, without an epilogue, in f32 and
    bf16: the forward of a conv C -> E on its map ("forward"), or dFeats,
    dout [B, M, E] through the inverse map with W^T ("dFeats reversed self
    map"; "dFeats inverted k3 s2 map", the inverse held card vs CPU
    exactly)."""
    from fcaf3d_tpu_torch.ops.sparse import conv as sconv
    from fcaf3d_tpu_torch.ops.sparse import gather_kernel as gk

    idx, n = idx_n
    b, m, k = idx.shape
    dev = idx.device
    gen = torch.Generator(device=dev).manual_seed(b * m + c + e)
    if how == "forward":
        src, rows, cin, cout = idx, n, c, e
    elif how == "dFeats reversed self map":
        src, rows, cin, cout = idx.flip(-1).contiguous(), m, e, c
    else:
        src, rows, cin, cout = sconv.invert_kernel_map(idx, n), m, e, c
        if not torch.equal(src.cpu(), sconv.invert_kernel_map(idx.cpu(), n)):
            raise AssertionError(f"inverse map B={b} differs card vs CPU")
    for dname in ("float32", "bfloat16"):
        dt = getattr(torch, dname)
        x = torch.randn(b, rows, cin, generator=gen, device=dev).to(dt)
        w = (torch.randn(k, cin, cout, generator=gen, device=dev)
             / np.sqrt(k * cin)).to(dt)
        got = gk.fused_gather_gemm(x, src, w)
        want = gk.fused_gather_gemm_plain(x, src, w)
        torch.cuda.synchronize()
        ref = want.float()
        diff = float((got.float() - ref).abs().max())
        tol = K2_RTOL[dname] * max(float(ref.abs().max()), 1.0)
        if not (diff <= tol and torch.isfinite(got).all()):
            raise AssertionError(f"K2 {how} {dname} B={b}: max abs diff "
                                 f"{diff} > {tol}")
        if dname == "float32":
            k2_equal_simt(torch, got, x, src, w, {}, f"{how} B={b}")
        r = k2_timing(torch, x, src, w, {}, dname)
        log(f"   K2 {how} {dname} map {tuple(src.shape)} C={cin} -> "
            f"E={cout}: ok (max abs diff {diff:.3g}); {r['variant']} "
            f"{r.get('tile', '')}: {report(r)}")
        if dname == "bfloat16":
            tc_yardsticks(f"K2 {how} C={cin} E={cout} B={b}", r)


def train_batch(cfg, batch, seed0):
    """`batch` crowded synthetic scenes (`data.synth`), each 50 000 raw
    points sampled to `cfg.num_points` as `inference_detector` samples,
    with GT boxes padded to `cfg.max_gt_boxes`."""
    from fcaf3d_tpu_torch.data.synth import crowded_scene, densify

    out = {"points": [], "colors": [], "gt_boxes": [], "gt_labels": [],
           "gt_valid": []}
    g = cfg.max_gt_boxes
    for i in range(batch):
        rng = np.random.default_rng(seed0 + i)
        scene = densify(crowded_scene(TRAIN_BOXES, cfg.n_classes, rng,
                                      extent=5.0),
                        TRAIN_BOX_POINTS, TRAIN_FLOOR_POINTS, rng)
        pts = scene["points"]
        pick = np.random.default_rng(0).choice(
            len(pts), cfg.num_points, replace=len(pts) < cfg.num_points)
        out["points"].append(pts[pick, :3])
        out["colors"].append(pts[pick, 3:6])
        n = len(scene["gt_boxes"])
        boxes = np.zeros((g, 7), np.float32)
        labels = np.zeros(g, np.int32)
        boxes[:n], labels[:n] = scene["gt_boxes"], scene["gt_labels"]
        out["gt_boxes"].append(boxes)
        out["gt_labels"].append(labels)
        out["gt_valid"].append(np.arange(g) < n)
    batch_np = {k: np.stack(v) for k, v in out.items()}
    batch_np["valid"] = np.ones(batch_np["points"].shape[:2], bool)
    return batch_np


def train_phase(torch, cfg, batch, device):
    """bf16 training at batch 8: a warm-up step whose K1 calls are checked
    and timed (`k1_path_phase`), then five timed steps. Returns launches per
    kernel over the timed steps, the launches by variant
    (`check_variants`) and the K1 record."""
    from fcaf3d_tpu_torch import _native
    from fcaf3d_tpu_torch.train import create_train_state, make_train_step

    model, opt, _ = create_train_state(cfg, seed=0, device=device)
    step = make_train_step(model, cfg, opt)
    calls = {}
    with recorded_k1_calls(calls):  # warm-up: cuBLAS and the allocator
        step(batch)
    torch.cuda.synchronize()
    k1 = k1_path_phase(torch, calls, 1, f"one batch-{TRAIN_BATCH} train step")
    calls.clear()  # the recorded copies must not count in the peak memory
    torch.cuda.reset_peak_memory_stats()
    _native.reset_launches()
    times, metrics = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        m = {k: float(v) for k, v in step(batch).items()}
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        metrics.append(m)
    launches = dict(_native.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    for i, (dt, m) in enumerate(zip(times, metrics)):
        log(f"   step {i}: {dt * 1e3:.1f} ms wall, " + ", ".join(
            f"{k} {v:.5g}" for k, v in m.items()))
        if not all(np.isfinite(v) for v in m.values()):
            raise AssertionError(f"step {i}: non-finite metrics {m}")
        if m["loss_bbox"] <= 0 or m["overflow_max"] != 0:
            raise AssertionError(f"step {i}: loss_bbox {m['loss_bbox']}, "
                                 f"overflow_max {m['overflow_max']}")
    n_conv = 0
    for name, p in model.named_parameters():
        if name.endswith("kernel"):
            n_conv += 1
            if p.grad is None or not torch.isfinite(p.grad).all() \
                    or not p.grad.abs().max() > 0:
                raise AssertionError(f"{name}: gradient missing, non-finite "
                                     "or zero")
    log(f"   {TRAIN_STEPS} steps at batch {TRAIN_BATCH}: mean "
        f"{np.mean(times) * 1e3:.1f} ms/step (min {min(times) * 1e3:.1f}); "
        f"peak memory {peak / 2**30:.2f} GiB; {n_conv} conv kernels with "
        f"finite non-zero gradients; launches {launches}")
    check_path_launches(launches, "fcaf3d_training")
    return launches, check_variants("bf16 training",
                                    ("gather_gemm", "gather_dw")), k1


def head_batch(torch, cfg, extent, b=2, boxes_per_scene=3, seed=0):
    """B `data.synth.synth_scene` scans of `extent` for a miniature config, with
    GT boxes of ~0.2 m around level-0 head locations of the training
    forward (on the CPU; weights and pruning are the same on the card), so
    that the assigner finds positives and the box loss is live."""
    from fcaf3d_tpu_torch.data.synth import synth_scene
    from fcaf3d_tpu_torch.train import create_train_state

    pts, cols = zip(*(synth_scene(np.random.RandomState(seed + s),
                                  cfg.num_points, extent=extent)
                      for s in range(b)))
    batch = {"points": np.stack(pts).astype(np.float32),
             "colors": np.stack(cols).astype(np.float32),
             "valid": np.ones((b, cfg.num_points), bool)}
    model, _, _ = create_train_state(cfg, 0, device="cpu")
    with torch.no_grad():
        outs, _ = model(*(torch.as_tensor(batch[k])
                          for k in ("points", "colors", "valid")))
    g = cfg.max_gt_boxes
    batch.update(gt_boxes=np.zeros((b, g, 7), np.float32),
                 gt_labels=np.zeros((b, g), np.int32),
                 gt_valid=np.zeros((b, g), bool))
    rng = np.random.default_rng(seed)
    for i in range(b):
        heads = outs[0].points[i][outs[0].valid[i]].numpy()
        for j, h in enumerate(heads[rng.choice(len(heads), boxes_per_scene,
                                               replace=False)]):
            dims = rng.uniform(0.18, 0.26, 3).astype(np.float32)
            batch["gt_boxes"][i, j] = [h[0], h[1], h[2] - dims[2] / 2,
                                       *dims, 0.0]
            batch["gt_labels"][i, j] = rng.integers(0, cfg.n_classes)
            batch["gt_valid"][i, j] = True
    return batch


def step_grads(torch, cfg, batch, dev, seed=0):
    """Forward in train mode, `fcaf3d_loss` and backward on `dev`: the
    head-level maps, overflow counts, losses and every parameter's
    gradient, on the CPU."""
    from fcaf3d_tpu_torch.models.detector import loss_config
    from fcaf3d_tpu_torch.models.fcaf3d_head import fcaf3d_loss
    from fcaf3d_tpu_torch.train import create_train_state

    model, _, _ = create_train_state(cfg, seed=seed, device=dev)
    t = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    outs, overflow = model(t["points"], t["colors"], t["valid"])
    losses = fcaf3d_loss(outs, t["gt_boxes"], t["gt_labels"], t["gt_valid"],
                         loss_config(cfg))
    sum(losses.values()).backward()
    return ([(o.points.cpu(), o.valid.cpu()) for o in outs],
            {k: v.cpu().tolist() for k, v in overflow.items()},
            {k: float(v.detach()) for k, v in losses.items()},
            {n: p.grad.cpu() for n, p in model.named_parameters()})


def leaf_errs(got, want):
    """Per gradient leaf: (|got - want| in L2 norm / |want|, largest
    |got - want| / largest |want|, name), sorted by the first."""
    return sorted(
        (float((got[n] - w).norm() / max(float(w.norm()), 1e-30)),
         float((got[n] - w).abs().max() / max(float(w.abs().max()), 1e-30)),
         n) for n, w in want.items())


def card_vs_cpu(torch, cfg, batch, device, what, seed=0):
    """One f32 train step on the card and on the CPU from the same weights
    and batch: head-level maps and overflow counts exactly equal. Returns
    the card's and the CPU's losses and the per-leaf errors."""
    lv_g, ovf_g, loss_g, grad_g = step_grads(torch, cfg, batch, device, seed)
    lv_c, ovf_c, loss_c, grad_c = step_grads(torch, cfg, batch, "cpu", seed)
    for i, ((pg, vg), (pc, vc)) in enumerate(zip(lv_g, lv_c)):
        if not (torch.equal(pg, pc) and torch.equal(vg, vc)):
            raise AssertionError(f"{what}: level {i} map differs card vs CPU "
                                 "(neck keep mask)")
    if ovf_g != ovf_c:
        raise AssertionError(f"{what}: overflow {ovf_g} vs {ovf_c}")
    return loss_g, loss_c, ovf_c, leaf_errs(grad_g, grad_c)


def report_errs(errs):
    return (f"median {errs[len(errs) // 2][0]:.3g}, worst "
            + ", ".join(f"{n} {a:.3g} ({b:.3g})" for a, b, n in errs[-3:]))


def compare_train_tiny(torch, device):
    """One f32 train step at `fcaf3d_tiny`, batch 2, card against CPU, with
    the tight per-element gate."""
    from fcaf3d_tpu_torch.configs import fcaf3d_tiny

    cfg = fcaf3d_tiny()
    batch = head_batch(torch, cfg, TINY_EXTENT)
    loss_g, loss_c, _, errs = card_vs_cpu(torch, cfg, batch, device,
                                          "f32 tiny train")
    loss_err = max(abs(loss_g[k] / loss_c[k] - 1) for k in loss_c)
    worst = max(errs, key=lambda x: x[1])
    log(f"   f32 tiny train, batch 2: head-level maps equal card vs CPU; "
        f"losses {loss_c} (max rel err {loss_err:.3g}, tol "
        f"{TRAIN_LOSS_RTOL}); gradient leaves, largest-element rel err: "
        f"worst {worst[2]} {worst[1]:.3g} (tol {TINY_GRAD_RTOL}); norm rel "
        f"err {report_errs(errs)}")
    if loss_c["loss_bbox"] <= 0 or loss_err > TRAIN_LOSS_RTOL \
            or worst[1] > TINY_GRAD_RTOL:
        raise AssertionError("f32 tiny train: card and CPU disagree")


def compare_train_f32(torch, cfg, device):
    """One f32 train step at batch 1: the card against the plain path on
    the CPU, from the same weights and batch (the loose gate)."""
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    batch = train_batch(cfg32, 1, seed0=100)
    cloud = np.concatenate([batch["points"], batch["colors"]], axis=-1)
    gpu_maps = backbone_maps(cloud, cfg32, device)
    cpu_maps = backbone_maps(cloud, cfg32, "cpu")
    for name, (m, _) in gpu_maps.items():
        if not torch.equal(m.cpu(), cpu_maps[name][0]):
            raise AssertionError(f"f32 train: {name} differs card vs CPU")
    loss_g, loss_c, ovf, errs = card_vs_cpu(torch, cfg32, batch, device,
                                            "f32 train")
    if any(max(v) for v in ovf.values()):
        raise AssertionError(f"f32 train: overflow {ovf}")
    loss_err = max(abs(loss_g[k] / loss_c[k] - 1) for k in loss_c)
    log(f"   f32 train: voxel keys, {len(gpu_maps) - 1} backbone maps and "
        f"the pruned head-level maps equal card vs CPU; losses {loss_c} "
        f"(max rel err {loss_err:.3g}, tol {TRAIN_LOSS_RTOL}); gradient "
        f"leaves, norm rel err (largest-element rel err): {report_errs(errs)}"
        f" (tol {TRAIN_GRAD_RTOL} in norm)")
    if loss_c["loss_bbox"] <= 0 or loss_err > TRAIN_LOSS_RTOL \
            or errs[-1][0] > TRAIN_GRAD_RTOL:
        raise AssertionError("f32 train: card and CPU disagree")


def grad_control(torch, cfg, device, seeds):
    """The f32 ScanNet gradients' sensitivity, for weight seed s and the
    batch-1 scene of data seed 100 + s: the card against the CPU, beside
    the CPU against itself with the input colours scaled by (1 + 1e-6)."""
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    for s in range(seeds):
        batch = train_batch(cfg32, 1, seed0=100 + s)
        nudged = {**batch, "colors": batch["colors"] * np.float32(1 + 1e-6)}
        _, _, _, grad_c = step_grads(torch, cfg32, batch, "cpu", s)
        _, _, _, grad_n = step_grads(torch, cfg32, nudged, "cpu", s)
        _, _, _, grad_g = step_grads(torch, cfg32, batch, device, s)
        for what, got in (("card vs CPU", grad_g),
                          ("CPU nudged vs CPU", grad_n)):
            errs = leaf_errs(got, grad_c)
            log(f"   seed {s} {what}: norm rel err (largest-element rel "
                f"err) {report_errs(errs)}; largest-element rel err over "
                f"leaves {max(e[1] for e in errs):.3g}")


def profile_inference(torch, cfg, scans):
    """One bf16 `inference_detector` scan under `torch.profiler` (after a
    warm-up scan): device time by kernel, busy share, launches; and the
    K2 launches by variant of that scan."""
    from torch.profiler import ProfilerActivity, profile

    from fcaf3d_tpu_torch import _native
    from fcaf3d_tpu_torch.apis import inference_detector, init_detector

    model = init_detector(cfg, seed=0, device="cuda")
    inference_detector(model, scans[0])
    torch.cuda.synchronize()
    _native.reset_launches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        inference_detector(model, scans[1])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    log_profile(prof, wall, "1 bf16 inference scan")
    log(f"   port launches {dict(_native.LAUNCHES)}")
    check_variants("profiled scan", ("gather_gemm",))


def profile_train(torch, cfg, batch):
    """The batch-8 bf16 train step: stage split on the host clock with a
    synchronise after each stage (3 steps), then 2 steps under
    `torch.profiler`: device time by kernel, busy share, host time."""
    from torch.profiler import ProfilerActivity, profile

    from fcaf3d_tpu_torch.models.detector import loss_config
    from fcaf3d_tpu_torch.models.fcaf3d_head import fcaf3d_loss
    from fcaf3d_tpu_torch.train import create_train_state, make_train_step
    from fcaf3d_tpu_torch.train.trainer import BATCH_KEYS

    model, opt, _ = create_train_state(cfg, seed=0, device="cuda")
    step = make_train_step(model, cfg, opt)
    step(batch)
    step(batch)
    lcfg = loss_config(cfg)
    for _ in range(3):
        t = {k: torch.as_tensor(batch[k], device="cuda") for k in BATCH_KEYS}
        marks = []

        def mark():
            torch.cuda.synchronize()
            marks.append(time.perf_counter())

        mark()
        opt.zero_grad(set_to_none=True)
        outs, _ = model(t["points"], t["colors"], t["valid"])
        mark()
        total = sum(fcaf3d_loss(outs, t["gt_boxes"], t["gt_labels"],
                                t["gt_valid"], lcfg).values())
        mark()
        total.backward()
        mark()
        opt.step()
        mark()
        ms = np.diff(marks) * 1e3
        log("   stages ms: " + ", ".join(
            f"{k} {v:.1f}" for k, v in zip(
                ("forward", "loss", "backward", "optimizer"), ms))
            + f", total {ms.sum():.1f}")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(2):
            step(batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    log_profile(prof, wall, "2 steps")


def log_profile(prof, wall, what):
    """Device time by kernel, busy share of `wall` and the host's largest
    items, from a finished `torch.profiler` run."""
    from torch.autograd import DeviceType

    ka = prof.key_averages()
    # device events, less the ranges the profiler books to annotations
    # such as `Optimizer.step`
    kern = [e for e in ka if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]
    dev_ms = sum(e.self_device_time_total for e in kern) / 1e3
    log(f"   profiled {what}: wall {wall * 1e3:.1f} ms, kernel device time "
        f"{dev_ms:.1f} ms (busy {dev_ms / (wall * 1e3):.3f}), "
        f"{sum(e.count for e in kern)} kernel launches")
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:16]:
        log(f"   device {e.self_device_time_total / 1e3:9.2f} ms "
            f"n {e.count:6d}  {e.key[:90]}")
    for e in sorted(ka, key=lambda e: -e.self_cpu_time_total)[:10]:
        log(f"   host   {e.self_cpu_time_total / 1e3:9.2f} ms "
            f"n {e.count:6d}  {e.key[:80]}")


def profile_votenet(torch, cfg, device):
    """VoteNet-v2 inference (f32, batch 1, test mode): the stage split of
    three scans on the host clock, each stage ended by a synchronise (FPS
    and ball queries inside the SA modules, the rest of each SA module, the
    FP modules, the vote module, the head, `votenet_get_bboxes`), then one
    scan under `torch.profiler`."""
    from torch.profiler import ProfilerActivity, profile

    from fcaf3d_tpu_torch.apis import inference_votenet, init_votenet
    from fcaf3d_tpu_torch.apis.inference import votenet_inputs
    from fcaf3d_tpu_torch.models import votenet

    model = init_votenet(cfg, seed=0, device=device)
    scans = [vote_scan(s, cfg.num_points) for s in range(3)]
    inference_votenet(model, scans[0])
    spans = {}

    def timed(name, fn):
        def call(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            spans[name] = spans.get(name, 0.0) + time.perf_counter() - t0
            return out
        return call

    stages = {"sa": [model.backbone.get_submodule(f"sa{i}")
                     for i in range(model.backbone.n_sa)]
              + [model.vote_aggregation],
              "fp": [model.backbone.get_submodule(f"fp{i}")
                     for i in range(model.backbone.n_fp)],
              "vote_module": [model.vote_module]}
    for name, mods in stages.items():
        for m in mods:
            m.forward = timed(name, m.forward)
    try:
        with wrapped_selections(timed):
            for s, pts in enumerate(scans):
                spans.clear()
                x = torch.as_tensor(votenet_inputs(pts, cfg.num_points)[None],
                                    device=device)
                with torch.inference_mode():
                    fwd = timed("forward", model)(
                        x, sample_mod=cfg.sample_mod_test)
                    timed("get_bboxes", votenet.votenet_get_bboxes)(
                        fwd, x, cfg.n_classes, nms_thr=cfg.nms_thr,
                        score_thr=cfg.score_thr,
                        per_class_proposal=cfg.per_class_proposal)
                spans["sa_rest"] = (spans["sa"] - spans["fps"]
                                    - spans["ball_query"])
                spans["head_rest"] = (spans["forward"] - spans["sa"]
                                      - spans["fp"] - spans["vote_module"]
                                      - spans["seed_fps"])
                log(f"   scan {s} stages ms: " + ", ".join(
                    f"{k} {spans[k] * 1e3:.2f}" for k in (
                        "fps", "seed_fps", "ball_query", "sa_rest", "fp",
                        "vote_module", "head_rest", "get_bboxes"))
                    + "; total "
                    f"{(spans['forward'] + spans['get_bboxes']) * 1e3:.2f}")
    finally:
        for mods in stages.values():
            for m in mods:
                del m.forward
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        inference_votenet(model, scans[1])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    log_profile(prof, wall, "1 VoteNet scan")


def vote_scan(seed, n):
    """One synthetic SUN RGB-D-like scan [n, 3] (xyz of
    `data.synth.synth_scene`)."""
    from fcaf3d_tpu_torch.data.synth import synth_scene

    return synth_scene(np.random.RandomState(seed), n)[0]


def pointnet_cases(torch, cfg, device):
    """The K5 and K6 cases of the VoteNet path of `cfg` on two scans
    [2, N, 3]: the backbone's xyz levels (each the FPS sample of the one
    before, by the plain version), and votes (the seeds moved by ~5 cm) for
    the aggregation. Returns (fps cases (name, points, S), ball-query cases
    (name, centres, points, radius, nsample))."""
    from fcaf3d_tpu_torch.models.votenet import VoteNet
    from fcaf3d_tpu_torch.ops.pointnet import gather_points
    from fcaf3d_tpu_torch.ops.pointnet.fps import furthest_point_sample_plain

    net = VoteNet(cfg, device="meta")
    lv = [torch.as_tensor(np.stack([vote_scan(s, cfg.num_points)
                                    for s in (0, 1)]), device=device)]
    for s in cfg.backbone_num_points:
        lv.append(gather_points(lv[-1], furthest_point_sample_plain(lv[-1],
                                                                    s)))
    seeds = lv[net.backbone.n_sa - net.backbone.n_fp]
    noise = np.random.default_rng(0).normal(0, 0.05, seeds.shape)
    votes = seeds + torch.as_tensor(noise.astype(np.float32), device=device)
    proposals = gather_points(votes, furthest_point_sample_plain(
        seeds, cfg.num_proposal))
    fps = [(f"SA{i + 1}", lv[i], s)
           for i, s in enumerate(cfg.backbone_num_points)]
    fps.append(("seeds", seeds, cfg.num_proposal))
    ballq = []
    for i in range(net.backbone.n_sa):
        sa = getattr(net.backbone, f"sa{i}")
        ballq.append((f"SA{i + 1}", lv[i + 1], lv[i], sa.radius,
                      sa.num_sample))
    agg = net.vote_aggregation
    ballq.append(("aggregation", proposals, votes, agg.radius,
                  agg.num_sample))
    return fps, ballq


def mask_of(torch, b, n, device, n_valid=None):
    """[b, n] bool: the first cloud all valid; the last with its first 3
    points and ~5% of the rest invalid (only the first `n_valid` of them
    valid when that is given)."""
    rng = np.random.default_rng(n)
    m = np.ones((b, n), bool)
    m[-1] = rng.random(n) > 0.05
    m[-1, :3] = False
    if n_valid is not None:
        m[-1, np.flatnonzero(m[-1])[n_valid:]] = False
    return torch.as_tensor(m, device=device)


def lattice_cloud(torch, b, n, device, seed=0):
    """[b, n, 3] f32 integer lattice points, each site drawn many times: a
    cloud of exact ties (equal distances and duplicated points)."""
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.integers(0, (9, 7, 5), (b, n, 3)).astype(
        np.float32), device=device)


def fps_plan_boundaries(s, n_max):
    """Every N up to n_max after which `fps_plan`'s variant (cluster size,
    points a thread, where the minima live) changes."""
    from fcaf3d_tpu_torch.ops.pointnet.fps import fps_plan

    out, last = [], None
    for n in range(1, n_max + 1):
        p = fps_plan(1, n, s)
        key = (p.cs, p.points_per_thread, p.where)
        if last is not None and key != last:
            out.append(n - 1)
        last = key
    return out


def empty_step(torch, plan, s, device):
    """The serial floor's launch: the cluster kernel at `plan`'s cluster
    and CTA size with one point a thread (P = 1, the smallest instance), on
    a cloud of one CTA's worth of points a rank whose first is its only
    valid one. Every step runs the whole protocol (warp argmax, candidate
    exchange, wait, the reduction of cs x warps candidates) and one
    distance update a thread. Not a strict bound: P = 1 is another compiled
    instance, whose step can read above the plan's own where the protocol
    is all of it (one CTA of 4 warps at SA4 and the seeds: PERF.md)."""
    from fcaf3d_tpu_torch.ops.pointnet.fps import furthest_point_sample

    one = plan._replace(points_per_thread=1)
    n = one.cs * one.threads
    x = torch.rand(1, n, 3, device=device)
    valid = torch.zeros(1, n, dtype=torch.bool, device=device)
    valid[0, ::one.threads] = True
    return lambda: furthest_point_sample(x, s, valid, _plan=one)


def pointnet_kernel_phase(torch, cfg, device):
    """K5 and K6 against their plain versions at every shape of the VoteNet
    path, at batch 1 and at batch 2 with a valid mask: exactly equal. Plus
    K5 with S above the valid count, with N beyond shared memory and beyond
    the cluster kernel's registers, on lattice tie clouds (SA1 and each
    side of every boundary of `fps_plan`) and at every cluster size of the
    sweep at SA1; K6 with centres that find no point. Times (batch 1) of
    each kernel and its plain version; K5 also beside its single-CTA kernel
    (the earlier one), its operations bound and its serial floor."""
    from fcaf3d_tpu_torch.ops.pointnet.ball_query import (
        ball_query, ball_query_plain, ball_query_plan)
    from fcaf3d_tpu_torch.ops.pointnet.fps import (
        CLUSTER_SIZE, MAX_CTA_POINTS, fps_plan, furthest_point_sample,
        furthest_point_sample_plain)

    gen = torch.Generator(device=device).manual_seed(0)
    fps_cases, ballq_cases = pointnet_cases(torch, cfg, device)
    small = torch.rand(2, 64, 3, generator=gen, device=device)
    big = torch.rand(2, 60000, 3, generator=gen, device=device) * 5
    beyond = CLUSTER_SIZE * MAX_CTA_POINTS + 1024
    huge = torch.rand(2, beyond, 3, generator=gen, device=device) * 5
    extra_fps = [("S > valid count", small, 32,
                  mask_of(torch, 2, 64, device, n_valid=20)),
                 ("no valid point", lattice_cloud(torch, 2, 20000, device),
                  16, torch.zeros(2, 20000, dtype=torch.bool, device=device)),
                 ("N beyond shared memory", big, 128,
                  mask_of(torch, 2, 60000, device)),
                 ("N beyond the cluster's registers", huge, 128,
                  mask_of(torch, 2, beyond, device))]
    far = torch.cat([small[:, :8], small[:, :4] + 10.0], dim=1)
    extra_ballq = [("centres without a hit", far, small, 0.3, 24,
                    mask_of(torch, 2, 64, device))]
    rec = {"fps": {"max_abs_err": 0}, "ball_query": {"max_abs_err": 0}}

    def check(name, what, got, want):
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max())
        rec[name]["max_abs_err"] = max(rec[name]["max_abs_err"], err)
        if not torch.equal(got, want):
            raise AssertionError(f"{name} {what}: kernel != plain (max abs "
                                 f"index diff {err})")

    shapes = {}
    for what, pts, s in fps_cases:
        n = pts.shape[1]
        for b in (1, 2):
            x = pts[:b].contiguous()
            v = None if b == 1 else mask_of(torch, b, n, device)
            check("fps", f"{what} B={b}", furthest_point_sample(x, s, v),
                  furthest_point_sample_plain(x, s, v))
        x = pts[:1].contiguous()
        plan = fps_plan(1, n, s)
        times = timed_turns(torch, {
            "plain": lambda: furthest_point_sample_plain(x, s),
            "kernel": lambda: furthest_point_sample(x, s),
            "earlier": lambda: furthest_point_sample(x, s, _variant="single"),
            "floor": empty_step(torch, plan, s, device)})
        # the S x N distance updates; xyz read once, the indices written
        r = timing_record(times, (s * n * FPS_OPS, n * 12 + s * 4),
                          PEAK_OPS["float32"])
        r["plan"] = list(plan)
        log(f"   K5 {what} {n} -> {s}: exact at B=1 and B=2 (masked); plan "
            f"{tuple(plan)}; {report(r)}")
        shapes[what] = {k: r[k] for k in (
            "ms", "earlier_ms", "plain_ms", "bound_ms", "serial_floor_ms",
            "plan")}
        if "ms" not in rec["fps"]:
            rec["fps"].update(r)
    rec["fps"]["shapes"] = shapes
    for what, x, s, v in extra_fps:
        check("fps", what, furthest_point_sample(x, s, v),
              furthest_point_sample_plain(x, s, v))
        log(f"   K5 {what} ({x.shape[1]} -> {s}, B=2, masked, plan "
            f"{tuple(fps_plan(2, x.shape[1], s))}): exact")

    rec["fps"]["sweep"] = fps_sweeps(torch, fps_cases, check, device)
    fps_ties(torch, fps_cases[0], check, device)

    shapes = {}
    for what, cent, pts, r, ns in ballq_cases:
        m, n = cent.shape[1], pts.shape[1]
        for b in (1, 2):
            c, x = cent[:b].contiguous(), pts[:b].contiguous()
            v = None if b == 1 else mask_of(torch, b, n, device)
            want = ball_query_plain(c, x, r, ns, v)
            check("ball_query", f"{what} B={b}", ball_query(c, x, r, ns, v),
                  want)
            check("ball_query", f"{what} B={b} first kernel",
                  ball_query(c, x, r, ns, v, _variant="warp"), want)
        c, x = cent[:1].contiguous(), pts[:1].contiguous()
        times = timed_turns(torch, {
            "plain": lambda: ball_query_plain(c, x, r, ns),
            "kernel": lambda: ball_query(c, x, r, ns),
            "earlier": lambda: ball_query(c, x, r, ns, _variant="warp")})
        # each centre scans its points in index order up to its ns-th hit
        # (or all N); centres and points read once, the indices written
        rt = timing_record(times, (ballq_scanned(torch, c, x, r, ns)
                                   * BALLQ_OPS, (m + n) * 12 + m * ns * 4),
                           PEAK_OPS["float32"])
        rt["plan"] = list(ball_query_plan(1, m, n))
        host = host_turns(torch, {
            "kernel": lambda: ball_query(c, x, r, ns),
            "earlier": lambda: ball_query(c, x, r, ns, _variant="warp")})
        rt["enqueue_us"], rt["earlier_enqueue_us"] = (
            host["kernel"][0], host["earlier"][0])
        log(f"   K6 {what} M={m} N={n} r={r} ns={ns}: exact at B=1 and B=2 "
            f"(masked), and the first kernel; plan {tuple(rt['plan'])}; "
            f"{report(rt)}; host enqueue {rt['enqueue_us']:.1f} us a call "
            f"(the first kernel {rt['earlier_enqueue_us']:.1f})")
        shapes[what] = {k: rt[k] for k in (
            "ms", "earlier_ms", "plain_ms", "bound_ms", "share", "plan",
            "enqueue_us", "earlier_enqueue_us")}
        if rt["ms"] >= rt["earlier_ms"]:
            NOT_FASTER.append((f"K6 {what}", rt["ms"], rt["earlier_ms"],
                               rt["plain_ms"]))
            log(f"   NOT FASTER than the first kernel: K6 {what}")
        if "ms" not in rec["ball_query"]:
            rec["ball_query"].update(rt)
    scan = {k: sum(r[k] for r in shapes.values())
            for k in ("ms", "earlier_ms")}
    log(f"   K6 over a scan's {len(shapes)} calls: {scan['ms']:.4f} ms of "
        f"device time (the first kernel {scan['earlier_ms']:.4f})")
    rec["ball_query"].update(shapes=shapes, scan_ms=scan["ms"],
                             earlier_scan_ms=scan["earlier_ms"])
    for what, c, x, r, ns, v in extra_ballq + ballq_edges(torch, gen,
                                                          device):
        want = ball_query_plain(c, x, r, ns, v)
        b, m, n = c.shape[0], c.shape[1], x.shape[1]
        check("ball_query", what, ball_query(c, x, r, ns, v), want)
        if what == "centres without a hit" and want[:, 8:].any():
            raise AssertionError(f"K6 {what}: a centre without a hit is not "
                                 "all zeros")
        log(f"   K6 {what} (M={m}, N={n}, ns={ns}, B={b}"
            f"{', masked' if v is not None else ''}): exact")
    return rec


def ballq_edges(torch, gen, device):
    """K6's edge clouds (name, centres, points, radius, nsample, valid), B=2:
    N % 4 != 0 beyond one tile, N below one tile, M not a multiple of the
    CTA's centres, nsample above N, each masked and not; and a lattice
    cloud where points lie at exactly r^2 (r = 1, and sqrt 2, whose f32 r^2
    is 2.0), masked."""
    from fcaf3d_tpu_torch.ops.pointnet.ball_query import (
        BQ_TILE_POINTS, squared_radius)

    out = []
    for n, m in ((4099, 70), (BQ_TILE_POINTS * 2 + 1, 129), (1000, 33),
                 (7, 5)):
        x = torch.rand(2, n, 3, generator=gen, device=device) * 2
        c = torch.rand(2, m, 3, generator=gen, device=device) * 2
        for ns in (16, n + 5):
            for v in (None, mask_of(torch, 2, n, device)):
                out.append((f"N={n} M={m}", c, x, 0.3, ns, v))
    x = lattice_cloud(torch, 2, 3001, device)
    for r in (1.0, 2.0 ** 0.5):
        out.append((f"lattice r^2={squared_radius(r)}",
                    x[:, :50].contiguous(), x, r, 32,
                    mask_of(torch, 2, 3001, device)))
    return out


def fps_sweeps(torch, fps_cases, check, device):
    """K5 at SA1 at every cluster size of FPS_SWEEP, exact at B=1 and B=2
    (masked) through `check`, timed in turns beside its serial floor.
    Returns the times by cluster size."""
    from fcaf3d_tpu_torch.ops.pointnet.fps import (
        fps_plan, furthest_point_sample, furthest_point_sample_plain)

    what, pts, s = fps_cases[0]
    n = pts.shape[1]
    fns, sweep = {}, {}
    for cs in FPS_SWEEP:
        for b in (1, 2):
            x = pts[:b].contiguous()
            v = None if b == 1 else mask_of(torch, b, n, device)
            check("fps", f"{what} cluster of {cs} B={b}",
                  furthest_point_sample(x, s, v, _plan=fps_plan(
                      b, n, s, cluster=cs)),
                  furthest_point_sample_plain(x, s, v))
        plan = fps_plan(1, n, s, cluster=cs)
        fns[cs] = (lambda x=pts[:1].contiguous(), p=plan:
                   furthest_point_sample(x, s, _plan=p))
        fns[(cs, "floor")] = empty_step(torch, plan, s, device)
    times = timed_turns(torch, fns)
    for cs in FPS_SWEEP:
        ms, floor = times[cs][0], times[(cs, "floor")][0]
        plan = fps_plan(1, n, s, cluster=cs)
        sweep[str(cs)] = {"ms": ms, "serial_floor_ms": floor,
                          "plan": list(plan)}
        log(f"   K5 sweep {what} {n} -> {s}, {tuple(plan)}: exact at B=1 "
            f"and B=2 (masked); kernel {ms:.4f} ms, serial floor "
            f"{floor:.4f} ms (share {floor / ms:.3f})")
    return sweep


def fps_ties(torch, sa1_case, check, device):
    """K5 exactly equal to plain through `check` on lattice tie clouds (B=2,
    the second masked): at SA1, and at FPS_TIE_S samples on each side of
    every boundary of `fps_plan` up to the cluster's register capacity."""
    from fcaf3d_tpu_torch.ops.pointnet.fps import (
        CLUSTER_SIZE, MAX_CTA_POINTS, fps_plan, furthest_point_sample,
        furthest_point_sample_plain)

    _, pts, s = sa1_case
    n = pts.shape[1]
    ties = [(n, s)] + [(m, FPS_TIE_S) for edge in fps_plan_boundaries(
        FPS_TIE_S, CLUSTER_SIZE * MAX_CTA_POINTS + 1) for m in (edge,
                                                                edge + 1)]
    for m, s in ties:
        x = lattice_cloud(torch, 2, m, device, seed=m)
        v = mask_of(torch, 2, m, device)
        check("fps", f"tie cloud {m} -> {s}", furthest_point_sample(x, s, v),
              furthest_point_sample_plain(x, s, v))
    log(f"   K5 lattice tie clouds (B=2, the second masked) exact at "
        + ", ".join(f"{m} -> {s} {tuple(fps_plan(2, m, s))[:3]}"
                    for m, s in ties))


def ballq_scanned(torch, centers, points, radius, nsample):
    """Points a ball query scans for centres [1, M, 3] over points [1, N,
    3]: for each centre, up to and including its nsample-th hit (the
    direct d^2 < r^2), or all N."""
    d2 = ((points[0][None] - centers[0][:, None]) ** 2).sum(-1)
    count = torch.cumsum((d2 < radius * radius).int(), dim=1)
    full = count[:, -1] >= nsample
    first = torch.argmax((count >= nsample).int(), dim=1) + 1
    return int(torch.where(full, first, points.shape[1]).sum())


@contextlib.contextmanager
def wrapped_selections(wrap):
    """Every FPS and ball query of the VoteNet forward goes through
    `wrap(kind, fn)` (kind "fps" in the SA modules, "ball_query", or
    "seed_fps" for the proposals of the test mode), by the names the model
    modules call."""
    from fcaf3d_tpu_torch.models import pointnet2, votenet

    names = ((pointnet2, "furthest_point_sample", "fps"),
             (pointnet2, "ball_query", "ball_query"),
             (votenet, "furthest_point_sample", "seed_fps"))
    saved = [getattr(mod, name) for mod, name, _ in names]
    for (mod, name, kind), fn in zip(names, saved):
        setattr(mod, name, wrap(kind, fn))
    try:
        yield
    finally:
        for (mod, name, _), fn in zip(names, saved):
            setattr(mod, name, fn)


def recorder(torch, calls):
    """A `wrapped_selections` wrapper appending (kind, arguments, result),
    on the CPU, to `calls`."""
    def wrap(kind, fn):
        def call(*args):
            out = fn(*args)
            calls.append((kind, [a.cpu() if torch.is_tensor(a) else a
                                 for a in args], out.cpu()))
            return out
        return call
    return wrap


def votenet_run(torch, model, x):
    """The body of `inference_votenet` on a prepared input [1, N, 4]:
    forward in the test mode and raw `VoteDetections`, with every FPS and
    ball query recorded."""
    from fcaf3d_tpu_torch.models.votenet import votenet_get_bboxes

    cfg = model.cfg
    calls = []
    with torch.inference_mode(), wrapped_selections(recorder(torch, calls)):
        preds = model(x, sample_mod=cfg.sample_mod_test)
        dets = votenet_get_bboxes(preds, x, cfg.n_classes,
                                  nms_thr=cfg.nms_thr, score_thr=cfg.score_thr,
                                  per_class_proposal=cfg.per_class_proposal)
    return calls, dets._replace(**{k: v.cpu() for k, v in
                                   dets._asdict().items()})


def compare_votenet_f32(torch, model, cfg, scan_xyz, device):
    """One scan, card against CPU (same weights, same input): every FPS and
    the SA1-SA4 groups exactly equal; aggregation groups equal but for
    members within AGG_D2_TOL of r^2; on proposals whose group is equal the
    same detections, boxes within BOX_ATOL and scores within SCORE_ATOL."""
    from fcaf3d_tpu_torch.apis import init_votenet
    from fcaf3d_tpu_torch.apis.inference import votenet_inputs

    x = votenet_inputs(scan_xyz, cfg.num_points)[None]
    calls_g, dets_g = votenet_run(torch, model, torch.as_tensor(
        x, device=device))
    calls_c, dets_c = votenet_run(torch, init_votenet(cfg, 0, device="cpu"),
                                  torch.as_tensor(x))
    if [c[0] for c in calls_g] != [c[0] for c in calls_c]:
        raise AssertionError("VoteNet f32: the card and the CPU made other "
                             "FPS / ball-query calls")
    n_bq = sum(c[0] == "ball_query" for c in calls_c)
    seen_bq, flipped, eq_rows = 0, 0, None
    for (name, _, got), (_, args, want) in zip(calls_g, calls_c):
        if name == "ball_query":
            seen_bq += 1
        if seen_bq < n_bq or name != "ball_query":
            if not torch.equal(got, want):
                raise AssertionError(f"VoteNet f32: {name} call "
                                     f"{seen_bq} differs card vs CPU")
            continue
        # the aggregation: disputed members must lie within AGG_D2_TOL of r^2
        cent, pts, radius = args[0][0].double(), args[1][0].double(), args[2]
        eq_rows = (got[0] == want[0]).all(-1)
        for r in torch.nonzero(~eq_rows).flatten().tolist():
            disputed = set(got[0, r].tolist()) ^ set(want[0, r].tolist())
            d2 = ((pts[sorted(disputed)] - cent[r]) ** 2).sum(-1)
            flipped += len(disputed)
            if ((d2 - radius * radius).abs() > AGG_D2_TOL).any():
                raise AssertionError(f"VoteNet f32: aggregation group {r} "
                                     f"differs away from r^2: {d2.tolist()}")
    same = eq_rows.repeat(cfg.n_classes if cfg.per_class_proposal else 1)
    vg, vc = dets_g.valid[0] & same, dets_c.valid[0] & same
    if not (vc.any() and torch.equal(vg, vc) and torch.equal(
            dets_g.labels[0][vc], dets_c.labels[0][vc])):
        raise AssertionError(f"VoteNet f32: {int(vg.sum())} detections on "
                             f"the card, {int(vc.sum())} on the CPU, or "
                             "other labels")
    box_err = float((dets_g.boxes[0][vc] - dets_c.boxes[0][vc]).abs().max())
    score_err = float((dets_g.scores[0][vc] - dets_c.scores[0][vc]).abs()
                      .max())
    log(f"   f32 card vs CPU: {len(calls_c)} FPS / ball-query calls, all "
        f"FPS and SA1-SA4 groups equal; aggregation: "
        f"{int((~eq_rows).sum())} of {len(eq_rows)} groups differ "
        f"({flipped} members within {AGG_D2_TOL} of r^2); "
        f"{int(vc.sum())} detections equal, max box err {box_err:.3g} "
        f"(tol {BOX_ATOL}), max score err {score_err:.3g} (tol {SCORE_ATOL})")
    if box_err > BOX_ATOL or score_err > SCORE_ATOL:
        raise AssertionError("VoteNet f32: card and CPU disagree")


def votenet_turns(torch, model, scans):
    """Per-scan wall ms of `inference_votenet` and device ms of its FPS and
    of its ball-query calls, with K5 and K6 as planned ("new") and with the
    kernels they replaced wrapped in ("earlier": K5's single-CTA kernel,
    K6's first kernel, one warp a centre), in turns: new, earlier, earlier,
    new. Each scan runs twice: bare for the wall time, then with CUDA events
    around each call behind a sleep kernel (TURN_SLEEP_CYCLES), so that an
    event times the kernel and not the host's enqueue of it. Returns
    variant -> (wall ms, FPS ms, ball-query ms) lists."""
    from fcaf3d_tpu_torch.apis import inference_votenet

    spans = {"fps": [], "ball_query": []}
    earlier = {"fps": "single", "seed_fps": "single", "ball_query": "warp"}

    def wrap_with(old, timed):
        def wrap(kind, fn):
            key = "ball_query" if kind == "ball_query" else "fps"

            def call(*args):
                variant = earlier[kind] if old else None
                if not timed:
                    return fn(*args, _variant=variant)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                torch.cuda._sleep(TURN_SLEEP_CYCLES)
                start.record()
                out = fn(*args, _variant=variant)
                end.record()
                spans[key].append((start, end))
                return out
            return call
        return wrap

    res = {"new": ([], [], []), "earlier": ([], [], [])}
    for variant in ("new", "earlier", "earlier", "new"):
        for pts in scans:
            with wrapped_selections(wrap_with(variant == "earlier", False)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                inference_votenet(model, pts)
                res[variant][0].append((time.perf_counter() - t0) * 1e3)
            for kept in spans.values():
                kept.clear()
            with wrapped_selections(wrap_with(variant == "earlier", True)):
                inference_votenet(model, pts)
            torch.cuda.synchronize()
            for i, key in ((1, "fps"), (2, "ball_query")):
                res[variant][i].append(sum(a.elapsed_time(b)
                                           for a, b in spans[key]))
    return res


def votenet_phase(torch, cfg, device):
    """`init_votenet(cfg)` in f32 and `inference_votenet` on VOTE_SCANS
    scans: per-scan wall time, non-empty finite detections, five K5 and five
    K6 launches per scan, every K5 launch on the cluster kernel (SA1 on a
    cluster of more than one CTA) and every K6 launch on the tiled kernel.
    Then the f32 card-vs-CPU comparison, one scan in "vote" mode (launches
    by variant and finiteness), and the scans' wall, FPS and ball-query
    device time with K5 and K6 against the kernels they replaced, in turns.
    Returns launches per kernel and by variant over the timed scans, and the
    turns' medians."""
    from fcaf3d_tpu_torch import _native
    from fcaf3d_tpu_torch.apis import inference_votenet, init_votenet
    from fcaf3d_tpu_torch.ops.pointnet.fps import fps_plan

    model = init_votenet(cfg, seed=0, device=device)
    scans = [vote_scan(s, cfg.num_points) for s in range(VOTE_SCANS)]

    def checked(dets, what):
        n = len(dets["scores_3d"])
        if n == 0 or dets["boxes_3d"].shape != (n, 7) \
                or not np.isfinite(dets["boxes_3d"]).all() \
                or not np.isfinite(dets["scores_3d"]).all() \
                or not ((dets["labels_3d"] >= 0)
                        & (dets["labels_3d"] < cfg.n_classes)).all():
            raise AssertionError(f"VoteNet {what}: malformed detections")
        return n

    inference_votenet(model, scans[0])  # warm-up: cuBLAS and allocator
    torch.cuda.synchronize()
    _native.reset_launches()
    times, counts = [], []
    for pts in scans:
        t0 = time.perf_counter()
        dets = inference_votenet(model, pts)
        times.append(time.perf_counter() - t0)
        counts.append(checked(dets, f"scan {len(counts)}"))
    launches = dict(_native.LAUNCHES)
    variants = {"/".join(key): n
                for key, n in sorted(_native.VARIANT_LAUNCHES.items())}
    for i, (dt, n) in enumerate(zip(times, counts)):
        log(f"   scan {i}: {dt * 1e3:.1f} ms wall, {n} detections")
    log(f"   launches over {len(scans)} scans: {launches}; K5 / K6 by "
        f"variant {variants}")
    want = {k: 5 * len(scans) if k in PATH_KERNELS["votenet_inference"]
            else 0 for k in launches}
    if launches != want:
        raise AssertionError(f"VoteNet launches {launches}, expected {want}")
    sa1 = fps_plan(1, cfg.num_points, cfg.backbone_num_points[0])
    on_path = {"fps/cluster/float32": want["fps"],
               "ball_query/tiled/float32": want["ball_query"]}
    if variants != on_path or sa1.cs < 2:
        raise AssertionError(f"VoteNet: K5 / K6 launches {variants}, SA1 "
                             f"plan {sa1}: expected every K5 launch on the "
                             "cluster kernel, SA1 on a cluster of more than "
                             "one CTA, every K6 launch on the tiled kernel")
    compare_votenet_f32(torch, model, cfg, scans[0], device)
    _native.reset_launches()
    n = checked(inference_votenet(model, scans[1], sample_mod="vote"),
                "vote mode")
    vote_launches = dict(_native.LAUNCHES)
    vote_variants = {"/".join(key): n
                     for key, n in sorted(_native.VARIANT_LAUNCHES.items())}
    if vote_launches != {k: v // len(scans) for k, v in want.items()} \
            or vote_variants != {k: v // len(scans)
                                 for k, v in on_path.items()}:
        raise AssertionError(f"VoteNet vote mode launches {vote_launches}, "
                             f"by variant {vote_variants}")
    log(f"   \"vote\" mode, scan 1: {n} detections, launches {vote_launches}")
    turns = votenet_turns(torch, model, scans)
    for variant, (wall, fps, ballq) in turns.items():
        log(f"   K5 / K6 {variant}: scan wall ms "
            + " ".join(f"{t:.1f}" for t in wall) + "; FPS device ms "
            + " ".join(f"{t:.3f}" for t in fps) + "; ball-query device ms "
            + " ".join(f"{t:.4f}" for t in ballq))
    medians = {variant: {k: float(np.median(v)) for k, v in zip(
        ("wall_ms", "fps_ms", "ball_query_ms"), lists)}
        for variant, lists in turns.items()}
    return launches, variants, medians


KERNELS = (
    ("searchsorted", "fcaf3d_tpu_torch/csrc/search.cu",
     "fcaf3d_tpu/ops/sparse/search.py:149"),
    ("gather_gemm", "fcaf3d_tpu_torch/csrc/gather_gemm_tc.cu",
     "fcaf3d_tpu/ops/sparse/gather_kernel.py:410"),
    ("gather_max", "fcaf3d_tpu_torch/csrc/gather_max.cu",
     "fcaf3d_tpu/ops/sparse/gather_kernel.py:991"),
    ("gather_dw", "fcaf3d_tpu_torch/csrc/gather_dw_tc.cu",
     "fcaf3d_tpu/ops/sparse/gather_kernel.py:755"),
    ("fps", "fcaf3d_tpu_torch/csrc/fps.cu",
     "fcaf3d_tpu/ops/pointnet/fps_kernel.py:98"),
    ("ball_query", "fcaf3d_tpu_torch/csrc/ball_query.cu",
     "fcaf3d_tpu/ops/pointnet/ballq_kernel.py:157"),
)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="profile a bf16 inference scan, a VoteNet scan and "
                         "the batch-8 bf16 train step instead")
    ap.add_argument("--grad-control", type=int, metavar="SEEDS",
                    help="measure the f32 ScanNet gradients' sensitivity "
                         "over SEEDS seeds instead")
    args = ap.parse_args()
    import torch

    t_start = time.perf_counter()
    smi = device_phase(torch)
    sys.path.insert(0, REPO)
    from fcaf3d_tpu_torch import _native
    from fcaf3d_tpu_torch.configs import fcaf3d_scannet, votenet_sunrgbd

    build_phase()
    cfg = fcaf3d_scannet()
    batch = train_batch(cfg, TRAIN_BATCH, seed0=0)
    if args.profile:
        profile_inference(torch, cfg, [scan(seed) for seed in range(2)])
        profile_votenet(torch, votenet_sunrgbd(), "cuda")
        return profile_train(torch, cfg, batch)
    if args.grad_control:
        return grad_control(torch, cfg, "cuda", args.grad_control)
    scans = [scan(seed) for seed in range(3)]
    log("== 3 kernels against their plain versions, main-path shapes")
    maps = backbone_maps(sample(scans[0], cfg)[None], cfg, "cuda")
    clouds = np.concatenate([batch["points"], batch["colors"]], axis=-1)
    maps8 = backbone_maps(clouds, cfg, "cuda")
    rec = kernel_phase(torch, cfg, maps, maps8)
    log(f"== 4 backward kernels against their plain versions, training "
        f"shapes, batch 1 and batch {TRAIN_BATCH}")
    rec.update(backward_kernel_phase(torch, cfg, [maps, maps8]))
    del maps8  # phase 6's peak memory counts no map of phases 3-4
    log("== 5 inference: fcaf3d_scannet, bf16, batch 1, 100000 points per "
        "scan")
    infer_launches, infer_variants, k1_infer = slice_phase(torch, cfg, scans,
                                                           "cuda")
    rec["gather_gemm"]["f32_scan"] = compare_f32(torch, cfg, scans[0], "cuda")
    log(f"== 6 training: fcaf3d_scannet, bf16, batch {TRAIN_BATCH}, "
        f"{cfg.num_points} points per scan")
    train_launches, train_variants, k1_train = train_phase(torch, cfg, batch,
                                                           "cuda")
    _native.reset_launches()
    compare_train_tiny(torch, "cuda")
    compare_train_f32(torch, cfg, "cuda")
    check_variants("f32 train steps", f32=True)
    rec["searchsorted"]["path_calls"] = {"fcaf3d_inference": k1_infer,
                                         "fcaf3d_training": k1_train}
    vcfg = votenet_sunrgbd()
    log("== 7 K5 and K6 against their plain versions, VoteNet-path shapes")
    rec.update(pointnet_kernel_phase(torch, vcfg, "cuda"))
    log(f"== 8 inference: votenet_sunrgbd, f32, batch 1, {vcfg.num_points} "
        "points per scan")
    vote_launches, vote_variants, turns = votenet_phase(torch, vcfg, "cuda")
    rec["fps"]["scan_turns"] = {v: {k: t[k] for k in ("wall_ms", "fps_ms")}
                                for v, t in turns.items()}
    rec["ball_query"]["scan_turns"] = {
        v: {k: t[k] for k in ("wall_ms", "ball_query_ms")}
        for v, t in turns.items()}
    log(f"== all phases passed in {time.perf_counter() - t_start:.1f} s")
    for what, ms, first, second in NOT_FASTER:
        log(f"   not faster than a yardstick: {what}: kernel {ms:.4f} ms, "
            f"yardsticks {first} and {second} ms")
    by_path = {"fcaf3d_inference": infer_launches,
               "fcaf3d_training": train_launches,
               "votenet_inference": vote_launches}
    variants = {"fcaf3d_inference": infer_variants,
                "fcaf3d_training": train_variants,
                "votenet_inference": vote_variants}
    kernels = []
    for name, src, tpu in KERNELS:
        k = {"name": name, "route": "cuda", "source": src, "replaces": tpu,
             "launches": sum(p[name] for p in by_path.values()),
             "launches_by_path": {k: p[name] for k, p in by_path.items()},
             **rec[name]}
        k["launches_by_variant"] = {
            path: {key: n for key, n in v.items()
                   if key.startswith(name + "/")}
            for path, v in variants.items()}
        kernels.append(k)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
