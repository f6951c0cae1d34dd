"""Smoke run of the PyTorch/CUDA port (`fcaf3d_tpu_torch`) on one GPU.

Run from the repository root, on a machine with an NVIDIA Hopper GPU, nvcc
and PyTorch built for CUDA:

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. Device: require CUDA; print the card's name and power limit.
2. Build: compile the CUDA kernels K1-K3 from `fcaf3d_tpu_torch/csrc/`.
3. Kernels against their plain PyTorch versions on the card, at the shapes
   of the main path's maps on a real-size scan: K1 exact (with and without
   `with_miss`), K2 in f32 and bf16 with every epilogue, K3 exact. Times
   of each kernel and its plain version (CUDA events).
4. The slice: `init_detector(fcaf3d_scannet())` in bf16 and
   `inference_detector` on three 100 000-point scans, with zero overflow
   and every kernel launched; then one scan in f32 on the card against the
   plain path on the CPU (voxel keys and backbone kernel maps exactly equal,
   detections equal within tolerance).

Output: progress lines, then a JSON line of per-kernel results, the
`nvidia-smi` name/power-limit line, and last `{"ok": true, "device": ...}`.
"""
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


def log(msg):
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
    from bench import synth_scene

    xyz, rgb = synth_scene(np.random.RandomState(seed), SCAN_POINTS)
    return np.concatenate([xyz, rgb], axis=1)


def backbone_maps(points, cfg, device, seed=0):
    """The voxel keys and every kernel map the backbone builds for one scan,
    sampled as `inference_detector` samples it. The maps depend only on
    coordinates, so this replays `MEResNet3D`'s map construction."""
    import torch

    from fcaf3d_tpu_torch.ops.sparse import (
        SparseTensor, build_kernel_map, build_kernel_map_self, conv_plan,
        downsample_coords, kernel_offsets, voxelize)

    rng = np.random.default_rng(seed)
    pts = points[rng.choice(len(points), cfg.num_points,
                            replace=len(points) < cfg.num_points)]
    p = torch.as_tensor(pts[None, :, :3].astype(np.float32), device=device)
    c = torch.as_tensor(pts[None, :, 3:6].astype(np.float32), device=device)
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


def cuda_ms(torch, fn, reps=10):
    """Mean device time of `fn` over `reps` launches (CUDA events), after
    one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_phase(torch, cfg, maps):
    from fcaf3d_tpu_torch.ops.sparse import (
        SENTINEL, decode_coords, encode_coords, kernel_offsets)
    from fcaf3d_tpu_torch.ops.sparse import gather_kernel as gk
    from fcaf3d_tpu_torch.ops.sparse import search

    dev = maps["voxel_keys"][0].device
    gen = torch.Generator(device=dev).manual_seed(0)
    rec = {}

    # K1 on the s8 self map's queries and on the voxel compaction query
    s8_keys = maps["s8_keys"][0]
    q = encode_coords(decode_coords(s8_keys)[:, :, None, :] + torch.as_tensor(
        kernel_offsets(3, 8), device=dev)).contiguous()
    # compaction: source row of the j-th valid voxel, as compact_positions
    csum = torch.cumsum((maps["voxel_keys"][0] != SENTINEL).int(), dim=1)
    csum = csum.long().contiguous()
    qc = torch.arange(1, cfg.backbone_budgets[0] + 1, device=dev)
    qc = qc[None, :, None].contiguous()
    k1_cases = [("s8 self-map lookup, with_miss", s8_keys, q, True),
                ("s8 self-map lookup, positions", s8_keys, q, False),
                ("voxel compaction positions", csum, qc, False)]
    k1_err = 0
    for name, kk, qq, miss in k1_cases:
        got = search.searchsorted_segments(kk, qq, with_miss=miss, layout="ms")
        want = search.searchsorted_segments_plain(kk, qq, with_miss=miss)
        torch.cuda.synchronize()
        k1_err = max(k1_err, int((got.long() - want.long()).abs().max()))
        if not torch.equal(got, want):
            raise AssertionError(f"K1 {name}: kernel != plain")
        ms = cuda_ms(torch, lambda: search.searchsorted_segments(
            kk, qq, with_miss=miss, layout="ms"))
        plain = cuda_ms(torch, lambda: search.searchsorted_segments_plain(
            kk, qq, with_miss=miss))
        log(f"   K1 {name} {tuple(qq.shape)} in N={kk.shape[1]}: exact; "
            f"kernel {ms:.4f} ms, plain {plain:.4f} ms")
        rec.setdefault("searchsorted", {"ms": ms, "plain_ms": plain})
    rec["searchsorted"]["max_abs_err"] = k1_err

    # K2 at every (C, E, K) of the path, on that shape's real map
    map_for = {(3, 64, 27): "s1_k3s2", (1, 8, 27): "s16_k3s1",
               (64, 64, 27): "s8_k3s1", (256, 512, 1): "s32_k1s2",
               (512, 512, 27): "s64_k3s1", (128, 128, 27): "s16_k3s1"}
    k2_err = {"float32": 0.0, "bfloat16": 0.0}
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
                k2_err[dname] = max(k2_err[dname], diff)
            kw = dict(variants)[PATH_VARIANT[(c, e, k)]]
            ms = cuda_ms(torch, lambda: gk.fused_gather_gemm(
                feats, idx, w, **kw))
            plain = cuda_ms(torch, lambda: gk.fused_gather_gemm_plain(
                feats, idx, w, **kw))
            log(f"   K2 C={c} E={e} K={k} {dname} idx {tuple(idx.shape)} "
                f"N={n}: {len(variants)} variants ok (max abs diff so far "
                f"{k2_err[dname]:.3g}); kernel {ms:.4f} ms, plain "
                f"{plain:.4f} ms")
            if (c, e, k, dname) == (64, 64, 27, "bfloat16"):
                rec["gather_gemm"] = {"ms": ms, "plain_ms": plain}
    rec["gather_gemm"]["max_abs_err"] = k2_err["float32"]

    # K3 on the stem pool map
    idx, n = maps["s2_pool_k2s2"]
    k3_err = 0.0
    for dname in ("float32", "bfloat16"):
        feats = torch.randn(idx.shape[0], n, 64, generator=gen,
                            device=dev).to(getattr(torch, dname))
        got = gk.fused_gather_max(feats, idx)
        want = gk.fused_gather_max_plain(feats, idx)
        torch.cuda.synchronize()
        k3_err = max(k3_err, float((got.float() - want.float()).abs().max()))
        if not torch.equal(got, want):
            raise AssertionError(f"K3 {dname}: kernel != plain")
        ms = cuda_ms(torch, lambda: gk.fused_gather_max(feats, idx))
        plain = cuda_ms(torch, lambda: gk.fused_gather_max_plain(feats, idx))
        log(f"   K3 {dname} idx {tuple(idx.shape)} N={n} C=64: exact; "
            f"kernel {ms:.4f} ms, plain {plain:.4f} ms")
        if dname == "bfloat16":
            rec["gather_max"] = {"ms": ms, "plain_ms": plain}
    rec["gather_max"]["max_abs_err"] = k3_err
    return rec


def compare_f32(torch, cfg, points, device):
    """One scan in f32: the card against the plain path on the CPU."""
    from fcaf3d_tpu_torch.apis import inference_detector, init_detector

    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    gpu_maps = backbone_maps(points, cfg32, device)
    cpu_maps = backbone_maps(points, cfg32, "cpu")
    for name, (m, _) in gpu_maps.items():
        if not torch.equal(m.cpu(), cpu_maps[name][0]):
            raise AssertionError(f"f32 slice: {name} differs card vs CPU")
    log(f"   f32: voxel keys and {len(gpu_maps) - 1} backbone maps equal "
        "card vs CPU")
    got, got_ovf = inference_detector(init_detector(cfg32, 0, device=device),
                                      points)
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


def slice_phase(torch, cfg, scans, device):
    """bf16 inference on every scan; returns launches per kernel."""
    from fcaf3d_tpu_torch import _native
    from fcaf3d_tpu_torch.apis import inference_detector, init_detector

    model = init_detector(cfg, seed=0, device=device)
    inference_detector(model, scans[0])  # warm-up: cuBLAS and allocator
    torch.cuda.synchronize()
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
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{missing}")
    return launches


KERNELS = (
    ("searchsorted", "fcaf3d_tpu_torch/csrc/search.cu",
     "fcaf3d_tpu/ops/sparse/search.py:149"),
    ("gather_gemm", "fcaf3d_tpu_torch/csrc/gather_gemm.cu",
     "fcaf3d_tpu/ops/sparse/gather_kernel.py:410"),
    ("gather_max", "fcaf3d_tpu_torch/csrc/gather_max.cu",
     "fcaf3d_tpu/ops/sparse/gather_kernel.py:991"),
)


def main():
    import torch

    smi = device_phase(torch)
    sys.path.insert(0, REPO)
    from fcaf3d_tpu_torch.configs import fcaf3d_scannet

    build_phase()
    cfg = fcaf3d_scannet()
    scans = [scan(seed) for seed in range(3)]
    log("== 3 kernels against their plain versions, main-path shapes")
    rec = kernel_phase(torch, cfg, backbone_maps(scans[0], cfg, "cuda"))
    log("== 4 slice: fcaf3d_scannet, bf16, batch 1, 100000 points per scan")
    launches = slice_phase(torch, cfg, scans, "cuda")
    compare_f32(torch, cfg, scans[0], "cuda")
    kernels = [{"name": name, "route": "cuda", "source": src,
                "replaces": tpu, "launches": launches[name], **rec[name]}
               for name, src, tpu in KERNELS]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
