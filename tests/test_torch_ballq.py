"""Kernel K6 (ball query) of the PyTorch port on the CPU: a numpy replay of
the tiled kernel's protocol (`csrc/ball_query.cu`) held to the plain version
and to the JAX package's `ball_query_grid` (Pallas in interpret mode), the
launch plan read back against the kernel's constants, and what the wrapper
hands its C entries.

The replay follows the kernel step by step: CTAs of kWarps warps with one
centre each (`ball_query_plan`), tiles of kTilePoints points staged as a
ragged head, 16-byte lines and a ragged tail, windows of 32 groups of 32
points whose ballots are walked in index order after the window, each
centre's counter stopping as soon as it is full, and the CTA's stop vote at
the tile boundary. Small tiles and windows replay the same protocol on small
clouds, so that every boundary is crossed.
"""
import importlib
import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fcaf3d_tpu.ops.pointnet.ballq_kernel import ball_query_grid
from fcaf3d_tpu_torch import _native
from fcaf3d_tpu_torch.ops.pointnet.fps import furthest_point_sample_plain
from tests.test_torch_kernels import _cuda_looking, _Recorder
from tests.test_torch_ops import jax_without_persistent_cache  # noqa: F401
from tests.test_torch_pointnet import lattice_cloud, scene

# the module (the package exports its function under the same name)
tbq = importlib.import_module("fcaf3d_tpu_torch.ops.pointnet.ball_query")
SOURCE = (Path(tbq.__file__).parents[2] / "csrc" / "ball_query.cu").read_text()


def constant(name):
    """The value of `constexpr int name = <integer>;` in ball_query.cu."""
    return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE).group(1))


WARPS, TILE, WINDOW = (constant(k) for k in ("kWarps", "kTilePoints",
                                             "kWindow"))
SMEM_PER_SM = 232448  # the H100's shared memory a block may use, bytes


def split(skew, count, line):
    """(head, lines, tail) of `count` items that start `skew` items into a
    line of `line` items, as `stage_tile` splits a tile: the items before
    the first whole line, the whole lines, the items after them."""
    head = min(count, (line - skew) % line)
    lines = (count - head) // line
    return head, lines, count - head - line * lines


def staged(src, skew, line, size):
    """A stage's copy of `src` as `stage_tile` lays it out: the ragged head
    and tail item by item, the lines whole, all `skew` items in."""
    out = np.full(size, np.nan if src.dtype.kind == "f" else 0, src.dtype)
    head, lines, tail = split(skew, len(src), line)
    body = head + line * lines
    assert head < line and tail < line
    assert lines == 0 or (skew + head) % line == 0  # the lines line up
    out[skew:skew + head] = src[:head]
    out[skew + head:skew + body] = src[head:body]
    out[skew + body:skew + body + tail] = src[body:]
    return out[skew:skew + len(src)]


def replay_k6(centers, points, valid, radius, nsample, plan, tile=TILE,
              window=WINDOW):
    """The tiled kernel on numpy arrays ([B, M, 3], [B, N, 3] f32, [B, N]
    bool or None). Returns (out [B, M, nsample] int32, counts of protocol
    events: centres that filled inside a tile with points left, CTAs that
    stopped before their last tile, warps that skipped a window)."""
    b, m, _ = centers.shape
    n = points.shape[1]
    per_cloud = math.ceil(m / WARPS)
    assert plan.ctas == b * per_cloud
    r2 = np.float32(tbq.squared_radius(radius))
    out = np.zeros((b, m, nsample), np.int32)
    events = {"full_mid_tile": 0, "cta_stop": 0, "warp_skip": 0}
    flat_xyz = points.reshape(-1)
    flat_valid = None if valid is None else valid.reshape(-1)
    tiles = math.ceil(n / tile)
    for bi in range(b):
        for cta in range(per_cloud):
            ids = cta * WARPS + np.arange(WARPS)  # a centre a warp
            cen = centers[bi, np.minimum(ids, m - 1)]
            count = np.where(ids < m, 0, nsample)
            first = np.zeros(len(ids), np.int64)
            for t in range(tiles):
                p0 = t * tile
                np_ = min(n - p0, tile)
                f0 = 3 * (bi * n + p0)  # the tile's first float
                xs = staged(flat_xyz[f0:f0 + 3 * np_], f0 % 4, 4,
                            3 * tile + 4).reshape(np_, 3)
                np.testing.assert_array_equal(xs, points[bi, p0:p0 + np_])
                ok = np.ones(np_, bool)
                if valid is not None:
                    v0 = bi * n + p0
                    ok = staged(flat_valid[v0:v0 + np_].view(np.uint8),
                                v0 % 16, 16, tile + 16).astype(bool)
                for w0 in range(0, np_, window):
                    j = np.arange(w0, w0 + window)  # past np_: never a hit
                    px = np.full((window, 3), np.nan, np.float32)
                    px[j < np_] = xs[j[j < np_]]
                    okw = np.zeros(window, bool)
                    okw[j < np_] = ok[j[j < np_]]
                    for c in range(WARPS):
                        if count[c] >= nsample:
                            events["warp_skip"] += 1
                            continue
                        d = px - cen[c]  # f32, each operation rounded
                        d2 = (d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]) \
                            + d[:, 2] * d[:, 2]
                        ballots = (okw & (d2 < r2)).reshape(window // 32, 32)
                        for g in np.flatnonzero(ballots.any(1)):
                            if count[c] >= nsample:
                                break  # the walk stops: full
                            lanes = np.flatnonzero(ballots[g])
                            base = p0 + w0 + 32 * g
                            if count[c] == 0:
                                first[c] = base + lanes[0]
                            slots = count[c] + np.arange(len(lanes))
                            keep = slots < nsample
                            out[bi, ids[c], slots[keep]] = base + lanes[keep]
                            count[c] += len(lanes)
                            if count[c] >= nsample and base + 32 < p0 + np_:
                                events["full_mid_tile"] += 1
                if not (count < nsample).any():  # the CTA's stop vote
                    events["cta_stop"] += t + 1 < tiles
                    break
            for c, i in enumerate(ids):
                if i < m:
                    out[bi, i, min(count[c], nsample):] = first[c]
    return out, events


def fps_centres(pts, m):
    """The first `m` - 1 plain-FPS samples of each cloud plus one centre far
    from every point (a row with no hit)."""
    idx = furthest_point_sample_plain(torch.as_tensor(pts), m - 1).numpy()
    cent = np.take_along_axis(pts, idx[..., None].astype(np.int64), axis=1)
    far = np.full((len(pts), 1, 3), 50.0, np.float32)
    return np.ascontiguousarray(np.concatenate([cent, far], axis=1))


def masked(b, n, seed):
    v = np.random.default_rng(seed).random((b, n)) < 0.7
    v[:, :3] = False
    return v


def case(name):
    """(centres, points, valid, radius, nsample) of a named cloud."""
    if name in ("tiny SA1", "tiny SA2"):  # votenet_tiny: 512 points
        pts = np.stack([scene(s, 512) for s in (0, 1)])
        m, r, ns = (129, 0.2, 64) if name == "tiny SA1" else (65, 0.4, 32)
        return fps_centres(pts, m), pts, masked(2, 512, m), r, ns
    if name == "nsample > N":
        pts = np.random.default_rng(2).uniform(0, 0.5, (2, 37, 3)).astype(
            np.float32)
        return fps_centres(pts, 11), pts, masked(2, 37, 3), 1.0, 64
    if name == "lattice d2 == r2":  # r^2 = 2 exactly: sqrt 2 rounds to 2.0
        pts = np.concatenate([lattice_cloud(701, seed=s) for s in (0, 1)])
        cent = np.ascontiguousarray(pts[:, 100:150])
        return cent, pts, masked(2, 701, 5), math.sqrt(2.0), 32
    if name == "dense, every centre fills":
        pts = np.random.default_rng(4).uniform(0, 1, (2, 1001, 3)).astype(
            np.float32)
        return fps_centres(pts, 23), pts, masked(2, 1001, 6), 0.5, 16
    assert name == "room, N % 4 != 0, tiles"
    pts = np.stack([scene(s, 5003, (4.0, 4.0, 2.0)) for s in (2, 3)])
    return fps_centres(pts, 70), pts, masked(2, 5003, 7), 0.3, 32


CASES = ["tiny SA1", "tiny SA2", "nsample > N", "lattice d2 == r2",
         "dense, every centre fills", "room, N % 4 != 0, tiles"]


@pytest.mark.parametrize("sizes", ["kernel", "small"])
@pytest.mark.parametrize("name", CASES)
def test_k6_replay_matches_plain(name, sizes):
    """The replayed kernel gives exactly `ball_query_plain`'s indices (B = 2,
    the second cloud masked, a centre with no hit) at the kernel's tile and
    window and at small ones (256 / 128 points: many tiles, windows of 4
    groups)."""
    cent, pts, valid, r, ns = case(name)
    want = tbq.ball_query_plain(torch.as_tensor(cent), torch.as_tensor(pts),
                                r, ns, torch.as_tensor(valid)).numpy()
    tile, window = (TILE, WINDOW) if sizes == "kernel" else (256, 128)
    b, m, n = len(pts), cent.shape[1], pts.shape[1]
    got, events = replay_k6(cent, pts, valid, r, ns,
                            tbq.ball_query_plan(b, m, n), tile, window)
    np.testing.assert_array_equal(got, want)
    if name == "nsample > N":
        assert ns > n
    if name == "dense, every centre fills" and sizes == "small":
        assert events["full_mid_tile"] and events["cta_stop"] \
            and events["warp_skip"], events
    if name == "lattice d2 == r2":  # points at exactly r^2 are out
        d2 = ((pts[:, None] - cent[:, :, None]) ** 2).sum(-1)
        assert (d2 == 2.0).any() and not np.isin(
            np.flatnonzero((d2 == 2.0)[0, 0]), want[0, 0]).any()
    if name.startswith("tiny"):
        assert (want[:, -1] == 0).all()  # the far centre: no hit


@pytest.mark.parametrize("name", ["tiny SA1", "lattice d2 == r2"])
def test_k6_replay_matches_pallas_grid(name):
    """The replay at the kernel's plan equals `ball_query_grid` with its
    Pallas kernel in interpret mode, where the grid's overflow is <= 0
    (asserted): the TPU kernel's contract."""
    cent, pts, valid, r, ns = case(name)
    plan = tbq.ball_query_plan(len(pts), cent.shape[1], pts.shape[1])
    got, _ = replay_k6(cent, pts, valid, r, ns, plan)
    want, overflow = ball_query_grid(jnp.asarray(cent), jnp.asarray(pts), r,
                                     ns, jnp.asarray(valid), interpret=True)
    assert int(overflow) <= 0
    np.testing.assert_array_equal(got, np.asarray(want))


def test_k6_plan_matches_the_kernel_source():
    """The plan's constants are the kernel's: BQ_WARPS is kWarps, the CTAs
    a cloud of `fcaf3d_ball_query_tiled` are M over kWarps rounded up,
    BQ_TILE_POINTS is kTilePoints, and a CTA's two stages (and mbarriers)
    need more than the default 48 KB of shared memory, which the launch
    grants once per instance and device, and fit an SM with room for
    several CTAs; `_native` binds the one K6 entry. A mismatch would show on
    the card only as a refused launch or a wrong result."""
    assert WARPS == tbq.BQ_WARPS and TILE == tbq.BQ_TILE_POINTS
    entry = SOURCE[SOURCE.index('extern "C" int fcaf3d_ball_query_tiled('):]
    assert "per_cloud = (m + kWarps - 1) / kWarps;" in entry
    assert "float xyz[3 * kTilePoints + 4];" in SOURCE
    assert "uint8_t valid[kTilePoints + 16];" in SOURCE
    assert "kSmemBytes = 2 * (int)sizeof(Stage) + 16;" in SOURCE
    smem = 2 * (4 * (3 * TILE + 4) + TILE + 16) + 16
    assert smem > 48 * 1024  # hence cudaFuncSetAttribute before the launch
    assert SMEM_PER_SM // (smem + 1024) >= 4  # +1 KB the card reserves
    grant = SOURCE[SOURCE.index("cudaError_t allow_tiled_smem() {"):
                   SOURCE.index("int launch_tiled(")]
    assert "if (granted.load(std::memory_order_relaxed) & bit)" in grant
    assert "cudaFuncAttributeMaxDynamicSharedMemorySize" in grant
    assert SOURCE.count("cudaFuncSetAttribute(") == 1
    bound = re.findall(r"lib\.(fcaf3d_ball_query\w*)\.argtypes",
                       Path(_native.__file__).read_text())
    assert bound == ["fcaf3d_ball_query_tiled"]


@pytest.mark.parametrize("b,m,n", [(1, 2048, 20000), (1, 1024, 2048),
                                   (1, 512, 1024), (1, 256, 512),
                                   (1, 256, 1024), (2, 2048, 20000),
                                   (16, 2048, 20000), (2, 129, 512),
                                   (1, 1, 1)])
def test_k6_plan_covers_every_centre_once(b, m, n):
    """The plan is a function of (B, M, N): its CTAs give each centre of
    each cloud exactly one warp, no CTA is empty, and its tiles cover N."""
    plan = tbq.ball_query_plan(b, m, n)
    assert plan == tbq.ball_query_plan(b, m, n)
    per_cloud = plan.ctas // b
    owner = np.zeros(m, np.int64)
    for cta in range(per_cloud):
        ids = cta * WARPS + np.arange(WARPS)
        assert ids[0] < m
        owner[ids[ids < m]] += 1
    assert (owner == 1).all() and plan.ctas == b * per_cloud
    assert plan.tiles * TILE >= n > (plan.tiles - 1) * TILE


@pytest.mark.parametrize("b,m,n,with_valid", [(1, 2048, 20000, False),
                                              (2, 129, 512, True)])
def test_k6_wrapper_launches_the_plan(monkeypatch, b, m, n, with_valid):
    """On a CUDA tensor the wrapper hands `fcaf3d_ball_query_tiled` the
    tensors, the shapes and the f32 r^2, the same on every call, counts each
    launch as "tiled", and takes no keyword that picks another kernel."""
    lib = _Recorder()
    monkeypatch.setattr(_native, "load", lambda: lib)
    monkeypatch.setattr(_native, "stream_ptr", lambda dev: 0)
    _native.reset_launches()
    cent = _cuda_looking(torch.zeros(b, m, 3))
    pts = _cuda_looking(torch.zeros(b, n, 3))
    valid = _cuda_looking(torch.ones(b, n, dtype=torch.bool)) \
        if with_valid else None
    r2 = tbq.squared_radius(0.2)
    outs = [tbq.ball_query(cent, pts, 0.2, 64, valid) for _ in range(2)]
    assert all(o.shape == (b, m, 64) and o.dtype == torch.int32 for o in outs)
    (n1, a1), (n2, a2) = lib.calls
    assert n1 == n2 == "fcaf3d_ball_query_tiled"
    assert a1[:2] == (cent.data_ptr(), pts.data_ptr())
    assert a1[2] == (valid.data_ptr() if with_valid else None)
    assert (a1[3], a2[3]) == (outs[0].data_ptr(), outs[1].data_ptr())
    assert a1[4:] == (b, m, n, 64, r2, 0) == a2[4:]
    assert _native.VARIANT_LAUNCHES == {
        ("ball_query", "tiled", "float32"): 2}
    assert _native.LAUNCHES["ball_query"] == 2
    with pytest.raises(TypeError, match="_variant"):
        tbq.ball_query(cent, pts, 0.2, 64, _variant="warp")
    assert len(lib.calls) == 2
    _native.reset_launches()


@pytest.mark.parametrize("what", ["f64 points", "mask of bytes",
                                  "strided points", "points on the CPU"])
def test_k6_wrapper_refuses_what_its_kernels_cannot_take(monkeypatch, what):
    """On a CUDA tensor the wrapper raises before any launch on inputs the
    kernels do not take, rather than running something else."""
    lib = _Recorder()
    monkeypatch.setattr(_native, "load", lambda: lib)
    monkeypatch.setattr(_native, "stream_ptr", lambda dev: 0)
    cent, pts = torch.zeros(1, 8, 3), torch.zeros(1, 40, 3)
    valid = None
    if what == "f64 points":
        pts = pts.double()
    elif what == "mask of bytes":
        valid = _cuda_looking(torch.ones(1, 40, dtype=torch.uint8))
    elif what == "strided points":
        pts = torch.zeros(1, 3, 40).transpose(1, 2)
    cent = _cuda_looking(cent)
    if what == "points on the CPU":  # the public entry would run plain here
        with pytest.raises(ValueError, match="one CUDA device"):
            tbq._ball_query_cuda(cent, pts, 0.2, 16, None)
    else:
        with pytest.raises((TypeError, ValueError), match="K6"):
            tbq.ball_query(cent, _cuda_looking(pts), 0.2, 16, valid)
    assert lib.calls == []
