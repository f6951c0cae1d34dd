"""The port's PointNet++ ops (`fcaf3d_tpu_torch.ops.pointnet`), box helpers
and aligned 3D NMS held against the JAX package on the CPU, on the same
numpy inputs.

K5 (farthest-point sampling) and K6 (ball query) run their plain versions
here, as every wrapper does on a CPU tensor; the JAX side runs its XLA
formulations and its Pallas kernels in interpret mode. Indices and masks
must be exactly equal; floats within f32 atol 1e-5 unless a test says why.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from fcaf3d_tpu.core import geometry as jgeo
from fcaf3d_tpu.core.nms import aligned_3d_nms as j_aligned_nms
from fcaf3d_tpu.ops.pointnet import ops as jops
from fcaf3d_tpu.ops.pointnet.ballq_kernel import ball_query_grid
from fcaf3d_tpu.ops.pointnet.fps_kernel import fps_tpu
from fcaf3d_tpu_torch import configs as tconfigs
from fcaf3d_tpu_torch.core import geometry as tgeo
from fcaf3d_tpu_torch.core.nms import aligned_3d_nms
from fcaf3d_tpu_torch.models.votenet import VoteNet
from fcaf3d_tpu_torch.ops.pointnet import fps as tfps
from fcaf3d_tpu_torch.ops.pointnet import ops as tops
from fcaf3d_tpu_torch.ops.pointnet.ball_query import squared_radius
from tests.test_torch_ops import jax_without_persistent_cache  # noqa: F401


def fps_cloud(rng, b, n, dup=True):
    """[B, N, 3] f32 with an exact duplicate point in the second cloud (a
    tie) and valid masks whose first valid index is > 0."""
    pts = rng.standard_normal((b, n, 3)).astype(np.float32)
    if dup:
        pts[1, 5] = pts[1, 3]
    valid = np.ones((b, n), bool)
    valid[0, :4] = False
    valid[1, n // 2:] = False
    return pts, valid


def scene(seed, n, extent=(2.0, 2.0, 1.4)):
    xyz, _ = bench.synth_scene(np.random.RandomState(seed), n, extent=extent)
    return xyz


@pytest.mark.parametrize("jax_form", ["xla", "pallas"])
@pytest.mark.parametrize("n,s", [(300, 17), (300, 200), (1000, 128)])
def test_k5_plain_matches_jax(jax_form, n, s):
    """Exactly the JAX indices: B = 2, valid masks starting past index 0, a
    duplicate point; (300, 200) asks for more samples than the second
    cloud's 150 valid points, so its tail repeats the first valid index."""
    rng = np.random.default_rng(n + s)
    pts, valid = fps_cloud(rng, 2, n)
    if n == 1000:  # a room-like cloud: many near-equal distances
        pts = np.stack([scene(0, n), scene(1, n)])
    got = tops.furthest_point_sample(torch.as_tensor(pts), s,
                                     torch.as_tensor(valid)).numpy()
    if jax_form == "xla":
        want = jops.furthest_point_sample(jnp.asarray(pts), s,
                                          jnp.asarray(valid))
    else:
        want = fps_tpu(jnp.asarray(pts), s, jnp.asarray(valid),
                       interpret=True)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert got.dtype == np.int32 and valid[np.arange(2)[:, None], got].all()
    if s > valid[1].sum():
        assert (got[1, valid[1].sum():] == np.argmax(valid[1])).all()


def test_k5_without_mask_starts_at_zero():
    pts = np.random.default_rng(3).standard_normal((1, 64, 3)).astype(
        np.float32)
    got = tops.furthest_point_sample(torch.as_tensor(pts), 8).numpy()
    want = jops.furthest_point_sample(jnp.asarray(pts), 8)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert got[0, 0] == 0


def ball_case(pts, m, with_valid, seed=0):
    """FPS centres of the clouds [B, N, 3] plus one centre far from every
    point (a row with no hit), and an optional random valid mask."""
    idx = np.asarray(jops.furthest_point_sample(jnp.asarray(pts), m - 1))
    cent = np.take_along_axis(pts, idx[..., None], axis=1)
    far = np.full((len(pts), 1, 3), 50.0, np.float32)
    cent = np.ascontiguousarray(np.concatenate([cent, far], axis=1))
    valid = (np.random.default_rng(seed).random(pts.shape[:2]) < 0.7
             if with_valid else None)
    return cent, valid


def t_or_none(x):
    return None if x is None else torch.as_tensor(x)


def j_or_none(x):
    return None if x is None else jnp.asarray(x)


@pytest.mark.parametrize("radius,nsample", [(0.2, 64), (0.4, 32), (0.3, 16)])
@pytest.mark.parametrize("with_valid", [False, True])
def test_k6_plain_matches_pallas_grid(radius, nsample, with_valid):
    """Exactly `ball_query_grid` with its Pallas kernel in interpret mode,
    on scenes where its overflow is <= 0 (asserted): first hits in index
    order, rows padded with the first hit, zeros for the far centre.
    Uniform clouds sized so that a ball holds ~1.5 nsample points on
    average: some rows fill up, and the grid's columns stay under its
    128-candidate cap."""
    n = 1500
    side = radius * (n * 4.19 / (1.5 * nsample)) ** (1 / 3)
    pts = np.random.default_rng(nsample).uniform(0, side, (2, n, 3)).astype(
        np.float32)
    cent, valid = ball_case(pts, 96, with_valid)
    got = tops.ball_query(torch.as_tensor(cent), torch.as_tensor(pts), radius,
                          nsample, t_or_none(valid)).numpy()
    want, overflow = ball_query_grid(jnp.asarray(cent), jnp.asarray(pts),
                                     radius, nsample, j_or_none(valid),
                                     interpret=True)
    assert int(overflow) <= 0
    np.testing.assert_array_equal(got, np.asarray(want))
    assert got.dtype == np.int32 and (got[:, -1] == 0).all()
    counts = [len(set(r)) for r in got.reshape(-1, nsample)]
    assert max(counts) == nsample and min(counts[:-1]) >= 1


def test_k6_plain_matches_brute_off_the_boundary():
    """Against the JAX package's brute `ball_query` (the |a|^2 - 2a.b + |b|^2
    expansion): equal except on points within 1e-5 of r^2."""
    radius, nsample = 0.2, 64
    pts = np.stack([scene(7, 3000, (3, 3, 2)), scene(8, 3000, (3, 3, 2))])
    cent, _ = ball_case(pts, 256, False)
    got = tops.ball_query(torch.as_tensor(cent), torch.as_tensor(pts), radius,
                          nsample).numpy()
    want = np.asarray(jops.ball_query(jnp.asarray(cent), jnp.asarray(pts),
                                      radius, nsample))
    bad = 0
    for bi, mi in zip(*np.where((got != want).any(-1))):
        d2 = ((pts[bi].astype(np.float64)
               - cent[bi, mi].astype(np.float64)) ** 2).sum(-1)
        disputed = set(got[bi, mi]) ^ set(want[bi, mi])
        bad += any(abs(d2[i] - radius ** 2) > 1e-5 for i in disputed)
    assert bad == 0


def test_k6_more_samples_than_points():
    """nsample > N: the hits, then the first hit repeated."""
    pts = np.random.default_rng(0).uniform(0, 0.1, (1, 5, 3)).astype(
        np.float32)
    cent = pts[:, :2].copy()
    got = tops.ball_query(torch.as_tensor(cent), torch.as_tensor(pts), 1.0,
                          8).numpy()
    want = jops.ball_query(jnp.asarray(cent), jnp.asarray(pts), 1.0, 8)
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(got[0, 0], [0, 1, 2, 3, 4, 0, 0, 0])


def test_squared_radius_is_the_f32_product():
    for r in (0.2, 0.3, 0.4, 0.8, 1.2):
        assert squared_radius(r) == float(jnp.float32(r * r))


def test_gather_group_three_nn_interpolate_match_jax():
    rng = np.random.default_rng(5)
    pts = rng.standard_normal((2, 120, 3)).astype(np.float32)
    feats = rng.standard_normal((2, 120, 7)).astype(np.float32)
    query = rng.standard_normal((2, 40, 3)).astype(np.float32)
    idx = rng.integers(0, 120, (2, 40)).astype(np.int32)
    gidx = rng.integers(0, 120, (2, 40, 5)).astype(np.int32)
    np.testing.assert_array_equal(
        tops.gather_points(torch.as_tensor(feats), torch.as_tensor(idx)),
        np.asarray(jops.gather_points(jnp.asarray(feats), jnp.asarray(idx))))
    np.testing.assert_array_equal(
        tops.group_points(torch.as_tensor(feats), torch.as_tensor(gidx)),
        np.asarray(jops.group_points(jnp.asarray(feats), jnp.asarray(gidx))))
    valid = rng.random((2, 120)) < 0.8
    for v in (None, valid):
        dist_t, idx_t = tops.three_nn(torch.as_tensor(query),
                                      torch.as_tensor(pts), t_or_none(v))
        dist_j, idx_j = jops.three_nn(jnp.asarray(query), jnp.asarray(pts),
                                      j_or_none(v))
        np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
        np.testing.assert_allclose(dist_t.numpy(), np.asarray(dist_j),
                                   rtol=0, atol=1e-5)
    out_t = tops.three_interpolate(torch.as_tensor(feats), idx_t, dist_t)
    out_j = jops.three_interpolate(jnp.asarray(feats), idx_j, dist_j)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), rtol=0,
                               atol=1e-5)


def random_boxes(rng, k):
    """Bottom-centre box7 [K, 7] in a 3 m room: sizes 0.2-1.5 m, yaw in
    (-pi, pi); every fourth box a near copy of its neighbour (overlaps)."""
    boxes = np.concatenate([
        rng.uniform(0, 3, (k, 3)), rng.uniform(0.2, 1.5, (k, 3)),
        rng.uniform(-np.pi, np.pi, (k, 1))], axis=1)
    boxes[3::4] = boxes[2::4][:len(boxes[3::4])] + rng.normal(0, 0.05, (
        len(boxes[3::4]), 7))
    return boxes.astype(np.float32)


def test_box_corners_and_points_in_boxes_match_jax():
    """Corners within 1e-6; inside masks exactly equal, single and
    batched (the port's extra leading dims)."""
    rng = np.random.default_rng(2)
    boxes = random_boxes(rng, 24)
    pts = rng.uniform(-0.2, 3.2, (2000, 3)).astype(np.float32)
    np.testing.assert_allclose(
        tgeo.box7_corners(torch.as_tensor(boxes)).numpy(),
        np.asarray(jgeo.box7_corners(jnp.asarray(boxes))), rtol=0, atol=1e-6)
    got = tgeo.points_in_boxes(torch.as_tensor(pts), torch.as_tensor(boxes))
    want = np.asarray(jgeo.points_in_boxes(jnp.asarray(pts),
                                           jnp.asarray(boxes)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.any(0).sum() > 12  # most boxes hold points
    batched = tgeo.points_in_boxes(torch.as_tensor(np.stack([pts, pts])),
                                   torch.as_tensor(np.stack([boxes, boxes])))
    np.testing.assert_array_equal(batched.numpy(), np.stack([want, want]))


@pytest.mark.parametrize("with_valid", [False, True])
def test_aligned_3d_nms_matches_jax(with_valid):
    """Keep masks exactly equal, with duplicate scores (stable order), two
    classes and padding rows; batched over two cloud copies."""
    rng = np.random.default_rng(4)
    k = 48
    corners = tgeo.box7_corners(torch.as_tensor(random_boxes(rng, k))).numpy()
    boxes6 = np.concatenate([corners.min(1), corners.max(1)], -1)
    scores = rng.random(k).astype(np.float32)
    scores[10:14] = scores[9]
    classes = rng.integers(0, 2, k)
    valid = rng.random(k) < 0.8 if with_valid else None
    want = np.asarray(j_aligned_nms(jnp.asarray(boxes6), jnp.asarray(scores),
                                    jnp.asarray(classes), 0.25,
                                    j_or_none(valid)))
    got = aligned_3d_nms(torch.as_tensor(boxes6), torch.as_tensor(scores),
                         torch.as_tensor(classes), 0.25, t_or_none(valid))
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.sum() < k - (0 if valid is None else (~valid).sum())
    two = aligned_3d_nms(*(torch.as_tensor(np.stack([a, a])) for a in
                           (boxes6, scores, classes)), 0.25,
                         None if valid is None else torch.as_tensor(
                             np.stack([valid, valid])))
    np.testing.assert_array_equal(two.numpy(), np.stack([want, want]))


def lattice_cloud(n, seed=0):
    """[1, N, 3] f32 integer lattice points, each site drawn many times: a
    cloud of exact ties (equal distances and duplicated points)."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, (9, 7, 5), (1, n, 3)).astype(np.float32)


def partitioned_fps(pts, s, valid, plan):
    """K5's cluster kernel (`csrc/fps.cu`) replayed in numpy on one cloud
    [N, 3]: point (r * T + t) * P + j lives in thread t of CTA r (rank) as
    its j-th point; the argmax compares each minimum's bits as an int32, so
    that invalid points (-1.0) and padding (-0.5) sort below every distance.
    Each step every thread keeps its first best, every warp its lowest lane
    at the warp's maximum, and the (rank, warp) candidates, carrying their
    coordinates, are folded in cluster-rank order by the kernel's rule
    (larger value, then lower index)."""
    cs, t, p = plan.cs, plan.threads, plan.points_per_thread
    n = len(pts)
    cap = cs * t * p
    xyz = np.zeros((cap, 3), np.float32)
    xyz[:n] = pts
    dcur = np.full(cap, -0.5, np.float32)
    dcur[:n] = np.where(valid, np.float32(1e10), np.float32(-1))
    x, y, z = (xyz[:, c].reshape(cs, t, p) for c in range(3))
    dcur = dcur.reshape(cs, t, p)
    index = np.arange(cap).reshape(cs, t, p)
    out, centre = [], None
    for k in range(s):
        if k:
            dx, dy, dz = x - centre[0], y - centre[1], z - centre[2]
            dcur = np.minimum(dcur, (dx * dx + dy * dy) + dz * dz)
        bits = dcur.view(np.int32)
        j = np.argmax(bits, axis=2)  # [cs, t]: the first best of a thread
        key = np.take_along_axis(bits, j[..., None], 2)[..., 0]
        idx = np.take_along_axis(index, j[..., None], 2)[..., 0]
        key, idx = key.reshape(cs, t // 32, 32), idx.reshape(cs, t // 32, 32)
        lane = np.argmax(key, axis=2)  # the lowest lane at the maximum
        wkey = np.take_along_axis(key, lane[..., None], 2)[..., 0]
        widx = np.take_along_axis(idx, lane[..., None], 2)[..., 0]
        best_k, best_i = np.iinfo(np.int32).min, cap
        for r in range(cs):
            for w in range(t // 32):
                kk, i = wkey[r, w], widx[r, w]
                if kk > best_k or (kk == best_k and i < best_i):
                    best_k, best_i = kk, i
        out.append(best_i)
        centre = xyz[best_i]
    return np.asarray(out, np.int32)


SA1_N, SA1_S = 20000, 2048


@pytest.mark.parametrize("cs", [2, 4, 8, 16])
@pytest.mark.parametrize("cloud", ["lattice", "masked", "s_above_valid",
                                   "none_valid"])
def test_k5_partitioned_argmax_matches_plain_and_pallas(cs, cloud):
    """The cluster kernel's partitioned argmax, split as `fps_plan` splits
    SA1 (20 000 points) at each swept cluster size, gives exactly the
    indices of `furthest_point_sample_plain` and of `fps_tpu` (interpret):
    on the lattice tie cloud, a masked room-like cloud, a cloud with fewer
    valid points than samples (the first valid index repeats) and one with
    none (index 0 throughout: invalid points rank above the padding)."""
    plan = tfps.fps_plan(1, SA1_N, SA1_S, cluster=cs)
    assert plan.where == "registers" and plan.cs == cs
    s = 48
    if cloud == "lattice":
        pts, valid = lattice_cloud(SA1_N), np.ones((1, SA1_N), bool)
    else:
        pts = scene(cs, SA1_N, (4.0, 4.0, 2.0))[None]
        rng = np.random.default_rng(cs)
        valid = rng.random((1, SA1_N)) < 0.9
        valid[0, :3] = False
        if cloud == "s_above_valid":
            valid[0, np.flatnonzero(valid[0])[20:]] = False
        if cloud == "none_valid":
            valid[:] = False
    got = partitioned_fps(pts[0], s, valid[0], plan)
    plain = tfps.furthest_point_sample_plain(
        torch.as_tensor(pts), s, torch.as_tensor(valid)).numpy()[0]
    want = np.asarray(fps_tpu(jnp.asarray(pts), s, jnp.asarray(valid),
                              interpret=True))[0]
    np.testing.assert_array_equal(plain, want)
    np.testing.assert_array_equal(got, plain)
    if cloud == "s_above_valid":
        assert (got[20:] == np.argmax(valid[0])).all()
    if cloud == "none_valid":
        assert (got == 0).all()


@pytest.mark.parametrize("n", [SA1_N - 1, SA1_N])
def test_k5_partitioned_argmax_at_sa1_plan(n):
    """The shipped SA1 plan (a cluster of more than one CTA) on the lattice
    tie cloud: the partitioned argmax equals the plain version."""
    plan = tfps.fps_plan(1, n, SA1_S)
    assert plan.where == "registers" and plan.cs > 1
    pts = lattice_cloud(n, seed=n)
    valid = np.ones((1, n), bool)
    got = partitioned_fps(pts[0], 64, valid[0], plan)
    want = tfps.furthest_point_sample_plain(torch.as_tensor(pts), 64).numpy()
    np.testing.assert_array_equal(got, want[0])


def fps_shapes(cfg):
    """(N, S) of every FPS of the VoteNet path of `cfg`: SA1-SA4 and the
    seeds' proposals (test mode)."""
    backbone = VoteNet(cfg, device="meta").backbone
    ns = (cfg.num_points,) + tuple(cfg.backbone_num_points)
    seeds = ns[backbone.n_sa - backbone.n_fp]
    return list(zip(ns[:-1], ns[1:])) + [(seeds, cfg.num_proposal)]


@pytest.mark.parametrize("name", ["votenet_sunrgbd", "votenet_tiny"])
def test_k5_plan_fits_the_card(name):
    """Every FPS shape of the VoteNet path gets a cluster-kernel plan that
    covers its cloud within the H100's limits: 227 KB of shared memory a
    CTA (the slice's float4 coordinates plus the two parities of
    candidates, as `csrc/fps.cu` lays them out), 255 registers a thread
    (and 65 536 a CTA) for 4 floats a point and a fixed overhead, 16 CTAs a
    cluster; SA1 on a cluster of more than one CTA."""
    cfg = getattr(tconfigs, name)()
    for n, s in fps_shapes(cfg):
        for b in (1, 2):
            plan = tfps.fps_plan(b, n, s)
            assert plan.where == "registers", (n, plan)
            assert plan.cs * plan.threads * plan.points_per_thread >= n
            assert plan.threads % 32 == 0 and 32 <= plan.threads <= 1024
            assert plan.threads <= tfps.max_threads(plan.points_per_thread)
            assert 1 <= plan.cs <= 16
            smem = (plan.points_per_thread * plan.threads * 16
                    + 2 * 16 * 32 * (8 + 16))
            assert smem <= 232448, (n, plan, smem)
            regs = 4 * plan.points_per_thread + 40
            assert regs <= min(255, 65536 // plan.threads), (n, plan, regs)
    if name == "votenet_sunrgbd":
        assert tfps.fps_plan(1, cfg.num_points, 2048).cs > 1


def test_k5_launch_rule_matches_the_kernel_source():
    """The wrapper's launch-shape rule is the kernel's: POINTS_PER_THREAD
    lists exactly the template instances that `launch_cluster_p` in
    `csrc/fps.cu` dispatches to, and `max_threads` gives each the CTA size
    of its `__launch_bounds__` (MaxThreads there). A mismatch would show on
    the card only as a refused launch."""
    src = (Path(tfps.__file__).parents[2] / "csrc" / "fps.cu").read_text()
    body = src[src.index("int launch_cluster_p("):]
    body = body[:body.index("default:")]
    cases = [int(a) for a, b in re.findall(
        r"case (\d+): return launch_cluster<(\d+)>\(a\);", body) if a == b]
    assert tuple(cases) == tfps.POINTS_PER_THREAD
    rule = re.search(r"struct MaxThreads \{\s*static constexpr int value = "
                     r"P <= (\d+) \? (\d+) : (\d+);", src)
    assert rule, "MaxThreads<P> not found in csrc/fps.cu"
    edge, small, large = map(int, rule.groups())
    for p in tfps.POINTS_PER_THREAD:
        assert tfps.max_threads(p) == (small if p <= edge else large), p
