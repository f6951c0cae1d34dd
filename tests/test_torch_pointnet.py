"""The port's PointNet++ ops (`fcaf3d_tpu_torch.ops.pointnet`), box helpers
and aligned 3D NMS held against the JAX package on the CPU, on the same
numpy inputs.

K5 (farthest-point sampling) and K6 (ball query) run their plain versions
here, as every wrapper does on a CPU tensor; the JAX side runs its XLA
formulations and its Pallas kernels in interpret mode. Indices and masks
must be exactly equal; floats within f32 atol 1e-5 unless a test says why.
"""
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
from fcaf3d_tpu_torch.core import geometry as tgeo
from fcaf3d_tpu_torch.core.nms import aligned_3d_nms
from fcaf3d_tpu_torch.ops.pointnet import ops as tops
from fcaf3d_tpu_torch.ops.pointnet.ball_query import squared_radius


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
