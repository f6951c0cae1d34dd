"""The port's `knn`, PAConv `assign_score_withk`, anchor generators and
hard voxelizer against the JAX package's, on the CPU.

- `knn`: per query, the squared distances (float64, from the points) of
  the two sides' neighbours exactly equal, and the indices equal wherever
  no other valid point of the cloud lies at that distance (the clouds hold
  duplicated points, so ties exist); invalid points never chosen.
- `assign_score_withk`: forward and the gradients of sum(out^2) against
  the JAX function and `jax.grad` within ATOL = 1e-5 (float32 einsum
  order), the forward also against `test_misc_ops.py`'s loop oracle, with
  out-of-range indices contributing zero.
- `Anchor3DRangeGenerator`, `AlignedAnchor3DRangeGenerator`,
  `points_to_voxel` and `VoxelGenerator` (numpy on both sides) exactly, on
  the inputs of `test_misc_ops.py`.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fcaf3d_tpu.core import anchors as janchors
from fcaf3d_tpu.core import voxel as jvoxel
from fcaf3d_tpu.ops.pointnet import assign_score_withk as j_assign
from fcaf3d_tpu.ops.pointnet.ops import knn as j_knn
from fcaf3d_tpu_torch.core import anchors as tanchors
from fcaf3d_tpu_torch.core import voxel as tvoxel
from fcaf3d_tpu_torch.ops.pointnet import assign_score_withk, knn
from tests.test_misc_ops import _assign_oracle

ATOL = 1e-5


@pytest.mark.parametrize("masked", [False, True])
def test_knn_equals_jax(masked):
    rng = np.random.RandomState(int(masked))
    b, n, m, k = 2, 96, 24, 8
    points = rng.uniform(-1, 1, (b, n, 3)).astype(np.float32)
    points[:, 48:64] = points[:, 16:32]  # duplicates: equal distances
    query = rng.uniform(-1, 1, (b, m, 3)).astype(np.float32)
    query[:, :4] = points[:, 16:20]  # queries on duplicated points
    valid = (rng.rand(b, n) > 0.3) if masked else None
    got = knn(torch.as_tensor(query), torch.as_tensor(points), k,
              None if valid is None else torch.as_tensor(valid))
    want = np.asarray(j_knn(jnp.asarray(query), jnp.asarray(points), k,
                            None if valid is None else jnp.asarray(valid)))
    got = got.numpy()
    assert got.dtype == np.int32 and got.shape == want.shape == (b, m, k)

    def dist(idx):
        p = np.take_along_axis(points.astype(np.float64),
                               idx.reshape(b, -1, 1).astype(np.int64), 1)
        return ((p.reshape(b, m, k, 3) - query[:, :, None]) ** 2).sum(-1)

    np.testing.assert_array_equal(np.sort(dist(got), -1),
                                  np.sort(dist(want), -1))
    # a neighbour whose distance no other valid point of the cloud shares
    full = ((points[:, None].astype(np.float64)
             - query[:, :, None]) ** 2).sum(-1)  # [B, M, N]
    if valid is not None:
        full = np.where(valid[:, None], full, np.inf)
    d = dist(want)
    unique = (full[..., None, :] == d[..., None]).sum(-1) == 1
    np.testing.assert_array_equal(got[unique], want[unique])
    assert (~unique).any()  # the duplicates made ties
    if valid is not None:
        assert np.take_along_axis(valid, got.reshape(b, -1), 1).all()


def test_assign_score_withk_equals_jax():
    """`test_misc_ops.py`'s shapes and invalid indices."""
    rng = np.random.RandomState(3)
    b, n, npoint, k, m, o = 2, 9, 4, 5, 3, 6
    scores = rng.rand(b, npoint, k, m).astype(np.float32)
    points = rng.randn(b, n, m, o).astype(np.float32)
    centers = rng.randn(b, n, m, o).astype(np.float32)
    knn_idx = rng.randint(0, n, (b, npoint, k)).astype(np.int32)
    knn_idx[0, 1, 2] = n + 3  # out of range -> zero contribution
    knn_idx[1, 0, 4] = -1

    ts, tp, tc = (torch.tensor(a, requires_grad=True)
                  for a in (scores, points, centers))
    out = assign_score_withk(ts, tp, tc, torch.as_tensor(knn_idx))
    (out ** 2).sum().backward()
    jargs = (jnp.asarray(scores), jnp.asarray(points), jnp.asarray(centers))
    jidx = jnp.asarray(knn_idx)
    want = np.asarray(j_assign(*jargs, jidx))
    assert out.shape == want.shape == (b, o, npoint, k)
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=0, atol=ATOL)
    np.testing.assert_allclose(
        out.detach().numpy(),
        _assign_oracle(scores, points, centers, knn_idx), rtol=0, atol=ATOL)
    assert (out.detach().numpy()[0, :, 1, 2] == 0).all()
    assert (out.detach().numpy()[1, :, 0, 4] == 0).all()
    grads = jax.grad(lambda s, p, c: jnp.sum(j_assign(s, p, c, jidx) ** 2),
                     argnums=(0, 1, 2))(*jargs)
    for t, g, name in zip((ts, tp, tc), grads, ("scores", "points",
                                                "centers")):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=0,
                                   atol=ATOL * float(np.abs(g).max()),
                                   err_msg=name)
    with pytest.raises(NotImplementedError):
        assign_score_withk(ts, tp, tc, torch.as_tensor(knn_idx), "max")


def test_anchor_generators_equal_jax():
    """The generators of `test_misc_ops.py`: every level and layout."""
    ranges = [[0, -39.68, -0.6, 70.4, 39.68, -0.6],
              [0, -39.68, -0.6, 70.4, 39.68, -0.6],
              [0, -39.68, -1.78, 70.4, 39.68, -1.78]]
    sizes = [[0.6, 0.8, 1.73], [0.6, 1.76, 1.73], [1.6, 3.9, 1.56]]
    cases = [
        ("Anchor3DRangeGenerator",
         dict(ranges=ranges, sizes=sizes, rotations=[0, 1.57],
              reshape_out=False), [((256, 256), 1.1)]),
        ("Anchor3DRangeGenerator",
         dict(ranges=ranges[:1], sizes=[[1.6, 3.9, 1.56]],
              rotations=[0, 1.57]), None),
        ("Anchor3DRangeGenerator",
         dict(ranges=ranges[:1], sizes=sizes, rotations=[0, 1.57],
              size_per_range=False, custom_values=(0, 0), scales=(1, 2)),
         None),
        ("AlignedAnchor3DRangeGenerator",
         dict(ranges=[[-51.2, -51.2, -1.8, 51.2, 51.2, -1.8]],
              sizes=[[1.0, 1.0, 1.0]], rotations=[0.0], scales=[1],
              reshape_out=False), [((4, 4), 1)]),
        ("AlignedAnchor3DRangeGenerator",
         dict(ranges=[[-51.2, -51.2, -1.8, 51.2, 51.2, -1.8]],
              sizes=[[1.0, 1.0, 1.0]], rotations=[0.0], scales=[1],
              align_corner=True), None),
    ]
    for name, kw, single in cases:
        got, want = getattr(tanchors, name)(**kw), getattr(janchors, name)(**kw)
        assert got.num_levels == want.num_levels
        assert got.num_base_anchors == want.num_base_anchors
        for size, scale in single or []:
            a = got.single_level_grid_anchors(size, scale)
            np.testing.assert_array_equal(
                a, want.single_level_grid_anchors(size, scale))
            assert a.dtype == np.float32
        sizes_in = [(8, 8)] * got.num_levels
        for a, w in zip(got.grid_anchors(sizes_in),
                        want.grid_anchors(sizes_in)):
            np.testing.assert_array_equal(a, w)


def test_points_to_voxel_equals_jax():
    """`test_misc_ops.py`'s clouds (a shared voxel, an out-of-range point,
    max_points and max_voxels truncation) and a random cloud, with and
    without `reverse_index`, and `VoxelGenerator`."""
    pts = np.array([[0.1, 0.1, 0.1, 7.0], [1.1, 0.1, 0.1, 8.0],
                    [0.2, 0.15, 0.1, 9.0], [99.0, 0.1, 0.1, 1.0],
                    [0.1, 1.2, 0.3, 2.0]], np.float32)
    many = np.tile(np.array([[0.5, 0.5, 0.5, 1.0]], np.float32), (5, 1))
    spread = np.stack([np.arange(6) + 0.5, np.zeros(6) + 0.5,
                       np.zeros(6) + 0.5], axis=1).astype(np.float32)
    cloud = np.random.RandomState(0).uniform(0, 4, (500, 4)).astype(
        np.float32)
    cases = [
        (pts, [1.0, 1.0, 1.0], [0, 0, 0, 4, 4, 4], 2, True, 20),
        (many, [1, 1, 1], [0, 0, 0, 2, 2, 2], 3, True, 2),
        (spread, [1, 1, 1], [0, 0, 0, 8, 8, 8], 1, True, 4),
        (cloud, [0.5, 0.5, 0.5], [0, 0, 0, 4, 4, 4], 4, False, 64),
        (cloud, [0.5, 0.5, 0.5], [0, 0, 0, 4, 4, 4], 35, True, 20000),
    ]
    for args in cases:
        for got, want in zip(tvoxel.points_to_voxel(*args),
                             jvoxel.points_to_voxel(*args)):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
    got = tvoxel.VoxelGenerator([0.5, 0.5, 0.5], [0, 0, 0, 4, 4, 2], 5,
                                max_voxels=100)
    want = jvoxel.VoxelGenerator([0.5, 0.5, 0.5], [0, 0, 0, 4, 4, 2], 5,
                                 max_voxels=100)
    for attr in ("voxel_size", "point_cloud_range", "grid_size"):
        np.testing.assert_array_equal(getattr(got, attr), getattr(want, attr))
    assert got.max_num_points_per_voxel == want.max_num_points_per_voxel
    assert repr(got) == repr(want)
    for a, w in zip(got.generate(cloud), want.generate(cloud)):
        np.testing.assert_array_equal(a, w)
