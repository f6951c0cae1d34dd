"""Hard voxelization (outdoor voxel encoders' input op): a copy of
`fcaf3d_tpu/core/voxel.py`, held equal to it by a test.

Equivalent of the reference's mmdet3d `core/voxel/voxel_generator.py`
(`VoxelGenerator` + the numba `points_to_voxel`): group points into
per-voxel lists of at most `max_points`, keeping at most `max_voxels`
voxels. Pure numpy: host-side preprocessing (the reference runs it in
dataloader workers / numba); the device-side analogs are
`ops.sparse.voxelize` (first-point-wins, ME semantics) and
`voxelize_reduce` (mean/max dynamic scatter).

Reference semantics preserved:
- voxels are kept in order of first appearance in the point stream
  ("points should be shuffled... because max_voxels drops points");
- each voxel keeps its first `max_points` points in stream order;
- returned coordinates are (z, y, x) when `reverse_index` (kitti layout).
"""
from __future__ import annotations

import numpy as np


def points_to_voxel(points, voxel_size, coors_range, max_points=35,
                    reverse_index=True, max_voxels=20000):
    """-> (voxels [M, max_points, ndim], coors [M, 3] int32,
    num_points_per_voxel [M] int32), M <= max_voxels."""
    points = np.asarray(points)
    voxel_size = np.asarray(voxel_size, np.float32)
    coors_range = np.asarray(coors_range, np.float32)
    grid = np.round((coors_range[3:] - coors_range[:3]) / voxel_size
                    ).astype(np.int64)

    c = np.floor((points[:, :3] - coors_range[:3]) / voxel_size).astype(
        np.int64)
    in_range = np.all((c >= 0) & (c < grid), axis=1)
    pts = points[in_range]
    c = c[in_range]

    # linear voxel id, then first-appearance ordering over the point stream
    lin = (c[:, 2] * grid[1] + c[:, 1]) * grid[0] + c[:, 0]
    uniq, first_pos, inv = np.unique(lin, return_index=True,
                                     return_inverse=True)
    order = np.argsort(first_pos, kind="stable")  # voxel rank by appearance
    rank_of_uniq = np.empty_like(order)
    rank_of_uniq[order] = np.arange(order.size)
    vox_of_pt = rank_of_uniq[inv]  # per-point voxel rank

    n_vox = min(uniq.size, max_voxels)
    ndim = points.shape[1]
    voxels = np.zeros((n_vox, max_points, ndim), points.dtype)
    num = np.zeros(n_vox, np.int32)
    coors = np.zeros((n_vox, 3), np.int32)

    # slot of each point inside its voxel = running occurrence count
    order_pts = np.argsort(vox_of_pt, kind="stable")
    sorted_vox = vox_of_pt[order_pts]
    starts = np.searchsorted(sorted_vox, np.arange(uniq.size))
    slot = np.empty(pts.shape[0], np.int64)
    slot[order_pts] = np.arange(pts.shape[0]) - starts[sorted_vox]

    keep = (vox_of_pt < n_vox) & (slot < max_points)
    voxels[vox_of_pt[keep], slot[keep]] = pts[keep]
    np.add.at(num, vox_of_pt[keep], 1)

    first_kept = order[:n_vox]
    cz = c[first_pos[first_kept]]
    coors[:] = cz[:, ::-1] if reverse_index else cz
    return voxels, coors, num


class VoxelGenerator:
    """Config wrapper mirroring the reference class surface."""

    def __init__(self, voxel_size, point_cloud_range, max_num_points,
                 max_voxels=20000):
        self._voxel_size = np.asarray(voxel_size, np.float32)
        self._point_cloud_range = np.asarray(point_cloud_range, np.float32)
        self._max_num_points = max_num_points
        self._max_voxels = max_voxels
        self._grid_size = np.round(
            (self._point_cloud_range[3:] - self._point_cloud_range[:3])
            / self._voxel_size).astype(np.int64)

    def generate(self, points):
        return points_to_voxel(points, self._voxel_size,
                               self._point_cloud_range,
                               self._max_num_points, True, self._max_voxels)

    @property
    def voxel_size(self):
        return self._voxel_size

    @property
    def max_num_points_per_voxel(self):
        return self._max_num_points

    @property
    def point_cloud_range(self):
        return self._point_cloud_range

    @property
    def grid_size(self):
        return self._grid_size

    def __repr__(self):
        return (f"VoxelGenerator(voxel_size={self._voxel_size.tolist()}, "
                f"range={self._point_cloud_range.tolist()}, "
                f"max_points={self._max_num_points}, "
                f"max_voxels={self._max_voxels})")
