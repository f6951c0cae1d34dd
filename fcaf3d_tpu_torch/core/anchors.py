"""3D anchor generation by range (outdoor models' anchor heads): a copy of
`fcaf3d_tpu/core/anchors.py`, held equal to it by a test.

Equivalent of the reference's mmdet3d `core/anchor/anchor_3d_generator.py`
(`Anchor3DRangeGenerator`, `AlignedAnchor3DRangeGenerator`): dense
[D, H, W, n_sizes, n_rots, 7(+custom)] anchor grids over a metric range.
Pure numpy: anchors are static per config, generated once when a model is
built.
"""
from __future__ import annotations

import numpy as np


class Anchor3DRangeGenerator:
    """Grid anchors distributed over [x_min..x_max] x [y..] x [z..].

    Args:
        ranges: list of [x_min, y_min, z_min, x_max, y_max, z_max], one per
            anchor size when `size_per_range` (duplicated from 1 otherwise).
        sizes: list of [dx, dy, dz] anchor sizes.
        scales: per-feature-level multiplicative size scales.
        rotations: yaw values replicated at every grid cell.
        custom_values: extra zero-initialized trailing dims (e.g. velocity).
    """

    def __init__(self, ranges, sizes=((1.6, 3.9, 1.56),), scales=(1,),
                 rotations=(0.0, 1.5707963), custom_values=(),
                 reshape_out=True, size_per_range=True):
        if size_per_range:
            if len(sizes) != len(ranges):
                assert len(ranges) == 1, (len(sizes), len(ranges))
                ranges = list(ranges) * len(sizes)
            assert len(ranges) == len(sizes)
        else:
            assert len(ranges) == 1
        self.ranges = [list(r) for r in ranges]
        self.sizes = [list(s) for s in sizes]
        self.scales = list(scales)
        self.rotations = list(rotations)
        self.custom_values = tuple(custom_values)
        self.reshape_out = reshape_out
        self.size_per_range = size_per_range

    @property
    def num_base_anchors(self) -> int:
        return len(self.rotations) * np.reshape(self.sizes, (-1, 3)).shape[0]

    @property
    def num_levels(self) -> int:
        return len(self.scales)

    def _centers(self, n, lo, hi):
        """Reference uses torch.linspace(lo, hi, n): n points INCLUSIVE of
        both range ends (`anchor_3d_generator.py:176-181`)."""
        return np.linspace(lo, hi, n, dtype=np.float32)

    def anchors_single_range(self, feature_size, anchor_range, scale=1,
                             sizes=((1.6, 3.9, 1.56),),
                             rotations=(0.0, 1.5707963)):
        """-> [D, H, W, n_sizes, n_rots, 7 + n_custom] float32."""
        if len(feature_size) == 2:
            feature_size = [1, feature_size[0], feature_size[1]]
        d, h, w = feature_size
        r = np.asarray(anchor_range, np.float32)
        zc = self._centers(d, r[2], r[5])
        yc = self._centers(h, r[1], r[4])
        xc = self._centers(w, r[0], r[3])
        sizes = np.reshape(np.asarray(sizes, np.float32), (-1, 3)) * scale
        rots = np.asarray(rotations, np.float32)
        ns, nr = sizes.shape[0], rots.shape[0]

        # meshgrid in (x, y, z, rot) then permute to (z, y, x) leading —
        # mirrors the reference's torch.meshgrid + permute([2,1,0,3,4,5])
        gx, gy, gz, gr = np.meshgrid(xc, yc, zc, rots, indexing="ij")
        grid = np.stack([gx, gy, gz], axis=-1)  # [W, H, D, nr, 3]
        grid = np.broadcast_to(
            grid[:, :, :, None], (w, h, d, ns, nr, 3))
        size_grid = np.broadcast_to(
            sizes[None, None, None, :, None, :], (w, h, d, ns, nr, 3))
        rot_grid = np.broadcast_to(
            gr[:, :, :, None, :, None], (w, h, d, ns, nr, 1))
        ret = np.concatenate([grid, size_grid, rot_grid], axis=-1)
        ret = np.transpose(ret, (2, 1, 0, 3, 4, 5))  # [D, H, W, ns, nr, 7]
        if self.custom_values:
            pad = np.zeros(ret.shape[:-1] + (len(self.custom_values),),
                           np.float32)
            ret = np.concatenate([ret, pad], axis=-1)
        return ret

    def single_level_grid_anchors(self, featmap_size, scale):
        if not self.size_per_range:
            return self.anchors_single_range(
                featmap_size, self.ranges[0], scale, self.sizes,
                self.rotations)
        out = [
            self.anchors_single_range(featmap_size, rng, scale, [size],
                                      self.rotations)
            for rng, size in zip(self.ranges, self.sizes)
        ]
        return np.concatenate(out, axis=-3)

    def grid_anchors(self, featmap_sizes):
        """-> one [N, 7+custom] (or unshaped) array per feature level."""
        assert self.num_levels == len(featmap_sizes)
        outs = []
        for i in range(self.num_levels):
            a = self.single_level_grid_anchors(featmap_sizes[i],
                                               self.scales[i])
            if self.reshape_out:
                a = a.reshape(-1, a.shape[-1])
            outs.append(a)
        return outs


class AlignedAnchor3DRangeGenerator(Anchor3DRangeGenerator):
    """Centers aligned with the voxel grid: the range is divided into
    `feature_size` cells and anchors sit at cell centers (or corners with
    `align_corner`), reference `anchor_3d_generator.py:222-292`."""

    def __init__(self, align_corner=False, **kwargs):
        super().__init__(**kwargs)
        self.align_corner = align_corner

    def _centers(self, n, lo, hi):
        shift = 0.0 if self.align_corner else 0.5
        step = (hi - lo) / n
        return (lo + (np.arange(n, dtype=np.float32) + shift) * step).astype(
            np.float32)
