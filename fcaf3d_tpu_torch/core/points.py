"""Typed point-cloud structure: coordinates + named attribute columns (port
of `fcaf3d_tpu/core/points.py`, host numpy as there).

Clean-room equivalent of the reference's points structures (mmdet3d
`core/points/base_points.py` `BasePoints` and the Depth/Cam/LiDAR
subclasses): an [N, 3+C] float32 array whose extra columns are addressed
by an `attribute_dims` name->column(s) map instead of ad-hoc slicing, a
coordinate-mode tag, and the geometric ops the pipelines apply (rotate /
flip / translate / scale / range filter / shuffle).

The host pipeline keeps operating on plain sample dicts; `Points3D` is the
typed boundary object. The column helpers that the pipelines import live
in `data/points.py` (`default_attribute_dims`, `add_height`,
`height_attribute_dims`), and `Points3D` uses them.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from ..data.points import (add_height, default_attribute_dims,  # noqa: F401
                           height_attribute_dims)
from .boxes import Box3DMode, convert_points


class Points3D:
    """[N, 3+C] float32 points with named attributes and a coordinate mode.

    Mirrors `BasePoints`'s surface (`base_points.py:10-430`): `.coord`,
    `.color`, `.height`, `rotate`, `flip`, `translate`, `scale`,
    `in_range_3d`, `shuffle`, `convert_to`. numpy-backed: a host pipeline
    object.
    """

    def __init__(self, arr: np.ndarray,
                 attribute_dims: Optional[Dict[str, object]] = None,
                 mode: Box3DMode = Box3DMode.DEPTH):
        arr = np.asarray(arr, np.float32)
        assert arr.ndim == 2 and arr.shape[1] >= 3, arr.shape
        self.arr = arr
        self.attribute_dims = dict(attribute_dims or {})
        self.mode = mode

    # -- accessors ---------------------------------------------------
    def __len__(self) -> int:
        return len(self.arr)

    @property
    def coord(self) -> np.ndarray:
        return self.arr[:, :3]

    @coord.setter
    def coord(self, xyz: np.ndarray) -> None:
        self.arr[:, :3] = xyz

    def _attr(self, name: str) -> Optional[np.ndarray]:
        idx = self.attribute_dims.get(name)
        if idx is None:
            return None
        return self.arr[:, idx] if isinstance(idx, int) else self.arr[:, list(idx)]

    @property
    def color(self) -> Optional[np.ndarray]:
        return self._attr("color")

    @color.setter
    def color(self, val) -> None:
        idx = self.attribute_dims["color"]
        self.arr[:, list(idx) if not isinstance(idx, int) else idx] = val

    @property
    def height(self) -> Optional[np.ndarray]:
        return self._attr("height")

    # -- geometry (reference `base_points.py` op semantics) ----------
    def rotate(self, angle: float, axis: int = 2) -> np.ndarray:
        """In-place z-rotation by `angle` (framework yaw convention, see
        `core.geometry.rotate_points_z`); returns the rotation matrix."""
        assert axis == 2, "indoor points rotate about z"
        c, s = np.cos(angle), np.sin(angle)
        # transposed rotation, p_rot = p @ R_T (core.geometry.rotation_matrix_z)
        rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
        self.arr[:, :3] = self.arr[:, :3] @ rot
        return rot

    def flip(self, bev_direction: str = "horizontal") -> None:
        axis = 0 if bev_direction == "horizontal" else 1
        self.arr[:, axis] = -self.arr[:, axis]

    def translate(self, trans: Sequence[float]) -> None:
        self.arr[:, :3] += np.asarray(trans, np.float32)

    def scale(self, factor: float) -> None:
        self.arr[:, :3] *= np.float32(factor)

    def in_range_3d(self, rng: Sequence[float]) -> np.ndarray:
        """Boolean mask of points inside [x1, y1, z1, x2, y2, z2]."""
        r = np.asarray(rng, np.float32)
        c = self.arr
        return ((c[:, 0] >= r[0]) & (c[:, 0] <= r[3])
                & (c[:, 1] >= r[1]) & (c[:, 1] <= r[4])
                & (c[:, 2] >= r[2]) & (c[:, 2] <= r[5]))

    def shuffle(self, rng: np.random.Generator) -> np.ndarray:
        perm = rng.permutation(len(self.arr))
        self.arr = self.arr[perm]
        return perm

    def __getitem__(self, item) -> "Points3D":
        return Points3D(self.arr[item], self.attribute_dims, self.mode)

    def add_height(self, floor_percentile: float = 0.99) -> "Points3D":
        """Append the shift-height column (z minus the floor level at the
        given quantile; reference `loading.py:418-424`), registering the
        `height` attribute and shifting any later attribute columns."""
        return Points3D(add_height(self.arr, floor_percentile),
                        height_attribute_dims(self.attribute_dims), self.mode)

    def convert_to(self, dst: Box3DMode,
                   rt_mat: Optional[np.ndarray] = None) -> "Points3D":
        """Coordinate-mode conversion (`Coord3DMode.convert_point`);
        attribute columns pass through unchanged."""
        arr = convert_points(self.arr, self.mode, dst, rt_mat=rt_mat)
        return Points3D(arr, self.attribute_dims, dst)
