"""Box structure API: coordinate modes and a light box-array wrapper (port
of `fcaf3d_tpu/core/boxes.py`, host numpy as there).

Clean-room equivalent of the reference's box structures (mmdet3d
`core/bbox/structures/`): `Box3DMode` / `Coord3DMode` conversion matrices
(`box_3d_mode.py`, `coord_3d_mode.py`) and the `BaseInstance3DBoxes`
surface (`base_box3d.py`) as a thin numpy wrapper over the framework's
canonical bottom-centered box7 arrays. Where the JAX wrapper calls the jnp
geometry on its arrays, this one calls the tensor geometry of
`core.geometry` on CPU tensors made from them and returns numpy arrays, as
the JAX wrapper does; `overlaps` is `core.eval.pairwise_iou_3d_np` (the
native IoU by default).

Coordinate conventions (reference `box_3d_mode.py` docstring):
- DEPTH: x right, y front, z up (indoor datasets; the framework canonical).
- CAM:   x right, y down, z front.
- LIDAR: x front, y left, z up.
"""
from __future__ import annotations

import enum
from typing import Optional

import numpy as np
import torch

from .eval import pairwise_iou_3d_np
from .geometry import (box7_corners, box_volume, flip_box7, points_in_boxes,
                       rotate_box7, scale_box7, translate_box7)


class Box3DMode(enum.IntEnum):
    LIDAR = 0
    CAM = 1
    DEPTH = 2


# rotation part of the point transform FROM mode TO mode (row-vector p @ R)
_POINT_ROT = {
    (Box3DMode.DEPTH, Box3DMode.CAM): np.array(
        [[1, 0, 0], [0, 0, -1], [0, 1, 0]], np.float32
    ),
    (Box3DMode.CAM, Box3DMode.DEPTH): np.array(
        [[1, 0, 0], [0, 0, 1], [0, -1, 0]], np.float32
    ),
    (Box3DMode.LIDAR, Box3DMode.CAM): np.array(
        [[0, -1, 0], [0, 0, -1], [1, 0, 0]], np.float32
    ),
    (Box3DMode.CAM, Box3DMode.LIDAR): np.array(
        [[0, 0, 1], [-1, 0, 0], [0, -1, 0]], np.float32
    ),
    (Box3DMode.LIDAR, Box3DMode.DEPTH): np.array(
        [[0, -1, 0], [1, 0, 0], [0, 0, 1]], np.float32
    ),
    (Box3DMode.DEPTH, Box3DMode.LIDAR): np.array(
        [[0, 1, 0], [-1, 0, 0], [0, 0, 1]], np.float32
    ),
}


def convert_points(points: np.ndarray, src: Box3DMode, dst: Box3DMode,
                   rt_mat: Optional[np.ndarray] = None) -> np.ndarray:
    """Convert point coordinates between modes (`Coord3DMode.convert_point`).

    Args:
        points: [..., 3+C]; extra columns pass through.
        rt_mat: optional explicit [3, 3] or [4, 4] transform overriding the
            default mode rotation (e.g. a calibration matrix).
    """
    if src == dst and rt_mat is None:
        return points
    xyz = points[..., :3]
    if rt_mat is None:
        rt_mat = _POINT_ROT[(src, dst)]
    if rt_mat.shape[-1] == 4:
        xyz = xyz @ rt_mat[:3, :3].T + rt_mat[:3, 3]
    else:
        xyz = xyz @ rt_mat.T
    return np.concatenate([xyz, points[..., 3:]], axis=-1)


def convert_boxes(boxes7: np.ndarray, src: Box3DMode, dst: Box3DMode) -> np.ndarray:
    """Convert bottom/center box7 arrays between modes (`Box3DMode.convert`).

    Follows the reference's dimension/yaw swap rules: CAM boxes store
    (w, h, l) with y-down gravity, DEPTH/LIDAR store (dx, dy, dz) z-up.
    Input/output z-center conventions match the mode (bottom-center for
    DEPTH/LIDAR, gravity-y for CAM), like the reference tensors.
    """
    if src == dst:
        return boxes7
    b = np.asarray(boxes7, np.float32)
    center = convert_points(b[..., :3], src, dst)
    dims = b[..., 3:6]
    yaw = b[..., 6:7]
    # dims permutation: which source axis each dst axis comes from
    if {src, dst} == {Box3DMode.DEPTH, Box3DMode.CAM} or \
       {src, dst} == {Box3DMode.LIDAR, Box3DMode.CAM}:
        dims = dims[..., [0, 2, 1]]
        yaw = -yaw
    elif {src, dst} == {Box3DMode.DEPTH, Box3DMode.LIDAR}:
        dims = dims[..., [1, 0, 2]]
        yaw = yaw - np.pi / 2 if src == Box3DMode.DEPTH else yaw + np.pi / 2
    return np.concatenate([center, dims, yaw], axis=-1)


class Boxes3D:
    """Light `BaseInstance3DBoxes`-style wrapper over canonical box7 arrays.

    Stores bottom-centered (cx, cy, cz_bottom, dx, dy, dz, yaw) numpy rows;
    6-column input gets yaw 0 and `with_yaw=False` (`base_box3d.py:49-56`).
    Device-side math stays functional (core.geometry); this class is the
    user-facing container API.
    """

    def __init__(self, tensor, box_dim: int = 7, with_yaw: bool = True,
                 origin=(0.5, 0.5, 0.0), mode: Box3DMode = Box3DMode.DEPTH):
        t = np.asarray(tensor, np.float32).reshape(-1, box_dim)
        if box_dim == 6:
            t = np.concatenate([t, np.zeros_like(t[:, :1])], axis=1)
            with_yaw = False
        if origin != (0.5, 0.5, 0.0):
            # shift the stored z to bottom-center
            dz = t[:, 5]
            t = t.copy()
            t[:, 2] -= (origin[2] - 0.0) * dz
        self.tensor = t
        self.with_yaw = with_yaw
        self.mode = mode

    def __len__(self):
        return len(self.tensor)

    def __getitem__(self, item):
        out = Boxes3D(self.tensor[item], with_yaw=self.with_yaw, mode=self.mode)
        return out

    @property
    def gravity_center(self):
        c = self.tensor[:, :3].copy()
        c[:, 2] += self.tensor[:, 5] / 2
        return c

    @property
    def bottom_center(self):
        return self.tensor[:, :3]

    @property
    def dims(self):
        return self.tensor[:, 3:6]

    @property
    def yaw(self):
        return self.tensor[:, 6]

    @property
    def volume(self):
        return box_volume(torch.from_numpy(self.tensor)).numpy()

    @property
    def height(self):
        return self.tensor[:, 5]

    @property
    def bev(self):
        """[N, 5] (x, y, dx, dy, yaw)."""
        return self.tensor[:, [0, 1, 3, 4, 6]]

    @property
    def corners(self):
        return box7_corners(torch.from_numpy(self.tensor)).numpy()

    def rotate(self, angle: float):
        return Boxes3D(rotate_box7(torch.from_numpy(self.tensor), angle)
                       .numpy(), with_yaw=self.with_yaw, mode=self.mode)

    def flip(self, bev_direction: str = "horizontal"):
        return Boxes3D(flip_box7(torch.from_numpy(self.tensor), bev_direction)
                       .numpy(), with_yaw=self.with_yaw, mode=self.mode)

    def scale(self, factor: float):
        return Boxes3D(scale_box7(torch.from_numpy(self.tensor), factor)
                       .numpy(), with_yaw=self.with_yaw, mode=self.mode)

    def translate(self, trans):
        trans = torch.from_numpy(np.asarray(trans, np.float32))
        return Boxes3D(translate_box7(torch.from_numpy(self.tensor), trans)
                       .numpy(), with_yaw=self.with_yaw, mode=self.mode)

    def points_in_boxes(self, points: np.ndarray) -> np.ndarray:
        pts = np.ascontiguousarray(points[:, :3], np.float32)
        return points_in_boxes(torch.from_numpy(pts),
                               torch.from_numpy(self.tensor)).numpy()

    def overlaps(self, other: "Boxes3D") -> np.ndarray:
        """[N, M] 3D IoU (`BaseInstance3DBoxes.overlaps`)."""
        return pairwise_iou_3d_np(self.tensor, other.tensor)

    def convert_to(self, dst: Box3DMode) -> "Boxes3D":
        return Boxes3D(convert_boxes(self.tensor, self.mode, dst),
                       with_yaw=self.with_yaw, mode=dst)

    def nearest_bev(self):
        """[N, 4] axis-aligned BEV boxes after snapping yaw to the nearest
        axis (`base_box3d.nearest_bev`)."""
        rot = np.abs((self.yaw + np.pi / 2) % np.pi - np.pi / 2)
        swap = rot > np.pi / 4
        dx = np.where(swap, self.dims[:, 1], self.dims[:, 0])
        dy = np.where(swap, self.dims[:, 0], self.dims[:, 1])
        x, y = self.tensor[:, 0], self.tensor[:, 1]
        return np.stack([x - dx / 2, y - dy / 2, x + dx / 2, y + dy / 2], axis=1)
