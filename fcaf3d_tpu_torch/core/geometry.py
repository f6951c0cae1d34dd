"""Box and rotation helpers (port of `fcaf3d_tpu/core/geometry.py`), on
tensors: the assigner and the rotated IoU call them on the device, and the
host box API (`core.boxes.Boxes3D`) on CPU tensors made from its numpy
arrays, as the JAX `Boxes3D` calls the jnp versions.

Canonical box layout, as in the JAX package: box7 = (cx, cy, cz_bottom, dx,
dy, dz, yaw); `gravity_center` lifts z by dz / 2.
"""
from __future__ import annotations

import math

import torch


def rotation_matrix_z(angles: torch.Tensor) -> torch.Tensor:
    """Transposed rotations about +z for angles [...] -> [..., 3, 3], so that
    `points @ R` rotates row-vector points; for +angle, (1, 0) maps to
    (cos, -sin), the reference's `rotation_3d_in_axis(axis=2)`."""
    c, s = torch.cos(angles), torch.sin(angles)
    zeros, ones = torch.zeros_like(c), torch.ones_like(c)
    return torch.stack([torch.stack([c, -s, zeros], dim=-1),
                        torch.stack([s, c, zeros], dim=-1),
                        torch.stack([zeros, zeros, ones], dim=-1)], dim=-2)


def rotate_points_z(points: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """Rotate points [..., N, 3] by angles [...] about +z."""
    return torch.einsum("...nj,...jk->...nk", points, rotation_matrix_z(angles))


def gravity_center(boxes7: torch.Tensor) -> torch.Tensor:
    """Bottom-centre box7 [..., 7] -> gravity centre [..., 3]."""
    z = boxes7[..., 2:3] + boxes7[..., 5:6] * 0.5
    return torch.cat([boxes7[..., :2], z], dim=-1)


# unit corners in the box frame: x, y in {-1/2, 1/2}, z in {0, 1} from the
# bottom, in binary (x, y, z) order
_UNIT_CORNERS = ((-0.5, -0.5, 0.0), (-0.5, -0.5, 1.0), (-0.5, 0.5, 0.0),
                 (-0.5, 0.5, 1.0), (0.5, -0.5, 0.0), (0.5, -0.5, 1.0),
                 (0.5, 0.5, 0.0), (0.5, 0.5, 1.0))


def box7_corners(boxes7: torch.Tensor) -> torch.Tensor:
    """Corners of bottom-centre box7 [..., 7] -> [..., 8, 3]: the unit
    corners scaled by the dims, rotated by the yaw about the vertical axis
    through (x, y), then moved to the box."""
    unit = torch.tensor(_UNIT_CORNERS, dtype=boxes7.dtype,
                        device=boxes7.device)
    corners = rotate_points_z(unit * boxes7[..., None, 3:6], boxes7[..., 6])
    return corners + boxes7[..., None, 0:3]


def bev_corners(boxes5: torch.Tensor) -> torch.Tensor:
    """BEV rectangles (x, y, dx, dy, yaw) [..., 5] -> corners [..., 4, 2],
    counter-clockwise in the box frame from (+dx/2, +dy/2), rotated as
    `rotate_points_z` rotates (clockwise for a positive yaw)."""
    sx = torch.tensor((0.5, -0.5, -0.5, 0.5), dtype=boxes5.dtype,
                      device=boxes5.device)
    sy = torch.tensor((0.5, 0.5, -0.5, -0.5), dtype=boxes5.dtype,
                      device=boxes5.device)
    cx = sx * boxes5[..., 2:3]  # [..., 4]
    cy = sy * boxes5[..., 3:4]
    c, s = torch.cos(boxes5[..., 4:5]), torch.sin(boxes5[..., 4:5])
    return torch.stack([cx * c + cy * s + boxes5[..., 0:1],
                        -cx * s + cy * c + boxes5[..., 1:2]], dim=-1)


def points_in_boxes(points: torch.Tensor, boxes7: torch.Tensor
                    ) -> torch.Tensor:
    """Points [..., N, 3] strictly inside bottom-centre boxes [..., G, 7] ->
    bool [..., N, G]: un-rotated about the box's gravity centre, within the
    half-dims on every axis."""
    shift = points[..., :, None, :] - gravity_center(boxes7)[..., None, :, :]
    local = rotate_points_z(shift.transpose(-3, -2), -boxes7[..., 6])
    half = boxes7[..., None, :, 3:6] * 0.5
    return (local.transpose(-3, -2).abs() < half).all(-1)


def flip_box7(boxes7: torch.Tensor, axis: str) -> torch.Tensor:
    """BEV flip of boxes [..., 7]: "horizontal" negates x and maps the yaw
    to pi - yaw, "vertical" negates y and the yaw (`DepthInstance3DBoxes.
    flip`)."""
    x, y, z, dx, dy, dz, yaw = boxes7.split(1, dim=-1)
    if axis == "horizontal":
        x, yaw = -x, math.pi - yaw
    elif axis == "vertical":
        y, yaw = -y, -yaw
    else:
        raise ValueError(axis)
    return torch.cat([x, y, z, dx, dy, dz, yaw], dim=-1)


def limit_period(val, offset: float = 0.5, period: float = math.pi):
    """Limit a periodic value into [-offset * period, (1 - offset) *
    period)."""
    return val - torch.floor(val / period + offset) * period


def box_volume(boxes7: torch.Tensor) -> torch.Tensor:
    return boxes7[..., 3] * boxes7[..., 4] * boxes7[..., 5]


def rotate_box7(boxes7: torch.Tensor, angle) -> torch.Tensor:
    """Rotate boxes [..., 7] about the z axis through the world origin by
    the scalar `angle`: the centre as `rotate_points_z` rotates points, the
    yaw plus `angle`."""
    a = torch.as_tensor(angle, dtype=boxes7.dtype, device=boxes7.device)
    center = rotate_points_z(boxes7[..., None, :3], a)[..., 0, :]
    return torch.cat([center, boxes7[..., 3:6], boxes7[..., 6:7] + a], dim=-1)


def scale_box7(boxes7: torch.Tensor, factor) -> torch.Tensor:
    return torch.cat([boxes7[..., :6] * factor, boxes7[..., 6:7]], dim=-1)


def translate_box7(boxes7: torch.Tensor, trans) -> torch.Tensor:
    trans = torch.as_tensor(trans, dtype=boxes7.dtype, device=boxes7.device)
    return torch.cat([boxes7[..., :3] + trans, boxes7[..., 3:7]], dim=-1)
