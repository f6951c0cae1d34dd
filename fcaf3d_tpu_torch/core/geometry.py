"""Box and rotation helpers of the assigner (port of part of
`fcaf3d_tpu/core/geometry.py`).

Canonical box layout, as in the JAX package: box7 = (cx, cy, cz_bottom, dx,
dy, dz, yaw); `gravity_center` lifts z by dz / 2.
"""
from __future__ import annotations

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
