"""Numpy box utilities (a copy of `fcaf3d_tpu/core/box_np_ops.py`, held
equal to it by a test): the converter/eval contract subset of the
reference's mmdet3d `core/bbox/box_np_ops.py`.

Only the functions the data converters and camera-geometry paths rely on
are kept (corner generation, per-angle rotation, rotated point-in-box,
camera<->lidar transforms, camera projection); the rest of the reference
file serves outdoor anchor pipelines that are explicit non-goals. All
functions are pure numpy and operate on the same array layouts as the
reference so converter outputs stay byte-compatible.

Conventions: boxes are (cx, cy, cz, dx, dy, dz, yaw) with bottom-centered z
unless stated; `origin` selects where the given center sits inside the box
(0.5 = centered, 0 = minimum corner) exactly like the reference.
"""
from __future__ import annotations

import numpy as np


def corners_nd(dims: np.ndarray, origin: float = 0.5) -> np.ndarray:
    """[N, ndim] sizes -> [N, 2**ndim, ndim] corner offsets around `origin`.

    Corner ordering matches the reference (`box_np_ops.py` `corners_nd`):
    binary enumeration of min/max per axis, with the x axis's bit flipped on
    odd y-parity so 2D corners trace the rectangle counter-clockwise
    starting at (-x, -y): (-, -), (-, +), (+, +), (+, -).
    """
    dims = np.asarray(dims)
    n, ndim = dims.shape
    # binary corner index per axis, x slowest
    unit = np.stack(
        np.meshgrid(*([np.array([0.0, 1.0])] * ndim), indexing="ij"), axis=-1
    ).reshape(-1, ndim)
    if ndim == 2:
        unit = unit[[0, 1, 3, 2]]
    elif ndim == 3:
        unit = unit[[0, 1, 3, 2, 4, 5, 7, 6]]
    return dims[:, None, :] * (unit[None] - origin)


def rotation_2d(points: np.ndarray, angles: np.ndarray) -> np.ndarray:
    """Rotate [N, K, 2] point sets by per-row `angles` [N].

    Reference convention (`box_np_ops.py` `rotation_2d`): for +angle the
    basis maps (1, 0) -> (cos, -sin) — clockwise in standard orientation,
    matching `rotation_3d_in_axis(axis=2)`.
    """
    c, s = np.cos(angles), np.sin(angles)
    rot_t = np.stack([np.stack([c, -s]), np.stack([s, c])])  # [2, 2, N]
    return np.einsum("nkj,jin->nki", points, rot_t)


def rotation_points_single_angle(
    points: np.ndarray, angle: float, axis: int = 0
) -> np.ndarray:
    """Rotate [N, 3] points by one angle around `axis` (reference
    `rotation_points_single_angle`), returning the rotated points."""
    c, s = np.cos(angle), np.sin(angle)
    if axis == 0:
        rot_t = np.array([[1, 0, 0], [0, c, -s], [0, s, c]])
    elif axis == 1:
        rot_t = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    else:
        rot_t = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
    return points @ rot_t


def center_to_corner_box2d(
    centers: np.ndarray, dims: np.ndarray, angles: np.ndarray = None,
    origin: float = 0.5,
) -> np.ndarray:
    """BEV boxes -> [N, 4, 2] corners (reference `center_to_corner_box2d`)."""
    corners = corners_nd(dims, origin=origin)
    if angles is not None:
        corners = rotation_2d(corners, angles)
    return corners + np.asarray(centers)[:, None, :]


def center_to_corner_box3d(
    centers: np.ndarray, dims: np.ndarray, angles: np.ndarray = None,
    origin=(0.5, 0.5, 0.5), axis: int = 2,
) -> np.ndarray:
    """3D boxes -> [N, 8, 3] corners rotated around `axis` (reference
    `center_to_corner_box3d`; indoor uses origin (.5, .5, .5), axis 2)."""
    origin = np.broadcast_to(np.asarray(origin, np.float64), (3,))
    dims = np.asarray(dims)
    n = dims.shape[0]
    unit = np.stack(
        np.meshgrid(*([np.array([0.0, 1.0])] * 3), indexing="ij"), axis=-1
    ).reshape(-1, 3)[[0, 1, 3, 2, 4, 5, 7, 6]]
    corners = dims[:, None, :] * (unit[None] - origin[None, None])
    if angles is not None:
        c, s = np.cos(angles), np.sin(angles)
        zeros, ones = np.zeros(n), np.ones(n)
        if axis == 2:
            rot_t = np.stack([
                np.stack([c, -s, zeros]), np.stack([s, c, zeros]),
                np.stack([zeros, zeros, ones])])
        elif axis == 1:
            rot_t = np.stack([
                np.stack([c, zeros, s]), np.stack([zeros, ones, zeros]),
                np.stack([-s, zeros, c])])
        else:
            rot_t = np.stack([
                np.stack([ones, zeros, zeros]), np.stack([zeros, c, -s]),
                np.stack([zeros, s, c])])
        corners = np.einsum("nkj,jin->nki", corners, rot_t)
    return corners + np.asarray(centers)[:, None, :]


def points_in_rbbox(points: np.ndarray, rbbox: np.ndarray,
                    z_axis: int = 2, origin=(0.5, 0.5, 0)) -> np.ndarray:
    """[N, G] bool: which points fall inside each rotated box (reference
    `points_in_rbbox`; default origin = bottom-centered boxes).

    Implemented by inverse-rotating point offsets into each box frame (the
    reference rasterizes surfaces instead; same predicate).
    """
    points = np.asarray(points)[:, :3]
    rbbox = np.asarray(rbbox)
    centers = rbbox[:, :3].copy()
    dims = rbbox[:, 3:6]
    yaw = rbbox[:, 6]
    origin = np.broadcast_to(np.asarray(origin, np.float64), (3,))
    # shift given center to the true geometric center
    centers = centers + dims * (0.5 - origin)
    rel = points[:, None, :] - centers[None]  # [N, G, 3]
    c, s = np.cos(yaw), np.sin(yaw)
    # undo the (clockwise-for-positive) yaw: apply the inverse rotation
    x = rel[..., 0] * c - rel[..., 1] * s
    y = rel[..., 0] * s + rel[..., 1] * c
    z = rel[..., z_axis]
    return (
        (np.abs(x) <= dims[None, :, 0] / 2)
        & (np.abs(y) <= dims[None, :, 1] / 2)
        & (np.abs(z) <= dims[None, :, 2] / 2)
    )


def camera_to_lidar(points: np.ndarray, r_rect: np.ndarray,
                    velo2cam: np.ndarray) -> np.ndarray:
    """KITTI-style rectified-camera -> lidar frame (reference
    `camera_to_lidar`): invert (r_rect @ velo2cam) on homogeneous points."""
    points = np.asarray(points)
    n = points.shape[0]
    hom = np.concatenate([points[:, :3], np.ones((n, 1))], axis=1)
    lidar = hom @ np.linalg.inv((r_rect @ velo2cam).T)
    return np.concatenate([lidar[:, :3], points[:, 3:]], axis=1)


def box_camera_to_lidar(boxes: np.ndarray, r_rect: np.ndarray,
                        velo2cam: np.ndarray) -> np.ndarray:
    """Camera-frame (x, y, z, l, h, w, ry) boxes -> lidar-frame
    (x, y, z, w, l, h, yaw) (reference `box_camera_to_lidar`)."""
    boxes = np.asarray(boxes)
    xyz = camera_to_lidar(boxes[:, :3], r_rect, velo2cam)
    l, h, w = boxes[:, 3:4], boxes[:, 4:5], boxes[:, 5:6]
    r = boxes[:, 6:7]
    return np.concatenate([xyz, w, l, h, r], axis=1)


def points_cam2img(points_3d: np.ndarray, proj_mat: np.ndarray) -> np.ndarray:
    """Project camera-frame points to pixel coordinates (reference
    `points_cam2img`): homogeneous multiply + perspective divide."""
    points_3d = np.asarray(points_3d)
    hom = np.concatenate(
        [points_3d[:, :3], np.ones((points_3d.shape[0], 1))], axis=1)
    p = np.eye(4)
    m, n = proj_mat.shape  # 3x3 K, 3x4 P, or full 4x4
    p[:m, :n] = proj_mat
    uvw = hom @ p.T
    return uvw[:, :2] / uvw[:, 2:3]
