"""Synthetic scenes, host numpy.

- `sample_box_surface`, `densify`, `crowded_scene`: scenes built from box
  annotations (a copy of `fcaf3d_tpu/data/synth.py`, held equal to it by a
  test; the JAX package's `data` imports jax through its package init).
  Points are sampled on the boxes' surfaces plus a floor sheet, so the box
  geometry and labels are exact.
- `synth_scene`: a room-like cloud without annotations (a copy of the JAX
  benchmark's `bench.synth_scene`, held equal to it by a test).
"""
from __future__ import annotations

import numpy as np

def sample_box_surface(box, n, rng):
    """n points on the surfaces of a (possibly yawed) box7 (bottom-center)."""
    cx, cy, cz, dx, dy, dz, yaw = box
    areas = np.array([dy * dz, dy * dz, dx * dz, dx * dz, dx * dy, dx * dy])
    face = rng.choice(6, size=n, p=areas / areas.sum())
    u = rng.uniform(-0.5, 0.5, (n, 2))
    local = np.zeros((n, 3), np.float32)
    for f, (fix_axis, sign) in enumerate(
        [(0, -1), (0, 1), (1, -1), (1, 1), (2, -1), (2, 1)]
    ):
        m = face == f
        other = [a for a in range(3) if a != fix_axis]
        local[m, fix_axis] = 0.5 * sign
        local[m, other[0]] = u[m, 0]
        local[m, other[1]] = u[m, 1]
    local *= np.array([dx, dy, dz], np.float32)
    c, s = np.cos(yaw), np.sin(yaw)
    rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    pts = local @ rot.T
    pts += np.array([cx, cy, cz + dz / 2], np.float32)
    return pts


def densify(sample, pts_per_box, n_floor, rng):
    """Replace a sample's cloud with surface samples of its GT boxes plus a
    floor sheet spanning the scene. Keeps boxes/labels untouched."""
    boxes = sample["gt_boxes"]
    clouds = [sample_box_surface(b, pts_per_box, rng) for b in boxes]
    lo = boxes[:, :3].min(axis=0) - 0.5
    hi = (boxes[:, :3] + boxes[:, 3:6] * 0.5).max(axis=0) + 0.5
    floor_z = boxes[:, 2].min()
    floor = np.stack(
        [
            rng.uniform(lo[0], hi[0], n_floor),
            rng.uniform(lo[1], hi[1], n_floor),
            np.full(n_floor, floor_z, np.float32),
        ],
        axis=1,
    ).astype(np.float32)
    pts = np.concatenate(clouds + [floor]).astype(np.float32)
    colors = rng.uniform(0, 255, (len(pts), 3)).astype(np.float32)
    return {
        "points": np.concatenate([pts, colors], axis=1),
        "gt_boxes": boxes,
        "gt_labels": sample["gt_labels"],
    }


def crowded_scene(n_boxes, n_classes, rng, extent=8.0, with_yaw=False):
    """Dense synthetic room: many small boxes on a grid with jitter —
    stresses per-class NMS candidate counts (nms_cap experiments)."""
    side = int(np.ceil(np.sqrt(n_boxes)))
    cell = extent / side
    boxes = []
    for i in range(n_boxes):
        gx, gy = i % side, i // side
        cxy = (np.array([gx, gy]) + 0.5) * cell + rng.uniform(-0.1, 0.1, 2)
        dims = rng.uniform(0.35, 0.7, 3) * min(cell, 1.0)
        yaw = rng.uniform(-np.pi, np.pi) if with_yaw else 0.0
        boxes.append([cxy[0], cxy[1], 0.0, dims[0], dims[1], dims[2], yaw])
    boxes = np.asarray(boxes, np.float32)
    labels = rng.integers(0, n_classes, n_boxes).astype(np.int64)
    return {"gt_boxes": boxes, "gt_labels": labels}


def synth_scene(rng, n_points, extent=(6.0, 6.0, 2.8)):
    """Room-like synthetic scene: points concentrated on walls/floor planes
    plus furniture blobs, so voxel occupancy resembles real scans. `rng` is
    a `np.random.RandomState`; returns (xyz [n, 3], rgb [n, 3]) float32."""
    n_planes = int(n_points * 0.6)
    n_blobs = n_points - n_planes
    pts = np.empty((n_points, 3), np.float32)
    # floor + 4 walls
    k = n_planes // 5
    e = np.asarray(extent)
    pts[:k] = rng.uniform(0, 1, (k, 3)) * [e[0], e[1], 0.02]
    pts[k:2 * k] = rng.uniform(0, 1, (k, 3)) * [e[0], 0.02, e[2]]
    pts[2 * k:3 * k] = (rng.uniform(0, 1, (k, 3)) * [0.02, e[1], e[2]]
                        + [e[0] - 0.02, 0, 0])
    pts[3 * k:4 * k] = (rng.uniform(0, 1, (k, 3)) * [e[0], 0.02, e[2]]
                        + [0, e[1] - 0.02, 0])
    pts[4 * k:n_planes] = (rng.uniform(0, 1, (n_planes - 4 * k, 3))
                           * [0.02, e[1], e[2]])
    # furniture blobs
    centers = rng.uniform(0.5, 1, (12, 3)) * (e - 1.0)
    blob = rng.randint(0, 12, n_blobs)
    pts[n_planes:] = centers[blob] + rng.normal(0, 0.25, (n_blobs, 3))
    colors = rng.uniform(0, 255, (n_points, 3)).astype(np.float32)
    return pts, colors
