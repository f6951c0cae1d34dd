"""Result dumping for external viewers (MeshLab etc.): a copy of
`fcaf3d_tpu/core/visualizer.py` over the port's `box7_corners`.

The reference's `_write_obj` / `_write_oriented_bbox` (mmdet3d
`core/visualizer/show_result.py`): point clouds as .obj vertices, boxes as
12-edge wireframe .obj meshes. No GUI dependency.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from .geometry import box7_corners

_EDGES = [
    (0, 2), (2, 6), (6, 4), (4, 0),  # bottom ring (z = bottom)
    (1, 3), (3, 7), (7, 5), (5, 1),  # top ring
    (0, 1), (2, 3), (4, 5), (6, 7),  # verticals
]


def write_points_obj(points: np.ndarray, path: str):
    """Write points [N, >=3] (optionally + rgb in [0, 255]) as .obj vertices."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        for p in points:
            if len(p) >= 6:
                f.write(
                    f"v {p[0]} {p[1]} {p[2]} "
                    f"{p[3] / 255.0} {p[4] / 255.0} {p[5] / 255.0}\n"
                )
            else:
                f.write(f"v {p[0]} {p[1]} {p[2]}\n")


def write_boxes_obj(boxes7: np.ndarray, path: str):
    """Write bottom-centered box7 [G, 7] as wireframe line segments (.obj)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    corners = box7_corners(torch.as_tensor(np.asarray(boxes7))).numpy()
    with open(path, "w") as f:
        for c in corners:
            for v in c:
                f.write(f"v {v[0]} {v[1]} {v[2]}\n")
        for i in range(len(corners)):
            base = i * 8
            for a, b in _EDGES:
                f.write(f"l {base + a + 1} {base + b + 1}\n")


def show_result(points, pred_boxes7, gt_boxes7, out_dir: str, name: str):
    """Dump {name}_points.obj / _pred.obj / _gt.obj (reference
    `show_result` file-dump path)."""
    os.makedirs(out_dir, exist_ok=True)
    if points is not None:
        write_points_obj(np.asarray(points), os.path.join(out_dir, f"{name}_points.obj"))
    if pred_boxes7 is not None and len(pred_boxes7):
        write_boxes_obj(np.asarray(pred_boxes7), os.path.join(out_dir, f"{name}_pred.obj"))
    if gt_boxes7 is not None and len(gt_boxes7):
        write_boxes_obj(np.asarray(gt_boxes7), os.path.join(out_dir, f"{name}_gt.obj"))
