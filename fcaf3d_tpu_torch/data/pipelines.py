"""Host-side (numpy) data pipeline transforms: copies of every transform
of `fcaf3d_tpu/data/pipelines.py`, held equal to them by a test.

The reference pipeline ops of the FCAF3D / VoteNet configs (mmdet3d's
`transforms_3d.py`): `GlobalAlignment`, `IndoorPointSample`,
`RandomFlip3D`, `GlobalRotScaleTrans` and the rest. They operate on a plain
sample dict:

    {"points": [N, 3+C] float32,          # xyz + attributes (rgb...)
     "gt_boxes": [G, 7] float32,          # bottom-centered box7
     "gt_labels": [G] int64}

and receive a `np.random.Generator` for reproducible augmentation. Box
rotation/flip follow the framework yaw convention (see core.geometry).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from .points import add_height, height_attribute_dims


class Compose:
    def __init__(self, transforms: Sequence):
        self.transforms = list(transforms)

    def __call__(self, sample: dict, rng: np.random.Generator) -> dict:
        for t in self.transforms:
            sample = t(sample, rng)
        return sample


class GlobalAlignment:
    """Apply the 4x4 axis-align matrix to points (rotation + translation).

    ScanNet boxes in the infos are already axis-aligned, so only points move
    (reference `transforms_3d.py:409-493`).
    """

    def __call__(self, sample, rng):
        mat = sample.get("axis_align_matrix")
        if mat is None:
            return sample
        pts = sample["points"]
        xyz = pts[:, :3] @ mat[:3, :3].T + mat[:3, 3]
        sample["points"] = np.concatenate([xyz, pts[:, 3:]], axis=1).astype(np.float32)
        return sample


class PointSample:
    """`IndoorPointSample`: uniform choice of `num_points`; with replacement
    iff the cloud is smaller (reference `transforms_3d.py:820-897`)."""

    def __init__(self, num_points: int):
        self.num_points = num_points

    def __call__(self, sample, rng):
        pts = sample["points"]
        n = len(pts)
        replace = n < self.num_points
        idx = rng.choice(n, self.num_points, replace=replace)
        sample["points"] = pts[idx]
        return sample


def _flip_points_boxes(sample, axis: int, with_yaw: bool = True):
    """axis 0 = BEV horizontal (x), axis 1 = vertical (y). Yaw-less boxes
    keep yaw untouched (reference `depth_box3d.py` flip semantics)."""
    pts = sample["points"].copy()
    pts[:, axis] = -pts[:, axis]
    sample["points"] = pts
    boxes = sample.get("gt_boxes")
    if boxes is not None and len(boxes):
        boxes = boxes.copy()
        boxes[:, axis] = -boxes[:, axis]
        if with_yaw:
            if axis == 0:
                boxes[:, 6] = np.pi - boxes[:, 6]
            else:
                boxes[:, 6] = -boxes[:, 6]
        sample["gt_boxes"] = boxes
    return sample


class RandomFlip:
    """`RandomFlip3D`: independent BEV horizontal/vertical flips."""

    def __init__(self, horizontal_ratio: float = 0.5, vertical_ratio: float = 0.0,
                 with_yaw: bool = True):
        self.h = horizontal_ratio
        self.v = vertical_ratio
        self.with_yaw = with_yaw

    def __call__(self, sample, rng):
        if self.h > 0 and rng.random() < self.h:
            sample = _flip_points_boxes(sample, 0, self.with_yaw)
            sample["flip_horizontal"] = True
        if self.v > 0 and rng.random() < self.v:
            sample = _flip_points_boxes(sample, 1, self.with_yaw)
            sample["flip_vertical"] = True
        return sample


class GlobalRotScaleTrans:
    """`GlobalRotScaleTrans`: rotation -> scaling -> translation, uniform
    rot/scale and gaussian translation (reference `transforms_3d.py:496-657`).

    with_yaw=False boxes follow the reference's axis-aligned rotation
    semantics (`depth_box3d.py:150-165`): centers rotate, and dims become
    the rotated corners' axis-aligned extents (enclosing-box refit) with
    yaw kept at 0 — NOT a yaw update."""

    def __init__(
        self,
        rot_range=(-0.087266, 0.087266),
        scale_range=(0.9, 1.1),
        translation_std=(0.1, 0.1, 0.1),
        with_yaw: bool = True,
    ):
        self.rot_range = rot_range
        self.scale_range = scale_range
        self.translation_std = np.asarray(translation_std, np.float32)
        self.with_yaw = with_yaw

    def __call__(self, sample, rng):
        angle = rng.uniform(*self.rot_range) if self.rot_range[0] != self.rot_range[1] else self.rot_range[0]
        scale = rng.uniform(*self.scale_range) if self.scale_range[0] != self.scale_range[1] else self.scale_range[0]
        trans = (rng.standard_normal(3) * self.translation_std).astype(np.float32)

        c, s = np.cos(angle), np.sin(angle)
        # clockwise-for-positive, matching core.geometry.rotate_points_z
        rot_t = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)

        pts = sample["points"].copy()
        pts[:, :3] = pts[:, :3] @ rot_t * scale + trans
        sample["points"] = pts

        boxes = sample.get("gt_boxes")
        if boxes is not None and len(boxes):
            boxes = boxes.copy()
            boxes[:, :3] = boxes[:, :3] @ rot_t * scale + trans
            if self.with_yaw:
                boxes[:, 3:6] *= scale
                boxes[:, 6] += angle
            else:
                ac, asn = abs(c), abs(s)
                dx, dy = boxes[:, 3].copy(), boxes[:, 4].copy()
                boxes[:, 3] = (dx * ac + dy * asn) * scale
                boxes[:, 4] = (dx * asn + dy * ac) * scale
                boxes[:, 5] *= scale
            sample["gt_boxes"] = boxes
        sample["pcd_rotation"] = angle
        sample["pcd_scale_factor"] = scale
        return sample


class PointShuffle:
    """`PointShuffle`: random permutation of points."""

    def __call__(self, sample, rng):
        sample["points"] = sample["points"][rng.permutation(len(sample["points"]))]
        return sample


class RandomJitterPoints:
    """`RandomJitterPoints`: clipped gaussian per-point jitter
    (reference `transforms_3d.py`, seg pipelines)."""

    def __init__(self, jitter_std=0.01, clip_range=(-0.05, 0.05)):
        self.std = jitter_std
        self.clip = clip_range

    def __call__(self, sample, rng):
        pts = sample["points"].copy()
        noise = np.clip(
            rng.standard_normal((len(pts), 3)) * self.std, self.clip[0], self.clip[1]
        )
        pts[:, :3] += noise.astype(np.float32)
        sample["points"] = pts
        return sample


class RandomDropPointsColor:
    """`RandomDropPointsColor`: zero the color channels with probability p.

    Color columns come from the sample's `attribute_dims` map
    (`data.points.default_attribute_dims`) so the transform works at any
    column layout (with/without a height column); [3, 4, 5] when absent."""

    def __init__(self, drop_ratio=0.2):
        self.drop_ratio = drop_ratio

    def __call__(self, sample, rng):
        if rng.random() < self.drop_ratio:
            cols = sample.get("attribute_dims", {}).get("color", [3, 4, 5])
            pts = sample["points"].copy()
            pts[:, list(cols)] = 0.0
            sample["points"] = pts
        return sample


class PointsRangeFilter:
    """`PointsRangeFilter`: keep points inside an axis-aligned range."""

    def __init__(self, point_cloud_range):
        self.range = np.asarray(point_cloud_range, np.float32)  # x1y1z1x2y2z2

    def __call__(self, sample, rng):
        pts = sample["points"]
        m = (
            (pts[:, 0] >= self.range[0]) & (pts[:, 0] <= self.range[3])
            & (pts[:, 1] >= self.range[1]) & (pts[:, 1] <= self.range[4])
            & (pts[:, 2] >= self.range[2]) & (pts[:, 2] <= self.range[5])
        )
        sample["points"] = pts[m]
        return sample


class ObjectNameFilter:
    """`ObjectNameFilter`: keep GT boxes whose label is in `keep_labels`."""

    def __init__(self, keep_labels):
        self.keep = set(int(k) for k in keep_labels)

    def __call__(self, sample, rng):
        labels = sample.get("gt_labels")
        if labels is not None and len(labels):
            m = np.asarray([int(l) in self.keep for l in labels])
            sample["gt_boxes"] = sample["gt_boxes"][m]
            sample["gt_labels"] = labels[m]
        return sample


class ShiftHeight:
    """`LoadPointsFromFile(shift_height=True)` height attribute: appends
    z - percentile(z, 0.99-quantile floor) as an extra column (reference
    `loading.py:418-424`). Used by the VoteNet/ImVoteNet pipelines."""

    def __call__(self, sample, rng):
        sample["points"] = add_height(sample["points"])
        sample["attribute_dims"] = height_attribute_dims(
            sample.get("attribute_dims"))
        return sample
