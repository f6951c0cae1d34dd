"""Test-time-augmentation merging (port of `fcaf3d_tpu/core/merge_augs.py`,
the reference's `merge_aug_bboxes_3d`): invert each augmentation's flips
and scale on its detections, concatenate, and run one class-wise NMS."""
from __future__ import annotations

from typing import Sequence

import torch

from .geometry import flip_box7
from .nms import nms_bev

# the JAX package's per-class x offset: boxes of two labels are 100 m apart
# and never overlap in the one NMS call
CLASS_OFFSET = 100.0


def invert_aug_boxes(boxes7: torch.Tensor, scale_factor: float = 1.0,
                     flip_horizontal: bool = False,
                     flip_vertical: bool = False) -> torch.Tensor:
    """Undo GlobalRotScaleTrans scaling and RandomFlip3D flips on box7."""
    b = boxes7
    if flip_vertical:
        b = flip_box7(b, "vertical")
    if flip_horizontal:
        b = flip_box7(b, "horizontal")
    if scale_factor != 1.0:
        b = torch.cat([b[..., :6] / scale_factor, b[..., 6:7]], dim=-1)
    return b


def merge_aug_detections(boxes_list: Sequence[torch.Tensor],
                         scores_list: Sequence[torch.Tensor],
                         labels_list: Sequence[torch.Tensor],
                         valid_list: Sequence[torch.Tensor],
                         aug_metas: Sequence[dict], iou_thr: float = 0.5,
                         rotated: bool = False):
    """Merge the per-aug detections [D, ...] of ONE sample. Returns the
    concatenated (boxes, scores, labels, keep) with NMS applied per class
    label; keep is False on every invalid row."""
    inv = [invert_aug_boxes(b, meta.get("pcd_scale_factor", 1.0),
                            meta.get("flip_horizontal", False),
                            meta.get("flip_vertical", False))
           for b, meta in zip(boxes_list, aug_metas)]
    boxes = torch.cat(inv, dim=0)
    scores = torch.cat(list(scores_list), dim=0)
    labels = torch.cat(list(labels_list), dim=0)
    valid = torch.cat(list(valid_list), dim=0)

    # class-wise NMS in one call: boxes of two labels never overlap
    shifted = boxes.clone()
    shifted[:, 0] += labels.to(boxes.dtype) * CLASS_OFFSET
    keep = nms_bev(shifted, scores, iou_thr, valid=valid, rotated=rotated)
    return boxes, scores, labels, keep & valid
