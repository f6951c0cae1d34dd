"""FCAF3D training target assignment (port of `fcaf3d_tpu/models/assigner.py`,
batched over the samples instead of vmapped).

Rule chain per head location and GT box:
1. the location is strictly inside the box (after un-rotating by its yaw);
2. the box picks one scale: the scale before the first one with fewer than
   `limit` inside locations, or the last scale when none has fewer;
3. within that scale only the `topk` highest-centerness locations per box
   stay positive;
4. a location claimed by several boxes goes to the smallest one.
Padding locations and padding boxes take part as background (label -1).
Ties resolve to the first index, as `argmax`/`argmin` do in both packages.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.geometry import gravity_center, rotate_points_z

_FLOAT_MAX = 1e8


class AssignResult(NamedTuple):
    centerness: torch.Tensor  # [B, P] targets (garbage where label < 0)
    bbox_targets: torch.Tensor  # [B, P, 7] gravity-centred GT box per location
    labels: torch.Tensor  # [B, P] int32, -1 = background


def compute_centerness(face_dists: torch.Tensor) -> torch.Tensor:
    """sqrt of the product of the per-axis min/max face-distance ratios,
    face_dists [..., 6] -> [...], multiplied and divided left to right as
    the JAX package does."""
    lo = [face_dists[..., 2 * a:2 * a + 2].amin(dim=-1) for a in range(3)]
    hi = [torch.clamp_min(face_dists[..., 2 * a:2 * a + 2].amax(dim=-1), 1e-12)
          for a in range(3)]
    r = lo[0] / hi[0] * lo[1] / hi[1] * lo[2] / hi[2]
    return torch.sqrt(torch.clamp_min(r, 0.0))


def fcaf3d_assign(points: torch.Tensor, scales: torch.Tensor,
                  points_valid: torch.Tensor, gt_boxes: torch.Tensor,
                  gt_labels: torch.Tensor, gt_valid: torch.Tensor,
                  n_scales: int, limit: int, topk: int) -> AssignResult:
    """Batched assignment.

    Args:
        points: [B, P, 3] metric head locations (all levels concatenated).
        scales: [B, P] int level of each location.
        points_valid: [B, P] bool.
        gt_boxes: [B, G, 7] bottom-centred box7; gt_labels: [B, G] int;
        gt_valid: [B, G] bool.
    """
    b, p, _ = points.shape
    centers = gravity_center(gt_boxes)  # [B, G, 3]
    dims = gt_boxes[..., 3:6]
    yaw = gt_boxes[..., 6]

    # face distances in each box's frame: [B, P, G, 6]
    shift = points[:, :, None, :] - centers[:, None, :, :]  # [B, P, G, 3]
    local = rotate_points_z(shift.transpose(1, 2), -yaw).transpose(1, 2)
    half = dims[:, None, :, :] * 0.5
    dist_min, dist_max = half + local, half - local
    face = torch.stack([dist_min[..., 0], dist_max[..., 0],
                        dist_min[..., 1], dist_max[..., 1],
                        dist_min[..., 2], dist_max[..., 2]], dim=-1)

    inside = face.amin(dim=-1) > 0  # [B, P, G]
    inside = inside & points_valid[:, :, None] & gt_valid[:, None, :]

    # condition 2: each box's scale
    levels = torch.arange(n_scales, device=scales.device)
    onehot = scales[:, :, None] == levels  # [B, P, S]
    counts = (inside[:, :, None, :] & onehot[..., None]).sum(dim=1)  # [B, S, G]
    lower = counts < limit
    lower_index = torch.clamp_min(lower.int().argmax(dim=1) - 1, 0)
    best_scale = torch.where((~lower).all(dim=1), n_scales - 1,
                             lower_index)  # [B, G]
    scale_ok = scales[:, :, None] == best_scale[:, None, :]  # [B, P, G]

    # condition 3: topk by centerness within the chosen scale; the
    # (topk+1)-th largest value per box is the threshold
    cness = torch.where(inside & scale_ok, compute_centerness(face), -1.0)
    k = min(topk + 1, p)
    thr = torch.topk(cness, k, dim=1).values[:, k - 1]  # [B, G]
    top_ok = cness > thr[:, None, :]

    # condition 4: the smallest box wins
    volumes = torch.where(gt_valid, dims[..., 0] * dims[..., 1] * dims[..., 2],
                          _FLOAT_MAX)
    vol = torch.where(inside & scale_ok & top_ok, volumes[:, None, :],
                      _FLOAT_MAX)
    min_vol = vol.amin(dim=2)  # [B, P]
    argmin = vol.argmin(dim=2)

    labels = torch.where(min_vol >= _FLOAT_MAX, -1,
                         torch.gather(gt_labels.long(), 1, argmin))
    chosen = torch.gather(face, 2, argmin[:, :, None, None].expand(
        b, p, 1, 6))[:, :, 0]
    target = torch.cat([centers, dims, yaw[..., None]], dim=-1)  # [B, G, 7]
    target = torch.gather(target, 1, argmin[..., None].expand(b, p, 7))
    return AssignResult(centerness=compute_centerness(chosen),
                        bbox_targets=target, labels=labels.int())
