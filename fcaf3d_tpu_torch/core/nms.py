"""Fixed-shape NMS (port of `fcaf3d_tpu/core/nms.py`): a static [K, K] IoU
matrix and a greedy suppression loop over score-sorted candidates, batched
over any leading dims (the classes of `fcaf3d_get_bboxes`, the clouds of
`votenet_get_bboxes`)."""
from __future__ import annotations

import torch

from ..utils import tracing
from .rotated_iou import pairwise_iou_bev


def _greedy_suppress(iou: torch.Tensor, order_valid: torch.Tensor,
                     iou_thr: float) -> torch.Tensor:
    """Greedy NMS given [..., K, K] IoU between score-sorted candidates.

    Args:
        order_valid: [..., K] bool; False rows are padding (never kept).

    Returns:
        keep [..., K] bool over the sorted candidates.
    """
    k = iou.shape[-1]
    suppr = (iou > iou_thr) & ~torch.eye(k, dtype=torch.bool,
                                         device=iou.device)
    alive = order_valid.clone()
    for i in range(k):  # candidate i, if still alive, kills what it overlaps
        alive &= ~(suppr[..., i, :] & alive[..., i:i + 1])
    return alive


@tracing.spanned("nms")
def nms_bev(boxes7: torch.Tensor, scores: torch.Tensor, iou_thr: float,
            valid=None, rotated: bool = True) -> torch.Tensor:
    """BEV NMS on 7-DoF boxes (x, y, z, dx, dy, dz, yaw), pcdet semantics.

    Args:
        boxes7: [..., K, 7] candidates (only x, y, dx, dy and yaw are
            read).
        scores: [..., K].
        valid: optional [..., K] bool candidate mask.
        rotated: True, the rotated BEV IoU (`pcdet_nms_gpu`); False, the
            axis-aligned overlap of `pcdet_nms_normal_gpu` (yaw ignored).

    Returns:
        keep [..., K] bool in the original candidate order.
    """
    if valid is None:
        valid = torch.ones_like(scores, dtype=torch.bool)
    masked = torch.where(valid, scores, -torch.inf)
    order = torch.argsort(-masked, dim=-1, stable=True)
    sboxes = torch.take_along_dim(boxes7, order[..., None], dim=-2)
    svalid = torch.gather(valid, -1, order)
    keep_sorted = _greedy_suppress(
        _rotated_bev_iou(sboxes) if rotated else _aligned_bev_iou(sboxes),
        svalid, iou_thr)
    return torch.zeros_like(keep_sorted).scatter(-1, order, keep_sorted)


def _rotated_bev_iou(boxes7: torch.Tensor) -> torch.Tensor:
    """[..., K, K] rotated BEV IoU of box7 [..., K, 7]."""
    bev = boxes7[..., [0, 1, 3, 4, 6]]
    return pairwise_iou_bev(bev, bev)


def _aligned_bev_iou(boxes7: torch.Tensor) -> torch.Tensor:
    """[..., K, K] BEV IoU of box7 [..., K, 7] with the yaw ignored."""
    lo = boxes7[..., 0:2] - boxes7[..., 3:5] * 0.5
    hi = boxes7[..., 0:2] + boxes7[..., 3:5] * 0.5
    inter = torch.clamp(
        torch.minimum(hi[..., :, None, :], hi[..., None, :, :])
        - torch.maximum(lo[..., :, None, :], lo[..., None, :, :]), min=0.0)
    inter_a = inter[..., 0] * inter[..., 1]
    area = boxes7[..., 3] * boxes7[..., 4]
    union = area[..., :, None] + area[..., None, :] - inter_a
    return inter_a / torch.clamp_min(union, 1e-8)


def aligned_3d_nms(boxes6: torch.Tensor, scores: torch.Tensor,
                   classes: torch.Tensor, iou_thr: float,
                   valid=None) -> torch.Tensor:
    """Axis-aligned 3D NMS on corner-form boxes [..., K, 6] = (x1, y1, z1,
    x2, y2, z2): full 3D IoU, suppression only within the same class
    (VoteNet's `aligned_3d_nms`).

    Returns:
        keep [..., K] bool in the original candidate order.
    """
    if valid is None:
        valid = torch.ones_like(scores, dtype=torch.bool)
    masked = torch.where(valid, scores, -torch.inf)
    order = torch.argsort(-masked, dim=-1, stable=True)
    b = torch.take_along_dim(boxes6, order[..., None], dim=-2)
    svalid = torch.gather(valid, -1, order)
    scls = torch.gather(classes, -1, order)

    lo, hi = b[..., :3], b[..., 3:6]
    inter = torch.clamp(
        torch.minimum(hi[..., :, None, :], hi[..., None, :, :])
        - torch.maximum(lo[..., :, None, :], lo[..., None, :, :]), min=0.0)
    vol_i = inter[..., 0] * inter[..., 1] * inter[..., 2]
    ext = hi - lo
    vol = ext[..., 0] * ext[..., 1] * ext[..., 2]
    union = vol[..., :, None] + vol[..., None, :] - vol_i
    iou = vol_i / torch.clamp_min(union, 1e-8)
    iou = torch.where(scls[..., :, None] == scls[..., None, :], iou, 0.0)

    keep_sorted = _greedy_suppress(iou, svalid, iou_thr)
    return torch.zeros_like(keep_sorted).scatter(-1, order, keep_sorted)
