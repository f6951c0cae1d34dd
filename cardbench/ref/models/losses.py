"""Detection losses of FCAF3D (port of the focal, BCE, IoU and GIoU losses
of `fcaf3d_tpu/models/losses.py`).

Each is a masked sum over the row axis (and the class axis), keeping any
leading batch axes: on one sample's [P, ...] inputs it returns the JAX
function's scalar, on [B, P, ...] inputs the [B] per-sample sums. Callers
divide by batch-mean normalisers.
"""
from __future__ import annotations

import torch

from ..core.rotated_iou import axis_aligned_iou, giou_3d, iou_3d


def _stable_bce_with_logits(logits: torch.Tensor,
                            targets: torch.Tensor) -> torch.Tensor:
    """Elementwise BCE with logits, max(x, 0) - x t + log1p(exp(-|x|)),
    with the JAX package's gradients at x == 0: 1/2 for the max and 1 for
    |x| (torch's `abs` gives 0 there)."""
    abs_x = torch.where(logits >= 0, logits, -logits)
    return (torch.maximum(logits, logits.new_zeros(())) - logits * targets
            + torch.log1p(torch.exp(-abs_x)))


def focal_loss_sum(logits: torch.Tensor, labels: torch.Tensor,
                   valid: torch.Tensor, gamma: float = 2.0,
                   alpha: float = 0.25) -> torch.Tensor:
    """Sigmoid focal loss (mmdet semantics) summed over valid rows [..., P]
    and the classes of logits [..., P, C]; label -1 is background."""
    c = logits.shape[-1]
    onehot = (labels[..., None] == torch.arange(c, device=labels.device))
    onehot = onehot.to(logits.dtype)
    p = torch.sigmoid(logits)
    pt = p * onehot + (1.0 - p) * (1.0 - onehot)
    alpha_t = alpha * onehot + (1.0 - alpha) * (1.0 - onehot)
    ce = _stable_bce_with_logits(logits, onehot)
    loss = alpha_t * ((1.0 - pt) ** gamma) * ce
    loss = loss.sum(dim=-1) * valid.to(logits.dtype)
    return loss.sum(dim=-1)


def bce_loss_sum(logits: torch.Tensor, targets: torch.Tensor,
                 valid: torch.Tensor) -> torch.Tensor:
    """BCE with logits summed over valid rows [..., P]."""
    loss = _stable_bce_with_logits(logits, targets)
    return (loss * valid.to(logits.dtype)).sum(dim=-1)


def iou3d_loss_sum(pred_boxes7: torch.Tensor, target_boxes7: torch.Tensor,
                   weight: torch.Tensor, with_yaw: bool) -> torch.Tensor:
    """(1 - IoU3D) * weight summed over gravity-centred box pairs
    [..., P, 7]: the rotated 3D IoU with `with_yaw`, else the axis-aligned
    IoU, which drops the yaw column."""
    if with_yaw:
        iou = iou_3d(pred_boxes7, target_boxes7)
    else:
        iou = axis_aligned_iou(pred_boxes7[..., :6], target_boxes7[..., :6])
    return ((1.0 - iou) * weight).sum(dim=-1)


def giou3d_loss_sum(pred_boxes7: torch.Tensor, target_boxes7: torch.Tensor,
                    weight: torch.Tensor) -> torch.Tensor:
    """GIoU3D loss * weight summed over gravity-centred box pairs
    [..., P, 7], with the smallest enclosing rectangle."""
    loss, _ = giou_3d(pred_boxes7, target_boxes7)
    return (loss * weight).sum(dim=-1)
