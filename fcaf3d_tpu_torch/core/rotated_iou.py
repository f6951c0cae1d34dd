"""3D IoU of the box loss (port of `axis_aligned_iou` from
`fcaf3d_tpu/core/rotated_iou.py`; the rotated IoU is not ported yet)."""
from __future__ import annotations

import torch

_EPS = 1e-8


def axis_aligned_iou(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """IoU of aligned pairs of axis-aligned gravity-centred boxes [..., 6]
    (cx, cy, cz, dx, dy, dz). Clamps use `maximum`, whose gradient at a tie
    is 1/2, as in the JAX package."""
    lo1 = pred[..., :3] - pred[..., 3:6] * 0.5
    hi1 = pred[..., :3] + pred[..., 3:6] * 0.5
    lo2 = target[..., :3] - target[..., 3:6] * 0.5
    hi2 = target[..., :3] + target[..., 3:6] * 0.5
    inter = torch.minimum(hi1, hi2) - torch.maximum(lo1, lo2)
    inter = torch.maximum(inter, inter.new_zeros(()))
    inter_vol = torch.prod(inter, dim=-1)
    v1 = torch.prod(hi1 - lo1, dim=-1)
    v2 = torch.prod(hi2 - lo2, dim=-1)
    union = v1 + v2 - inter_vol
    return inter_vol / torch.maximum(union, union.new_full((), _EPS))
