"""Iterative farthest-point sampling in plain PyTorch: the plain version
of kernel K5, frozen from the port. Each step picks the point farthest
from the chosen set, the lowest index among equal distances."""
from __future__ import annotations

from typing import Optional

import torch

_BIG = 1e10


def furthest_point_sample_plain(points: torch.Tensor, num_samples: int,
                                valid: Optional[torch.Tensor] = None
                                ) -> torch.Tensor:
    """Plain PyTorch version of K5, same arguments and result. Each step's
    distance is written per column, so its order of operations is fixed."""
    b, n, _ = points.shape
    pts = points.float()
    x, y, z = (pts[..., c].contiguous() for c in range(3))
    if valid is None:
        valid = torch.ones((b, n), dtype=torch.bool, device=points.device)
    out = torch.zeros((b, num_samples), dtype=torch.int64,
                      device=points.device)
    if num_samples == 0:
        return out.int()
    # argmax of a bool row: its first True, 0 when there is none
    out[:, 0] = torch.argmax(valid.to(torch.uint8), dim=1)
    dcur = torch.full((b, n), _BIG, dtype=torch.float32, device=points.device)
    neg = torch.full((), -1.0, dtype=torch.float32, device=points.device)
    for i in range(1, num_samples):
        last = out[:, i - 1:i]
        dx = x - x.gather(1, last)
        dy = y - y.gather(1, last)
        dz = z - z.gather(1, last)
        d = (dx * dx + dy * dy) + dz * dz
        dcur = torch.minimum(dcur, d)
        out[:, i] = torch.argmax(torch.where(valid, dcur, neg), dim=1)
    return out.int()


def furthest_point_sample(points: torch.Tensor, num_samples: int,
                          valid: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """[B, S] int32 indices of [B, N, 3] f32 points, starting at the first
    valid index; invalid points are never selected."""
    return furthest_point_sample_plain(points, num_samples, valid)
