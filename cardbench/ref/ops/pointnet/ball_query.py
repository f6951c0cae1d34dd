"""Fixed-radius neighbours in plain PyTorch: the plain version of kernel
K6, frozen from the port."""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def squared_radius(radius: float) -> float:
    """r^2 as the JAX package compares it: the Python product, rounded once
    to f32."""
    return float(np.float32(float(radius) * float(radius)))


def ball_query_plain(centers: torch.Tensor, points: torch.Tensor,
                     radius: float, nsample: int,
                     valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of K6, same arguments and result: the brute
    [B, M, N] hit mask, then the first `nsample` hits by index."""
    b, n, _ = points.shape
    dev = points.device
    d2 = None
    for c in range(3):
        d = points[:, None, :, c] - centers[:, :, None, c]
        d2 = d * d if d2 is None else d2 + d * d
    r2 = torch.tensor(squared_radius(radius), dtype=torch.float32, device=dev)
    ok = d2 < r2
    if valid is not None:
        ok &= valid[:, None, :]
    iota = torch.arange(n, dtype=torch.int32, device=dev)
    score = torch.where(ok, iota, torch.full((), n, dtype=torch.int32,
                                              device=dev))
    picked = torch.topk(score, min(nsample, n), dim=-1, largest=False,
                        sorted=True).values
    if nsample > n:
        picked = torch.nn.functional.pad(picked, (0, nsample - n), value=n)
    first = picked[..., :1]
    idx = torch.where(picked >= n, first, picked)
    return torch.where(first >= n, 0, idx).int()


def ball_query(centers: torch.Tensor, points: torch.Tensor, radius: float,
               nsample: int, valid: Optional[torch.Tensor] = None
               ) -> torch.Tensor:
    """[B, M, nsample] int32: the first `nsample` points of [B, N, 3] within
    `radius` of each of [B, M, 3] centres, by index, padded with the first
    (0 where there is none); invalid points are never returned."""
    return ball_query_plain(centers, points, radius, nsample, valid)
