"""PointNet++ primitive ops (port of `fcaf3d_tpu/ops/pointnet/ops.py`).

Padded [B, N, ...] tensors with optional validity masks, as in the JAX
package. `furthest_point_sample` (K5) and `ball_query` (K6) dispatch on the
device: the kernel on a CUDA tensor, the plain version on a CPU one. The
other ops are plain PyTorch on both, as `knn` here and `assign_score_withk`
(`paconv.py`), which are no Pallas kernels in the JAX package either.
"""
from __future__ import annotations

from typing import Optional

import torch

from .ball_query import ball_query  # noqa: F401
from .fps import furthest_point_sample  # noqa: F401

_BIG = 1e10


def _sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise squared distances [..., N, 3] x [..., M, 3] -> [..., N, M],
    by the expansion |a|^2 - 2 a.b + |b|^2."""
    return ((a * a).sum(-1)[..., :, None]
            - 2.0 * torch.einsum("...nc,...mc->...nm", a, b)
            + (b * b).sum(-1)[..., None, :])


def gather_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """[B, N, C] gathered at [B, M] -> [B, M, C]."""
    index = idx.long()[..., None].expand(*idx.shape, points.shape[-1])
    return torch.gather(points, 1, index)


def group_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """[B, N, C] grouped by [B, M, K] -> [B, M, K, C]."""
    b, m, k = idx.shape
    return gather_points(points, idx.reshape(b, m * k)).reshape(b, m, k, -1)


def knn(query: torch.Tensor, points: torch.Tensor, k: int,
        valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The k nearest points of each query: [B, M, 3] in [B, N, 3] -> idx
    [B, M, k] int32, nearest first. An exact k-smallest over the same
    expansion as the JAX package's `approx_min_k` at recall 1.0; invalid
    points sit at distance `_BIG`. Ties may pick another of the equally
    distant points than the JAX function (their distances are equal)."""
    d2 = _sqdist(query, points)
    if valid is not None:
        d2 = torch.where(valid[:, None, :], d2, _BIG)
    return torch.topk(d2, k, dim=-1, largest=False, sorted=True)[1].int()


def three_nn(query: torch.Tensor, points: torch.Tensor,
             valid: Optional[torch.Tensor] = None):
    """The 3 nearest points of each query: (dist [B, M, 3], idx [B, M, 3]
    int32), nearest first. An exact 3-smallest over the same expansion as
    the JAX package's `approx_min_k` at recall 1.0."""
    d2 = _sqdist(query, points)
    if valid is not None:
        d2 = torch.where(valid[:, None, :], d2, _BIG)
    d, idx = torch.topk(d2, 3, dim=-1, largest=False, sorted=True)
    return torch.sqrt(torch.clamp_min(d, 1e-12)), idx.int()


def three_interpolate(features: torch.Tensor, idx: torch.Tensor,
                      dist: torch.Tensor) -> torch.Tensor:
    """Inverse-distance-weighted 3-NN interpolation: features [B, N, C],
    idx / dist [B, M, 3] -> [B, M, C]."""
    w = 1.0 / torch.clamp_min(dist * dist, 1e-8)
    w = w / w.sum(-1, keepdim=True)
    return (group_points(features, idx) * w[..., None]).sum(2)
