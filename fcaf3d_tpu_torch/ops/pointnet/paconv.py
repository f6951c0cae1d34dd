"""PAConv `assign_score_withk` (port of `fcaf3d_tpu/ops/pointnet/paconv.py`),
the equivalent of the reference's CUDA op (mmdet3d `ops/paconv/src/
assign_score_withk_cuda.cu`, wrapper `ops/paconv/assign_score.py`).

Semantics (from the CUDA forward kernel):
    out[b, o, n, k] = sum_m scores[b, n, k, m] *
        (points[b, knn_idx[b, n, k], m, o] - centers[b, knn_idx[b, n, 0], m, o])
with out-of-range neighbour indices (idx < 0 or idx >= N) contributing
zero. The reference kernel writes one slot per (n, k) whatever the
`aggregate` flag (PAConv only ever dispatches 'sum'). Plain PyTorch, as the
JAX function is plain jnp: the gradients come from torch autograd where
the JAX package takes `jax.grad` and the reference three hand-written
backward kernels.
"""
from __future__ import annotations

import torch


def assign_score_withk(scores: torch.Tensor, points: torch.Tensor,
                       centers: torch.Tensor, knn_idx: torch.Tensor,
                       aggregate: str = "sum") -> torch.Tensor:
    """Aggregate weight-bank point features by predicted scores.

    Args:
        scores: [B, npoint, K, M] weight-bank mixing scores.
        points: [B, N, M, O] per-point features, one per weight matrix.
        centers: [B, N, M, O] per-point center features.
        knn_idx: [B, npoint, K] integer neighbour indices; column k = 0 is
            the center point. Out-of-range entries contribute zero.
        aggregate: only 'sum' (the reference kernel's sole behaviour).

    Returns:
        [B, O, npoint, K] aggregated features (the reference layout).
    """
    if aggregate != "sum":
        raise NotImplementedError("reference kernel implements only 'sum'")
    b, n, m, o = points.shape
    npoint, k = knn_idx.shape[1:]
    valid = (knn_idx >= 0) & (knn_idx < n)
    safe = knn_idx.clamp(0, n - 1).long()
    p = torch.take_along_dim(points.reshape(b, n, m * o),
                             safe.reshape(b, npoint * k, 1), dim=1)
    c = torch.take_along_dim(centers.reshape(b, n, m * o),
                             safe[:, :, :1], dim=1)
    diff = (p.reshape(b, npoint, k, m, o)
            - c.reshape(b, npoint, 1, m, o))
    # sum_m s[..., m] * (p - c)[..., m, o]: a batched [1, M] x [M, O] GEMM
    out = torch.einsum("bnkm,bnkmo->bnko", scores, diff)
    out = torch.where(valid[..., None], out, out.new_zeros(()))
    return out.permute(0, 3, 1, 2)
