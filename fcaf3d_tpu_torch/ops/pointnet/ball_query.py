"""Ball query, kernel K6 (port of the contract of
`fcaf3d_tpu/ops/pointnet/ballq_kernel.py::ball_query_grid`, whose TPU
kernel is `_scores_pallas`).

Per centre, the first `nsample` valid points with
`(x-cx)^2 + (y-cy)^2 + (z-cz)^2 < r^2`, in ascending point index; the row
is padded with its first hit, and a centre with no hit gives zeros. This is
`ball_query_grid`'s result whenever its overflow is <= 0; the cell grid, the
128-candidate cap and the overflow count are the TPU's means to that end,
and the port has no cap, so nothing overflows.

The distance is the direct form of the TPU kernel (not the
`|a|^2 - 2a.b + |b|^2` expansion of the JAX package's brute `ball_query`),
rounded one operation at a time: the two forms can disagree on a point
within an ulp of r^2.

On a CUDA tensor the query is kernel K6 (`csrc/ball_query.cu`); on a CPU
tensor it is the plain PyTorch version, `ball_query_plain`.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ... import _native


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


def _ball_query_cuda(centers, points, radius, nsample, valid):
    lib = _native.load()
    dev = points.device
    if dev.type != "cuda" or centers.device != dev or (
            valid is not None and valid.device != dev):
        raise ValueError(f"K6 needs its tensors on one CUDA device, got "
                         f"{centers.device}, {dev} and "
                         f"{None if valid is None else valid.device}")
    b, n, _ = points.shape
    if centers.dtype != torch.float32 or points.dtype != torch.float32 \
            or centers.dim() != 3 or centers.shape[0] != b \
            or centers.shape[2] != 3 or points.shape[2] != 3:
        raise TypeError(f"K6 takes f32 centres [B, M, 3] and points [B, N, 3]"
                        f", got {centers.dtype} {tuple(centers.shape)} and "
                        f"{points.dtype} {tuple(points.shape)}")
    if valid is not None and (valid.dtype != torch.bool
                              or tuple(valid.shape) != (b, n)):
        raise TypeError(f"K6 takes a bool valid mask [B, N], got "
                        f"{valid.dtype} {tuple(valid.shape)}")
    if not (centers.is_contiguous() and points.is_contiguous()) or (
            valid is not None and not valid.is_contiguous()):
        raise ValueError("K6 takes contiguous centres, points and valid mask")
    m = centers.shape[1]
    out = torch.empty((b, m, nsample), dtype=torch.int32, device=dev)
    err = lib.fcaf3d_ball_query(
        centers.data_ptr(), points.data_ptr(),
        None if valid is None else valid.data_ptr(), out.data_ptr(), b, m, n,
        nsample, squared_radius(radius), _native.stream_ptr(dev))
    _native.LAUNCHES["ball_query"] += 1
    _native.check(err, "ball_query")
    return out


def ball_query(centers: torch.Tensor, points: torch.Tensor, radius: float,
               nsample: int, valid: Optional[torch.Tensor] = None
               ) -> torch.Tensor:
    """Fixed-radius neighbours.

    Args:
        centers: [B, M, 3] f32; points: [B, N, 3] f32.
        valid: optional [B, N] bool; invalid points are never returned.

    Returns:
        [B, M, nsample] int32.
    """
    if points.device.type == "cpu":
        return ball_query_plain(centers, points, radius, nsample, valid)
    return _ball_query_cuda(centers, points, radius, nsample, valid)
