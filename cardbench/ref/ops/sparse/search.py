"""Per-sample searchsorted of segmented queries in plain PyTorch: the
plain version of kernel K1, frozen from the port."""
from __future__ import annotations

import torch

from .tensor import SENTINEL


def searchsorted_segments_plain(keys: torch.Tensor, queries: torch.Tensor,
                                with_miss: bool = False) -> torch.Tensor:
    """Plain PyTorch version of K1, same arguments and result."""
    b, n = keys.shape
    flat = queries.reshape(b, -1)
    idx = torch.searchsorted(keys, flat, side="left")
    if with_miss:
        safe = torch.clamp(idx, max=n - 1)
        hit = (torch.gather(keys, 1, safe) == flat) & (flat != SENTINEL)
        idx = torch.where(hit, safe, n)
    return idx.int().reshape(queries.shape)


def searchsorted_segments(keys: torch.Tensor, queries: torch.Tensor,
                          with_miss: bool = False,
                          layout: str = "sm") -> torch.Tensor:
    """Per-sample searchsorted(side='left'): keys [B, N] int64 ascending
    (SENTINEL padding at the end), queries [B, S, M] or [B, M, S] int64;
    with `with_miss` an absent query or the SENTINEL gives N. int32 in
    [0, N], the shape of `queries`."""
    if layout not in ("sm", "ms"):
        raise ValueError(f"layout must be 'sm' or 'ms', got {layout!r}")
    return searchsorted_segments_plain(keys, queries, with_miss)
