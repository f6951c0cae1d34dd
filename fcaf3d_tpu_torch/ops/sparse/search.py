"""Per-sample sorted-key search (port of `fcaf3d_tpu/ops/sparse/search.py`).

The contract is `searchsorted_segments`: side='left' positions of query keys
in ascending per-sample keys, optionally hit-verified (`with_miss`: a query
that is absent, or is the SENTINEL, returns N). Queries come in "sm"
([B, S, M]) or "ms" ([B, M, S]) layout; the search is elementwise, so the
layout only names the shape.

On a CUDA tensor the search is kernel K1 (`csrc/search.cu`); on a CPU tensor
it is the plain PyTorch version, `searchsorted_segments_plain`.
"""
from __future__ import annotations

import torch

from ... import _native
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


def _searchsorted_cuda(keys, queries, with_miss):
    lib = _native.load()
    if keys.device.type != "cuda" or queries.device != keys.device:
        raise ValueError("K1 needs keys and queries on one CUDA device, got "
                         f"{keys.device} and {queries.device}")
    if keys.dtype != torch.int64 or queries.dtype != torch.int64:
        raise TypeError("K1 takes int64 keys and queries, got "
                        f"{keys.dtype} and {queries.dtype}")
    if keys.dim() != 2 or queries.shape[0] != keys.shape[0]:
        raise ValueError(f"K1 shapes: keys {tuple(keys.shape)}, "
                         f"queries {tuple(queries.shape)}")
    if not (keys.is_contiguous() and queries.is_contiguous()):
        raise ValueError("K1 takes contiguous keys and queries")
    b, n = keys.shape
    out = torch.empty(queries.shape, dtype=torch.int32, device=keys.device)
    err = lib.fcaf3d_searchsorted(
        keys.data_ptr(), queries.data_ptr(), out.data_ptr(), b, n,
        queries.numel() // max(b, 1), int(with_miss),
        _native.stream_ptr(keys.device))
    _native.LAUNCHES["searchsorted"] += 1
    _native.check(err, "searchsorted")
    return out


def searchsorted_segments(keys: torch.Tensor, queries: torch.Tensor,
                          with_miss: bool = False, layout: str = "sm"):
    """Per-sample searchsorted(side='left') of segmented query arrays.

    Args:
        keys: [B, N] int64 ascending per sample (SENTINEL padding at end).
        queries: [B, S, M] (layout="sm") or [B, M, S] (layout="ms"), int64.
        with_miss: return N for a query that is absent or the SENTINEL.

    Returns:
        int32 in [0, N], same shape as `queries`.
    """
    if layout not in ("sm", "ms"):
        raise ValueError(f"layout must be 'sm' or 'ms', got {layout!r}")
    if keys.device.type == "cpu":
        return searchsorted_segments_plain(keys, queries, with_miss)
    return _searchsorted_cuda(keys, queries, with_miss)
