"""Per-sample sorted-key search (port of `fcaf3d_tpu/ops/sparse/search.py`).

The contract is `searchsorted_segments`: side='left' positions of query keys
in ascending per-sample keys, optionally hit-verified (`with_miss`: a query
that is absent, or is the SENTINEL, returns N). Queries come in "sm"
([B, S, M]) or "ms" ([B, M, S]) layout; the search is elementwise, so the
layout only names the shape.

On a CUDA tensor the search is kernel K1 (`csrc/search.cu`); on a CPU tensor
it is the plain PyTorch version, `searchsorted_segments_plain`. K1 is the
gallop kernel: a thread walks one segment of the queries over consecutive
rows, each search starting from its previous answer. `k1_gallop_plan` sets
its rows a thread from the shapes alone.
"""
from __future__ import annotations

import torch

from ... import _native
from ..._native import SMS
from .tensor import SENTINEL

K1_THREADS = 256  # a CTA of the gallop kernel (kThreads there)
K1_RESIDENT = SMS * 2048  # threads the card holds at once


def k1_gallop_plan(b: int, m: int, s: int) -> int:
    """The gallop kernel's rows a thread for B samples of M rows of S
    segments: one while every (row, segment) can have a resident thread of
    its own, else as many as spread the queries over the resident threads
    (each search after a thread's first starts from the one before)."""
    return max(1, -(-b * m * s // K1_RESIDENT))


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


def _searchsorted_cuda(keys, queries, with_miss, plan=None):
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
    q = queries.numel() // max(b, 1)
    # segments: the last axis of [B, M, S] queries; else one segment
    s = queries.shape[-1] if queries.dim() == 3 else 1
    m = q // max(s, 1)
    out = queries.new_empty(queries.shape, dtype=torch.int32)
    err = lib.fcaf3d_searchsorted_gallop(
        keys.data_ptr(), queries.data_ptr(), out.data_ptr(), b, n, m, s,
        plan or k1_gallop_plan(b, m, s), int(with_miss),
        _native.stream_ptr(keys.device))
    _native.count_launch("searchsorted", "gallop", keys.dtype)
    _native.check(err, "searchsorted (gallop)")
    return out


def searchsorted_segments(keys: torch.Tensor, queries: torch.Tensor,
                          with_miss: bool = False, layout: str = "sm", *,
                          _plan=None):
    """Per-sample searchsorted(side='left') of segmented query arrays.

    Args:
        keys: [B, N] int64 ascending per sample (SENTINEL padding at end).
        queries: [B, S, M] (layout="sm") or [B, M, S] (layout="ms"), int64.
        with_miss: return N for a query that is absent or the SENTINEL.

    Returns:
        int32 in [0, N], same shape as `queries`.

    `_plan` forces the gallop kernel's rows a thread on a CUDA tensor (so
    that checks reach a run of several rows on small edge clouds; the path
    never passes it).
    """
    if layout not in ("sm", "ms"):
        raise ValueError(f"layout must be 'sm' or 'ms', got {layout!r}")
    if keys.device.type == "cpu":
        return searchsorted_segments_plain(keys, queries, with_miss)
    return _searchsorted_cuda(keys, queries, with_miss, _plan)
