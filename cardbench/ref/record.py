"""What the reference's matrix products did, kept by the active recorders:
the shapes and maps of its gather-GEMM (K2) and gather weight-gradient
(K4) calls, and the shapes of its dense layers."""
from __future__ import annotations

from typing import List

import torch

_ACTIVE: List["calls"] = []


class calls:
    """Context manager collecting one record a call made inside it: for K2
    / K4 ("k2", "k4") (kind, B, M, K, C, E, N, hits, epilogue, add, feats
    dtype), `hits` a 0-d device tensor, the map entries that are not
    misses, summed without a synchronise; for a dense layer ("dense",
    rows, in, out, whether its input needs a gradient)."""

    def __init__(self):
        self.records = []

    def __enter__(self):
        _ACTIVE.append(self)
        return self

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        return False


def record_call(kind: str, feats: torch.Tensor, idx: torch.Tensor, e: int,
                epilogue: bool = False, add: bool = False) -> None:
    if not _ACTIVE:
        return
    b, n, c = feats.shape
    m, k = idx.shape[1:]
    hits = (idx < n).sum()
    for rec in _ACTIVE:
        rec.records.append((kind, b, m, k, c, e, n, hits, epilogue, add,
                            feats.dtype))


def record_dense(x: torch.Tensor, kernel: torch.Tensor) -> None:
    if not _ACTIVE:
        return
    rows = x.numel() // x.shape[-1]
    for rec in _ACTIVE:
        rec.records.append(("dense", rows, kernel.shape[0], kernel.shape[1],
                            x.requires_grad))
