"""Ops of the prune-early neck (port of `fcaf3d_tpu/ops/sparse/neck_ops.py`).

Children of a coarse level are generated parent-major, scored by the coarse
level's statically interpolated prune score, pruned to the level's budget
by `threshold_select` (force-keeping lateral-backed children), compacted
and sorted; the lateral is then a scatter-add.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Optional

import numpy as np
import torch

from .conv import gather_gemm, offsets_table
from .tables import const_table
from .tensor import (
    SENTINEL,
    SparseTensor,
    _extent,
    compact_positions,
    decode_coords,
    encode_coords,
    lookup,
    sort_rows,
    take_rows,
)


def trilinear_slot_weights() -> np.ndarray:
    """[27, 8] table W[k, o]: weight of parent-offset k (kernel_offsets(3)
    order) in the trilinear interpolation at child slot o (kernel_offsets(2)
    order): corner j contributes iff j <= bits(o), with 2^-popcount(o)."""
    w = np.zeros((27, 8), np.float32)
    for o, bits in enumerate(itertools.product((0, 1), repeat=3)):
        bits = np.asarray(bits)
        for j in itertools.product((0, 1), repeat=3):
            j = np.asarray(j)
            if np.all(j <= bits):
                k = (j[0] + 1) * 9 + (j[1] + 1) * 3 + (j[2] + 1)
                w[k, o] = 0.5 ** bits.sum()
    return w


def child_prune_scores(parent_scores: torch.Tensor,
                       parent_kmap: torch.Tensor) -> torch.Tensor:
    """Interpolated prune score [B, 8P] of every generated child,
    parent-major (row = p*8 + o), from coarse scores [B, P, 1] and the
    parent self kernel map [B, P, 27] (absent neighbours add zero)."""
    w = const_table(trilinear_slot_weights, device=parent_scores.device,
                    dtype=parent_scores.dtype).reshape(27, 1, 8)
    out = gather_gemm(parent_scores, parent_kmap, w)  # [B, P, 8]
    b, p, _ = out.shape
    return out.reshape(b, 8 * p)


def threshold_select(scores: torch.Tensor, valid: torch.Tensor, budget: int,
                     must_keep: Optional[torch.Tensor] = None,
                     iters: int = 24) -> torch.Tensor:
    """Top-`budget` keep mask [B, N] by score without an argsort: a fixed
    `iters`-step float32 bisection on the threshold, then the boundary rows
    are filled in row order. Step for step the JAX package's arithmetic."""
    b, n = scores.shape
    if must_keep is None:
        must_keep = torch.zeros_like(valid)
    must_keep = must_keep & valid
    if budget >= n:
        return valid

    cand = valid & ~must_keep
    s = scores.float()
    big = 3e38
    quota = torch.clamp(budget - must_keep.sum(dim=1), min=0)
    lo = torch.where(cand, s, big).amin(dim=1) - 1.0
    hi = torch.where(cand, s, -big).amax(dim=1) + 1.0
    hi = torch.maximum(hi, lo)  # no candidates -> empty range
    for _ in range(iters):
        mid = 0.5 * (lo + hi)  # count candidates strictly above mid
        gt = (cand & (s > mid[:, None])).sum(dim=1) > quota
        lo, hi = torch.where(gt, mid, lo), torch.where(gt, hi, mid)
    keep_hi = cand & (s > hi[:, None])
    n_hi = keep_hi.sum(dim=1)
    boundary = cand & (s > lo[:, None]) & ~keep_hi
    fill = torch.cumsum(boundary.int(), dim=1) <= (quota - n_hi)[:, None]
    return must_keep | keep_hi | (boundary & fill)


def compact_select(coords, keys, feats, keep, budget: int):
    """Compact kept rows (order-preserving) into `budget` rows.

    Returns (coords, keys, feats, old2new) where old2new [B, N] maps source
    rows to compacted rows (budget = dropped/not kept)."""
    del coords  # decoded from the kept keys
    sel, _ = compact_positions(keep, budget)
    out_keys = take_rows(torch.where(keep, keys, SENTINEL), sel, fill=SENTINEL)
    out_feats = None if feats is None else take_rows(feats, sel)
    pos = torch.cumsum(keep.int(), dim=1) - 1
    pos = torch.where(keep & (pos < budget), pos, budget)
    return decode_coords(out_keys), out_keys, out_feats, pos


def sort_tensor(st: SparseTensor) -> SparseTensor:
    """Key-sort a SparseTensor's rows (padding sinks to the end)."""
    coords, feats, keys = sort_rows(st.coords, st.feats, st.keys)
    return dataclasses.replace(st, coords=coords, feats=feats, keys=keys,
                               is_sorted=True)


def gen_children(parent: SparseTensor, weight: torch.Tensor):
    """Generative-transpose (k2 s2) children, parent-major: returns
    (coords [B, 8P, 3], keys [B, 8P], feats [B, 8P, E])."""
    offs = offsets_table(2, parent.stride // 2, parent.coords.device)
    b, p = parent.coords.shape[:2]
    coords = (parent.coords[:, :, None, :] + offs).reshape(b, p * 8, 3)
    feats = torch.einsum("bnc,kcd->bnkd", parent.feats, weight)
    feats = feats.reshape(b, p * 8, -1)
    pvalid = torch.repeat_interleave(parent.valid, 8, dim=1)
    keys = torch.where(pvalid, encode_coords(coords), SENTINEL)
    coords = torch.where(pvalid[..., None], coords, _extent(coords))
    feats = torch.where(pvalid[..., None], feats, 0.0)
    return coords, keys, feats


def lateral_child_rows(parent: SparseTensor,
                       lateral: SparseTensor) -> torch.Tensor:
    """Parent-major child row [B, L] of every lateral voxel (8P = not found):
    parent_row * 8 + slot(bits)."""
    two_s = parent.stride
    valid = lateral.valid
    pc = torch.div(lateral.coords, two_s, rounding_mode="floor") * two_s
    prow = lookup(parent.keys, torch.where(valid, encode_coords(pc), SENTINEL))
    p = parent.capacity
    bits = torch.div(lateral.coords, two_s // 2, rounding_mode="floor") % 2
    slot = bits[..., 0] * 4 + bits[..., 1] * 2 + bits[..., 2]
    rows = prow * 8 + slot
    return torch.where((prow < p) & valid, rows, 8 * p)
