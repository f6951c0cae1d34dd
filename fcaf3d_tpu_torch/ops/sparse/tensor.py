"""Batched static-shape sparse voxel tensor (PyTorch port of
`fcaf3d_tpu/ops/sparse/tensor.py`).

Same contract as the JAX package: every coordinate map has a fixed row
budget, real voxels fill a prefix, padding rows carry the SENTINEL key and
EXTENT coords, and keys are ascending per sample.

Keys are held as int64 tensors carrying the same uint32 values as the JAX
package's keys (PyTorch's uint32 has thin op coverage): order and
SENTINEL-as-max are preserved, and `keys.numpy().astype(np.uint32)` equals
the JAX keys.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .tables import const_table

# bit budget: x:11, y:11, z:10 -> exactly 32 bits
X_BITS, Y_BITS, Z_BITS = 11, 11, 10
# x is capped one short so the all-ones SENTINEL can never be a valid key
EXTENT = (2 ** X_BITS - 1, 2 ** Y_BITS, 2 ** Z_BITS)  # (2047, 2048, 1024)
SENTINEL = 0xFFFFFFFF


@dataclasses.dataclass
class SparseTensor:
    """Batched sparse voxel tensor (see module docstring for invariants)."""

    coords: torch.Tensor  # [B, N, 3] int32
    feats: torch.Tensor  # [B, N, C]
    keys: torch.Tensor  # [B, N] int64 holding uint32 values, ascending
    shift: torch.Tensor  # [B, 3] int32; original_voxel = coords - shift
    stride: int = 1
    # generated child maps can stay in parent-major order; such tensors must
    # not be used with `lookup` until re-sorted
    is_sorted: bool = True
    # [B] int32 count of valid voxels dropped when this map was built because
    # the row budget was too small; None = no compaction happened
    dropped: Optional[torch.Tensor] = None

    @property
    def capacity(self) -> int:
        return self.coords.shape[1]

    @property
    def num_channels(self) -> int:
        return self.feats.shape[-1]

    @property
    def valid(self) -> torch.Tensor:  # [B, N] bool
        return self.keys != SENTINEL

    def positions(self, voxel_size: float) -> torch.Tensor:
        """Metric positions [B, N, 3] of each voxel."""
        return (self.coords - self.shift[:, None, :]).float() * voxel_size

    def with_feats(self, feats: torch.Tensor) -> "SparseTensor":
        return dataclasses.replace(self, feats=feats)


def _extent(like: torch.Tensor) -> torch.Tensor:
    """EXTENT as an int32 [3] tensor on `like`'s device (`const_table`)."""
    return const_table(torch.tensor, EXTENT, device=like.device,
                       dtype=torch.int32)


def encode_coords(coords: torch.Tensor) -> torch.Tensor:
    """Pack int coords [..., 3] into sortable keys (int64 holding uint32);
    out-of-range -> SENTINEL. The range mask is applied before the bit
    fields are combined, so no negative value reaches a shift."""
    x, y, z = coords[..., 0], coords[..., 1], coords[..., 2]
    in_range = ((x >= 0) & (x < EXTENT[0]) & (y >= 0) & (y < EXTENT[1])
                & (z >= 0) & (z < EXTENT[2]))
    x, y, z = (torch.where(in_range, v, 0).long() for v in (x, y, z))
    key = (x << (Y_BITS + Z_BITS)) | (y << Z_BITS) | z
    return torch.where(in_range, key, SENTINEL)


def decode_coords(keys: torch.Tensor) -> torch.Tensor:
    """Inverse of `encode_coords`; SENTINEL rows decode to EXTENT, so
    `decode_coords(keys) == coords` for every map built here."""
    x = keys >> (Y_BITS + Z_BITS)
    y = (keys >> Z_BITS) & (2 ** Y_BITS - 1)
    z = keys & (2 ** Z_BITS - 1)
    c = torch.stack([x, y, z], dim=-1).int()
    return torch.where((keys == SENTINEL)[..., None], _extent(keys), c)


def sort_rows(coords: torch.Tensor, feats: Optional[torch.Tensor],
              keys: torch.Tensor):
    """Stable sort of a batched (coords, feats, keys) triplet by key; coords
    are decoded from the sorted keys (callers keep coords == decode(keys))."""
    skeys, order = torch.sort(keys, dim=1, stable=True)
    coords = decode_coords(skeys)
    if feats is not None:
        feats = torch.take_along_dim(feats, order[..., None], dim=1)
    return coords, feats, skeys


def compact_positions(mask: torch.Tensor, budget: int):
    """Source row of the j-th set bit of `mask`, for j < budget.

    Returns (sel [B, budget] int32 monotone, N where the j-th set bit does
    not exist; total [B] int32 set-bit count)."""
    from .search import searchsorted_segments

    b, n = mask.shape
    csum = torch.cumsum(mask.int(), dim=1)
    total = csum[:, -1]
    q = torch.arange(1, budget + 1, dtype=torch.int64, device=mask.device)
    q = q[None, :, None].expand(b, budget, 1).contiguous()
    # first i with csum[i] >= j+1  ==  searchsorted(csum, j+1, 'left')
    sel = searchsorted_segments(csum.long(), q, with_miss=False, layout="ms")
    return torch.clamp(sel.reshape(b, budget), max=n).int(), total.int()


def take_rows(values: torch.Tensor, sel: torch.Tensor, fill=0):
    """values[b, sel[b, j]] with sel == N returning `fill`."""
    b = values.shape[0]
    pad = torch.full((b, 1) + tuple(values.shape[2:]), fill,
                     dtype=values.dtype, device=values.device)
    vpad = torch.cat([values, pad], dim=1)
    idx = sel.long()[(...,) + (None,) * (values.dim() - 2)]
    return torch.take_along_dim(vpad, idx, dim=1)


def compact_unique(coords: torch.Tensor, keys: torch.Tensor, budget: int):
    """Deduplicate sorted keys to the first occurrence per key and compact
    into `budget` rows (overflow rows are dropped).

    Returns (coords [B, budget, 3], keys [B, budget], src_idx [B, budget],
    dropped [B])."""
    del coords  # decoded from the compacted keys (module invariant)
    b = keys.shape[0]
    prev = torch.cat([torch.full((b, 1), SENTINEL, dtype=keys.dtype,
                                 device=keys.device), keys[:, :-1]], dim=1)
    first = (keys != prev) & (keys != SENTINEL)
    sel, total = compact_positions(first, budget)
    dropped = torch.clamp(total - budget, min=0).int()
    out_keys = take_rows(keys, sel, fill=SENTINEL)
    return decode_coords(out_keys), out_keys, sel, dropped


def lookup(keys_sorted: torch.Tensor, queries: torch.Tensor,
           segments: bool = False) -> torch.Tensor:
    """Rows of `queries` [B, ...] in per-sample sorted keys [B, N]: int32 in
    [0, N], N = miss (callers use row N as a zero dump row)."""
    from .search import searchsorted_segments

    b = keys_sorted.shape[0]
    q3 = (queries if segments and queries.dim() == 3
          else queries.reshape(b, -1, 1))
    idx = searchsorted_segments(keys_sorted, q3.contiguous(), with_miss=True,
                                layout="ms")
    return idx.reshape(queries.shape)


def voxelize(points: torch.Tensor, features: torch.Tensor,
             valid: torch.Tensor, voxel_size: float, budget: int,
             margin: int = 64) -> SparseTensor:
    """Quantize a padded point batch into a stride-1 SparseTensor: floor-
    quantize, shift each sample to a non-negative grid, keep the FIRST point
    of each voxel, compact to `budget` rows.

    Args:
        points: [B, P, 3] float metric coordinates.
        features: [B, P, C].
        valid: [B, P] bool.
    """
    # divide by a device tensor, not a Python scalar: on CUDA a scalar
    # divisor becomes a multiply by its reciprocal, which moves points that
    # sit on a voxel face into the neighbouring voxel
    vs = torch.full((1,), voxel_size, dtype=points.dtype, device=points.device)
    q = torch.floor(points / vs).int()
    qmin = torch.where(valid[..., None], q, 1 << 20).amin(dim=1)  # [B, 3]
    shift = (margin - qmin).int()
    coords = torch.where(valid[..., None], q + shift[:, None, :], _extent(q))
    keys = torch.where(valid, encode_coords(coords), SENTINEL)

    keys, order = torch.sort(keys, dim=1, stable=True)
    coords = decode_coords(keys)
    out_coords, out_keys, src, dropped = compact_unique(coords, keys, budget)
    b, p = order.shape
    order_pad = torch.cat(
        [order, torch.full((b, 1), p, dtype=order.dtype, device=order.device)],
        dim=1)
    src_orig = torch.take_along_dim(order_pad, src.long(), dim=1)  # in [0, P]
    fpad = torch.cat([features, torch.zeros_like(features[:, :1])], dim=1)
    out_feats = torch.take_along_dim(fpad, src_orig[..., None], dim=1)
    return SparseTensor(coords=out_coords, feats=out_feats, keys=out_keys,
                        shift=shift, stride=1, dropped=dropped)


def voxelize_reduce(points: torch.Tensor, features: torch.Tensor,
                    valid: torch.Tensor, voxel_size: float, budget: int,
                    reduce: str = "mean", margin: int = 64) -> SparseTensor:
    """`voxelize` with a mean or max over each voxel's points instead of
    the first point (mmdet3d's `DynamicScatter`).

    Each voxel's points are contiguous after the key sort, so the reduction
    is a segment reduction over those runs, each summed in row order by one
    thread: no float atomics, so two runs on the card agree bitwise. Rows of
    padding points and of voxels beyond the budget go to a dump segment
    that is cut off.

    Args:
        points: [B, P, 3] float metric coordinates.
        features: [B, P, C].
        valid: [B, P] bool.
        reduce: "mean" or "max".
    """
    if reduce not in ("mean", "max"):
        raise ValueError(f"reduce must be 'mean' or 'max', got {reduce!r}")
    # a device-tensor divisor: see `voxelize`
    vs = torch.full((1,), voxel_size, dtype=points.dtype, device=points.device)
    q = torch.floor(points / vs).int()
    qmin = torch.where(valid[..., None], q, 1 << 20).amin(dim=1)
    shift = (margin - qmin).int()
    coords = torch.where(valid[..., None], q + shift[:, None, :], _extent(q))
    keys = torch.where(valid, encode_coords(coords), SENTINEL)

    keys, order = torch.sort(keys, dim=1, stable=True)
    feats = torch.take_along_dim(features, order[..., None], dim=1)
    out_coords, out_keys, _, dropped = compact_unique(decode_coords(keys),
                                                      keys, budget)
    # every row's output slot: the count of voxels up to it, less one; the
    # rows of padding points and of overflow voxels land in slot `budget`
    b, p = keys.shape
    prev = torch.cat([torch.full((b, 1), SENTINEL, dtype=keys.dtype,
                                 device=keys.device), keys[:, :-1]], dim=1)
    seg = torch.cumsum((keys != prev) & (keys != SENTINEL), dim=1) - 1
    seg = torch.where((keys != SENTINEL) & (seg >= 0) & (seg < budget), seg,
                      budget)
    # slots ascend along each sample's rows, so the flat slot ids ascend
    gid = (seg + torch.arange(b, device=seg.device)[:, None] * (budget + 1))
    lengths = torch.bincount(gid.reshape(-1), minlength=b * (budget + 1))
    flat = feats.reshape(b * p, -1)
    c = flat.shape[-1]
    if reduce == "mean":
        acc = torch.segment_reduce(flat, "sum", lengths=lengths, unsafe=True)
        acc = acc.reshape(b, budget + 1, c)[:, :budget]
        cnt = lengths.reshape(b, budget + 1)[:, :budget, None]
        out_feats = acc / torch.clamp_min(cnt, 1).to(acc.dtype)
    else:
        acc = torch.segment_reduce(flat, "max", lengths=lengths, unsafe=True,
                                   initial=torch.finfo(flat.dtype).min)
        acc = acc.reshape(b, budget + 1, c)[:, :budget]
        out_feats = torch.where((out_keys != SENTINEL)[..., None], acc, 0.0)
    return SparseTensor(coords=out_coords, feats=out_feats.to(feats.dtype),
                        keys=out_keys, shift=shift, stride=1, dropped=dropped)


def downsample_coords(st: SparseTensor, factor: int, budget: int):
    """Output coordinate map of a strided op: unique(floor(c / s') * s').

    Returns (coords [B, budget, 3], keys [B, budget], dropped [B])."""
    new_stride = st.stride * factor
    valid = st.valid
    c = torch.div(st.coords, new_stride, rounding_mode="floor") * new_stride
    c = torch.where(valid[..., None], c, _extent(c))
    keys = torch.where(valid, encode_coords(c), SENTINEL)
    c, _, keys = sort_rows(c, None, keys)
    out_coords, out_keys, _, dropped = compact_unique(c, keys, budget)
    return out_coords, out_keys, dropped
