"""Sparse convolution and max pooling on sorted coordinate maps, and the
ops of the reference-order neck: the generative transposed conv, the conv3
on its parent-major child map, union-add, prune and trilinear
interpolation (port of `fcaf3d_tpu/ops/sparse/conv.py`).

Each convolution derives its output coordinate map, looks every
`out_coord + offset` up in the sorted input keys to build a [B, M, K]
neighbour table (miss -> N, the zero dump row), and runs one gather-GEMM
(kernel K2) over it. Its backward is the JAX package's fused one: dW from
the weight-gradient kernel K4 on the forward map, dFeats from K2 on the
inverse map (the offset-reversed map for a self-symmetric conv, else one
int32 scatter inversion) with the transposed weights.

Kernel offset order: `itertools.product` over (x, y, z), x slowest; odd
kernels span {-S..S}, even kernels {0..(k-1)S}.
"""
from __future__ import annotations

import itertools
from typing import Optional

import numpy as np
import torch

from .gather_kernel import (
    apply_epilogue,
    fused_gather_dw,
    fused_gather_gemm,
    fused_gather_max,
)
from .tables import const_table
from .tensor import (
    SENTINEL,
    SparseTensor,
    compact_positions,
    decode_coords,
    downsample_coords,
    encode_coords,
    lookup,
    sort_rows,
    take_rows,
)


def kernel_offsets(kernel_size: int, stride_units: int) -> np.ndarray:
    """[K, 3] int32 offsets in raw lattice units for a cubic kernel."""
    if kernel_size % 2 == 1:
        r = range(-(kernel_size // 2), kernel_size // 2 + 1)
    else:
        r = range(0, kernel_size)
    offs = np.array(list(itertools.product(r, r, r)), dtype=np.int32)
    return offs * stride_units


def offsets_table(kernel_size: int, stride_units: int,
                  device: torch.device) -> torch.Tensor:
    """`kernel_offsets` as an int32 [K, 3] tensor on `device`, made once
    (`const_table`)."""
    return const_table(kernel_offsets, kernel_size, stride_units,
                       device=device, dtype=torch.int32)


def build_kernel_map(in_keys: torch.Tensor, out_coords: torch.Tensor,
                     offsets) -> torch.Tensor:
    """Neighbour index table [B, M, K] int32; value N (= in capacity) means
    miss. One hit-verified search per (row, offset): the JAX package's
    z-difference counting streams are a TPU device and give the same table.

    `offsets`: [K, 3] int32, an `offsets_table` on `out_coords`' device
    (no copy) or a host array (copied to the device on each call)."""
    offs = torch.as_tensor(offsets, dtype=torch.int32, device=out_coords.device)
    q = encode_coords(out_coords[:, :, None, :] + offs)  # [B, M, K]
    return lookup(in_keys, q, segments=True)


def build_kernel_map_self(keys: torch.Tensor, coords: torch.Tensor,
                          stride: int) -> torch.Tensor:
    """k3 s1 submanifold kernel map on the map's own coordinates."""
    return build_kernel_map(keys, coords,
                            offsets_table(3, stride, coords.device))


def conv_plan(st: SparseTensor, kernel_size: int, stride: int = 1,
              out_budget: Optional[int] = None):
    """A convolution's (out_coords, out_keys, idx, dropped), shareable by
    every conv on the same coordinate map."""
    offs = offsets_table(kernel_size, st.stride, st.coords.device)
    if stride == 1:
        out_coords, out_keys, dropped = st.coords, st.keys, st.dropped
    else:
        budget = out_budget if out_budget is not None else st.capacity
        out_coords, out_keys, dropped = downsample_coords(st, stride, budget)
    idx = build_kernel_map(st.keys, out_coords, offs)
    return out_coords, out_keys, idx, dropped


class ConvEpilogue:
    """Folded-BN affine + activation (+ residual) fused into the conv's
    output write (inference only). `scale`/`shift` are per-output-channel
    f32; `act` in {None, 'relu', 'elu'}; `add` is an optional [B, M, Cout]
    residual added after the affine, before the activation."""

    __slots__ = ("scale", "shift", "act", "add")

    def __init__(self, scale, shift, act=None, add=None):
        self.scale = scale
        self.shift = shift
        self.act = act
        self.add = add


def invert_kernel_map(idx: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse [B, N, K] of a kernel map [B, M, K] over N input rows:
    rev[b, i, k] = the m with idx[b, m, k] == i, else M (a miss). Conv maps
    are injective per offset, so one int32 scatter builds it; misses land
    in the dump block of row N, which is cut off."""
    b, m, k = idx.shape
    pos = idx.long() * k + torch.arange(k, device=idx.device)
    src = torch.arange(m, dtype=torch.int32, device=idx.device)
    src = src[None, :, None].expand(b, m, k)
    rev = torch.full((b, (n + 1) * k), m, dtype=torch.int32,
                     device=idx.device)
    rev.scatter_(1, pos.reshape(b, -1), src.reshape(b, -1))
    return rev.reshape(b, n + 1, k)[:, :n].contiguous()


class _GatherGemm(torch.autograd.Function):
    """`fused_gather_gemm` (K2) with the fused backward of the JAX
    package's `gather_gemm` custom VJP (`conv.py:359-399`)."""

    @staticmethod
    def forward(ctx, feats, idx, weight, self_symmetric):
        ctx.save_for_backward(feats, idx, weight)
        ctx.self_symmetric = self_symmetric
        return fused_gather_gemm(feats, idx, weight)

    @staticmethod
    def backward(ctx, dout):
        feats, idx, weight = ctx.saved_tensors
        dout = dout.contiguous()
        dfeats = dw = None
        if ctx.needs_input_grad[2]:
            # f32 accumulation, cast to the weight's dtype
            dw = fused_gather_dw(feats, idx, dout).to(weight.dtype)
        if ctx.needs_input_grad[0]:
            if ctx.self_symmetric:
                rev = idx.flip(-1).contiguous()
            else:
                rev = invert_kernel_map(idx, feats.shape[1])
            wT = weight.transpose(1, 2).contiguous()
            dfeats = fused_gather_gemm(dout, rev, wT).to(feats.dtype)
        return dfeats, None, dw, None


def gather_gemm(feats: torch.Tensor, idx: torch.Tensor, weight: torch.Tensor,
                self_symmetric: bool = False) -> torch.Tensor:
    """out[b, m] = sum_k feats[b, idx[b, m, k]] @ weight[k] (miss rows -> 0).

    Differentiable in `feats` and `weight`. `self_symmetric` says the map is
    a stride-1 odd-kernel map over its own coordinates (M == N, offsets
    closed under negation), whose inverse is `idx.flip(-1)`; otherwise the
    backward inverts the map with one scatter."""
    return _GatherGemm.apply(feats.contiguous(), idx.contiguous(), weight,
                             self_symmetric)


def gather_gemm_inference(feats, idx, weight, *, scale, shift, act=None,
                          vmask=None, add=None):
    """Gather-GEMM with the fused inference epilogue."""
    return fused_gather_gemm(
        feats.contiguous(), idx.contiguous(), weight, scale=scale,
        shift=shift, act=act, vmask=vmask,
        add=None if add is None else add.contiguous())


def sparse_conv(st: SparseTensor, weight: torch.Tensor, kernel_size: int,
                stride: int = 1, bias: Optional[torch.Tensor] = None,
                out_budget: Optional[int] = None, plan=None,
                epilogue: Optional[ConvEpilogue] = None) -> SparseTensor:
    """Sparse convolution (MinkowskiConvolution semantics).

    Args:
        weight: [K, Cin, Cout], K = kernel_size**3, in the feats dtype.
        out_budget: row capacity of the strided output map.
        plan: optional precomputed `conv_plan` output.
        epilogue: optional fused BN-affine/activation/residual (inference).
            Raises ValueError together with `bias` (fold a conv bias into
            `shift` instead).
    """
    if epilogue is not None and bias is not None:
        raise ValueError("fold the conv bias into epilogue.shift")
    if kernel_size == 1 and stride == 1:
        out_coords, out_keys, dropped = st.coords, st.keys, st.dropped
        out = st.feats @ weight[0]
        if epilogue is not None:
            out = apply_epilogue(out, epilogue.scale, epilogue.shift,
                                 epilogue.act, vmask=out_keys != SENTINEL,
                                 add=epilogue.add)
    else:
        if plan is None:
            plan = conv_plan(st, kernel_size, stride, out_budget)
        out_coords, out_keys, idx, dropped = plan
        if epilogue is not None:
            out = gather_gemm_inference(
                st.feats, idx, weight, scale=epilogue.scale,
                shift=epilogue.shift, act=epilogue.act,
                vmask=out_keys != SENTINEL, add=epilogue.add)
        else:
            # stride-1 odd-kernel convs run on their own coordinate map,
            # whose offset set is closed under negation
            out = gather_gemm(st.feats, idx, weight,
                              stride == 1 and kernel_size % 2 == 1)
    if epilogue is None:
        if bias is not None:
            out = out + bias
        out = torch.where((out_keys != SENTINEL)[..., None], out, 0.0)
    return SparseTensor(
        coords=out_coords, feats=out, keys=out_keys, shift=st.shift,
        stride=st.stride * stride,
        is_sorted=st.is_sorted if stride == 1 else True, dropped=dropped)


class _MaxPoolFeats(torch.autograd.Function):
    """`fused_gather_max` (K3) with the JAX package's inverse-map backward
    (`conv.py:559-572`): every input row has one parent output row, and
    gets the parent's gradient where it equals the parent's max. Every tied
    maximum receives the full gradient (torch's `amax` would split it)."""

    @staticmethod
    def forward(ctx, feats, idx, parent_row):
        out = fused_gather_max(feats, idx)
        ctx.save_for_backward(feats, out, parent_row)
        return out

    @staticmethod
    def backward(ctx, dout):
        feats, out, parent_row = ctx.saved_tensors
        b, _, c = dout.shape
        dpad = torch.cat([dout, dout.new_zeros((b, 1, c))], dim=1)
        opad = torch.cat([out, out.new_full((b, 1, c),
                                            torch.finfo(out.dtype).min)],
                         dim=1)
        rows = parent_row.long()[..., None].expand(-1, -1, c)
        dparent = torch.gather(dpad, 1, rows)
        oparent = torch.gather(opad, 1, rows)
        dfeats = torch.where(feats == oparent, dparent, 0.0)
        return dfeats.to(feats.dtype), None, None


def sparse_max_pool(st: SparseTensor, kernel_size: int, stride: int,
                    out_budget: Optional[int] = None) -> SparseTensor:
    """Max pooling over present neighbours (MinkowskiMaxPooling), kernel K3.

    The backward needs each input row to lie in exactly one window, so
    `kernel_size` must equal `stride` (ValueError otherwise)."""
    if kernel_size != stride:
        raise ValueError(f"sparse_max_pool needs kernel_size == stride, got "
                         f"{kernel_size} and {stride}")
    budget = out_budget if out_budget is not None else st.capacity
    out_coords, out_keys, dropped = downsample_coords(st, stride, budget)
    idx = build_kernel_map(st.keys, out_coords,
                           offsets_table(kernel_size, st.stride,
                                         out_coords.device))
    parent_row = None
    if torch.is_grad_enabled() and st.feats.requires_grad:
        # inverse map for the backward: each input row's one parent output
        # row (miss -> M)
        new_stride = st.stride * stride
        pc = torch.div(st.coords, new_stride,
                       rounding_mode="floor") * new_stride
        parent_row = lookup(out_keys, torch.where(
            st.valid, encode_coords(pc), SENTINEL))
    out = _MaxPoolFeats.apply(st.feats.contiguous(), idx, parent_row)
    out = torch.where((out_keys != SENTINEL)[..., None], out, 0.0)
    return SparseTensor(coords=out_coords, feats=out, keys=out_keys,
                        shift=st.shift, stride=st.stride * stride,
                        dropped=dropped)


def generative_transpose_conv2x2(st: SparseTensor, weight: torch.Tensor,
                                 sort_output: bool = True) -> SparseTensor:
    """Generative transposed conv, kernel 2 stride 2 (ME's
    `MinkowskiGenerativeConvolutionTranspose`): every parent at stride 2S
    emits its 8 children `parent + {0, S}^3`, child k's features
    `parent @ W[k]`. Children of distinct parents never collide, so the map
    is exactly 8P rows: parent-major (the 8 children of parent row p at rows
    8p..8p+7 in `kernel_offsets(2)` order) or, with `sort_output`,
    key-sorted.

    Args:
        weight: [8, Cin, Cout] in `kernel_offsets(2, S)` order.
    """
    from .neck_ops import gen_children, sort_tensor

    coords, keys, feats = gen_children(st, weight)
    out = SparseTensor(coords=coords, feats=feats, keys=keys, shift=st.shift,
                       stride=st.stride // 2, is_sorted=False)
    return sort_tensor(out) if sort_output else out


def gen_route_tables() -> np.ndarray:
    """Static routing of a parent-major child map: the neighbour of child
    slot o at k3 offset d lives in parent-offset pk(o, d) (a
    `kernel_offsets(3)` index) at child slot cb(o, d). Returns route [8*27]
    with route[o*27 + d] = pk*8 + cb."""
    o_bits = np.array(list(itertools.product((0, 1), repeat=3)), np.int32)
    deltas = np.array(list(itertools.product((-1, 0, 1), repeat=3)), np.int32)
    v = o_bits[:, None, :] + deltas[None, :, :]  # [8, 27, 3] in {-1..2}
    p_off = np.floor_divide(v, 2)  # {-1, 0, 1}
    bit = v - 2 * p_off  # {0, 1}
    pk = (p_off[..., 0] + 1) * 9 + (p_off[..., 1] + 1) * 3 + (p_off[..., 2] + 1)
    cb = bit[..., 0] * 4 + bit[..., 1] * 2 + bit[..., 2]
    return (pk * 8 + cb).reshape(-1)


def gen_child_idx(parent_idx: torch.Tensor) -> torch.Tensor:
    """Expand a parent k3 self map [B, P, 27] (P = miss) to the k3 map of
    its parent-major child map [B, 8P, 27] (8P = miss)."""
    b, p, _ = parent_idx.shape
    route = const_table(gen_route_tables, device=parent_idx.device)
    j = parent_idx[:, :, route // 8].reshape(b, p, 8, 27)
    cb = (route % 8).reshape(8, 27).int()
    child = torch.where(j >= p, 8 * p, j * 8 + cb)
    return child.reshape(b, 8 * p, 27).int().contiguous()


def gen_conv_plan(parent: SparseTensor, child: SparseTensor):
    """The k3 s1 `conv_plan` of a parent-major generated child map, from a
    27-offset search over the P parents alone (not the 8P children)."""
    if child.is_sorted or child.capacity != 8 * parent.capacity:
        raise ValueError("gen_conv_plan needs the parent-major child map "
                         "of `parent`")
    parent_idx = build_kernel_map(parent.keys, parent.coords,
                                  offsets_table(3, parent.stride,
                                                parent.coords.device))
    return child.coords, child.keys, gen_child_idx(parent_idx), child.dropped


def gen_gather_gemm(child_feats: torch.Tensor, parent_idx: torch.Tensor,
                    weight: torch.Tensor) -> torch.Tensor:
    """Sparse conv3 on a parent-major generated child map: `gather_gemm`
    (K2) on the child map `gen_child_idx(parent_idx)`.

    The child map of a parent self map is a symmetric self map, so the
    backward is the self-symmetric one: dFeats K2 on the flipped map with
    the transposed weights, dW K4. Rows of invalid parents may still hit
    real children; the caller masks their outputs, which zeroes their
    cotangents.

    Args:
        child_feats: [B, 8P, C] parent-major child features.
        parent_idx: [B, P, 27] parent k3 self map (P = miss).
        weight: [27, C, E].
    """
    return gather_gemm(child_feats, gen_child_idx(parent_idx), weight,
                       self_symmetric=True)


def sparse_union_add(a: SparseTensor, b: SparseTensor,
                     budget: Optional[int] = None) -> SparseTensor:
    """a + b on the union of their coordinate maps (ME's sparse addition).

    The rows of both are concatenated and stably key-sorted; each key's
    first row sets its output row, in key order. A map's keys are unique,
    so a key has at most two rows, a's then b's, and its features are the
    one sum a + b, whatever device adds them. The default budget Na + Nb
    drops nothing; `dropped` counts the keys beyond a smaller one."""
    if a.stride != b.stride:
        raise ValueError(f"strides differ: {a.stride} and {b.stride}")
    if budget is None:
        budget = a.capacity + b.capacity
    _, feats, keys = sort_rows(
        torch.cat([a.coords, b.coords], dim=1),
        torch.cat([a.feats, b.feats.to(a.feats.dtype)], dim=1),
        torch.cat([a.keys, b.keys], dim=1))
    bsz = keys.shape[0]
    sent = torch.full((bsz, 1), SENTINEL, dtype=keys.dtype, device=keys.device)
    prev = torch.cat([sent, keys[:, :-1]], dim=1)
    first = (keys != prev) & (keys != SENTINEL)
    sel, total = compact_positions(first, budget)
    # the row after a key's first row, where it holds the same key
    nxt = torch.cat([keys[:, 1:], sent], dim=1)
    second = torch.cat([feats[:, 1:], torch.zeros_like(feats[:, :1])], dim=1)
    second = torch.where(((nxt == keys) & first)[..., None], second, 0.0)
    out_feats = take_rows(feats, sel) + take_rows(second, sel)
    out_keys = take_rows(keys, sel, fill=SENTINEL)
    return SparseTensor(
        coords=decode_coords(out_keys), feats=out_feats, keys=out_keys,
        shift=a.shift, stride=a.stride,
        dropped=torch.clamp(total - budget, min=0).int())


def sparse_add_into(a: SparseTensor, b: SparseTensor) -> SparseTensor:
    """a + b where b's coordinates are a subset of a's (sparse addition on
    a's map). b's keys are unique, so each row of a receives at most one
    row of b; rows of b that a lacks land in the dump row, cut off."""
    if a.stride != b.stride:
        raise ValueError(f"strides differ: {a.stride} and {b.stride}")
    idx = lookup(a.keys, b.keys)  # [B, Nb] in [0, Na]
    bsz, na, c = a.feats.shape
    pad = torch.zeros((bsz, na + 1, c), dtype=a.feats.dtype,
                      device=a.feats.device)
    pad = pad.scatter_add(1, idx.long()[..., None].expand(-1, -1, c),
                          b.feats.to(a.feats.dtype))
    return a.with_feats(a.feats + pad[:, :na])


def sparse_prune(st: SparseTensor, scores: torch.Tensor,
                 budget: int) -> SparseTensor:
    """Keep the top-`budget` valid rows by score (ME pruning after the
    reference neck's top-k) and compact them in key order. Ties rank in
    row order (a stable sort); invalid rows score -inf. With `budget` >=
    the valid rows this only compacts."""
    b, n = st.keys.shape
    s = torch.where(st.valid, scores.reshape(b, n).float(), -float("inf"))
    order = torch.argsort(-s, dim=1, stable=True)
    rank = torch.empty_like(order).scatter_(
        1, order, torch.arange(n, device=order.device).expand(b, n))
    keep = (rank < min(budget, n)) & st.valid
    sel, _ = compact_positions(keep, budget)
    out_keys = take_rows(torch.where(keep, st.keys, SENTINEL), sel,
                         fill=SENTINEL)
    return SparseTensor(coords=decode_coords(out_keys),
                        feats=take_rows(st.feats, sel), keys=out_keys,
                        shift=st.shift, stride=st.stride)


def interpolate_at(st: SparseTensor, positions: torch.Tensor) -> torch.Tensor:
    """Trilinear interpolation of sparse features at raw-lattice positions
    [B, Q, 3] float (ME's `features_at_coordinates`): the features live on
    the stride-`st.stride` lattice, absent corners add zero (no weight
    renormalisation). The 8 corners of every position are one segmented
    search [B, Q, 8] (K1). Returns [B, Q, C]."""
    s = st.stride
    pos = positions / torch.full((1,), float(s), dtype=positions.dtype,
                                 device=positions.device)
    base = torch.floor(pos)
    frac = pos - base
    corners = offsets_table(2, 1, positions.device)  # [8, 3], z fastest
    cc = base.int()[:, :, None, :] * s + corners * s  # [B, Q, 8, 3]
    idx = lookup(st.keys, encode_coords(cc), segments=True)  # [B, Q, 8]
    f3 = frac[:, :, None, :]
    w = torch.where(corners.bool(), f3, 1.0 - f3)
    w = w[..., 0] * w[..., 1] * w[..., 2]  # [B, Q, 8]
    b, q, _ = idx.shape
    fpad = torch.cat([st.feats, torch.zeros_like(st.feats[:, :1])], dim=1)
    f = torch.take_along_dim(fpad, idx.reshape(b, q * 8, 1).long(), dim=1)
    f = f.reshape(b, q, 8, -1)
    out = f[:, :, 0] * w[..., 0, None]
    for j in range(1, 8):
        out = out + f[:, :, j] * w[..., j, None]
    return out
