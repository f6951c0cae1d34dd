"""Sparse convolution and max pooling on sorted coordinate maps (port of
the main path of `fcaf3d_tpu/ops/sparse/conv.py`).

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
from .tensor import (
    SENTINEL,
    SparseTensor,
    downsample_coords,
    encode_coords,
    lookup,
)


def kernel_offsets(kernel_size: int, stride_units: int) -> np.ndarray:
    """[K, 3] int32 offsets in raw lattice units for a cubic kernel."""
    if kernel_size % 2 == 1:
        r = range(-(kernel_size // 2), kernel_size // 2 + 1)
    else:
        r = range(0, kernel_size)
    offs = np.array(list(itertools.product(r, r, r)), dtype=np.int32)
    return offs * stride_units


def build_kernel_map(in_keys: torch.Tensor, out_coords: torch.Tensor,
                     offsets: np.ndarray) -> torch.Tensor:
    """Neighbour index table [B, M, K] int32; value N (= in capacity) means
    miss. One hit-verified search per (row, offset): the JAX package's
    z-difference counting streams are a TPU device and give the same table."""
    offs = torch.as_tensor(offsets, dtype=torch.int32, device=out_coords.device)
    q = encode_coords(out_coords[:, :, None, :] + offs)  # [B, M, K]
    return lookup(in_keys, q, segments=True)


def build_kernel_map_self(keys: torch.Tensor, coords: torch.Tensor,
                          stride: int) -> torch.Tensor:
    """k3 s1 submanifold kernel map on the map's own coordinates."""
    return build_kernel_map(keys, coords, kernel_offsets(3, stride))


def conv_plan(st: SparseTensor, kernel_size: int, stride: int = 1,
              out_budget: Optional[int] = None):
    """A convolution's (out_coords, out_keys, idx, dropped), shareable by
    every conv on the same coordinate map."""
    offs = kernel_offsets(kernel_size, st.stride)
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
                           kernel_offsets(kernel_size, st.stride))
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
