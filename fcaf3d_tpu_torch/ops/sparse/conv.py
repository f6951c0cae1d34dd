"""Sparse convolution on sorted coordinate maps, forward only (port of the
inference path of `fcaf3d_tpu/ops/sparse/conv.py`).

Each convolution derives its output coordinate map, looks every
`out_coord + offset` up in the sorted input keys to build a [B, M, K]
neighbour table (miss -> N, the zero dump row), and runs one gather-GEMM
(kernel K2) over it.

Kernel offset order: `itertools.product` over (x, y, z), x slowest; odd
kernels span {-S..S}, even kernels {0..(k-1)S}.
"""
from __future__ import annotations

import itertools
from typing import Optional

import numpy as np
import torch

from .gather_kernel import apply_epilogue, fused_gather_gemm, fused_gather_max
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


def gather_gemm(feats: torch.Tensor, idx: torch.Tensor,
                weight: torch.Tensor) -> torch.Tensor:
    """out[b, m] = sum_k feats[b, idx[b, m, k]] @ weight[k] (miss rows -> 0)."""
    return fused_gather_gemm(feats.contiguous(), idx.contiguous(), weight)


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
            out = gather_gemm(st.feats, idx, weight)
    if epilogue is None:
        if bias is not None:
            out = out + bias
        out = torch.where((out_keys != SENTINEL)[..., None], out, 0.0)
    return SparseTensor(
        coords=out_coords, feats=out, keys=out_keys, shift=st.shift,
        stride=st.stride * stride,
        is_sorted=st.is_sorted if stride == 1 else True, dropped=dropped)


def sparse_max_pool(st: SparseTensor, kernel_size: int, stride: int,
                    out_budget: Optional[int] = None) -> SparseTensor:
    """Max pooling over present neighbours (MinkowskiMaxPooling), kernel K3."""
    budget = out_budget if out_budget is not None else st.capacity
    out_coords, out_keys, dropped = downsample_coords(st, stride, budget)
    idx = build_kernel_map(st.keys, out_coords,
                           kernel_offsets(kernel_size, st.stride))
    out = fused_gather_max(st.feats.contiguous(), idx)
    out = torch.where((out_keys != SENTINEL)[..., None], out, 0.0)
    return SparseTensor(coords=out_coords, feats=out, keys=out_keys,
                        shift=st.shift, stride=st.stride * stride,
                        dropped=dropped)
