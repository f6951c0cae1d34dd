"""Sparse building blocks (port of `fcaf3d_tpu/models/blocks.py`).

Module and parameter names follow the JAX package's flax names, so a flax
variable tree `a/b/c` is the state_dict entry `a.b.c` (`params.py`).
Parameters stay f32; convs cast their kernel to the activations' dtype.

`module.train()` / `.eval()` take the place of the flax `train` argument:
training normalises with masked batch statistics and updates the running
ones; evaluation folds every BN, activation and residual add into the
producing conv's epilogue.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..ops.sparse.conv import (
    ConvEpilogue,
    gen_gather_gemm,
    generative_transpose_conv2x2,
    sparse_conv,
    sparse_max_pool,
)
from ..ops.sparse.neck_ops import gen_children
from ..ops.sparse.tensor import SparseTensor
from ..parallel.comm import global_sums
from ..precision import operand


def at_least_f32(x: torch.Tensor) -> torch.Tensor:
    """`x` in f32, or in its own dtype when that is wider (float64)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


class SparseConv(nn.Module):
    """MinkowskiConvolution equivalent; `kernel` is [K, Cin, Cout]."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 1, use_bias: bool = False,
                 out_budget: Optional[int] = None, device=None):
        super().__init__()
        self.kernel_size = kernel_size
        self.stride = stride
        self.out_budget = out_budget
        self.kernel = nn.Parameter(torch.zeros(
            kernel_size ** 3, in_channels, out_channels, device=device))
        self.bias = (nn.Parameter(torch.zeros(out_channels, device=device))
                     if use_bias else None)

    def forward(self, st: SparseTensor, plan=None,
                epilogue: Optional[ConvEpilogue] = None) -> SparseTensor:
        dtype = st.feats.dtype
        bias = None if self.bias is None else self.bias.to(dtype)
        return sparse_conv(st.with_feats(operand(st.feats)),
                           operand(self.kernel.to(dtype)), self.kernel_size,
                           stride=self.stride, bias=bias,
                           out_budget=self.out_budget, plan=plan,
                           epilogue=epilogue)


class SparseGenConv3(SparseConv):
    """A k3 s1 `SparseConv` (the same `kernel` [27, Cin, Cout]) that also
    runs on a parent-major generated child map: `forward(child,
    parent_kmap=...)` is `gen_gather_gemm` over the parent's k3 self map,
    with the rows of invalid parents zeroed after the product."""

    def __init__(self, in_channels: int, out_channels: int, device=None):
        super().__init__(in_channels, out_channels, 3, device=device)

    def forward(self, st: SparseTensor, plan=None,
                epilogue: Optional[ConvEpilogue] = None,
                parent_kmap: Optional[torch.Tensor] = None) -> SparseTensor:
        if parent_kmap is None:
            return super().forward(st, plan=plan, epilogue=epilogue)
        if plan is not None or epilogue is not None or st.is_sorted:
            raise ValueError("a conv on a generated child map takes the "
                             "parent map alone, no plan or epilogue")
        out = gen_gather_gemm(operand(st.feats), parent_kmap,
                              operand(self.kernel.to(st.feats.dtype)))
        return st.with_feats(torch.where(st.valid[..., None], out, 0.0))


class SparseGenerativeTranspose(nn.Module):
    """MinkowskiGenerativeConvolutionTranspose(kernel=2, stride=2), in the
    parent-major raw form of the prune-early neck: returns (coords, keys,
    feats) without building a SparseTensor."""

    def __init__(self, in_channels: int, out_channels: int, device=None):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(8, in_channels, out_channels,
                                               device=device))

    def forward(self, st: SparseTensor):
        return gen_children(st.with_feats(operand(st.feats)),
                            operand(self.kernel.to(st.feats.dtype)))

    def generate(self, st: SparseTensor) -> SparseTensor:
        """The parent-major child map as a SparseTensor (the reference
        neck's form)."""
        return generative_transpose_conv2x2(
            st.with_feats(operand(st.feats)),
            operand(self.kernel.to(st.feats.dtype)), sort_output=False)


class SparseBatchNorm(nn.Module):
    """Masked BatchNorm, eps 1e-5. Training normalises with the two-pass
    mean and biased variance of the valid rows of the whole batch and moves
    the running statistics by momentum 0.1 (`running = 0.9 * running +
    0.1 * batch`, biased variance: not `torch.nn.BatchNorm`'s rule);
    evaluation uses the running statistics. Under a data-parallel group
    (`parallel.data_parallel`) the whole batch is the global one: the
    count and sum, then the squared deviations, are summed over the ranks
    (two all-reduces, gradients flowing through both)."""

    momentum = 0.1

    def __init__(self, num_features: int, eps: float = 1e-5, device=None):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(num_features, device=device))
        self.bias = nn.Parameter(torch.zeros(num_features, device=device))
        self.register_buffer("mean", torch.zeros(num_features, device=device))
        self.register_buffer("var", torch.ones(num_features, device=device))

    def affine(self):
        """Folded f32 `(inv, shift)` with `bn(x) == x * inv + shift`, for
        the producing conv's epilogue."""
        inv = self.scale / torch.sqrt(self.var + self.eps)
        return inv, self.bias - self.mean * inv

    def forward(self, st: SparseTensor) -> SparseTensor:
        feats32 = at_least_f32(st.feats)
        if self.training:
            mask = st.valid[..., None].float()
            count, total = global_sums(mask.sum(),
                                       (feats32 * mask).sum(dim=(0, 1)))
            count = torch.clamp_min(count, 1.0)
            mean = total / count
            (sq,) = global_sums((((feats32 - mean) ** 2) * mask).sum(
                dim=(0, 1)))
            var = sq / count
            with torch.no_grad():
                m = self.momentum
                self.mean.copy_((1 - m) * self.mean + m * mean)
                self.var.copy_((1 - m) * self.var + m * var)
        else:
            mean, var = self.mean, self.var
        inv = self.scale / torch.sqrt(var + self.eps)
        out = (feats32 - mean) * inv + self.bias
        out = torch.where(st.valid[..., None], out, 0.0).to(st.feats.dtype)
        return st.with_feats(out)


class SparseInstanceNorm(nn.Module):
    """Per-sample masked InstanceNorm (stem of the backbone)."""

    def __init__(self, num_features: int, eps: float = 1e-5, device=None):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(num_features, device=device))
        self.bias = nn.Parameter(torch.zeros(num_features, device=device))

    def forward(self, st: SparseTensor) -> SparseTensor:
        feats32 = at_least_f32(st.feats)
        mask = st.valid[..., None].float()
        count = torch.clamp_min(mask.sum(dim=1, keepdim=True), 1.0)
        mean = (feats32 * mask).sum(dim=1, keepdim=True) / count
        var = (((feats32 - mean) ** 2) * mask).sum(dim=1, keepdim=True) / count
        out = (feats32 - mean) / torch.sqrt(var + self.eps) * self.scale \
            + self.bias
        out = torch.where(st.valid[..., None], out, 0.0).to(st.feats.dtype)
        return st.with_feats(out)


def sparse_relu(st: SparseTensor) -> SparseTensor:
    """max(x, 0) with the JAX package's gradient: 1/2 at exactly 0, where
    `relu` and `clamp_min` give 0 and 1."""
    return st.with_feats(torch.maximum(st.feats, st.feats.new_zeros(())))


def sparse_elu(st: SparseTensor) -> SparseTensor:
    """ELU with expm1 (the fused epilogue's ELU is exp(min(x, 0)) - 1)."""
    out = torch.where(st.feats > 0, st.feats, torch.expm1(st.feats))
    return st.with_feats(torch.where(st.valid[..., None], out, 0.0))


def sparse_pool2x2(st: SparseTensor,
                   out_budget: Optional[int] = None) -> SparseTensor:
    return sparse_max_pool(st, kernel_size=2, stride=2, out_budget=out_budget)


class SparseBasicBlock(nn.Module):
    """ME `BasicBlock`: conv3(stride)-BN-ReLU-conv3-BN (+skip), ReLU; the
    skip is conv1(stride)+BN when the stride or width changes. Evaluation
    runs every BN, activation and the residual add in the convs' fused
    epilogues; training runs them as separate ops."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 out_budget: Optional[int] = None, device=None):
        super().__init__()
        self.conv1 = SparseConv(inplanes, planes, 3, stride=stride,
                                out_budget=out_budget, device=device)
        self.norm1 = SparseBatchNorm(planes, device=device)
        self.conv2 = SparseConv(planes, planes, 3, device=device)
        self.norm2 = SparseBatchNorm(planes, device=device)
        self.has_ds = stride != 1 or inplanes != planes
        if self.has_ds:
            self.downsample_conv = SparseConv(inplanes, planes, 1,
                                              stride=stride,
                                              out_budget=out_budget,
                                              device=device)
            self.downsample_norm = SparseBatchNorm(planes, device=device)

    def forward(self, st: SparseTensor, plans=None) -> SparseTensor:
        """`plans` is an optional (conv1, conv2, downsample) triple of
        precomputed `conv_plan`s."""
        p1, p2, pds = plans if plans is not None else (None, None, None)
        if self.training:
            out = sparse_relu(self.norm1(self.conv1(st, plan=p1)))
            out = self.norm2(self.conv2(out, plan=p2))
            residual = st
            if self.has_ds:
                residual = self.downsample_norm(
                    self.downsample_conv(st, plan=pds))
            return sparse_relu(out.with_feats(out.feats + residual.feats))
        inv1, sh1 = self.norm1.affine()
        inv2, sh2 = self.norm2.affine()
        out = self.conv1(st, plan=p1, epilogue=ConvEpilogue(inv1, sh1, "relu"))
        residual = st
        if self.has_ds:
            invd, shd = self.downsample_norm.affine()
            residual = self.downsample_conv(
                st, plan=pds, epilogue=ConvEpilogue(invd, shd, None))
        return self.conv2(out, plan=p2, epilogue=ConvEpilogue(
            inv2, sh2, "relu", add=residual.feats))


class SparseBottleneck(nn.Module):
    """ME `Bottleneck` (expansion 4) of the depth-50/101 backbones:
    conv1x1-BN-ReLU, conv3(stride)-BN-ReLU, conv1x1(4 x planes)-BN (+skip),
    ReLU; the skip is conv1(stride)+BN when the stride or width changes.
    Evaluation folds every BN, activation and the residual add into the
    convs' epilogues; training runs them as separate ops."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 out_budget: Optional[int] = None, device=None):
        super().__init__()
        out_ch = planes * self.expansion
        self.conv1 = SparseConv(inplanes, planes, 1, device=device)
        self.norm1 = SparseBatchNorm(planes, device=device)
        self.conv2 = SparseConv(planes, planes, 3, stride=stride,
                                out_budget=out_budget, device=device)
        self.norm2 = SparseBatchNorm(planes, device=device)
        self.conv3 = SparseConv(planes, out_ch, 1, device=device)
        self.norm3 = SparseBatchNorm(out_ch, device=device)
        self.has_ds = stride != 1 or inplanes != out_ch
        if self.has_ds:
            self.downsample_conv = SparseConv(inplanes, out_ch, 1,
                                              stride=stride,
                                              out_budget=out_budget,
                                              device=device)
            self.downsample_norm = SparseBatchNorm(out_ch, device=device)

    def forward(self, st: SparseTensor, plans=None) -> SparseTensor:
        """`plans` is an optional (conv2, unused, downsample) triple of
        precomputed `conv_plan`s (a stage's triple); conv1 and conv3 are
        k1 on unchanged maps and need none."""
        p2, _, pds = plans if plans is not None else (None, None, None)
        if self.training:
            out = sparse_relu(self.norm1(self.conv1(st)))
            out = sparse_relu(self.norm2(self.conv2(out, plan=p2)))
            out = self.norm3(self.conv3(out))
            residual = st
            if self.has_ds:
                residual = self.downsample_norm(
                    self.downsample_conv(st, plan=pds))
            return sparse_relu(out.with_feats(out.feats + residual.feats))
        inv1, sh1 = self.norm1.affine()
        inv2, sh2 = self.norm2.affine()
        inv3, sh3 = self.norm3.affine()
        out = self.conv1(st, epilogue=ConvEpilogue(inv1, sh1, "relu"))
        out = self.conv2(out, plan=p2,
                         epilogue=ConvEpilogue(inv2, sh2, "relu"))
        residual = st
        if self.has_ds:
            invd, shd = self.downsample_norm.affine()
            residual = self.downsample_conv(
                st, plan=pds, epilogue=ConvEpilogue(invd, shd, None))
        return self.conv3(out, epilogue=ConvEpilogue(
            inv3, sh3, "relu", add=residual.feats))
