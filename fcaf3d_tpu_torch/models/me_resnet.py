"""Sparse 3D ResNet backbone (port of `fcaf3d_tpu/models/me_resnet.py`).

Stem = conv3 s2 -> InstanceNorm -> ReLU -> maxpool2x2 s2, then up to four
stages of BasicBlocks (depth 14/18/34) or Bottlenecks (depth 50/101,
outputs 4x as wide), each opening with stride 2. Output strides 8, 16, 32,
64.
"""
from __future__ import annotations

from typing import Sequence, Tuple

from torch import nn

from ..ops.sparse.conv import (
    build_kernel_map,
    build_kernel_map_self,
    conv_plan,
    kernel_offsets,
)
from ..ops.sparse.tensor import SparseTensor
from .blocks import (
    SparseBasicBlock,
    SparseBottleneck,
    SparseConv,
    SparseInstanceNorm,
    sparse_pool2x2,
)

# depth -> (blocks per stage, bottleneck?) (reference `me_resnet.py:104-121`)
DEPTH_LAYERS = {
    14: ((1, 1, 1, 1), False),
    18: ((2, 2, 2, 2), False),
    34: ((3, 4, 6, 3), False),
    50: ((4, 3, 6, 3), True),
    101: ((3, 4, 23, 3), True),
}
PLANES = (64, 128, 256, 512)
INIT_DIM = 64


def out_channels(depth: int, n_outs: int) -> Tuple[int, ...]:
    """The widths of the backbone's `n_outs` outputs at `depth`: PLANES,
    times the Bottleneck's expansion at depth 50/101."""
    _, bottleneck = DEPTH_LAYERS[depth]
    expansion = SparseBottleneck.expansion if bottleneck else 1
    return tuple(p * expansion for p in PLANES[:n_outs])


class MEResNet3D(nn.Module):
    """HDResNet backbone over the sparse engine.

    Args:
        in_channels: input feature width (3: RGB).
        depth: 14/18/34 (BasicBlock) or 50/101 (Bottleneck).
        n_outs: number of output scales (1-4).
        budgets: row capacity per downsample level, by stride
            (2, 4, 8, 16, 32, 64).
    """

    def __init__(self, in_channels: int = 3, depth: int = 34, n_outs: int = 4,
                 budgets: Sequence[int] = (65536, 32768, 24576, 8192, 3072,
                                           1024), device=None):
        super().__init__()
        if depth not in DEPTH_LAYERS:
            raise ValueError(f"depth must be one of {sorted(DEPTH_LAYERS)}, "
                             f"got {depth}")
        self.n_outs = n_outs
        self.layers, bottleneck = DEPTH_LAYERS[depth]
        block = SparseBottleneck if bottleneck else SparseBasicBlock
        widths = out_channels(depth, 4)
        self.budgets = tuple(budgets)
        self.conv1 = SparseConv(in_channels, INIT_DIM, 3, stride=2,
                                out_budget=self.budgets[0], device=device)
        self.norm1 = SparseInstanceNorm(INIT_DIM, device=device)
        inplanes = INIT_DIM
        for i in range(n_outs):
            for j in range(self.layers[i]):
                stride = 2 if j == 0 else 1
                budget = self.budgets[2 + i] if j == 0 else None
                self.add_module(f"layer{i + 1}_{j}", block(
                    inplanes, PLANES[i], stride=stride, out_budget=budget,
                    device=device))
                inplanes = widths[i]

    def forward(self, st: SparseTensor) -> Tuple[SparseTensor, ...]:
        x = self.norm1(self.conv1(st), act="relu")
        x = sparse_pool2x2(x, out_budget=self.budgets[1])
        outs = []
        for i in range(self.n_outs):
            # one kernel map per coordinate map, shared by the stage's convs
            plan_s2 = conv_plan(x, 3, 2, self.budgets[2 + i])
            out_coords, out_keys, _, drop = plan_s2
            plan_ds = (out_coords, out_keys, build_kernel_map(
                x.keys, out_coords, kernel_offsets(1, x.stride)), drop)
            plan_s1 = (out_coords, out_keys, build_kernel_map_self(
                out_keys, out_coords, x.stride * 2), drop)
            x = getattr(self, f"layer{i + 1}_0")(x, (plan_s2, plan_s1, plan_ds))
            for j in range(1, self.layers[i]):
                x = getattr(self, f"layer{i + 1}_{j}")(
                    x, (plan_s1, plan_s1, None))
            outs.append(x)
        return tuple(outs)
