"""PointNet++ set abstraction, feature propagation and the SSG backbone
(port of `fcaf3d_tpu/models/pointnet2.py`), channel-last [B, N, C], f32.

Module and parameter names are the flax names, so a flax variable tree
`a/b/c` is the state_dict entry `a.b.c` (`params.py`): `Dense_0.kernel` is
[in, out] and is applied as `x @ kernel + bias`; `BatchNorm_0` holds
`scale`, `bias` and the running `mean`, `var`. In training mode the
BatchNorm normalises with the batch statistics and updates the running
ones; in evaluation mode it uses the running statistics.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ..ops.pointnet import (
    ball_query,
    furthest_point_sample,
    gather_points,
    group_points,
    three_interpolate,
    three_nn,
)


class Dense(nn.Module):
    """flax `nn.Dense`: `x @ kernel + bias`, kernel [in, out]."""

    def __init__(self, in_features: int, out_features: int, device=None):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(in_features, out_features,
                                               device=device))
        self.bias = nn.Parameter(torch.zeros(out_features, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.kernel + self.bias


class BatchNorm(nn.Module):
    """flax `nn.BatchNorm(momentum=0.9, epsilon=1e-5)`, normalising in
    flax's order: `(x - mean) * (rsqrt(var + eps) * scale) + bias`.

    In training mode the statistics are flax's: in at least f32 (float64
    input keeps float64) over every axis but the last (padding rows count
    whole), the variance in the fast form
    `max(0, mean(x^2) - mean(x)^2)`; gradients flow through both, and the
    running statistics become `0.9 * running + 0.1 * batch` (the biased
    variance) outside the graph."""

    eps = 1e-5
    momentum = 0.9

    def __init__(self, num_features: int, device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(num_features, device=device))
        self.bias = nn.Parameter(torch.zeros(num_features, device=device))
        self.register_buffer("mean", torch.zeros(num_features, device=device))
        self.register_buffer("var", torch.ones(num_features, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            axes = tuple(range(x.dim() - 1))
            x32 = x.to(torch.promote_types(x.dtype, torch.float32))
            mean = x32.mean(axes)
            var = torch.maximum((x32 * x32).mean(axes) - mean * mean,
                                x32.new_zeros(()))
            with torch.no_grad():
                m = self.momentum
                self.mean.copy_(m * self.mean + (1 - m) * mean)
                self.var.copy_(m * self.var + (1 - m) * var)
        else:
            mean, var = self.mean, self.var
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.scale) \
            + self.bias


class DenseBNReLU(nn.Module):
    """1x1 conv (dense over the last dim) + BN + ReLU."""

    def __init__(self, in_features: int, features: int, device=None):
        super().__init__()
        self.Dense_0 = Dense(in_features, features, device=device)
        self.BatchNorm_0 = BatchNorm(features, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.BatchNorm_0(self.Dense_0(x)))


def _mlp(in_features: int, channels: Sequence[int], device) -> dict:
    """DenseBNReLU layers named mlp0, mlp1, ... (the flax names)."""
    layers = {}
    for i, ch in enumerate(channels):
        layers[f"mlp{i}"] = DenseBNReLU(in_features, ch, device=device)
        in_features = ch
    return layers


class PointSAModule(nn.Module):
    """Single-scale-grouping set abstraction: FPS -> ball query -> shared
    MLP -> max pool. The relative xyz of each group, divided by the radius,
    comes before its features (the JAX module's `use_xyz` and
    `normalize_xyz`, which every caller leaves on)."""

    def __init__(self, num_point: int, radius: float, num_sample: int,
                 mlp_channels: Sequence[int], in_features: int, device=None):
        super().__init__()
        self.num_point = num_point
        self.radius = radius
        self.num_sample = num_sample
        for name, layer in _mlp(in_features + 3, mlp_channels,
                                device).items():
            self.add_module(name, layer)
        self.n_mlp = len(mlp_channels)

    def forward(self, xyz: torch.Tensor, features: Optional[torch.Tensor],
                valid: Optional[torch.Tensor] = None,
                indices: Optional[torch.Tensor] = None,
                target_xyz: Optional[torch.Tensor] = None):
        """xyz [B, N, 3], features [B, N, C] or None, valid [B, N]; either
        pre-sampled `indices` [B, M] or `target_xyz` [B, M, 3] replace the
        FPS. Returns (new_xyz [B, M, 3], new_features [B, M, C'], indices
        [B, M] int32; zeros with `target_xyz`)."""
        if target_xyz is not None:
            new_xyz = target_xyz
            indices = torch.zeros(target_xyz.shape[:2], dtype=torch.int32,
                                  device=target_xyz.device)
        else:
            if indices is None:
                indices = furthest_point_sample(xyz, self.num_point, valid)
            new_xyz = gather_points(xyz, indices)

        idx = ball_query(new_xyz, xyz, self.radius, self.num_sample, valid)
        # divide by a device tensor: a Python scalar divisor becomes a
        # reciprocal multiply on CUDA
        x = (group_points(xyz, idx) - new_xyz[:, :, None, :]) / torch.full(
            (1,), self.radius, dtype=xyz.dtype, device=xyz.device)
        if features is not None:
            x = torch.cat([x, group_points(features, idx)], dim=-1)
        for i in range(self.n_mlp):
            x = getattr(self, f"mlp{i}")(x)
        return new_xyz, x.amax(dim=2), indices


class PointFPModule(nn.Module):
    """Feature propagation: 3-NN inverse-distance interpolation + MLP."""

    def __init__(self, mlp_channels: Sequence[int], in_features: int,
                 device=None):
        super().__init__()
        for name, layer in _mlp(in_features, mlp_channels, device).items():
            self.add_module(name, layer)
        self.n_mlp = len(mlp_channels)

    def forward(self, target_xyz: torch.Tensor, source_xyz: torch.Tensor,
                target_feats: Optional[torch.Tensor],
                source_feats: torch.Tensor) -> torch.Tensor:
        dist, idx = three_nn(target_xyz, source_xyz)
        x = three_interpolate(source_feats, idx, dist)
        if target_feats is not None:
            x = torch.cat([x, target_feats], dim=-1)
        for i in range(self.n_mlp):
            x = getattr(self, f"mlp{i}")(x)
        return x


class PointNet2SASSG(nn.Module):
    """PointNet++ SSG backbone with the JAX module's default radii, samples
    and widths. Input points [B, N, 3 + in_feat_dims]; returns the dict of
    the JAX module: fp_xyz / fp_features / fp_indices (deepest first) and
    sa_xyz / sa_features / sa_indices."""

    radius = (0.2, 0.4, 0.8, 1.2)
    num_samples = (64, 32, 16, 16)
    sa_channels = ((64, 64, 128), (128, 128, 256), (128, 128, 256),
                   (128, 128, 256))
    fp_channels = ((256, 256), (256, 256))

    def __init__(self, in_feat_dims: int,
                 num_points: Sequence[int] = (2048, 1024, 512, 256),
                 device=None):
        super().__init__()
        self.n_sa, self.n_fp = len(self.sa_channels), len(self.fp_channels)
        widths = [in_feat_dims]
        for i, ch in enumerate(self.sa_channels):
            self.add_module(f"sa{i}", PointSAModule(
                num_points[i], self.radius[i], self.num_samples[i], ch,
                widths[-1], device=device))
            widths.append(ch[-1])
        fp_width = widths[-1]
        for i, ch in enumerate(self.fp_channels):
            self.add_module(f"fp{i}", PointFPModule(
                ch, fp_width + widths[self.n_sa - i - 1], device=device))
            fp_width = ch[-1]

    def forward(self, points: torch.Tensor,
                valid: Optional[torch.Tensor] = None) -> dict:
        xyz = points[..., :3].contiguous()
        features = points[..., 3:] if points.shape[-1] > 3 else None
        b, n = xyz.shape[:2]
        indices = torch.arange(n, dtype=torch.int32,
                               device=xyz.device)[None].expand(b, n)
        sa_xyz, sa_features, sa_indices = [xyz], [features], [indices]
        sa_valid = valid
        for i in range(self.n_sa):
            cur_xyz, cur_features, cur_indices = getattr(self, f"sa{i}")(
                sa_xyz[i], sa_features[i], valid=sa_valid)
            sa_xyz.append(cur_xyz)
            sa_features.append(cur_features)
            sa_indices.append(torch.gather(sa_indices[-1], 1,
                                           cur_indices.long()))
            sa_valid = None  # sampled levels are fully valid

        fp_xyz, fp_features = [sa_xyz[-1]], [sa_features[-1]]
        fp_indices = [sa_indices[-1]]
        for i in range(self.n_fp):
            fp_features.append(getattr(self, f"fp{i}")(
                sa_xyz[self.n_sa - i - 1], sa_xyz[self.n_sa - i],
                sa_features[self.n_sa - i - 1], fp_features[-1]))
            fp_xyz.append(sa_xyz[self.n_sa - i - 1])
            fp_indices.append(sa_indices[self.n_sa - i - 1])
        return dict(fp_xyz=fp_xyz, fp_features=fp_features,
                    fp_indices=fp_indices, sa_xyz=sa_xyz,
                    sa_features=sa_features, sa_indices=sa_indices)
