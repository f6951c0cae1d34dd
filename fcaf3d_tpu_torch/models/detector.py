"""FCAF3D detector: voxelize -> sparse ResNet -> neck/head (port of
`fcaf3d_tpu/models/detector.py`). `model.train()` runs the training forward
(batch-statistics BN), `model.eval()` the folded inference one."""
from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from ..configs.fcaf3d import FCAF3DConfig
from ..ops.sparse.tensor import voxelize
from ..utils import tracing
from .fcaf3d_head import Fcaf3DNeckWithHead, FcafLossConfig, FcafTestConfig
from .me_resnet import MEResNet3D, out_channels


class FCAF3D(nn.Module):
    """`forward(points [B, P, 3] metric, colors [B, P, C] 0-255, valid
    [B, P] bool)` returns (per-level `HeadLevelOutput`s, overflow): overflow
    maps "input", "backbone_s{stride}" and "neck_lateral_missed_{i}" to
    [B] int32 counts of voxels the static budgets dropped (any nonzero count
    means a budget is too small for the scene)."""

    def __init__(self, cfg: FCAF3DConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.backbone = MEResNet3D(cfg.in_channels, cfg.depth, cfg.n_outs,
                                   cfg.backbone_budgets, device=device)
        self.neck_with_head = Fcaf3DNeckWithHead(
            in_channels=out_channels(cfg.depth, cfg.n_outs),
            n_classes=cfg.n_classes,
            out_channels=cfg.head_out_channels, n_reg_outs=cfg.n_reg_outs,
            voxel_size=cfg.voxel_size,
            neck_budgets=cfg.neck_budgets[:cfg.n_outs],
            neck_mode=cfg.neck_mode, device=device)

    def forward(self, points: torch.Tensor, colors: torch.Tensor,
                valid: torch.Tensor):
        c = self.cfg
        # divide by a device tensor: see `voxelize` on scalar divisors
        scale = torch.full((1,), 255.0, dtype=colors.dtype,
                           device=colors.device)
        with tracing.span("voxelize"):
            st = voxelize(points, colors / scale, valid,
                          voxel_size=c.voxel_size, budget=c.input_budget)
            st = st.with_feats(st.feats.to(getattr(torch, c.compute_dtype)))
            _count_rows(st)
        with tracing.span("backbone"):
            feats = self.backbone(st)
            _count_rows(*feats)
        overflow: Dict[str, torch.Tensor] = {"input": st.dropped}
        for f in feats:
            overflow[f"backbone_s{f.stride}"] = f.dropped
        with tracing.span("neck_head"):
            outs, neck_overflow = self.neck_with_head(feats)
        overflow.update(neck_overflow)
        return outs, overflow


def _count_rows(*levels) -> None:
    """While tracing, the open span's counters `budget_rows` (each level's
    rows over the batch: what the sparse convolutions compute on) and
    `valid_rows` (those that hold a voxel), one entry a level."""
    if tracing.enabled():
        tracing.count("budget_rows", [lv.keys.numel() for lv in levels])
        tracing.count("valid_rows",
                      torch.stack([lv.valid.sum() for lv in levels]))


def loss_config(cfg: FCAF3DConfig) -> FcafLossConfig:
    return FcafLossConfig(
        n_scales=cfg.n_outs, assign_limit=cfg.assign_limit,
        assign_topk=cfg.assign_topk, with_yaw=cfg.with_yaw,
        yaw_parametrization=cfg.yaw_parametrization)


def infer_config(cfg: FCAF3DConfig) -> FcafTestConfig:
    return FcafTestConfig(
        nms_pre=cfg.nms_pre, iou_thr=cfg.iou_thr, score_thr=cfg.score_thr,
        nms_cap=cfg.nms_cap, with_yaw=cfg.with_yaw,
        yaw_parametrization=cfg.yaw_parametrization)
