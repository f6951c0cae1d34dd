"""FCAF3D configs of the port: the same dataclass and values as
`fcaf3d_tpu/configs/fcaf3d.py` (a test holds them equal), kept here so the
port loads without the JAX package.

Only the configs the port runs are here: ScanNet 18-class (the main path)
and the two CPU-test sizes.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class FCAF3DConfig:
    # model
    n_classes: int = 18
    in_channels: int = 3
    depth: int = 34
    n_outs: int = 4
    head_out_channels: int = 128
    n_reg_outs: int = 6
    voxel_size: float = 0.01
    yaw_parametrization: str = "fcaf3d"
    with_yaw: bool = False
    neck_mode: str = "prune_early"

    # activation dtype on the conv path (params stay f32)
    compute_dtype: str = "bfloat16"
    # static row budgets
    num_points: int = 100000  # input point sample (IndoorPointSample)
    input_budget: int = 98304  # stride-1 voxels after dedup
    backbone_budgets: Tuple[int, ...] = (65536, 32768, 24576, 8192, 3072, 1024)
    neck_budgets: Tuple[int, ...] = (32768, 16384, 4096, 1024)
    max_gt_boxes: int = 64
    # assigner
    assign_limit: int = 27
    assign_topk: int = 18
    # test cfg
    nms_pre: int = 1000
    iou_thr: float = 0.5
    score_thr: float = 0.01
    nms_cap: int = 256  # per-class candidate cap fed to the NMS matrix
    # train schedule
    lr: float = 0.001
    weight_decay: float = 0.0001
    grad_clip: float = 10.0
    max_epochs: int = 12
    lr_steps: Tuple[int, ...] = (8, 11)
    batch_size: int = 16


def fcaf3d_scannet() -> FCAF3DConfig:
    """ScanNet 18-class, axis-aligned, HDResNet34, 4 scales. Budgets hold
    the reference's ScanNet detection scans (50k raw points sampled to 100k
    with replacement)."""
    return FCAF3DConfig(
        n_classes=18,
        n_reg_outs=6,
        with_yaw=False,
        input_budget=45056,
        backbone_budgets=(43520, 39936, 30720, 13312, 3584, 1024),
        neck_budgets=(32768, 16384, 6144, 1024),
    )


def fcaf3d_nano(n_classes: int = 3) -> FCAF3DConfig:
    """Depth 14, 2 scales, f32, tiny budgets (CPU tests)."""
    return FCAF3DConfig(
        n_classes=n_classes,
        n_reg_outs=6,
        with_yaw=False,
        compute_dtype="float32",
        depth=14,
        n_outs=2,
        num_points=128,
        input_budget=128,
        backbone_budgets=(96, 64, 48, 24, 12, 8),
        neck_budgets=(48, 24),
        max_gt_boxes=4,
        nms_pre=16,
        nms_cap=16,
        batch_size=8,
    )


def fcaf3d_tiny(n_classes: int = 4, with_yaw: bool = False) -> FCAF3DConfig:
    """Depth 34, 4 scales, f32, miniature budgets (CPU tests)."""
    return FCAF3DConfig(
        n_classes=n_classes,
        n_reg_outs=8 if with_yaw else 6,
        with_yaw=with_yaw,
        compute_dtype="float32",
        num_points=512,
        input_budget=512,
        backbone_budgets=(256, 128, 96, 48, 24, 12),
        neck_budgets=(96, 48, 24, 12),
        max_gt_boxes=8,
        nms_pre=32,
        nms_cap=32,
        batch_size=2,
    )
