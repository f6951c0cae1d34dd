"""FCAF3D configs of the port: the same dataclass and values as
`fcaf3d_tpu/configs/fcaf3d.py` (a test holds them equal), kept here so the
port loads without the JAX package.

The north-star configs (ScanNet 18-class with its 3- and 2-scale variants,
SUN RGB-D 10-class with rotated boxes, S3DIS 5-class) and the two CPU-test
sizes. Each config's budgets hold its dataset's acquisition model
(`data.synth`: ScanNet's 50k-point scans, a z-buffered Kinect frame for SUN
RGB-D, a dense 1M-point room sampled to 100k for S3DIS).
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


def config_from_dict(d: dict) -> FCAF3DConfig:
    """Rebuild a config from a JSON round-trip (`dataclasses.asdict` ->
    json -> here): unknown keys are dropped and lists become the tuples the
    dataclass declares."""
    fields = {f.name for f in dataclasses.fields(FCAF3DConfig)}
    default = FCAF3DConfig()
    kw = {}
    for k, v in d.items():
        if k not in fields:
            continue
        if isinstance(getattr(default, k), tuple) and isinstance(v, list):
            v = tuple(v)
        kw[k] = v
    return FCAF3DConfig(**kw)


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


def fcaf3d_scannet_3scales() -> FCAF3DConfig:
    """HDResNet34:3, ScanNet's fast variant: 3 output scales, 1 cm
    voxels."""
    return dataclasses.replace(fcaf3d_scannet(), n_outs=3)


def fcaf3d_scannet_2scales() -> FCAF3DConfig:
    """HDResNet34:2: 2 output scales at 2 cm voxels, budgets from the 2 cm
    cascade of the 50k-point scans."""
    return dataclasses.replace(
        fcaf3d_scannet(),
        n_outs=2,
        voxel_size=0.02,
        input_budget=46592,
        backbone_budgets=(42496, 30720, 13312, 3584, 1024, 512),
        neck_budgets=(16384, 8192),
    )


def fcaf3d_sunrgbd() -> FCAF3DConfig:
    """SUN RGB-D 10-class, rotated boxes (8 regression outputs, Mobius yaw).
    One Kinect view back-projects every depth pixel, so the 100k sample
    stays ~98% unique at 1 cm."""
    return FCAF3DConfig(
        n_classes=10,
        n_reg_outs=8,
        with_yaw=True,
        input_budget=100352,
        backbone_budgets=(96768, 62976, 24064, 6656, 2048, 1024),
        neck_budgets=(28672, 9728, 4096, 1024),
    )


def fcaf3d_s3dis() -> FCAF3DConfig:
    """S3DIS 5-class, axis-aligned. Dense Matterport rooms (~1M raw points,
    100k sample) keep the deeper levels fuller than ScanNet's."""
    return FCAF3DConfig(
        n_classes=5,
        n_reg_outs=6,
        with_yaw=False,
        input_budget=100352,
        backbone_budgets=(98304, 85504, 46592, 13824, 3584, 1024),
        neck_budgets=(56320, 16896, 4608, 1024),
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
