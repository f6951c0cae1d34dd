"""VoteNet configs: a copy of `fcaf3d_tpu/configs/votenet.py` (the
reference's `configs/votenet/votenet-v2_16x8_sunrgbd-3d-10class.py` with
`_base_/schedules/schedule_3x.py` and `_base_/datasets/sunrgbd-3d-10class.py`,
and the bin-based v1 recipes for SUN RGB-D and ScanNet), held equal to it
by a test.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class VoteNetConfig:
    # "v2" = Mobius direct regression (votenet-v2 configs); "v1" = upstream
    # bin-based VoteHead + PartialBinBasedBBoxCoder
    head_version: str = "v2"
    n_classes: int = 10
    n_reg_outs: int = 7
    yaw_parametrization: str = "fcaf3d"
    with_yaw: bool = True
    num_proposal: int = 256
    gt_per_seed: int = 3
    backbone_num_points: Tuple[int, ...] = (2048, 1024, 512, 256)
    # data: xyz + height feature (shift_height=True, use_dim [0,1,2])
    num_points: int = 20000
    in_feat_dims: int = 1
    max_gt_boxes: int = 64
    # train cfg
    pos_distance_thr: float = 0.3
    neg_distance_thr: float = 0.6
    sample_mod: str = "vote"
    # test cfg
    sample_mod_test: str = "seed"
    nms_thr: float = 0.25
    score_thr: float = 0.05
    per_class_proposal: bool = True
    # schedule (schedule_3x)
    lr: float = 0.008
    weight_decay: float = 0.01
    grad_clip: float = 10.0
    max_epochs: int = 36
    lr_steps: Tuple[int, ...] = (24, 32)
    batch_size: int = 16


def votenet_sunrgbd() -> VoteNetConfig:
    return VoteNetConfig()


def votenet_v1_sunrgbd() -> VoteNetConfig:
    """Upstream bin-based VoteNet recipe
    (`configs/votenet/votenet_16x8_sunrgbd-3d-10class.py`): same data and
    schedule as v2; the head and coder come from `models.votenet_v1`
    (`sunrgbd_coder()`: 12 direction bins, 10 size classes)."""
    return VoteNetConfig(head_version="v1")


def votenet_v1_scannet() -> VoteNetConfig:
    """`configs/votenet/votenet_8x8_scannet-3d-18class.py`: 18 classes,
    axis-aligned (`scannet_coder()`), 40k points with colour-free
    xyz + height."""
    return VoteNetConfig(
        head_version="v1",
        n_classes=18,
        with_yaw=False,
        num_points=40000,
        batch_size=8,
    )


def votenet_tiny() -> VoteNetConfig:
    return VoteNetConfig(
        n_classes=4,
        num_points=512,
        max_gt_boxes=8,
        num_proposal=32,
        backbone_num_points=(128, 64, 32, 16),
        batch_size=2,
    )
