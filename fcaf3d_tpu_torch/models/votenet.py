"""VoteNet-v2 ("Mobius" VoteNet) inference: vote module, detector, box
decode and aligned-3D-NMS post-processing (port of the inference part of
`fcaf3d_tpu/models/votenet.py`), f32, batched [B, ...].

Parameter names are the flax names (see `pointnet2.py`). Training (targets,
loss, train step) is not ported yet.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from ..configs.votenet import VoteNetConfig
from ..core.geometry import box7_corners, points_in_boxes
from ..core.nms import aligned_3d_nms
from ..ops.pointnet import furthest_point_sample
from .pointnet2 import Dense, DenseBNReLU, PointNet2SASSG, PointSAModule


class VoteModule(nn.Module):
    """Per-seed vote offsets and residual features (one vote per seed),
    with the JAX module's defaults: two 256-wide convs, normalised vote
    features."""

    def __init__(self, in_features: int, device=None):
        super().__init__()
        self.vote_conv0 = DenseBNReLU(in_features, 256, device=device)
        self.vote_conv1 = DenseBNReLU(256, 256, device=device)
        self.conv_out = Dense(256, 3 + in_features, device=device)

    def forward(self, seed_xyz: torch.Tensor, seed_feats: torch.Tensor):
        """seed_xyz [B, N, 3], seed_feats [B, N, C] -> (vote_xyz [B, N, 3],
        vote_feats [B, N, C], offset [B, N, 3])."""
        votes = self.conv_out(self.vote_conv1(self.vote_conv0(seed_feats)))
        offset = votes[..., :3]
        vote_feats = seed_feats + votes[..., 3:]
        norm = torch.sqrt((vote_feats * vote_feats).sum(-1, keepdim=True)
                          + 1e-12)
        return (seed_xyz + offset, vote_feats / torch.clamp_min(norm, 1e-8),
                offset)


def _atan2_safe_x(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The x operand of an atan2 that the JAX package keeps finite in its
    gradient at (0, 0): 1 there, x elsewhere (atan2(0, 1) == atan2(0, 0),
    so the value is unchanged)."""
    return torch.where((y == 0) & (x == 0), torch.ones_like(x), x)


def decode_vote_bbox(aggregated_points: torch.Tensor, bbox_pred: torch.Tensor,
                     yaw_parametrization: str = "fcaf3d") -> torch.Tensor:
    """Decode the head's regressions to gravity-centred box7 [..., 7]."""
    center = aggregated_points + bbox_pred[..., :3]
    if yaw_parametrization == "naive":
        dims = torch.exp(bbox_pred[..., 3:6])
        yaw = bbox_pred[..., 6]
    elif yaw_parametrization == "sin-cos":
        s, c = bbox_pred[..., 6], bbox_pred[..., 7]
        norm = torch.sqrt(s * s + c * c + 1e-12)
        yaw = torch.atan2(s / norm, _atan2_safe_x(s, c) / norm)
        dims = torch.exp(bbox_pred[..., 3:6])
    elif yaw_parametrization == "fcaf3d":
        # (dx, dy, dz, ln scale, ln h, sin 2a ln q, cos 2a ln q)
        scale = torch.exp(bbox_pred[..., 3])
        s, c = bbox_pred[..., 5], bbox_pred[..., 6]
        q = torch.exp(torch.sqrt(s * s + c * c + 1e-12))
        yaw = 0.5 * torch.atan2(s, _atan2_safe_x(s, c))
        w = scale / (1 + q)
        dims = torch.stack([w, w * q, torch.exp(bbox_pred[..., 4])], dim=-1)
    else:
        raise ValueError(f"unknown yaw parametrization "
                         f"{yaw_parametrization!r}")
    return torch.cat([center, dims, yaw[..., None]], dim=-1)


class VoteNet(nn.Module):
    """VoteNet-v2: PointNet2SASSG -> VoteModule -> vote-aggregation SA ->
    shared (128, 128) convs -> objectness, class and box outputs.

    `forward(points [B, N, 3 + in_feat_dims], valid=None, sample_mod=None)`
    returns the JAX module's dict. `sample_mod` "vote" (the module default)
    samples the proposals by FPS over the votes, "seed" by FPS over the
    seeds."""

    sample_mod = "vote"
    agg_radius = 0.3
    agg_num_sample = 16

    def __init__(self, cfg: VoteNetConfig, device=None):
        super().__init__()
        if cfg.head_version != "v2":
            raise NotImplementedError(
                f"VoteNet head {cfg.head_version!r} is not ported: only v2")
        self.cfg = cfg
        self.backbone = PointNet2SASSG(
            cfg.in_feat_dims, num_points=cfg.backbone_num_points,
            device=device)
        self.vote_module = VoteModule(256, device=device)
        self.vote_aggregation = PointSAModule(
            cfg.num_proposal, self.agg_radius, self.agg_num_sample,
            (128, 128, 128), 256, device=device)
        self.shared_conv0 = DenseBNReLU(128, 128, device=device)
        self.shared_conv1 = DenseBNReLU(128, 128, device=device)
        self.conv_cls = Dense(128, cfg.n_classes + 2, device=device)
        self.conv_reg = Dense(128, cfg.n_reg_outs, device=device)

    def forward(self, points: torch.Tensor, valid=None, sample_mod=None):
        sample_mod = sample_mod or self.sample_mod
        feat = self.backbone(points, valid=valid)
        seed_xyz = feat["fp_xyz"][-1]
        vote_xyz, vote_feats, vote_offset = self.vote_module(
            seed_xyz, feat["fp_features"][-1])
        if sample_mod == "vote":
            agg_xyz, agg_feats, _ = self.vote_aggregation(vote_xyz, vote_feats)
        elif sample_mod == "seed":
            sample_indices = furthest_point_sample(seed_xyz,
                                                   self.cfg.num_proposal)
            agg_xyz, agg_feats, _ = self.vote_aggregation(
                vote_xyz, vote_feats, indices=sample_indices)
        else:
            raise ValueError(f"unknown sample_mod {sample_mod!r}")
        x = self.shared_conv1(self.shared_conv0(agg_feats))
        cls_out = self.conv_cls(x)
        return dict(
            seed_points=seed_xyz,
            seed_indices=feat["fp_indices"][-1],
            vote_points=vote_xyz,
            vote_offset=vote_offset,
            aggregated_points=agg_xyz,
            obj_scores=cls_out[..., :2],
            sem_scores=cls_out[..., 2:],
            bbox_preds=decode_vote_bbox(agg_xyz, self.conv_reg(x),
                                        self.cfg.yaw_parametrization),
        )


class VoteDetections(NamedTuple):
    boxes: torch.Tensor  # [B, D, 7] bottom-centred box7
    scores: torch.Tensor  # [B, D]
    labels: torch.Tensor  # [B, D] int32
    valid: torch.Tensor  # [B, D] bool


def votenet_get_bboxes(preds: dict, points: torch.Tensor, n_classes: int,
                       nms_thr: float = 0.25, score_thr: float = 0.05,
                       per_class_proposal: bool = True) -> VoteDetections:
    """Aligned-3D-NMS inference with static shapes: proposals holding more
    than 5 points, same-class NMS by the objectness, then objectness above
    `score_thr`; with `per_class_proposal`, every (class, proposal) pair
    scored obj x sem, D = n_classes x P."""
    obj = torch.softmax(preds["obj_scores"], dim=-1)[..., 1]  # [B, P]
    sem = torch.softmax(preds["sem_scores"], dim=-1)  # [B, P, C]
    boxes7 = preds["bbox_preds"]
    # gravity-centred -> bottom-centred for corners and point tests
    bc = torch.cat([boxes7[..., :2], boxes7[..., 2:3] - boxes7[..., 5:6] / 2,
                    boxes7[..., 3:]], dim=-1)
    corners = box7_corners(bc)  # [B, P, 8, 3]
    minmax = torch.cat([corners.amin(-2), corners.amax(-2)], dim=-1)
    n_inside = points_in_boxes(points[..., :3], bc).sum(-2)  # [B, P]
    classes = torch.argmax(sem, dim=-1)
    keep = aligned_3d_nms(minmax, obj, classes, nms_thr, valid=n_inside > 5)
    selected = keep & (obj > score_thr)
    if not per_class_proposal:
        return VoteDetections(bc, obj, classes.int(), selected)
    b, p = obj.shape
    scores = (obj[:, None, :] * sem.transpose(1, 2)).reshape(b, n_classes * p)
    labels = torch.arange(n_classes, dtype=torch.int32,
                          device=obj.device).repeat_interleave(p)
    return VoteDetections(
        bc.repeat(1, n_classes, 1), scores, labels[None].expand(b, -1),
        selected.repeat(1, n_classes) & (scores > score_thr))
