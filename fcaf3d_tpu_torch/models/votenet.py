"""VoteNet-v2 ("Mobius" VoteNet): vote module, detector, box decode,
training targets and loss, and aligned-3D-NMS post-processing (port of
`fcaf3d_tpu/models/votenet.py`), f32, batched [B, ...].

Parameter names are the flax names (see `pointnet2.py`). The targets, the
vote, objectness, centre and semantic losses are shared with the bin-based
VoteNet-v1 (`votenet_v1.py`).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from ..configs.votenet import VoteNetConfig
from ..core.geometry import box7_corners, gravity_center, points_in_boxes
from ..core.nms import aligned_3d_nms
from ..ops.pointnet import furthest_point_sample
from ..parallel.comm import global_sums
from ..utils import tracing
from .losses import iou3d_loss_sum
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
    returns the JAX module's dict. `sample_mod` "vote" (the module default,
    which training uses) samples the proposals by FPS over the votes,
    "seed" by FPS over the seeds."""

    head_version = "v2"
    sample_mod = "vote"
    agg_radius = 0.3
    agg_num_sample = 16

    def __init__(self, cfg: VoteNetConfig, device=None):
        super().__init__()
        if cfg.head_version != self.head_version:
            raise ValueError(
                f"{type(self).__name__} builds the {self.head_version} head, "
                f"the config asks for {cfg.head_version!r}: build a v1 config "
                "with `models.votenet_v1.VoteNetV1(cfg, coder)`")
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
        self.conv_reg = Dense(128, self.n_reg_outs(), device=device)

    def n_reg_outs(self) -> int:
        return self.cfg.n_reg_outs

    def head(self, agg_xyz: torch.Tensor, cls_out: torch.Tensor,
             reg_out: torch.Tensor) -> dict:
        """The head's outputs from the aggregated centres and the raw class
        and regression outputs."""
        return dict(obj_scores=cls_out[..., :2], sem_scores=cls_out[..., 2:],
                    bbox_preds=decode_vote_bbox(agg_xyz, reg_out,
                                                self.cfg.yaw_parametrization))

    def forward(self, points: torch.Tensor, valid=None, sample_mod=None):
        sample_mod = sample_mod or self.sample_mod
        with tracing.span("backbone"):
            feat = self.backbone(points, valid=valid)
        with tracing.span("vote_head"):
            return self._vote_head(feat, sample_mod)

    def _vote_head(self, feat, sample_mod):
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
        preds = self.head(agg_xyz, self.conv_cls(x), self.conv_reg(x))
        preds.update(seed_points=seed_xyz,
                     seed_indices=feat["fp_indices"][-1],
                     vote_points=vote_xyz,
                     vote_offset=vote_offset,
                     aggregated_points=agg_xyz)
        return preds


class VoteTargets(NamedTuple):
    vote_targets: torch.Tensor  # [B, N, 3 * gt_per_seed]
    vote_mask: torch.Tensor  # [B, N] bool
    objectness: torch.Tensor  # [B, P] f32 {0, 1}
    objectness_mask: torch.Tensor  # [B, P] f32 (positive or definite negative)
    assigned_boxes: torch.Tensor  # [B, P, 7] gravity-centred
    assigned_labels: torch.Tensor  # [B, P]


def _take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, G, C] at idx [B, ...] along G -> [B, ..., C]."""
    flat = idx.reshape(idx.shape[0], -1).long()
    out = torch.gather(x, 1, flat[..., None].expand(-1, -1, x.shape[-1]))
    return out.reshape(*idx.shape, x.shape[-1])


def votenet_targets(points: torch.Tensor, gt_boxes: torch.Tensor,
                    gt_labels: torch.Tensor, gt_valid: torch.Tensor,
                    aggregated_points: torch.Tensor, gt_per_seed: int = 3,
                    pos_thr: float = 0.3, neg_thr: float = 0.6
                    ) -> VoteTargets:
    """Vote and proposal targets, batched: points [B, N, 3], bottom-centred
    gt box7 [B, G, 7] with labels and valid mask [B, G], aggregated centres
    [B, P, 3] (no gradient flows into the targets).

    A point's j-th vote target (j < gt_per_seed) is the centre of the j-th
    valid box by box order that contains it, or of the first one when it is
    in fewer; a proposal is assigned the valid box of the nearest centre,
    positive within `pos_thr`, a definite negative beyond `neg_thr`."""
    agg = aggregated_points.detach()
    centers = gravity_center(gt_boxes)  # [B, G, 3]
    inside = points_in_boxes(points, gt_boxes) & gt_valid[:, None, :]
    vote_mask = inside.any(-1)  # [B, N]
    rank = torch.cumsum(inside.int(), dim=-1)

    def vote_to(sel):  # the first box of `sel` by box order
        return _take_rows(centers, torch.argmax(sel.byte(), dim=-1)) - points

    first_vote = vote_to(inside)
    votes = []
    for j in range(gt_per_seed):
        sel = inside & (rank == j + 1)
        votes.append(torch.where(sel.any(-1)[..., None], vote_to(sel),
                                 first_vote))
    vote_targets = torch.where(vote_mask[..., None], torch.cat(votes, -1),
                               torch.zeros((), device=points.device))

    diff = agg[:, :, None, :] - centers[:, None, :, :]  # [B, P, G, 3]
    d2 = (diff[..., 0] ** 2 + diff[..., 1] ** 2) + diff[..., 2] ** 2
    d2 = torch.where(gt_valid[:, None, :], d2,
                     torch.full((), 1e10, device=d2.device))
    assignment = torch.argmin(d2, dim=-1)  # [B, P]
    dist = torch.sqrt(d2.amin(-1) + 1e-6)
    pos = dist < pos_thr
    objectness = pos.float()
    obj_mask = (pos | (dist > neg_thr)).float()
    boxes = torch.cat([centers, gt_boxes[..., 3:7]], dim=-1)
    assigned_labels = torch.gather(gt_labels, 1, assignment)
    return VoteTargets(vote_targets, vote_mask, objectness, obj_mask,
                       _take_rows(boxes, assignment), assigned_labels)


def votenet_common_losses(preds: dict, points: torch.Tensor,
                          gt_boxes: torch.Tensor, gt_labels: torch.Tensor,
                          gt_valid: torch.Tensor, pred_center: torch.Tensor,
                          gt_per_seed: int = 3):
    """The losses VoteNet-v2 and v1 share (the reference configs' weights):
    the vote Chamfer-L1 to the nearest of a seed's gt votes (x10), the
    objectness CE with class weights [0.2, 0.8] (x5) and the two-sided
    centre Chamfer-L2 of `pred_center` [B, P, 3] (x10). Returns (targets,
    {vote_loss, objectness_loss, center_loss}, the positives' weights
    [B, P]). Mins are `amin`: a tie's gradient is split among the tied
    entries, as `jnp.min` splits it. Under a data-parallel group
    (`parallel.data_parallel`) the four normalising sums are the global
    batch's (one all-reduce), so every loss here and in the callers is this
    rank's share of the global one."""
    t = votenet_targets(points[..., :3], gt_boxes, gt_labels, gt_valid,
                        preds["aggregated_points"], gt_per_seed)

    seed_idx = preds["seed_indices"].long()  # [B, S]
    b, s = seed_idx.shape
    seed_mask = torch.gather(t.vote_mask, 1, seed_idx)
    gt_votes = _take_rows(t.vote_targets, seed_idx).reshape(
        b, s, gt_per_seed, 3) + preds["seed_points"][:, :, None, :]
    diff = (preds["vote_points"][:, :, None, :] - gt_votes).abs().sum(-1)
    w = seed_mask.float()
    obj_t = t.objectness
    w_sum, mask_sum, obj_sum, gt_sum = global_sums(
        w.sum(), t.objectness_mask.sum(), obj_t.sum(), gt_valid.sum())
    w = w / (w_sum + 1e-6)
    vote_loss = 10.0 * (diff.amin(-1) * w).sum()

    logp = torch.log_softmax(preds["obj_scores"], dim=-1)  # [B, P, 2]
    cls_w = 0.8 * obj_t + 0.2 * (1.0 - obj_t)
    ce = -(obj_t * logp[..., 1] + (1.0 - obj_t) * logp[..., 0]) * cls_w
    ow = t.objectness_mask / (mask_sum + 1e-6)
    objectness_loss = 5.0 * (ce * ow).sum()

    box_w = obj_t / (obj_sum + 1e-6)  # [B, P]
    gt_w = gt_valid.float() / (gt_sum + 1e-6)
    c = pred_center[:, :, None, :] - gravity_center(gt_boxes)[:, None]
    d2 = (c ** 2).sum(-1)  # [B, P, G]
    d2 = torch.where(gt_valid[:, None, :], d2,
                     torch.full((), 1e10, device=d2.device))
    dst_min = torch.where(gt_valid, d2.amin(1),
                          torch.zeros((), device=d2.device))
    center_loss = 10.0 * ((d2.amin(2) * box_w).sum() + (dst_min * gt_w).sum())
    return t, dict(vote_loss=vote_loss, objectness_loss=objectness_loss,
                   center_loss=center_loss), box_w


def semantic_loss(sem_scores: torch.Tensor, labels: torch.Tensor,
                  n_classes: int, box_w: torch.Tensor) -> torch.Tensor:
    """The positives' semantic CE (x1)."""
    sem_logp = torch.log_softmax(sem_scores, dim=-1)
    onehot = torch.nn.functional.one_hot(labels.long(), n_classes).float()
    return (-(onehot * sem_logp).sum(-1) * box_w).sum()


def votenet_loss(preds: dict, points: torch.Tensor, gt_boxes: torch.Tensor,
                 gt_labels: torch.Tensor, gt_valid: torch.Tensor,
                 n_classes: int, with_yaw: bool = True,
                 gt_per_seed: int = 3) -> dict:
    """VoteNet-v2 loss: `votenet_common_losses` on the boxes' centres, the
    semantic CE (x1) and the IoU3D loss (x3, rotated with `with_yaw`) of
    the positives against their assigned boxes."""
    t, losses, box_w = votenet_common_losses(
        preds, points, gt_boxes, gt_labels, gt_valid,
        preds["bbox_preds"][..., :3], gt_per_seed)
    losses["semantic_loss"] = semantic_loss(preds["sem_scores"],
                                            t.assigned_labels, n_classes,
                                            box_w)
    losses["iou_loss"] = 3.0 * iou3d_loss_sum(
        preds["bbox_preds"], t.assigned_boxes, box_w, with_yaw=with_yaw).sum()
    return losses


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
