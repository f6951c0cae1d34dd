"""FCAF3D neck + anchor-free head, loss and inference (port of
`fcaf3d_tpu/models/fcaf3d_head.py`).

- Top-down neck, coarsest level first, in one of two orders
  (`neck_mode`, one parameter tree for both):
  "prune_early": generative transpose (k2 s2) of the coarser level,
  children pruned to the level's budget by the coarser level's
  interpolated max-class score before any conv, then BN -> ELU -> conv3
  (+BN, ELU folded) and a scatter-add of the backbone lateral.
  "reference" (the released checkpoints' order): the transpose, BN -> ELU
  -> conv3 over all 8P children (unfolded, also in evaluation) -> BN ->
  ELU, the union-add of the lateral, then the prune by the interpolated
  score.
- Per level: out conv3 (+BN, ELU folded), shared 1x1 head convs
  (centerness 1, reg n_reg_outs, cls n_classes), exp(scale * reg[:6]).
- `fcaf3d_loss`: focal cls over all valid locations, BCE centerness and
  centerness-weighted 3D IoU (rotated with `with_yaw`, else axis-aligned)
  over the assigned positives; normalisers are batch means (of the global
  batch under a data-parallel group).
- `fcaf3d_get_bboxes`: per-level top `nms_pre`, box decode (the yaw by
  the config's parametrization), per-class top `nms_cap`, BEV NMS (rotated
  with `with_yaw`).

In training (`module.train()`) the BNs normalise with batch statistics and
run as separate ops; in evaluation they fold into the convs' epilogues.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Sequence, Tuple

import torch
from torch import nn

from ..core.nms import nms_bev
from ..ops.sparse.conv import (
    ConvEpilogue,
    build_kernel_map_self,
    interpolate_at,
    sparse_prune,
    sparse_union_add,
)
from ..ops.sparse.neck_ops import (
    child_prune_scores,
    compact_select,
    lateral_child_rows,
    sort_tensor,
    threshold_select,
)
from ..ops.sparse.masked_norm import at_least_f32
from ..ops.sparse.tensor import SENTINEL, SparseTensor, lookup
from ..parallel.comm import global_batch
from ..utils import tracing
from .assigner import fcaf3d_assign
from .blocks import (
    SparseBatchNorm,
    SparseConv,
    SparseGenConv3,
    SparseGenerativeTranspose,
)
from .losses import bce_loss_sum, focal_loss_sum, iou3d_loss_sum
from .votenet import _atan2_safe_x


class HeadLevelOutput(NamedTuple):
    centerness: torch.Tensor  # [B, N, 1]
    bbox_pred: torch.Tensor  # [B, N, n_reg]
    cls_scores: torch.Tensor  # [B, N, C]
    points: torch.Tensor  # [B, N, 3] metric
    valid: torch.Tensor  # [B, N]


class Fcaf3DNeckWithHead(nn.Module):
    """Neck and head. `neck_budgets[i]` is the post-prune row budget of
    level i (i < n_levels - 1); the deepest level keeps its backbone map.

    Args:
        in_channels: backbone widths per level, finest first.
        neck_mode: "prune_early" or "reference" (module docstring).

    `forward` returns (per-level `HeadLevelOutput`s, overflow telemetry
    {"neck_lateral_missed_{i}": [B] int32}: laterals absent from the pruned
    map in "prune_early"; in "reference" the keys the union-add dropped,
    zero by construction)."""

    def __init__(self, in_channels: Sequence[int], n_classes: int,
                 out_channels: int = 128, n_reg_outs: int = 6,
                 voxel_size: float = 0.01,
                 neck_budgets: Sequence[int] = (32768, 16384, 4096, 1024),
                 neck_mode: str = "prune_early", device=None):
        super().__init__()
        if neck_mode not in ("prune_early", "reference"):
            raise ValueError(f"neck_mode must be 'prune_early' or "
                             f"'reference', got {neck_mode!r}")
        self.neck_mode = neck_mode
        self.n_levels = len(in_channels)
        self.voxel_size = voxel_size
        self.neck_budgets = tuple(neck_budgets)
        for i in range(self.n_levels):
            c = in_channels[i]
            self.add_module(f"out_block_{i}_conv", SparseConv(
                c, out_channels, 3, device=device))
            self.add_module(f"out_block_{i}_bn",
                            SparseBatchNorm(out_channels, device=device))
            self.register_parameter(
                f"scale_{i}", nn.Parameter(torch.ones((), device=device)))
            if i > 0:  # up block i: level i -> level i - 1
                lo = in_channels[i - 1]
                self.add_module(f"up_block_{i}_tr",
                                SparseGenerativeTranspose(c, lo, device=device))
                self.add_module(f"up_block_{i}_bn1",
                                SparseBatchNorm(lo, device=device))
                self.add_module(f"up_block_{i}_conv",
                                SparseGenConv3(lo, lo, device=device))
                self.add_module(f"up_block_{i}_bn2",
                                SparseBatchNorm(lo, device=device))
        self.centerness_conv = SparseConv(out_channels, 1, 1, device=device)
        self.reg_conv = SparseConv(out_channels, n_reg_outs, 1, device=device)
        self.cls_conv = SparseConv(out_channels, n_classes, 1, use_bias=True,
                                   device=device)

    def _up_level_pruned(self, i, parent, parent_kmap, scores_st, lateral):
        """Generate level i's children from `parent`, prune them by the
        interpolated coarse scores (force-keeping lateral-backed children),
        sort, run the up-block convs on the pruned map and scatter-add the
        lateral. Returns (level map, its self kernel map, missed count)."""
        budget = self.neck_budgets[i]
        b, p = parent.keys.shape
        coords, keys, feats = getattr(self, f"up_block_{i + 1}_tr")(parent)

        # the prune mask takes no gradient (`stop_gradient` in the JAX
        # package, no_grad in the reference's `_prune`)
        cs = child_prune_scores(scores_st.feats.float().detach(), parent_kmap)
        lat_rows = lateral_child_rows(parent, lateral)  # [B, L] in [0, 8P]
        # dump row 8P takes every unmatched lateral; real rows are unique
        must = torch.zeros((b, 8 * p + 1), dtype=torch.bool, device=keys.device)
        must.scatter_(1, lat_rows.long(), lateral.valid)
        keep = threshold_select(cs, keys != SENTINEL, budget,
                                must_keep=must[:, :8 * p])
        c2, k2, f2, _ = compact_select(coords, keys, feats, keep, budget)
        x = sort_tensor(SparseTensor(coords=c2, feats=f2, keys=k2,
                                     shift=parent.shift,
                                     stride=parent.stride // 2,
                                     is_sorted=False))
        kmap = build_kernel_map_self(x.keys, x.coords, x.stride)
        plan = (x.coords, x.keys, kmap, None)

        x = getattr(self, f"up_block_{i + 1}_bn1")(x, act="elu")
        x = self._conv_bn_elu(f"up_block_{i + 1}_conv",
                              f"up_block_{i + 1}_bn2", x, plan)

        # every lateral voxel is in the pruned map (must_keep at every
        # level), so the reference's union-add is a scatter-add
        lrow = lookup(x.keys, lateral.keys)  # [B, L] in [0, budget]
        c = x.num_channels
        fpad = torch.zeros((b, budget + 1, c), dtype=x.feats.dtype,
                           device=x.feats.device)
        fpad = fpad.scatter_add(1, lrow.long()[..., None].expand(-1, -1, c),
                                lateral.feats.to(x.feats.dtype))
        x = x.with_feats(x.feats + fpad[:, :budget])
        missed = ((lrow >= budget) & lateral.valid).sum(dim=1).int()
        return x, kmap, missed

    def _up_level_reference(self, i, parent, parent_kmap, scores_st,
                            lateral):
        """Level i in the reference order: generate all 8P children of
        `parent` (parent-major), BN -> ELU -> conv3 on the child map that
        the parent's k3 self map `parent_kmap` gives -> BN -> ELU,
        union-add the lateral, prune to the level's budget by the
        interpolated coarse scores (detached: the keep mask takes no
        gradient). Returns (level map, None: the level's self map is
        still to build, keys the union dropped)."""
        x = getattr(self, f"up_block_{i + 1}_tr").generate(parent)
        x = getattr(self, f"up_block_{i + 1}_bn1")(x, act="elu")
        x = getattr(self, f"up_block_{i + 1}_conv")(x, parent_kmap=parent_kmap)
        x = getattr(self, f"up_block_{i + 1}_bn2")(x, act="elu")
        x = sparse_union_add(x, lateral)
        interp = interpolate_at(scores_st.with_feats(scores_st.feats.detach()),
                                x.coords.float())
        x_pruned = sparse_prune(x, interp[..., 0], self.neck_budgets[i])
        return x_pruned, None, x.dropped

    def _conv_bn_elu(self, conv, bn, x, plan):
        """conv3 -> BN -> ELU on a shared plan: one conv with the folded
        epilogue in evaluation, the conv and one norm call in training."""
        conv, bn = getattr(self, conv), getattr(self, bn)
        if self.training:
            return bn(conv(x, plan=plan), act="elu")
        inv, sh = bn.affine()
        return conv(x, plan=plan, epilogue=ConvEpilogue(inv, sh, "elu"))

    def forward(self, inputs: Tuple[SparseTensor, ...]):
        n = len(inputs)
        outs = [None] * n
        overflow: Dict[str, torch.Tensor] = {}
        x = inputs[-1]
        scores_st = None
        kmap = None
        for i in range(n - 1, -1, -1):
            if i < n - 1:
                up = (self._up_level_pruned if self.neck_mode == "prune_early"
                      else self._up_level_reference)
                x, kmap, missed = up(i, x, kmap, scores_st, inputs[i])
                overflow[f"neck_lateral_missed_{i}"] = missed
            if kmap is None:
                kmap = build_kernel_map_self(x.keys, x.coords, x.stride)
            plan = (x.coords, x.keys, kmap, None)
            out = self._conv_bn_elu(f"out_block_{i}_conv",
                                    f"out_block_{i}_bn", x, plan)

            # head outputs leave the (possibly bf16) conv path in f32
            ctr_feats = at_least_f32(self.centerness_conv(out).feats)
            cls_feats = at_least_f32(self.cls_conv(out).feats)
            reg_feats = at_least_f32(self.reg_conv(out).feats)
            scale = getattr(self, f"scale_{i}")
            reg_dist = torch.exp(reg_feats[..., :6] * scale)
            bbox_pred = torch.cat([reg_dist, reg_feats[..., 6:]], dim=-1)
            bbox_pred = torch.where(out.valid[..., None], bbox_pred, 0.0)

            # prune score = max class logit; padding rows are unreachable by
            # key lookup, so they contribute zero
            scores_st = out.with_feats(cls_feats.amax(dim=-1, keepdim=True))
            outs[i] = HeadLevelOutput(
                centerness=ctr_feats, bbox_pred=bbox_pred,
                cls_scores=cls_feats, points=out.positions(self.voxel_size),
                valid=out.valid)
        return tuple(outs), overflow


def bbox_pred_to_bbox(points: torch.Tensor, bbox_pred: torch.Tensor,
                      yaw_parametrization: str = "fcaf3d") -> torch.Tensor:
    """Decode head regressions to gravity-centred boxes: 6 outputs to
    axis-aligned [..., 6] = (x, y, z, w, l, h); 7 or 8 outputs to [..., 7]
    with the yaw of `yaw_parametrization`: "naive" (output 6 is the yaw),
    "sin-cos" (outputs 6, 7 are its sine and cosine) or "fcaf3d" (Mobius:
    outputs 6, 7 are (sin 2a, cos 2a) ln q for the w / l ratio q, and w + l
    is the sum of the four horizontal distances)."""
    x = points[..., 0] + (bbox_pred[..., 1] - bbox_pred[..., 0]) / 2
    y = points[..., 1] + (bbox_pred[..., 3] - bbox_pred[..., 2]) / 2
    z = points[..., 2] + (bbox_pred[..., 5] - bbox_pred[..., 4]) / 2
    base = torch.stack([
        x, y, z,
        bbox_pred[..., 0] + bbox_pred[..., 1],
        bbox_pred[..., 2] + bbox_pred[..., 3],
        bbox_pred[..., 4] + bbox_pred[..., 5],
    ], dim=-1)
    if bbox_pred.shape[-1] == 6:
        return base
    if yaw_parametrization == "naive":
        return torch.cat([base, bbox_pred[..., 6:7]], dim=-1)
    s, c = bbox_pred[..., 6], bbox_pred[..., 7]
    if yaw_parametrization == "sin-cos":
        norm = torch.sqrt(s ** 2 + c ** 2 + 1e-12)
        yaw = torch.atan2(s / norm, _atan2_safe_x(s, c) / norm)
        return torch.cat([base, yaw[..., None]], dim=-1)
    # "fcaf3d"; the epsilon and the safe x keep the sqrt and atan2
    # gradients finite at (0, 0), as in the JAX package
    scale = (bbox_pred[..., 0] + bbox_pred[..., 1] + bbox_pred[..., 2]
             + bbox_pred[..., 3])
    q = torch.exp(torch.sqrt(s ** 2 + c ** 2 + 1e-12))
    alpha = 0.5 * torch.atan2(s, _atan2_safe_x(s, c))
    return torch.stack([
        x, y, z, scale / (1 + q), scale / (1 + q) * q,
        bbox_pred[..., 5] + bbox_pred[..., 4], alpha,
    ], dim=-1)


def _box7(boxes: torch.Tensor) -> torch.Tensor:
    """Decoded boxes as box7: a zero yaw column appended to [..., 6]."""
    if boxes.shape[-1] == 7:
        return boxes
    return torch.cat([boxes, torch.zeros_like(boxes[..., :1])], dim=-1)


def _concat_levels(outs: Tuple[HeadLevelOutput, ...]):
    """Level outputs concatenated along rows: (centerness, bbox_pred,
    cls_scores, points, valid, scales [N] int32 level of each row)."""
    cat = [torch.cat([getattr(o, f) for o in outs], dim=1)
           for f in HeadLevelOutput._fields]
    scales = torch.cat([
        torch.full((o.valid.shape[1],), i, dtype=torch.int32,
                   device=o.valid.device) for i, o in enumerate(outs)])
    return (*cat, scales)


class FcafLossConfig(NamedTuple):
    n_scales: int = 4
    assign_limit: int = 27
    assign_topk: int = 18
    with_yaw: bool = False
    yaw_parametrization: str = "fcaf3d"
    # static cap on positives per sample for the bbox/centerness terms;
    # >= assign_topk * max_gt_boxes covers every possible positive
    max_pos: int = 2048


def fcaf3d_loss(outs: Tuple[HeadLevelOutput, ...], gt_boxes: torch.Tensor,
                gt_labels: torch.Tensor, gt_valid: torch.Tensor,
                cfg: FcafLossConfig) -> Dict[str, torch.Tensor]:
    """Batched FCAF3D loss (the JAX package's `fcaf3d_loss`, batched over
    B instead of vmapped).

    Args:
        gt_boxes: [B, G, 7] bottom-centred; gt_labels: [B, G] int;
        gt_valid: [B, G] bool.

    Returns:
        {loss_centerness, loss_bbox, loss_cls} scalar tensors. Per-sample
        sums are divided by batch-mean normalisers (positive count, and the
        sum of positive centerness targets for the box term). Under a
        data-parallel group (`parallel.data_parallel`) the batch is the
        global one: the per-sample sums and normaliser terms of every rank
        are gathered (`parallel.global_batch`), so each rank's losses are
        the global ones and its gradient flows to its own samples (gathered,
        not summed: the means below stay one process's, bitwise at one
        rank).
    """
    centerness, bbox_pred, cls_scores, points, valid, scales = \
        _concat_levels(outs)
    b, p = valid.shape
    with torch.no_grad():
        assign = fcaf3d_assign(points, scales.expand(b, p), valid, gt_boxes,
                               gt_labels, gt_valid, n_scales=cfg.n_scales,
                               limit=cfg.assign_limit, topk=cfg.assign_topk)
    pos = (assign.labels >= 0) & valid
    n_pos = pos.sum(dim=1).float()
    cls_sum = focal_loss_sum(cls_scores, assign.labels, valid)

    # compact the positives to a static cap, in row order (stable sort)
    k = min(cfg.max_pos, p)
    pos_idx = torch.argsort((~pos).to(torch.int32), dim=1, stable=True)[:, :k]
    pos_k = torch.gather(pos, 1, pos_idx)
    ctr_k = torch.gather(centerness[..., 0], 1, pos_idx)
    ctr_t_k = torch.gather(assign.centerness, 1, pos_idx)
    ctr_sum = bce_loss_sum(ctr_k, ctr_t_k, pos_k)

    pred_boxes = _box7(bbox_pred_to_bbox(_take(points, pos_idx),
                                         _take(bbox_pred, pos_idx),
                                         cfg.yaw_parametrization))
    w = torch.where(pos_k, ctr_t_k, 0.0)
    bbox_sum = iou3d_loss_sum(pred_boxes, _take(assign.bbox_targets, pos_idx),
                              w, with_yaw=cfg.with_yaw)
    n_pos, cls_sum, ctr_sum, bbox_sum, w_sum = global_batch(
        n_pos, cls_sum, ctr_sum, bbox_sum, w.sum(dim=1))
    n_pos_avg = torch.clamp_min(n_pos.mean(), 1.0)
    denorm = torch.clamp_min(w_sum.mean(), 1e-6)
    return {
        "loss_cls": (cls_sum / n_pos_avg).mean(),
        "loss_centerness": (ctr_sum / n_pos_avg).mean(),
        "loss_bbox": (bbox_sum / denorm).mean(),
    }


class FcafTestConfig(NamedTuple):
    nms_pre: int = 1000
    iou_thr: float = 0.5
    score_thr: float = 0.01
    nms_cap: int = 256  # per-class candidate cap fed to the NMS matrix
    with_yaw: bool = False  # rotated BEV NMS
    yaw_parametrization: str = "fcaf3d"


class Detections(NamedTuple):
    boxes: torch.Tensor  # [B, D, 7] bottom-centred box7
    scores: torch.Tensor  # [B, D]
    labels: torch.Tensor  # [B, D] int32
    valid: torch.Tensor  # [B, D] bool


def _take(x: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """x [B, N, ...] rows at ids [B, k]."""
    return torch.take_along_dim(x, ids[(...,) + (None,) * (x.dim() - 2)],
                                dim=1)


@tracing.spanned("get_bboxes")
def fcaf3d_get_bboxes(outs: Tuple[HeadLevelOutput, ...],
                      cfg: FcafTestConfig) -> Detections:
    """Batched inference post-processing with static shapes: per level the
    top `nms_pre` rows by max class score, decoded; per class the top
    `nms_cap` candidates, BEV NMS (rotated with `cfg.with_yaw`, else
    axis-aligned). Every sort is stable, so ties (padding rows all score 0)
    resolve by row order."""
    cand_boxes, cand_scores = [], []
    for o in outs:
        score = torch.sigmoid(o.cls_scores) * torch.sigmoid(o.centerness)
        score = torch.where(o.valid[..., None], score, 0.0)
        max_score = score.amax(dim=-1)
        k = min(cfg.nms_pre, max_score.shape[1])
        ids = torch.argsort(-max_score, dim=1, stable=True)[:, :k]
        cand_boxes.append(_box7(bbox_pred_to_bbox(
            _take(o.points, ids), _take(o.bbox_pred, ids),
            cfg.yaw_parametrization)))
        cand_scores.append(_take(score, ids))
    boxes = torch.cat(cand_boxes, dim=1)  # [B, Ct, 7] gravity-centred
    scores = torch.cat(cand_scores, dim=1)  # [B, Ct, C]

    b, ct, n_classes = scores.shape
    kc = min(cfg.nms_cap, ct)
    per_class = scores.transpose(1, 2)  # [B, C, Ct]
    ids = torch.argsort(-per_class, dim=-1, stable=True)[..., :kc]
    s = torch.gather(per_class, 2, ids)  # [B, C, kc]
    cb = torch.take_along_dim(boxes[:, None], ids[..., None], dim=2)
    keep = nms_bev(cb, s, cfg.iou_thr, valid=s > cfg.score_thr,
                   rotated=cfg.with_yaw)
    labels = torch.arange(n_classes, dtype=torch.int32, device=scores.device)
    labels = labels[None, :, None].expand(b, n_classes, kc)
    flat = cb.reshape(b, n_classes * kc, 7)
    # gravity-centred -> bottom-centred canonical box7
    flat = torch.cat([flat[..., :2], flat[..., 2:3] + (-flat[..., 5:6] / 2),
                      flat[..., 3:]], dim=-1)
    return Detections(boxes=flat, scores=s.reshape(b, -1),
                      labels=labels.reshape(b, -1), valid=keep.reshape(b, -1))
