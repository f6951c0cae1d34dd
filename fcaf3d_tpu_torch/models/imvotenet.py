"""ImVoteNet-v2 stage 2: vote fusion of 2D detections with the point seeds
and three weight-shared VoteNet towers (port of
`fcaf3d_tpu/models/imvotenet.py`), f32, batched [B, ...].

Parameter names are the flax names (see `pointnet2.py`). The fusion keeps
the JAX package's rules: rounding half to even (`torch.round`), stable
argsorts (the top `max_imvote` pairs of a seed by inside + confidence, and
the valid imvotes' resampling), the forward-axis guard of the geometric cue
verbatim, and no Python scalar divisor (the texture's `/ 255` divides by a
device tensor). Each tower's proposals run K5 and K6 over its votes.

Nothing in the forward waits on the device: the calibration's inverse skips
`torch.linalg.inv`'s error check (a read of its status on the host), and
the x / z columns of a ray are a strided view, not an index list copied to
the device. Tracing (`utils.tracing`) sees the spans `backbone`, `fusion`
(`vote_fusion`, `sample_valid_seeds`, the gathers and the image MLP) and
`tower_joint`, `tower_pts`, `tower_img`; while it is on, `fusion` counts
`fusion_pairs` (the valid pairs kept) over `fusion_slots` (S x
`max_imvote` a scan), `fusion_seeds` (the seeds with at least one valid
pair) and `boxes2d_valid` (the valid 2D boxes).
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
from torch import nn

from ..configs.votenet import VoteNetConfig
from ..ops.pointnet import furthest_point_sample
from ..utils import tracing
from .pointnet2 import Dense, DenseBNReLU, PointNet2SASSG, PointSAModule
from .votenet import VoteModule, _take_rows, decode_vote_bbox, votenet_loss

EPS = 1e-6
TOWERS = ("joint", "pts", "img")
LOSS_WEIGHTS = (0.8, 0.1, 0.1)


def project_to_image(xyz: torch.Tensor, depth2img: torch.Tensor):
    """Depth-frame points [B, S, 3] through [B, 3, 3] calibs -> (uv [B, S,
    2], z [B, S]). The products are summed elementwise in one order, so the
    card and the CPU project alike."""
    m = depth2img[:, None]  # [B, 1, 3, 3]: proj = xyz @ depth2img^T
    proj = (xyz[..., None, 0] * m[..., 0] + xyz[..., None, 1] * m[..., 1]) \
        + xyz[..., None, 2] * m[..., 2]
    z = proj[..., 2]
    uv = proj[..., :2] / torch.maximum(z[..., None], z.new_full((), EPS))
    return uv, z


def vote_fusion(image: torch.Tensor, boxes2d: torch.Tensor,
                boxes2d_valid: torch.Tensor, seeds_depth: torch.Tensor,
                depth2img: torch.Tensor, n_classes: int, max_imvote: int = 3):
    """Fusion cues of each (seed, 2D box) pair, batched: image [B, H, W, 3]
    raw 0-255, boxes2d [B, D, 6] (x1, y1, x2, y2, conf, cls), valid [B, D],
    seeds [B, S, 3] in the original depth frame, depth2img [B, 3, 3].
    Returns (cues [B, S * max_imvote, 5 + C + 3], mask [B, S *
    max_imvote]): the geometric (5), semantic (C) and texture (3) cues of
    each seed's top `max_imvote` pairs by inside + confidence, the mask
    true where `floor(inside + conf) >= 1`: the inside pairs of a box below
    confidence 1, every pair of a box at 1."""
    b, s = seeds_depth.shape[:2]
    d = boxes2d.shape[1]
    zero = seeds_depth.new_zeros(())
    uv, z_cam = project_to_image(seeds_depth, depth2img)
    uv = torch.round(uv - 1.0)

    l, t, r, btm = (boxes2d[..., i] for i in range(4))
    conf = torch.where(boxes2d_valid, boxes2d[..., 4], zero)
    cls = boxes2d[..., 5].to(torch.int32)
    u, v = uv[..., 0, None], uv[..., 1, None]  # [B, S, 1]
    inside = ((u > l[:, None]) & (u < r[:, None]) & (v > t[:, None])
              & (v < btm[:, None]) & boxes2d_valid[:, None, :])  # [B, S, D]

    # semantic cue: class-scattered confidence [B, S, D, C]
    sem = (cls[..., None] == torch.arange(n_classes, device=cls.device)) \
        * conf[..., None]
    sem = sem[:, None].expand(b, s, d, n_classes)

    # geometric cue: the 2D centre offset lifted to a 3D ray
    delta_u = ((l + r) / 2.0)[:, None, :] - u
    delta_v = ((t + btm) / 2.0)[:, None, :] - v
    imvote_uvz = torch.stack([delta_u, delta_v, torch.zeros_like(delta_u)],
                             -1) * z_cam[..., None, None]
    inv = torch.linalg.inv_ex(depth2img.transpose(1, 2)).inverse
    imvote = (imvote_uvz.reshape(b, s * d, 3) @ inv).reshape(b, s, d, 3)
    seed_exp = seeds_depth[:, :, None, :].expand(b, s, d, 3)
    ray = seed_exp + imvote
    ray = ray / torch.sqrt((ray ** 2).sum(-1, keepdim=True) + EPS)
    # guard the forward-axis division: rays from invalid or degenerate boxes
    # can have ray_y ~ -EPS, and an inf there turns `* inside` into NaN
    den = ray[..., 1:2]
    den = torch.where(den.abs() < 1e-4, torch.where(
        den < 0, den.new_full((), -1e-4), den.new_full((), 1e-4)), den)
    xz = ray[..., ::2] / den * seed_exp[..., 1:2] - seed_exp[..., ::2]
    geo = torch.cat([xz, ray], -1)  # [B, S, D, 5]
    cues = torch.cat([geo, sem], -1) * inside[..., None]

    # top max_imvote pairs of each seed by inside + confidence
    pair_score = inside.to(conf.dtype) + conf[:, None, :]
    if d < max_imvote:
        pad = max_imvote - d
        pair_score = nn.functional.pad(pair_score, (0, pad))
        cues = nn.functional.pad(cues, (0, 0, 0, pad))
    order = torch.argsort(-pair_score, dim=-1, stable=True)[..., :max_imvote]
    top_score = torch.gather(pair_score, 2, order)
    top_cues = torch.gather(cues, 2, order[..., None].expand(
        -1, -1, -1, cues.shape[-1]))
    mask = torch.floor(top_score) >= 1.0

    # texture cue: the seed pixel's RGB, shared across its votes
    h, w = image.shape[1:3]
    px = torch.clamp(torch.round(uv[..., 0]), 0, w - 1).long()
    py = torch.clamp(torch.round(uv[..., 1]), 0, h - 1).long()
    rgb = image[torch.arange(b, device=image.device)[:, None], py, px] \
        / torch.full((1,), 255.0, device=image.device)
    txt = rgb[:, :, None, :].expand(b, s, max_imvote, 3)
    out = torch.cat([top_cues, txt], -1)
    return (out.reshape(b, s * max_imvote, -1),
            mask.reshape(b, s * max_imvote))


def sample_valid_seeds(mask: torch.Tensor, k: int) -> torch.Tensor:
    """Indices [B, k] of k valid imvotes of each mask [B, M]: the valid ones
    in index order, cycled when fewer than k are valid; with no valid imvote
    a uniform cycle over all M (`ar % M`)."""
    m = mask.shape[1]
    order = torch.argsort((~mask).to(torch.uint8), dim=1, stable=True)
    cnt = torch.clamp(mask.sum(1, keepdim=True), min=1)
    ar = torch.arange(k, device=mask.device)[None]
    first = order[:, torch.clamp(ar[0], max=m - 1)]
    idx = torch.where(ar < cnt, first, torch.gather(order, 1, ar % cnt))
    return torch.where(mask.any(1, keepdim=True), idx, ar % m)


class ImVoteNet(nn.Module):
    """Stage-2 ImVoteNet at a VoteNet-v2 config: the PointNet++ backbone,
    the image MLP over the fusion cues (`img_mlp0`, `img_mlp1`: 5 + C + 3
    -> 256 -> 256), and one set of VoteNet modules (512-wide seeds) that
    serves the joint, points-only and image-only towers.

    `forward(points [B, N, 3 + in_feat_dims], images [B, H, W, 3], boxes2d
    [B, D, 6], boxes2d_valid [B, D], seeds_depth_fn=None, depth2img [B, 3,
    3], valid=None, sample_mod="vote", towers=TOWERS)` returns {tower:
    the VoteNet prediction dict}. In training mode each tower's BatchNorms
    update the running statistics in turn, joint, then pts, then img."""

    agg_radius = 0.3
    agg_num_sample = 16

    def __init__(self, cfg: VoteNetConfig, num_sampled_seed: int = 1024,
                 max_imvote: int = 3, device=None):
        super().__init__()
        if cfg.head_version != "v2":
            raise ValueError("ImVoteNet builds VoteNet-v2 towers, the config "
                             f"asks for {cfg.head_version!r}")
        self.cfg = cfg
        self.num_sampled_seed = num_sampled_seed
        self.max_imvote = max_imvote
        self.backbone = PointNet2SASSG(
            cfg.in_feat_dims, num_points=cfg.backbone_num_points,
            device=device)
        self.img_mlp0 = DenseBNReLU(5 + cfg.n_classes + 3, 256,
                                    device=device)
        self.img_mlp1 = DenseBNReLU(256, 256, device=device)
        self.vote_module = VoteModule(512, device=device)
        self.vote_aggregation = PointSAModule(
            cfg.num_proposal, self.agg_radius, self.agg_num_sample,
            (128, 128, 128), 512, device=device)
        self.shared_conv0 = DenseBNReLU(128, 128, device=device)
        self.shared_conv1 = DenseBNReLU(128, 128, device=device)
        self.conv_cls = Dense(128, cfg.n_classes + 2, device=device)
        self.conv_reg = Dense(128, cfg.n_reg_outs, device=device)

    def tower(self, seed_xyz: torch.Tensor, seed_feats: torch.Tensor,
              seed_indices: torch.Tensor, sample_mod: str) -> dict:
        """One VoteNet tower pass over the resampled seeds."""
        vote_xyz, vote_feats, vote_offset = self.vote_module(seed_xyz,
                                                             seed_feats)
        if sample_mod == "seed":
            si = furthest_point_sample(seed_xyz, self.cfg.num_proposal)
            agg_xyz, agg_feats, _ = self.vote_aggregation(
                vote_xyz, vote_feats, indices=si)
        elif sample_mod == "vote":
            agg_xyz, agg_feats, _ = self.vote_aggregation(vote_xyz,
                                                          vote_feats)
        else:
            raise ValueError(f"unknown sample_mod {sample_mod!r}")
        x = self.shared_conv1(self.shared_conv0(agg_feats))
        cls_out, reg_out = self.conv_cls(x), self.conv_reg(x)
        return dict(
            seed_points=seed_xyz, seed_indices=seed_indices,
            vote_points=vote_xyz, vote_offset=vote_offset,
            aggregated_points=agg_xyz, obj_scores=cls_out[..., :2],
            sem_scores=cls_out[..., 2:],
            bbox_preds=decode_vote_bbox(agg_xyz, reg_out,
                                        self.cfg.yaw_parametrization))

    def forward(self, points: torch.Tensor, images: torch.Tensor,
                boxes2d: torch.Tensor, boxes2d_valid: torch.Tensor,
                seeds_depth_fn: Optional[Callable] = None,
                depth2img: Optional[torch.Tensor] = None, valid=None,
                sample_mod: str = "vote",
                towers: Sequence[str] = TOWERS) -> dict:
        with tracing.span("backbone"):
            feat = self.backbone(points, valid=valid)
        with tracing.span("fusion"):
            sel_xyz, sel_feats, sel_idx, img_feats = self._fuse(
                feat, images, boxes2d, boxes2d_valid, seeds_depth_fn,
                depth2img)
        variants = {
            "joint": lambda: torch.cat([sel_feats, img_feats], -1),
            "pts": lambda: torch.cat([sel_feats, torch.zeros_like(img_feats)],
                                     -1),
            "img": lambda: torch.cat([torch.zeros_like(sel_feats), img_feats],
                                     -1),
        }
        out = {}
        for name in towers:
            with tracing.span(f"tower_{name}"):
                out[name] = self.tower(sel_xyz, variants[name](), sel_idx,
                                       sample_mod)
        return out

    def _fuse(self, feat, images, boxes2d, boxes2d_valid, seeds_depth_fn,
              depth2img):
        """The resampled seeds' (xyz, point features, input indices) and
        their image features."""
        seeds = feat["fp_xyz"][-1]
        seed_feats = feat["fp_features"][-1]
        seed_idx = feat["fp_indices"][-1]
        seeds_depth = seeds_depth_fn(seeds) if seeds_depth_fn else seeds
        cues, mask = vote_fusion(images, boxes2d, boxes2d_valid, seeds_depth,
                                 depth2img, self.cfg.n_classes,
                                 self.max_imvote)
        if tracing.enabled():
            b, slots = mask.shape
            tracing.count("fusion_pairs", mask.sum())
            tracing.count("fusion_slots", b * slots)
            tracing.count("fusion_seeds", mask.reshape(
                b, -1, self.max_imvote).any(-1).sum())
            tracing.count("boxes2d_valid", boxes2d_valid.sum())
        inds = sample_valid_seeds(mask, self.num_sampled_seed)  # into S*V
        cues = _take_rows(cues, inds)
        seed_sel = inds % seeds.shape[1]
        sel_xyz = _take_rows(seeds, seed_sel)
        sel_feats = _take_rows(seed_feats, seed_sel)
        sel_idx = torch.gather(seed_idx, 1, seed_sel)
        return sel_xyz, sel_feats, sel_idx, self.img_mlp1(self.img_mlp0(cues))


def imvotenet_loss(tower_outs: dict, points: torch.Tensor,
                   gt_boxes: torch.Tensor, gt_labels: torch.Tensor,
                   gt_valid: torch.Tensor, n_classes: int,
                   loss_weights: Sequence[float] = LOSS_WEIGHTS) -> dict:
    """The towers' `votenet_loss`, weighted in the towers' order (0.8 /
    0.1 / 0.1 for joint / pts / img), keys "{tower}_{loss}"."""
    total = {}
    for w, (name, preds) in zip(loss_weights, tower_outs.items()):
        losses = votenet_loss(preds, points, gt_boxes, gt_labels, gt_valid,
                              n_classes=n_classes)
        for k, v in losses.items():
            total[f"{name}_{k}"] = w * v
    return total
