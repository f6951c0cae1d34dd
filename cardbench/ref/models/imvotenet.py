"""ImVoteNet-v2 stage 2 (Qi et al., CVPR 2020, arXiv:2001.10692) as the
SamsungLabs FCAF3D repository configures it
(`configs/imvotenet/imvotenet-v2_stage2_16x8_sunrgbd-3d-10class.py`), in
plain PyTorch, f32, batched [B, ...]: the projection of the point seeds
into the image, vote fusion of the 2D boxes with the seeds, the resampling
of the valid seed-box pairs, the image MLP over their cues, and one set of
VoteNet modules run as three towers (joint, points only, image only) with
their losses.

Parameter names are the flax names (`pointnet2.py`). Departures from the
published configuration, which the benchmark's configuration lists:
- the towers are VoteNet-v2's (`votenet.py`: direct Mobius regression and
  the IoU3D loss), the "v2" of the configuration's name, not the
  bin-based VoteHead of the paper;
- the towers' losses are weighted 0.8 / 0.1 / 0.1 (joint / points / image),
  the weights of the ImVoteNet recipe that this benchmark assumes; the
  published file is not in this repository;
- the 2D boxes are inputs (a scan's GT boxes projected into its image at
  confidence 1); the frozen 2D detector and its random drop of half the
  boxes are not run.

The fusion's rules: the seed's pixel is `round(uv - 1)` (half to even); a
seed-box pair is inside where that pixel lies strictly inside the box; the
top `max_imvote` pairs of a seed by inside + confidence come from a stable
argsort; a pair is valid where `floor(inside + confidence) >= 1`; the
resampling takes the valid pairs in index order, cycled, or a uniform
cycle where a scan has none; a resampled pair's seed is its index modulo
S. In training mode each tower's BatchNorms normalise with the batch
statistics and update the running ones in turn: joint, then points, then
image.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..configs.votenet import VoteNetConfig
from .pointnet2 import Dense, DenseBNReLU, PointNet2SASSG, PointSAModule
from .votenet import VoteModule, _take_rows, decode_vote_bbox, votenet_loss

EPS = 1e-6
TOWERS = ("joint", "pts", "img")
LOSS_WEIGHTS = (0.8, 0.1, 0.1)


def project_to_image(xyz: torch.Tensor, depth2img: torch.Tensor):
    """Depth-frame points [B, S, 3] through [B, 3, 3] calibrations ->
    (uv [B, S, 2], depth z [B, S]): uvz = xyz @ depth2img^T, its three
    products summed in one order."""
    m = depth2img[:, None]
    proj = (xyz[..., None, 0] * m[..., 0] + xyz[..., None, 1] * m[..., 1]) \
        + xyz[..., None, 2] * m[..., 2]
    z = proj[..., 2]
    uv = proj[..., :2] / torch.maximum(z[..., None], z.new_full((), EPS))
    return uv, z


def vote_fusion(image: torch.Tensor, boxes2d: torch.Tensor,
                boxes2d_valid: torch.Tensor, seeds: torch.Tensor,
                depth2img: torch.Tensor, n_classes: int, max_imvote: int):
    """image [B, H, W, 3] (0-255), boxes2d [B, D, 6] (x1, y1, x2, y2,
    confidence, class), boxes2d_valid [B, D], seeds [B, S, 3], depth2img
    [B, 3, 3] -> (cues [B, S * max_imvote, 5 + C + 3], valid [B, S *
    max_imvote]): each seed's top pairs' geometric cue (the 2D centre
    offset lifted to a ray: x / z where the ray meets the seed's depth, and
    the unit ray), semantic cue (the box's confidence at its class), both
    zero outside the box, and the seed pixel's colour / 255."""
    b, s = seeds.shape[:2]
    d = boxes2d.shape[1]
    uv, depth = project_to_image(seeds, depth2img)
    uv = torch.round(uv - 1.0)
    x1, y1, x2, y2 = (boxes2d[..., i][:, None, :] for i in range(4))
    conf = torch.where(boxes2d_valid, boxes2d[..., 4],
                       torch.zeros((), device=boxes2d.device))
    cls = boxes2d[..., 5].to(torch.int64)
    u, v = uv[..., 0:1], uv[..., 1:2]
    inside = (u > x1) & (u < x2) & (v > y1) & (v < y2) \
        & boxes2d_valid[:, None, :]

    onehot = nn.functional.one_hot(cls, n_classes).to(conf.dtype)
    sem = (onehot * conf[..., None])[:, None].expand(b, s, d, n_classes)

    du = (x1 + x2) / 2.0 - u
    dv = (y1 + y2) / 2.0 - v
    offset_uvz = torch.stack([du, dv, torch.zeros_like(du)], -1) \
        * depth[..., None, None]
    inv = torch.linalg.inv(depth2img.transpose(1, 2))
    offset = torch.bmm(offset_uvz.reshape(b, s * d, 3), inv).reshape(
        b, s, d, 3)
    seed = seeds[:, :, None, :].expand(b, s, d, 3)
    ray = seed + offset
    ray = ray / torch.sqrt((ray * ray).sum(-1, keepdim=True) + EPS)
    # the forward component as a divisor, kept at least 1e-4 from zero
    fwd = ray[..., 1:2]
    fwd = torch.where(fwd.abs() < 1e-4, torch.where(
        fwd < 0, fwd.new_full((), -1e-4), fwd.new_full((), 1e-4)), fwd)
    xz = ray[..., [0, 2]] / fwd * seed[..., 1:2] - seed[..., [0, 2]]
    cues = torch.cat([xz, ray, sem], -1) * inside[..., None]

    score = inside.to(conf.dtype) + conf[:, None, :]
    if d < max_imvote:
        score = nn.functional.pad(score, (0, max_imvote - d))
        cues = nn.functional.pad(cues, (0, 0, 0, max_imvote - d))
    top = torch.argsort(-score, dim=-1, stable=True)[..., :max_imvote]
    top_cues = torch.gather(cues, 2, top[..., None].expand(
        -1, -1, -1, cues.shape[-1]))
    valid = torch.floor(torch.gather(score, 2, top)) >= 1.0

    h, w = image.shape[1:3]
    px = torch.clamp(torch.round(uv[..., 0]), 0, w - 1).long()
    py = torch.clamp(torch.round(uv[..., 1]), 0, h - 1).long()
    rows = torch.arange(b, device=image.device)[:, None]
    rgb = image[rows, py, px] / torch.full((1,), 255.0, device=image.device)
    texture = rgb[:, :, None, :].expand(b, s, max_imvote, 3)
    out = torch.cat([top_cues, texture], -1)
    return (out.reshape(b, s * max_imvote, -1),
            valid.reshape(b, s * max_imvote))


def sample_valid_seeds(valid: torch.Tensor, k: int) -> torch.Tensor:
    """[B, k] indices into each row of valid [B, M]: its valid entries in
    index order, cycled; a row with none cycles over all M."""
    m = valid.shape[1]
    order = torch.argsort((~valid).to(torch.uint8), dim=1, stable=True)
    count = torch.clamp(valid.sum(1, keepdim=True), min=1)
    ar = torch.arange(k, device=valid.device)[None]
    idx = torch.gather(order, 1, ar % count)
    return torch.where(valid.any(1, keepdim=True), idx, ar % m)


class ImVoteNet(nn.Module):
    """The PointNet++ backbone, the image MLP over the fusion cues
    (`img_mlp0`, `img_mlp1`: 5 + C + 3 -> 256 -> 256), and one set of
    VoteNet-v2 modules over 512-wide seeds (the point features, then the
    image features) that serves the three towers. `forward` returns {tower:
    VoteNet's prediction dict}."""

    agg_radius = 0.3
    agg_num_sample = 16

    def __init__(self, cfg: VoteNetConfig, num_sampled_seed: int = 1024,
                 max_imvote: int = 3, device=None):
        super().__init__()
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

    def tower(self, xyz: torch.Tensor, feats: torch.Tensor,
              indices: torch.Tensor) -> dict:
        """One VoteNet pass over the resampled seeds, proposals sampled by
        FPS over the votes."""
        vote_xyz, vote_feats, vote_offset = self.vote_module(xyz, feats)
        agg_xyz, agg_feats, _ = self.vote_aggregation(vote_xyz, vote_feats)
        x = self.shared_conv1(self.shared_conv0(agg_feats))
        cls_out, reg_out = self.conv_cls(x), self.conv_reg(x)
        return dict(seed_points=xyz, seed_indices=indices,
                    vote_points=vote_xyz, vote_offset=vote_offset,
                    aggregated_points=agg_xyz, obj_scores=cls_out[..., :2],
                    sem_scores=cls_out[..., 2:],
                    bbox_preds=decode_vote_bbox(
                        agg_xyz, reg_out, self.cfg.yaw_parametrization))

    def forward(self, points: torch.Tensor, images: torch.Tensor,
                boxes2d: torch.Tensor, boxes2d_valid: torch.Tensor,
                depth2img: torch.Tensor,
                towers: Sequence[str] = TOWERS) -> dict:
        feat = self.backbone(points)
        seeds = feat["fp_xyz"][-1]
        cues, valid = vote_fusion(images, boxes2d, boxes2d_valid, seeds,
                                  depth2img, self.cfg.n_classes,
                                  self.max_imvote)
        picked = sample_valid_seeds(valid, self.num_sampled_seed)
        seed_of = picked % seeds.shape[1]
        xyz = _take_rows(seeds, seed_of)
        point_feats = _take_rows(feat["fp_features"][-1], seed_of)
        indices = torch.gather(feat["fp_indices"][-1], 1, seed_of)
        image_feats = self.img_mlp1(self.img_mlp0(_take_rows(cues, picked)))
        inputs = {
            "joint": lambda: torch.cat([point_feats, image_feats], -1),
            "pts": lambda: torch.cat(
                [point_feats, torch.zeros_like(image_feats)], -1),
            "img": lambda: torch.cat(
                [torch.zeros_like(point_feats), image_feats], -1),
        }
        return {name: self.tower(xyz, inputs[name](), indices)
                for name in towers}


def imvotenet_loss(tower_outs: dict, points: torch.Tensor,
                   gt_boxes: torch.Tensor, gt_labels: torch.Tensor,
                   gt_valid: torch.Tensor, n_classes: int,
                   loss_weights: Sequence[float] = LOSS_WEIGHTS) -> dict:
    """Each tower's `votenet_loss` times its weight, in the towers' order,
    keys "{tower}_{loss}"."""
    out = {}
    for weight, (name, preds) in zip(loss_weights, tower_outs.items()):
        for k, v in votenet_loss(preds, points, gt_boxes, gt_labels,
                                 gt_valid, n_classes=n_classes).items():
            out[f"{name}_{k}"] = weight * v
    return out
