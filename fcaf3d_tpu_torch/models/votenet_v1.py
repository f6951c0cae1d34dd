"""VoteNet-v1: the upstream bin-based VoteHead and its
PartialBinBasedBBoxCoder (port of `fcaf3d_tpu/models/votenet_v1.py`), f32,
batched [B, ...].

It shares the backbone, vote module, vote aggregation, targets, the vote,
objectness, centre and semantic losses and the NMS path with VoteNet-v2
(`votenet.py`); it differs in the regression head's channels, the
bin-based encode / decode and the direction and size losses (CE over the
bins, smooth-L1 of the residual at the target bin).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..configs.votenet import VoteNetConfig
from .votenet import (
    VoteDetections,
    VoteNet,
    semantic_loss,
    votenet_common_losses,
    votenet_get_bboxes,
)

_PI = np.float32(np.pi)
_TWO_PI = np.float32(2 * np.pi)


@dataclasses.dataclass(frozen=True)
class PartialBinBasedBBoxCoder:
    """Bin-based box coder: size decoded as `mean_sizes[argmax size_class]
    + size_res`, direction as `bin_centre(argmax dir_class) + dir_res`.

    The angle constants are the JAX package's f32 values (2 pi and pi as
    weakly typed f32, the bin width from the double quotient), and
    `angle2class` divides by a device tensor: on CUDA a Python scalar
    divisor becomes a reciprocal multiply, which moves a bin at its edge."""

    num_dir_bins: int
    num_sizes: int
    mean_sizes: Tuple[Tuple[float, float, float], ...]
    with_rot: bool = True

    @property
    def angle_per_class(self) -> float:
        return 2 * np.pi / self.num_dir_bins

    def _means(self, like: torch.Tensor) -> torch.Tensor:
        return torch.tensor(self.mean_sizes, dtype=torch.float32,
                            device=like.device)

    def angle2class(self, angle: torch.Tensor):
        """Angles [...] -> (bin [...] int64, residual from the bin's centre
        [...] f32), both `%` floor-mods as `jnp`'s."""
        dev = angle.device
        two_pi = torch.tensor(_TWO_PI, device=dev)
        width = torch.tensor(np.float32(self.angle_per_class), device=dev)
        half = torch.tensor(np.float32(self.angle_per_class / 2), device=dev)
        angle = torch.remainder(angle, two_pi)
        shifted = torch.remainder(angle + half, two_pi)
        cls = torch.floor(shifted / width).long()
        return cls, shifted - (cls.float() * width + half)

    def class2angle(self, cls: torch.Tensor, res: torch.Tensor):
        """The inverse of `angle2class`, wrapped to (-pi, pi]."""
        angle = cls.float() * np.float32(self.angle_per_class) + res
        return torch.where(angle > _PI, angle - _TWO_PI, angle)

    def encode(self, boxes7_gravity: torch.Tensor, labels: torch.Tensor):
        """Gravity-centred box7 [..., 7] and labels [...] -> (centre,
        size_class, size_res, dir_class, dir_res)."""
        center = boxes7_gravity[..., :3]
        size_res = boxes7_gravity[..., 3:6] - self._means(labels)[
            labels.long()]
        if self.with_rot:
            dir_class, dir_res = self.angle2class(boxes7_gravity[..., 6])
        else:
            dir_class = torch.zeros_like(labels, dtype=torch.int64)
            dir_res = boxes7_gravity.new_zeros(boxes7_gravity.shape[:-1])
        return center, labels, size_res, dir_class, dir_res

    def split_pred(self, cls_out: torch.Tensor, reg_out: torch.Tensor,
                   base_xyz: torch.Tensor) -> dict:
        """Raw head outputs (cls_out [..., 2 + C], reg_out
        [..., 3 + 2 bins + 4 sizes]) -> the named parts."""
        b, ns = self.num_dir_bins, self.num_sizes
        out = {"obj_scores": cls_out[..., :2], "sem_scores": cls_out[..., 2:],
               "center": base_xyz + reg_out[..., :3]}
        s = 3
        out["dir_class"] = reg_out[..., s:s + b]
        s += b
        out["dir_res_norm"] = reg_out[..., s:s + b]
        out["dir_res"] = out["dir_res_norm"] * np.float32(np.pi / b)
        s += b
        out["size_class"] = reg_out[..., s:s + ns]
        s += ns
        size_res_norm = reg_out[..., s:s + 3 * ns]
        size_res_norm = size_res_norm.reshape(*size_res_norm.shape[:-1], ns,
                                              3)
        out["size_res_norm"] = size_res_norm
        out["size_res"] = size_res_norm * self._means(reg_out)
        return out

    def decode(self, preds: dict) -> torch.Tensor:
        """The predicted parts -> gravity-centred box7 [..., 7]."""
        center = preds["center"]
        if self.with_rot:
            dir_class = torch.argmax(preds["dir_class"], dim=-1)
            dir_res = torch.gather(preds["dir_res"], -1,
                                   dir_class[..., None])[..., 0]
            yaw = self.class2angle(dir_class, dir_res)
        else:
            yaw = center.new_zeros(center.shape[:-1])
        size_class = torch.argmax(preds["size_class"], dim=-1)
        size_res = preds["size_res"]
        # the [..., 1, 3] index of the chosen size's row (gather does not
        # broadcast)
        index = size_class[..., None, None].expand(*size_class.shape, 1, 3)
        size_res = torch.gather(size_res, -2, index)[..., 0, :]
        dims = self._means(center)[size_class] + size_res
        return torch.cat([center, dims, yaw[..., None]], dim=-1)


class VoteNetV1(VoteNet):
    """The upstream VoteNet detector: VoteNet-v2's modules under the same
    names, with the bin-based head (`conv_reg` 3 + 2 bins + 4 sizes wide)
    decoded by `coder`. `forward` returns the coder's parts with the seed,
    vote and proposal entries and the decoded `bbox_preds`."""

    head_version = "v1"

    def __init__(self, cfg: VoteNetConfig, coder: PartialBinBasedBBoxCoder,
                 device=None):
        self.coder = coder
        super().__init__(cfg, device=device)

    def n_reg_outs(self) -> int:
        return 3 + 2 * self.coder.num_dir_bins + 4 * self.coder.num_sizes

    def head(self, agg_xyz, cls_out, reg_out) -> dict:
        preds = self.coder.split_pred(cls_out, reg_out, agg_xyz)
        preds["bbox_preds"] = self.coder.decode(preds)
        return preds


def build_votenet(cfg: VoteNetConfig, coder=None, device=None) -> VoteNet:
    """`VoteNet(cfg)` for a v2 config, `VoteNetV1(cfg, coder)` for a v1
    config, which needs its coder (`sunrgbd_coder()`, `scannet_coder()`)."""
    if cfg.head_version != "v1":
        return VoteNet(cfg, device=device)
    if coder is None:
        raise ValueError("a v1 VoteNet config needs its box coder (coder=)")
    return VoteNetV1(cfg, coder, device=device)


def _smooth_l1(x: torch.Tensor, beta: float = 1.0) -> torch.Tensor:
    ax = x.abs()
    return torch.where(ax < beta, 0.5 * ax * ax / beta, ax - 0.5 * beta)


def _at(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [..., K] at idx [...] along the last axis -> [...]."""
    return torch.gather(x, -1, idx[..., None].long())[..., 0]


def votenet_v1_loss(preds: dict, points: torch.Tensor, gt_boxes: torch.Tensor,
                    gt_labels: torch.Tensor, gt_valid: torch.Tensor,
                    coder: PartialBinBasedBBoxCoder, n_classes: int,
                    gt_per_seed: int = 3) -> dict:
    """The bin-based VoteHead loss (the reference config's weights):
    `votenet_common_losses` on the predicted centres, the direction-bin CE
    (x1) and residual smooth-L1 at the target bin (x10), the size-bin CE
    (x1) and normalised residual smooth-L1 at the target bin (x10/3), and
    the semantic CE (x1), each over the positives."""
    t, common, box_w = votenet_common_losses(
        preds, points, gt_boxes, gt_labels, gt_valid, preds["center"],
        gt_per_seed)
    _, size_cls_t, size_res_t, dir_cls_t, dir_res_t = coder.encode(
        t.assigned_boxes, t.assigned_labels)
    dir_res_t = dir_res_t / torch.tensor(
        np.float32(np.pi / coder.num_dir_bins), device=dir_res_t.device)
    size_res_t = size_res_t / coder._means(size_res_t)[
        t.assigned_labels.long()]

    dir_logp = torch.log_softmax(preds["dir_class"], dim=-1)
    dir_class_loss = (-_at(dir_logp, dir_cls_t) * box_w).sum()
    dir_res_loss = 10.0 * (_smooth_l1(
        _at(preds["dir_res_norm"], dir_cls_t) - dir_res_t) * box_w).sum()

    size_logp = torch.log_softmax(preds["size_class"], dim=-1)
    size_class_loss = (-_at(size_logp, size_cls_t) * box_w).sum()
    index = size_cls_t.long()[..., None, None].expand(*size_cls_t.shape, 1,
                                                      3)
    size_res_pred = torch.gather(preds["size_res_norm"], -2, index)[..., 0, :]
    size_res_loss = (10.0 / 3.0) * (
        _smooth_l1(size_res_pred - size_res_t).sum(-1) * box_w).sum()

    return dict(
        **common,
        dir_class_loss=dir_class_loss,
        dir_res_loss=dir_res_loss,
        size_class_loss=size_class_loss,
        size_res_loss=size_res_loss,
        semantic_loss=semantic_loss(preds["sem_scores"], t.assigned_labels,
                                    n_classes, box_w),
    )


def votenet_v1_get_bboxes(preds: dict, points: torch.Tensor, n_classes: int,
                          **kw) -> VoteDetections:
    """Inference: VoteNet-v2's aligned-NMS path (`votenet_get_bboxes`) on
    the coder-decoded boxes in `preds["bbox_preds"]`."""
    return votenet_get_bboxes(preds, points, n_classes, **kw)


SUNRGBD_MEAN_SIZES = (
    (2.114256, 1.620300, 0.927272), (0.791118, 1.279516, 0.718182),
    (0.923508, 1.867419, 0.845495), (0.591958, 0.552978, 0.827272),
    (0.699104, 0.454178, 0.75625), (0.69519, 1.346299, 0.736364),
    (0.528526, 1.002642, 1.172878), (0.500618, 0.632163, 0.683424),
    (0.404671, 1.071108, 1.688889), (0.76584, 1.398258, 0.472728),
)

SCANNET_MEAN_SIZES = (
    (0.76966727, 0.8116021, 0.92573744), (1.876858, 1.8425595, 1.1931566),
    (0.61328, 0.6148609, 0.7182701), (1.3955007, 1.5121545, 0.83443564),
    (0.97949594, 1.0675149, 0.6329687), (0.531663, 0.5955577, 1.7500148),
    (0.9624706, 0.72462326, 1.1481868), (0.83221924, 1.0490936, 1.6875663),
    (0.21132214, 0.4206159, 0.5372846), (1.4440073, 1.8970833, 0.26985747),
    (1.0294262, 1.4040797, 0.87554324), (1.3766412, 0.65521795, 1.6813129),
    (0.6650819, 0.71111923, 1.298853), (0.41999173, 0.37906948, 1.7513971),
    (0.59359556, 0.5912492, 0.73919016), (0.50867593, 0.50656086, 0.30136237),
    (1.1511526, 1.0546296, 0.49706793), (0.47535285, 0.49249494, 0.5802117),
)


def sunrgbd_coder() -> PartialBinBasedBBoxCoder:
    """`votenet_16x8_sunrgbd-3d-10class.py`: 12 direction bins, 10 sizes."""
    return PartialBinBasedBBoxCoder(
        num_dir_bins=12, num_sizes=10, mean_sizes=SUNRGBD_MEAN_SIZES,
        with_rot=True)


def scannet_coder() -> PartialBinBasedBBoxCoder:
    """`votenet_8x8_scannet-3d-18class.py`: axis-aligned, 18 sizes."""
    return PartialBinBasedBBoxCoder(
        num_dir_bins=1, num_sizes=18, mean_sizes=SCANNET_MEAN_SIZES,
        with_rot=False)
