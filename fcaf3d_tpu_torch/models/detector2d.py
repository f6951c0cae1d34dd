"""ImVoteNet's stage-1 image branch: a compact FCOS-style 2D detector (port
of `fcaf3d_tpu/models/detector2d.py`), f32, batched.

Activations run NCHW through `F.conv2d`; the outputs are the JAX module's
NHWC dicts. Module and parameter names are the flax names (`params.py`),
flax's auto-names inside a `ResBlock2D` included (`ConvBNRelu_0`, `Conv_0`,
`GroupNorm_0`, and `Conv_1` / `GroupNorm_1` on the shortcut); conv kernels
are held HWIO, as flax holds them. Two flax semantics that PyTorch's
defaults do not share:

- `nn.Conv` pads "SAME": a 3x3 stride-2 conv on an even size pads (0, 1),
  bottom / right, not PyTorch's symmetric 1; a 1x1 stride-2 conv pads
  nothing.
- `nn.GroupNorm` normalises with epsilon 1e-6 and the fast variance
  `max(0, E[x^2] - E[x]^2)` in f32, in flax's order
  `(x - mean) * (rsqrt(var + eps) * scale) + bias`.

The decode keeps the JAX package's tie rules: `lax.top_k` (the lower index
first) is a stable descending sort, every argsort is stable, argmax / argmin
take the first index, and the per-class NMS offsets boxes by `cls * 1e4` in
f32, verbatim.
"""
from __future__ import annotations

import math
from typing import List, NamedTuple, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core.nms import _greedy_suppress
from .votenet import _take_rows

LEVEL_STRIDES = (8, 16, 32)
# FCOS regression range limits per level (max l/t/r/b in pixels)
LEVEL_RANGES = ((0, 64), (64, 160), (160, 1e8))
IMAGE_MEAN = (123.675, 116.28, 103.53)
IMAGE_STD = 58.0


def _same_pads(n: int, k: int, s: int):
    """flax "SAME" padding (low, high) of one spatial dim of size n."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """flax `nn.Conv` with "SAME" padding on NCHW activations; `kernel` is
    HWIO [k, k, in, out]."""

    def __init__(self, in_ch: int, out_ch: int, k: int, stride: int = 1,
                 bias: bool = True, device=None):
        super().__init__()
        self.k, self.stride = k, stride
        self.kernel = nn.Parameter(torch.zeros(k, k, in_ch, out_ch,
                                               device=device))
        if bias:
            self.bias = nn.Parameter(torch.zeros(out_ch, device=device))
        else:
            self.register_parameter("bias", None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        (top, bottom), (left, right) = (
            _same_pads(n, self.k, self.stride) for n in x.shape[-2:])
        if (top, left) != (bottom, right):
            x = F.pad(x, (left, right, top, bottom))
            top = left = 0
        weight = self.kernel.permute(3, 2, 0, 1).contiguous()
        return F.conv2d(x, weight, self.bias, self.stride, (top, left))


class GroupNorm(nn.Module):
    """flax `nn.GroupNorm(num_groups=gcd(32, ch))` on NCHW activations."""

    eps = 1e-6

    def __init__(self, ch: int, device=None):
        super().__init__()
        self.groups = math.gcd(32, ch)
        self.scale = nn.Parameter(torch.ones(ch, device=device))
        self.bias = nn.Parameter(torch.zeros(ch, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c = x.shape[:2]
        # statistics in at least f32, as flax promotes them
        xg = x.to(torch.promote_types(x.dtype, torch.float32)).reshape(
            b, self.groups, -1)
        mean = xg.mean(-1)
        var = torch.maximum((xg * xg).mean(-1) - mean * mean,
                            xg.new_zeros(()))
        per_ch = (b, c) + (1,) * (x.dim() - 2)
        mean = mean.repeat_interleave(c // self.groups, 1).reshape(per_ch)
        var = var.repeat_interleave(c // self.groups, 1).reshape(per_ch)
        scale = self.scale.reshape((c,) + (1,) * (x.dim() - 2))
        bias = self.bias.reshape(scale.shape)
        return (x - mean) * (torch.rsqrt(var + self.eps) * scale) + bias


class ConvBNRelu(nn.Module):
    """3x3 conv (no bias), GroupNorm, ReLU."""

    def __init__(self, in_ch: int, ch: int, stride: int = 1, device=None):
        super().__init__()
        self.Conv_0 = Conv(in_ch, ch, 3, stride, bias=False, device=device)
        self.GroupNorm_0 = GroupNorm(ch, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.GroupNorm_0(self.Conv_0(x)))


class ResBlock2D(nn.Module):
    """Basic residual block; a 1x1 conv + GroupNorm shortcut where the
    stride or the width changes."""

    def __init__(self, in_ch: int, ch: int, stride: int = 1, device=None):
        super().__init__()
        self.ConvBNRelu_0 = ConvBNRelu(in_ch, ch, stride, device=device)
        self.Conv_0 = Conv(ch, ch, 3, bias=False, device=device)
        self.GroupNorm_0 = GroupNorm(ch, device=device)
        self.shortcut = stride != 1 or in_ch != ch
        if self.shortcut:
            self.Conv_1 = Conv(in_ch, ch, 1, stride, bias=False,
                               device=device)
            self.GroupNorm_1 = GroupNorm(ch, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.GroupNorm_0(self.Conv_0(self.ConvBNRelu_0(x)))
        r = self.GroupNorm_1(self.Conv_1(x)) if self.shortcut else x
        return torch.relu(y + r)


def _resize_nearest(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """`jax.image.resize(..., "nearest")` of NCHW x to (h, w): source index
    floor((i + 0.5) * in / out), in f32 (i // 2 at exactly 2x)."""
    for dim, n in ((2, h), (3, w)):
        m = x.shape[dim]
        if m != n:
            idx = np.floor((np.arange(n, dtype=np.float32) + np.float32(0.5))
                           * np.float32(m) / np.float32(n)).astype(np.int64)
            x = x.index_select(dim, torch.as_tensor(idx, device=x.device))
    return x


class Detector2D(nn.Module):
    """ResNet-lite + FPN + FCOS head. `forward(images [B, H, W, 3] f32,
    0-255)` returns one dict per level (strides 8, 16, 32): cls [B, h, w,
    C] logits, ctr [B, h, w] logits, reg [B, h, w, 4] ltrb pixels."""

    def __init__(self, n_classes: int = 10, width: int = 64,
                 fpn_ch: int = 128, device=None):
        super().__init__()
        self.n_classes, self.width, self.fpn_ch = n_classes, width, fpn_ch
        w = width
        self.stem1 = ConvBNRelu(3, w // 2, 2, device=device)
        self.stem2 = ConvBNRelu(w // 2, w // 2, 1, device=device)
        self.layer1 = ResBlock2D(w // 2, w, 2, device=device)
        self.layer2 = ResBlock2D(w, w * 2, 2, device=device)
        self.layer3 = ResBlock2D(w * 2, w * 4, 2, device=device)
        self.layer4 = ResBlock2D(w * 4, w * 8, 2, device=device)
        for name, ch in (("lat5", w * 8), ("lat4", w * 4), ("lat3", w * 2)):
            self.add_module(name, Conv(ch, fpn_ch, 1, device=device))
        for i in range(3):
            self.add_module(f"smooth{i}", Conv(fpn_ch, fpn_ch, 3,
                                               device=device))
        for i in range(2):
            self.add_module(f"cls_tower{i}", ConvBNRelu(fpn_ch, fpn_ch,
                                                        device=device))
            self.add_module(f"reg_tower{i}", ConvBNRelu(fpn_ch, fpn_ch,
                                                        device=device))
        self.cls_pred = Conv(fpn_ch, n_classes, 3, device=device)
        self.ctr_pred = Conv(fpn_ch, 1, 3, device=device)
        self.reg_pred = Conv(fpn_ch, 4, 3, device=device)
        for lvl in range(3):
            self.register_parameter(f"scale{lvl}", nn.Parameter(
                torch.ones((), device=device)))
        # held in float64 and cast to the images' dtype, as JAX casts its
        # Python constants; divide by a device tensor: a Python scalar
        # divisor becomes a reciprocal multiply on CUDA
        self.register_buffer("image_mean", torch.tensor(
            IMAGE_MEAN, dtype=torch.float64, device=device), persistent=False)
        self.register_buffer("image_std", torch.full(
            (1,), IMAGE_STD, dtype=torch.float64, device=device),
            persistent=False)

    def forward(self, images: torch.Tensor) -> List[dict]:
        # NCHW-contiguous: the permuted view is channels-last, on which the
        # CPU's oneDNN convolutions corrupted the heap over repeated train
        # steps (PyTorch 2.13, the stride-2 stem on 3 channels)
        x = ((images - self.image_mean.to(images.dtype))
             / self.image_std.to(images.dtype)).permute(0, 3, 1, 2)
        x = x.contiguous()
        x = self.stem2(self.stem1(x))
        c3 = self.layer2(self.layer1(x))
        c4 = self.layer3(c3)
        c5 = self.layer4(c4)
        p5 = self.lat5(c5)
        p4 = self.lat4(c4) + _resize_nearest(p5, *c4.shape[2:])
        p3 = self.lat3(c3) + _resize_nearest(p4, *c3.shape[2:])
        outs = []
        for lvl, p in enumerate((p3, p4, p5)):
            f = getattr(self, f"smooth{lvl}")(p)
            c = self.cls_tower1(self.cls_tower0(f))
            r = self.reg_tower1(self.reg_tower0(f))
            reg = torch.exp(self.reg_pred(r) * getattr(self, f"scale{lvl}")) \
                * LEVEL_STRIDES[lvl]
            outs.append({"cls": self.cls_pred(c).permute(0, 2, 3, 1),
                         "ctr": self.ctr_pred(c)[:, 0],
                         "reg": reg.permute(0, 2, 3, 1)})
        return outs


def level_points(h: int, w: int, stride: int, device=None) -> torch.Tensor:
    """Pixel-centre coordinates [h, w, 2] (x, y) of a stride-s level."""
    ys = (torch.arange(h, dtype=torch.float32, device=device) + 0.5) * stride
    xs = (torch.arange(w, dtype=torch.float32, device=device) + 0.5) * stride
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([gx, gy], dim=-1)


def _ltrb_boxes(pts: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """xyxy boxes of points [..., 2] and their ltrb distances [..., 4]."""
    return torch.stack([pts[..., 0] - d[..., 0], pts[..., 1] - d[..., 1],
                        pts[..., 0] + d[..., 2], pts[..., 1] + d[..., 3]], -1)


def fcos_targets(outs, gt_boxes, gt_labels, gt_valid) -> List[dict]:
    """FCOS target assignment (per pixel: inside a box and in the level's
    range; the smallest box's area wins, the first box at a tie). gt_boxes
    [B, G, 4] xyxy; returns per-level dicts: labels [B, hw] (-1
    background), ltrb [B, hw, 4], ctr [B, hw] and pos [B, hw]."""
    areas = (gt_boxes[..., 2] - gt_boxes[..., 0]) * (
        gt_boxes[..., 3] - gt_boxes[..., 1])
    big = torch.full((), 1e18, device=gt_boxes.device)
    areas = torch.where(gt_valid, areas, big)
    targets = []
    for lvl, o in enumerate(outs):
        b, h, w = o["ctr"].shape
        pts = level_points(h, w, LEVEL_STRIDES[lvl],
                           gt_boxes.device).reshape(1, h * w, 1, 2)
        x, y = pts[..., 0], pts[..., 1]  # [1, hw, 1]
        ltrb = torch.stack([x - gt_boxes[:, None, :, 0],
                            y - gt_boxes[:, None, :, 1],
                            gt_boxes[:, None, :, 2] - x,
                            gt_boxes[:, None, :, 3] - y], -1)  # [B,hw,G,4]
        inside = ltrb.amin(-1) > 0
        mx = ltrb.amax(-1)
        lo, hi = LEVEL_RANGES[lvl]
        cand = inside & (mx >= lo) & (mx <= hi) & gt_valid[:, None, :]
        gi = torch.argmin(torch.where(cand, areas[:, None, :], big), dim=-1)
        pos = cand.any(-1)
        lab = torch.where(pos, torch.gather(gt_labels, 1, gi),
                          torch.full((), -1, dtype=gt_labels.dtype,
                                     device=gt_labels.device))
        tl = torch.gather(ltrb, 2, gi[..., None, None].expand(
            -1, -1, 1, 4))[:, :, 0, :]
        lr = torch.stack([tl[..., 0], tl[..., 2]], -1)
        tb = torch.stack([tl[..., 1], tl[..., 3]], -1)
        ctr = torch.sqrt(torch.clamp(
            (lr.amin(-1) / torch.clamp(lr.amax(-1), min=1e-6))
            * (tb.amin(-1) / torch.clamp(tb.amax(-1), min=1e-6)), min=0))
        targets.append({"labels": lab, "ltrb": tl, "ctr": ctr, "pos": pos})
    return targets


def _iou_xyxy(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IoU of aligned xyxy boxes [..., 4] (exactly symmetric in a, b);
    clamps are `torch.maximum` against a zero tensor, whose gradient at a
    tie is jnp's."""
    zero = a.new_zeros(())
    lt = torch.maximum(a[..., :2], b[..., :2])
    rb = torch.minimum(a[..., 2:], b[..., 2:])
    wh = torch.maximum(rb - lt, zero)
    inter = wh[..., 0] * wh[..., 1]
    area_a = torch.maximum(a[..., 2] - a[..., 0], zero) * torch.maximum(
        a[..., 3] - a[..., 1], zero)
    area_b = torch.maximum(b[..., 2] - b[..., 0], zero) * torch.maximum(
        b[..., 3] - b[..., 1], zero)
    return inter / torch.maximum(area_a + area_b - inter,
                                 a.new_full((), 1e-6))


def detector2d_loss(outs, gt_boxes, gt_labels, gt_valid) -> dict:
    """Focal cls + IoU reg + BCE centerness (FCOS losses), summed per level
    in the JAX package's order of terms."""
    targets = fcos_targets(outs, gt_boxes, gt_labels, gt_valid)
    zero = gt_boxes.new_zeros(())
    n_pos = sum(t["pos"].sum() for t in targets)
    norm = torch.maximum(n_pos.to(gt_boxes.dtype), gt_boxes.new_ones(()))
    cls_loss = reg_loss = ctr_loss = 0.0
    for lvl, (o, t) in enumerate(zip(outs, targets)):
        b, h, w, c = o["cls"].shape
        logits = o["cls"].reshape(b, h * w, c)
        labels = t["labels"]
        onehot = (labels[..., None] == torch.arange(
            c, device=labels.device)).to(logits.dtype) \
            * (labels >= 0)[..., None]
        p = torch.sigmoid(logits)
        pt = onehot * p + (1 - onehot) * (1 - p)
        alpha = onehot * 0.25 + (1 - onehot) * 0.75
        ce = -torch.log(torch.maximum(pt, logits.new_full((), 1e-8)))
        cls_loss += torch.sum(alpha * (1 - pt) ** 2 * ce)

        pos = t["pos"]
        pts = level_points(h, w, LEVEL_STRIDES[lvl],
                           logits.device).reshape(1, h * w, 2)
        iou = _iou_xyxy(_ltrb_boxes(pts, o["reg"].reshape(b, h * w, 4)),
                        _ltrb_boxes(pts, t["ltrb"]))
        reg_loss += torch.sum(torch.where(pos, (1 - iou) * t["ctr"], zero))

        x = o["ctr"].reshape(b, h * w)
        bce = torch.maximum(x, zero) - x * t["ctr"] + torch.log1p(
            torch.exp(-torch.where(x >= 0, x, -x)))
        ctr_loss += torch.sum(torch.where(pos, bce, zero))

    ctr_sum = sum(torch.sum(torch.where(t["pos"], t["ctr"], zero))
                  for t in targets)
    return {
        "cls_loss": cls_loss / norm,
        "reg_loss": reg_loss / torch.maximum(ctr_sum, ctr_sum.new_full(
            (), 1e-6)),
        "ctr_loss": ctr_loss / norm,
    }


def nms_2d(boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
           iou_thr: float = 0.5) -> torch.Tensor:
    """Greedy NMS over xyxy boxes [..., N, 4] in stable score order;
    returns the keep mask [..., N] in the candidates' order."""
    masked = torch.where(valid, scores, torch.full((), -torch.inf,
                                                   device=scores.device))
    order = torch.argsort(-masked, dim=-1, stable=True)
    b = torch.gather(boxes, -2, order[..., None].expand(
        *order.shape, boxes.shape[-1]))
    keep = _greedy_suppress(_iou_xyxy(b[..., :, None, :], b[..., None, :, :]),
                            torch.gather(valid, -1, order), iou_thr)
    return torch.zeros_like(keep).scatter(-1, order, keep)


class Detections2D(NamedTuple):
    boxes: torch.Tensor  # [B, D, 6] x1, y1, x2, y2, conf, cls
    valid: torch.Tensor  # [B, D]


def decode_topk(outs, topk: int = 64, image_hw: Sequence[int] = None):
    """Each level's top-k pixels by their best class score (sigmoid cls x
    sigmoid ctr): (boxes [B, N, 4] xyxy, clipped to `image_hw` when given,
    scores [B, N], classes [B, N], the pixels' indices within their level
    [B, N]), levels concatenated."""
    boxes, scores, classes, indices = [], [], [], []
    for lvl, o in enumerate(outs):
        b, h, w, c = o["cls"].shape
        pts = level_points(h, w, LEVEL_STRIDES[lvl],
                           o["cls"].device).reshape(1, h * w, 2)
        score = torch.sigmoid(o["cls"]).reshape(b, h * w, c) * torch.sigmoid(
            o["ctr"]).reshape(b, h * w, 1)
        level_boxes = _ltrb_boxes(pts, o["reg"].reshape(b, h * w, 4))
        best, cls = score.max(-1).values, torch.argmax(score, -1)
        # lax.top_k: the lower index first at a tie
        idx = torch.sort(best, dim=-1, descending=True,
                         stable=True).indices[:, :min(topk, h * w)]
        boxes.append(_take_rows(level_boxes, idx))
        scores.append(torch.gather(best, 1, idx))
        classes.append(torch.gather(cls, 1, idx))
        indices.append(idx)
    boxes = torch.cat(boxes, 1)
    if image_hw is not None:
        hh, ww = image_hw
        boxes = torch.stack([boxes[..., 0].clamp(0, ww),
                             boxes[..., 1].clamp(0, hh),
                             boxes[..., 2].clamp(0, ww),
                             boxes[..., 3].clamp(0, hh)], -1)
    return (boxes, torch.cat(scores, 1), torch.cat(classes, 1),
            torch.cat(indices, 1))


def class_nms(boxes: torch.Tensor, scores: torch.Tensor,
              classes: torch.Tensor, score_thr: float = 0.1,
              iou_thr: float = 0.5) -> torch.Tensor:
    """The keep mask [B, N] of one NMS call that suppresses within a class
    only: boxes offset by `cls * 1e4` (f32), candidates above `score_thr`."""
    off = classes.to(boxes.dtype)[..., None] * 1e4
    return nms_2d(boxes + off, scores, scores > score_thr, iou_thr)


def detector2d_get_bboxes(outs, n_classes: int, topk: int = 64,
                          max_det: int = 64, score_thr: float = 0.1,
                          iou_thr: float = 0.5,
                          image_hw: Sequence[int] = None) -> Detections2D:
    """Decode (top-k per level) + per-class NMS into the [D, 6] ImVoteNet
    interface, batched."""
    boxes, scores, classes, _ = decode_topk(outs, topk, image_hw)
    keep = class_nms(boxes, scores, classes, score_thr, iou_thr)
    ninf = torch.full((), -torch.inf, device=scores.device)
    rank = torch.argsort(-torch.where(keep, scores, ninf), dim=-1,
                         stable=True)[:, :max_det]
    out = torch.cat([_take_rows(boxes, rank), torch.gather(scores, 1, rank)[
        ..., None], torch.gather(classes, 1, rank)[..., None].to(
            boxes.dtype)], -1)
    return Detections2D(boxes=out, valid=torch.gather(keep, 1, rank))


def extract_bboxes_2d(model: Detector2D, images: torch.Tensor,
                      generator: torch.Generator = None, train: bool = False,
                      **decode_kw):
    """The frozen 2D branch (reference `imvotenet.py:308-365`): decode the
    detector's boxes, sorted by confidence; with `train` and a `generator`,
    each box is dropped with probability 1/2 (`torch.rand` < 0.5 keeps it).
    Returns (boxes [B, D, 6], zero where not valid; valid [B, D])."""
    with torch.no_grad():
        dets = detector2d_get_bboxes(model(images), model.n_classes,
                                     image_hw=images.shape[1:3], **decode_kw)
    valid = dets.valid
    if train and generator is not None:
        keep = torch.rand(valid.shape, generator=generator,
                          device=generator.device) < 0.5
        valid = valid & keep.to(valid.device)
    return torch.where(valid[..., None], dets.boxes,
                       dets.boxes.new_zeros(())), valid
