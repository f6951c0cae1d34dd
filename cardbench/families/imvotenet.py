"""ImVoteNet-v2 stage 2 on the benchmark: the port's train step, the
reference's (`cardbench.ref`) that its check compares it with, and the
frame each scan of a generic train batch becomes: a SUN RGB-D-like depth
frame, its camera, its image and its 2D boxes.

`prepare` places the crowded room in front of a pinhole camera at the
origin looking along +y, z up (SUN RGB-D's depth frame, `Rt` the
identity): the points and the GT boxes move by `SHIFT`. The camera is
SUN RGB-D's focal length scaled to a 640-pixel-wide image, centred. The
image is mid-grey with each sampled point's colour painted at its pixel,
far to near, so the nearest point of a pixel wins; a pixel is
`round(uv - 1)`, the pixel the fusion's texture cue reads for a seed. The
2D boxes are the valid GT boxes' 8 projected corners' bounds, clipped to
the image, at confidence 1 with the box's label as class. Everything is
numpy and decided by the batch alone, so the port and the reference get the
same arrays.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from .. import weights
from ..traffic.generator import add_height
from . import common
# VoteNet's configuration fields, its draw (`params.init_imvotenet_variables`
# takes VoteNet's head gains) and its control (TF32 on)
from .votenet import (CONTROL, GAINS, ZERO_BIAS,  # noqa: F401
                      program_config, ref_config)

LOSS = "imvotenet_loss"
TRAIN_KEYS = ("points", "images", "depth2img", "boxes2d", "boxes2d_valid",
              "gt_boxes", "gt_labels", "gt_valid")

IMAGE_HW = (480, 640)
MAX_BOXES2D = 32
# SUN RGB-D's Kinect v2 focal length, 529.5 px on its 730-px-wide
# images, scaled to 640 px wide; the principal point at the centre
FOCAL = 529.5 * 640 / 730
CENTRE = (320.0, 240.0)
SHIFT = np.float32([-2.5, 3.7, -1.2])  # the 5 m room ahead, floor below
GREY = 128.0
MIN_DEPTH = 1.0  # m: a valid box's centre lies at least this far ahead
# SUN RGB-D's depth -> camera axes (x, -z, y), y forward
_FLIP = np.float32([[1, 0, 0], [0, 0, 1], [0, -1, 0]])
_UNIT = np.float32([[x, y, z] for x in (-0.5, 0.5) for y in (-0.5, 0.5)
                    for z in (0.0, 1.0)])


def depth2img() -> np.ndarray:
    """[3, 3] with uvz = xyz @ depth2img^T: SUN RGB-D's transposed K
    [fx 0 0; 0 fy 0; cx cy 1] after the axis flip, `Rt` the identity (the
    port's `data.calib.sunrgbd_depth2img`)."""
    k = np.float32([[FOCAL, 0, 0], [0, FOCAL, 0], [CENTRE[0], CENTRE[1], 1]])
    return (_FLIP @ k).T.astype(np.float32)


def _project(xyz: np.ndarray, d2i: np.ndarray):
    uvz = xyz @ d2i.T
    z = uvz[..., 2]
    return uvz[..., :2] / np.maximum(z, 1e-6)[..., None], z


def _paint(xyz: np.ndarray, colors: np.ndarray, d2i: np.ndarray
           ) -> np.ndarray:
    """[H, W, 3] f32: grey, each point ahead of the camera painted at its
    pixel, the nearest point of a pixel winning."""
    h, w = IMAGE_HW
    uv, z = _project(xyz, d2i)
    px = np.round(uv - 1.0).astype(np.int64)
    keep = (z > 1e-6) & (px[:, 0] >= 0) & (px[:, 0] < w) & (px[:, 1] >= 0) \
        & (px[:, 1] < h)
    pix = px[keep, 1] * w + px[keep, 0]
    order = np.lexsort((z[keep], pix))  # by pixel, nearest first
    first = order[np.r_[True, pix[order][1:] != pix[order][:-1]]]
    image = np.full((h * w, 3), GREY, np.float32)
    image[pix[first]] = colors[keep][first]
    return image.reshape(h, w, 3)


def _boxes2d(boxes: np.ndarray, labels: np.ndarray, d2i: np.ndarray
             ) -> np.ndarray:
    """[n, 6] (x1, y1, x2, y2, 1, label) of bottom-centred box7s [n, 7]:
    the bounds of their projected corners, clipped to the image."""
    h, w = IMAGE_HW
    out = np.zeros((len(boxes), 6), np.float32)
    for j, (cx, cy, cz, dx, dy, dz, yaw) in enumerate(boxes):
        c, s = np.cos(yaw), np.sin(yaw)
        rot = np.float32([[c, -s, 0], [s, c, 0], [0, 0, 1]])
        corners = (_UNIT * [dx, dy, dz]) @ rot.T + [cx, cy, cz]
        uv, z = _project(corners, d2i)
        if (z < 0.1).any():
            raise ValueError(f"box {j} reaches behind the camera")
        lo, hi = uv.min(0), uv.max(0)
        out[j, :4] = [np.clip(lo[0], 0, w - 1), np.clip(lo[1], 0, h - 1),
                      np.clip(hi[0], 0, w - 1), np.clip(hi[1], 0, h - 1)]
    out[:, 4] = 1.0
    out[:, 5] = labels
    return out


def prepare(batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """The generic batch as ImVoteNet trains on it: points [B, P, 4] (xyz
    in the camera's depth frame and the height), images [B, H, W, 3],
    depth2img [B, 3, 3], boxes2d [B, 32, 6], boxes2d_valid [B, 32], and the
    moved GT boxes with their labels and valid mask. Raises ValueError
    where a valid box's centre falls outside the image or nearer than
    `MIN_DEPTH`."""
    h, w = IMAGE_HW
    b = batch["points"].shape[0]
    d2i = depth2img()
    xyz = batch["points"] + SHIFT
    gt_valid = batch["gt_valid"]
    gt_boxes = batch["gt_boxes"].copy()
    gt_boxes[..., :3] += np.where(gt_valid[..., None], SHIFT, 0)
    images = np.empty((b, h, w, 3), np.float32)
    boxes2d = np.zeros((b, MAX_BOXES2D, 6), np.float32)
    boxes2d_valid = np.zeros((b, MAX_BOXES2D), bool)
    for i in range(b):
        images[i] = _paint(xyz[i], batch["colors"][i], d2i)
        boxes, labels = gt_boxes[i][gt_valid[i]], batch["gt_labels"][i][
            gt_valid[i]]
        if len(boxes) > MAX_BOXES2D:
            raise ValueError(f"{len(boxes)} boxes, at most {MAX_BOXES2D}")
        centre = boxes[:, :3] + np.stack(
            [np.zeros(len(boxes)), np.zeros(len(boxes)), boxes[:, 5] / 2],
            -1).astype(np.float32)
        uv, z = _project(centre, d2i)
        if not ((z >= MIN_DEPTH).all() and (uv >= 0).all()
                and (uv[:, 0] < w).all() and (uv[:, 1] < h).all()):
            raise ValueError(f"scan {i}: a box centre lies outside the "
                             f"image or nearer than {MIN_DEPTH} m")
        boxes2d[i, :len(boxes)] = _boxes2d(boxes, labels, d2i)
        boxes2d_valid[i, :len(boxes)] = True
    return {"points": np.stack([add_height(p) for p in xyz]),
            "images": images,
            "depth2img": np.broadcast_to(d2i, (b, 3, 3)).copy(),
            "boxes2d": boxes2d, "boxes2d_valid": boxes2d_valid,
            "gt_boxes": gt_boxes, "gt_labels": batch["gt_labels"],
            "gt_valid": gt_valid}


def _fusion(config: dict) -> dict:
    """The configuration's `imvotenet` block, held to what `prepare`
    builds."""
    im = config["imvotenet"]
    if tuple(im["image_hw"]) != IMAGE_HW or im["max_boxes2d"] != MAX_BOXES2D:
        raise ValueError(f"the adapter builds {IMAGE_HW} images and "
                         f"{MAX_BOXES2D} 2D boxes, the configuration asks "
                         f"for {im['image_hw']} and {im['max_boxes2d']}")
    return {"num_sampled_seed": im["num_sampled_seed"],
            "max_imvote": im["max_imvote"]}


def draw(config: dict, seed: int, device) -> dict:
    from ..ref.models.imvotenet import ImVoteNet
    shapes = weights.model_shapes(ImVoteNet(
        ref_config(config), **_fusion(config), device="meta"))
    return weights.draw(shapes, seed, device, GAINS, ZERO_BIAS)


def program_train(config: dict, tree: dict, device):
    """(model, optimizer, step): `create_imvotenet_train_state` and
    `make_imvotenet_train_step`, as `tools.train_imvotenet` builds them,
    with the drawn variables loaded."""
    from fcaf3d_tpu_torch.params import load_variables
    from fcaf3d_tpu_torch.train.trainer import (create_imvotenet_train_state,
                                                make_imvotenet_train_step)

    cfg = program_config(config)
    model, opt, _ = create_imvotenet_train_state(cfg, device=device,
                                                 **_fusion(config))
    load_variables(model, tree)
    model.train()
    return model, opt, make_imvotenet_train_step(model, cfg, opt)


def ref_train(config: dict, tree: dict, batches: List[dict], device) -> dict:
    from ..ref.models.imvotenet import ImVoteNet, imvotenet_loss
    from ..ref.params import load_variables
    from ..ref.train.optim import ClipAdamW, constant_schedule

    cfg = ref_config(config)
    model = ImVoteNet(cfg, **_fusion(config), device=device)
    load_variables(model, tree)
    opt = ClipAdamW(model.parameters(), constant_schedule(cfg.lr),
                    weight_decay=cfg.weight_decay, grad_clip=cfg.grad_clip)

    def loss_of(t):
        outs = model(t["points"], t["images"], t["boxes2d"],
                     t["boxes2d_valid"], t["depth2img"])
        return imvotenet_loss(outs, t["points"], t["gt_boxes"],
                              t["gt_labels"], t["gt_valid"],
                              n_classes=cfg.n_classes)

    return common.run_ref_steps(model, opt, loss_of, batches, TRAIN_KEYS,
                                device, cfg.grad_clip)
