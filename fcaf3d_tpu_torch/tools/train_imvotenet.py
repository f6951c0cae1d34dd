"""Train ImVoteNet stage 2 on SUN RGB-D with the in-framework 2D branch: the
port's counterpart of `tools/train_imvotenet.py`.

Reference recipe: `configs/imvotenet/imvotenet-v2_stage2_16x8_sunrgbd…py`:
stage 2 trains the point/fusion towers with the 2D branch FROZEN
(`imvotenet.py:169-215`). Here the frozen branch is the `Detector2D` pickle
that `tools.train_detector2d` writes; its `extract_bboxes_2d` (with the
reference's train-time random half-drop, drawn from a `torch.Generator`
seeded from `--seed`) feeds the vote fusion each step. `--gt-boxes-2d`
substitutes ground-truth 2D boxes instead (useful before a 2D checkpoint
exists).

    python -m fcaf3d_tpu_torch.tools.train_imvotenet \
        --data-root data/sunrgbd --work-dir work_dirs/imvotenet \
        [--detector2d work_dirs/imvotenet_2d/detector2d.pkl | --gt-boxes-2d] \
        [--batch 8] [--epochs 36] [--num-points 20000] [--max-det2d 32] \
        [--seed 0] [--device cpu]

Writes `train_log.jsonl` and, after each epoch, `imvotenet.pkl` (the
`{"params", "batch_stats"}` numpy tree in the flax layout that
`init_imvotenet(params_file=)` reads).
"""
import argparse
import json
import os
import pickle

import numpy as np
import torch

from ..apis.inference import init_detector2d
from ..configs import votenet_sunrgbd
from ..data import ShiftHeight, sunrgbd_depth2img
from ..data.datasets import boxes_to_bottom_center
from ..models.detector2d import extract_bboxes_2d
from ..params import export_variables
from ..train import create_imvotenet_train_state, make_imvotenet_train_step
from . import train_detector2d
from .train_detector2d import IMG_HW, load_infos


def load_sample(root, info, rng, num_points):
    """(points [num_points, 4] xyz + height, image [H, W, 3] at IMG_HW,
    depth2img [3, 3] for the resized image, bottom-centred GT boxes [n, 7],
    labels [n], GT 2D boxes [n, 4] xyxy scaled to IMG_HW) of one info. The
    draws: `ShiftHeight`, then one `rng.choice` of the points."""
    pts = np.fromfile(os.path.join(root, info["pts_path"]),
                      np.float32).reshape(-1, 6)[:, :3]
    pts = ShiftHeight()({"points": pts}, rng)["points"]
    sel = rng.choice(len(pts), num_points, replace=len(pts) < num_points)
    pts = pts[sel]
    img, (w0, h0) = train_detector2d.read_image(
        os.path.join(root, info["image"]["image_path"]), IMG_HW)
    sx, sy = IMG_HW[1] / w0, IMG_HW[0] / h0
    annos = info["annos"]
    # depth->image projection (SUN RGB-D transposed-K + Rt + axis flip)
    k = sunrgbd_depth2img(info["calib"], sx, sy)
    # the infos' boxes are gravity-centred; the losses take bottom-centred
    # ones, as `IndoorDetDataset` hands them to the other train CLIs
    boxes3d = boxes_to_bottom_center(annos["gt_boxes_upright_depth"])
    labels = annos["class"].astype(np.int32)
    gt2d = annos["bbox"].astype(np.float32) * np.asarray(
        [sx, sy, sx, sy], np.float32)
    return pts, img, k, boxes3d, labels, gt2d


def collate(samples, max_gt_boxes, max_det2d):
    """The train batch of `load_sample` tuples: (points, images, depth2img,
    GT boxes [B, max_gt_boxes, 7], labels, valid, GT 2D boxes [B, max_det2d,
    6] at confidence 1 with the 3D labels as classes, their valid mask)."""
    b = len(samples)
    g = max_gt_boxes
    pts = np.stack([s[0] for s in samples])
    imgs = np.stack([s[1] for s in samples])
    calib = np.stack([s[2] for s in samples])
    boxes = np.zeros((b, g, 7), np.float32)
    labels = np.zeros((b, g), np.int32)
    valid = np.zeros((b, g), bool)
    d = max_det2d
    gt2 = np.zeros((b, d, 6), np.float32)
    gt2v = np.zeros((b, d), bool)
    for i, (_, _, _, bx, lb, b2) in enumerate(samples):
        n = min(len(bx), g)
        boxes[i, :n], labels[i, :n], valid[i, :n] = bx[:n], lb[:n], True
        m = min(len(b2), d)
        gt2[i, :m, :4] = b2[:m]
        gt2[i, :m, 4] = 1.0
        gt2[i, :m, 5] = lb[:m].astype(np.float32)
        gt2v[i, :m] = True
    return pts, imgs, calib, boxes, labels, valid, gt2, gt2v


def train(data_root, work_dir, detector2d=None, batch=8, epochs=36,
          num_points=20000, max_det2d=32, seed=0, device="cuda"):
    """Train ImVoteNet at `votenet_sunrgbd` from the seeded numpy draw of
    flax's default init (`create_imvotenet_train_state`), at
    a constant LR, with the 2D boxes of the `detector2d` pickle or, without
    one, the GT 2D boxes. All host draws come from one `default_rng(seed)`:
    one `load_sample` of the first info (the JAX tool builds its init batch
    from it), then every epoch a permutation and the batches' samples.
    Returns (model, optimizer)."""
    cfg = votenet_sunrgbd()
    infos = load_infos(data_root)
    print(f"{len(infos)} scenes")
    det2d = gen = None
    if detector2d:
        det2d = init_detector2d(cfg.n_classes, params_file=detector2d,
                                device=device)
        gen = torch.Generator(device=device).manual_seed(seed)
    rng = np.random.default_rng(seed)
    load_sample(data_root, infos[0], rng, num_points)
    model, opt, _ = create_imvotenet_train_state(cfg, seed=seed,
                                                 device=device)
    step = make_imvotenet_train_step(model, cfg, opt)
    os.makedirs(work_dir, exist_ok=True)
    out = os.path.join(work_dir, "imvotenet.pkl")
    steps = len(infos) // batch
    with open(os.path.join(work_dir, "train_log.jsonl"), "a") as log:
        for epoch in range(epochs):
            order = rng.permutation(len(infos))
            for it in range(steps):
                idxs = order[it * batch:(it + 1) * batch]
                pts, imgs, calib, boxes, labels, valid, gt2, gt2v = collate(
                    [load_sample(data_root, infos[i], rng, num_points)
                     for i in idxs], cfg.max_gt_boxes, max_det2d)
                if det2d is not None:
                    gt2, gt2v = extract_bboxes_2d(
                        det2d, torch.as_tensor(imgs, device=device),
                        generator=gen, train=True, max_det=max_det2d)
                m = step({"points": pts, "images": imgs, "depth2img": calib,
                          "boxes2d": gt2, "boxes2d_valid": gt2v,
                          "gt_boxes": boxes, "gt_labels": labels,
                          "gt_valid": valid})
                if (it + 1) % 50 == 0 or it + 1 == steps:
                    rec = {"epoch": epoch + 1, "iter": it + 1,
                           "loss": round(float(m["loss"]), 4)}
                    print(rec, flush=True)
                    log.write(json.dumps(rec) + "\n")
                    log.flush()
            with open(out, "wb") as f:
                pickle.dump(export_variables(model), f)
    print("saved", out)
    return model, opt


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--data-root", required=True)
    ap.add_argument("--work-dir", required=True)
    ap.add_argument("--detector2d", default=None,
                    help="detector2d.pkl from tools.train_detector2d")
    ap.add_argument("--gt-boxes-2d", action="store_true",
                    help="use GT 2D boxes instead of the trained branch")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--epochs", type=int, default=36)
    ap.add_argument("--num-points", type=int, default=20000)
    ap.add_argument("--max-det2d", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default the card)")
    args = ap.parse_args(argv)
    if not args.gt_boxes_2d and not args.detector2d:
        ap.error("need --detector2d CKPT or --gt-boxes-2d")
    return args


def main(argv=None):
    args = parse_args(argv)
    train(args.data_root, args.work_dir, args.detector2d, args.batch,
          args.epochs, args.num_points, args.max_det2d, args.seed,
          args.device)


if __name__ == "__main__":
    main()
