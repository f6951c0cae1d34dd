"""Train ImVoteNet's stage-1 2D detector on SUN RGB-D 2D annotations: the
port's counterpart of `tools/train_detector2d.py`.

The reference freezes a Faster R-CNN pretrained via mmdetection
(`configs/_base_/models/imvotenet_image.py`); here the compact FCOS-style
`Detector2D` is trained directly on the converter-extracted 2D boxes
(`annos['bbox']` xyxy + `annos['class']`) and its `detector2d.pkl` (the
`{"params", "batch_stats"}` numpy tree in the flax layout) feeds
`init_detector2d(params_file=)` and `tools.train_imvotenet --detector2d`.

    python -m fcaf3d_tpu_torch.tools.train_detector2d \
        --data-root data/sunrgbd --work-dir work_dirs/imvotenet_2d \
        [--epochs 12] [--batch 8] [--lr 1e-3] [--seed 0] [--device cpu]

Images are read by `read_image`, the one function here that needs Pillow.
"""
import argparse
import json
import os
import pickle

import numpy as np

from ..params import export_variables
from ..train import create_detector2d_train_state, make_detector2d_train_step

IMG_HW = (480, 640)  # fixed input (SUN RGB-D images are ~530x730)


def read_image(path, hw):
    """The image at `path` as RGB resized to `hw` = (H, W) with Pillow's
    default resampling: (float32 [H, W, 3], (width, height) before the
    resize)."""
    from PIL import Image

    im = Image.open(path).convert("RGB")
    size = im.size
    return np.asarray(im.resize((hw[1], hw[0])), np.float32), size


def load_sample(root, info, rng, train=True):
    """(image [H, W, 3], boxes [n, 4] xyxy scaled to IMG_HW, labels [n]) of
    one info; in training a horizontal flip with probability 1/2 (one
    `rng.random()` draw)."""
    img, (w0, h0) = read_image(
        os.path.join(root, info["image"]["image_path"]), IMG_HW)
    sx, sy = IMG_HW[1] / w0, IMG_HW[0] / h0
    annos = info.get("annos", {})
    if annos.get("gt_num", 0):
        boxes = annos["bbox"].astype(np.float32)
        boxes = boxes * np.asarray([sx, sy, sx, sy], np.float32)
        labels = annos["class"].astype(np.int32)
    else:
        boxes = np.zeros((0, 4), np.float32)
        labels = np.zeros((0,), np.int32)
    if train and rng.random() < 0.5:  # horizontal flip
        img = img[:, ::-1]
        x1 = IMG_HW[1] - boxes[:, 2]
        x2 = IMG_HW[1] - boxes[:, 0]
        boxes = np.stack([x1, boxes[:, 1], x2, boxes[:, 3]], -1)
    return img, boxes, labels


def collate(samples, max_gt=32):
    b = len(samples)
    imgs = np.stack([s[0] for s in samples])
    boxes = np.zeros((b, max_gt, 4), np.float32)
    labels = np.zeros((b, max_gt), np.int32)
    valid = np.zeros((b, max_gt), bool)
    for i, (_, bx, lb) in enumerate(samples):
        n = min(len(bx), max_gt)
        boxes[i, :n] = bx[:n]
        labels[i, :n] = lb[:n]
        valid[i, :n] = True
    return imgs, boxes, labels, valid


def load_infos(data_root):
    """The train infos that have 2D annotations."""
    with open(os.path.join(data_root, "sunrgbd_infos_train.pkl"), "rb") as f:
        infos = pickle.load(f)
    return [i for i in infos if i.get("annos", {}).get("gt_num", 0) > 0]


def train(data_root, work_dir, batch=8, epochs=12, lr=1e-3, seed=0,
          device="cuda"):
    """Train `Detector2D(n_classes=10)` from the seeded numpy draw of
    flax's default init (`create_detector2d_train_state`): every
    epoch a permutation of the infos from one `default_rng(seed)`, then
    batches of `load_sample` (a flip draw a sample); logs every 50
    iterations and at an epoch's last, and writes `detector2d.pkl` after
    each epoch. Returns (model, optimizer)."""
    infos = load_infos(data_root)
    print(f"{len(infos)} images with 2D annotations")
    model, opt, _ = create_detector2d_train_state(n_classes=10, seed=seed,
                                                  device=device, lr=lr)
    step = make_detector2d_train_step(model, opt)
    os.makedirs(work_dir, exist_ok=True)
    out = os.path.join(work_dir, "detector2d.pkl")
    rng = np.random.default_rng(seed)
    steps = len(infos) // batch
    with open(os.path.join(work_dir, "train_log.jsonl"), "a") as log:
        for epoch in range(epochs):
            order = rng.permutation(len(infos))
            for it in range(steps):
                idxs = order[it * batch:(it + 1) * batch]
                samples = [load_sample(data_root, infos[i], rng)
                           for i in idxs]
                imgs, boxes, labels, valid = collate(samples)
                m = step({"images": imgs, "gt_boxes": boxes,
                          "gt_labels": labels, "gt_valid": valid})
                if (it + 1) % 50 == 0 or it + 1 == steps:
                    rec = {"epoch": epoch + 1, "iter": it + 1,
                           "loss": round(float(m["loss"]), 4),
                           **{k: round(float(v), 4) for k, v in m.items()
                              if k not in ("loss", "grad_norm")}}
                    print(rec, flush=True)
                    log.write(json.dumps(rec) + "\n")
                    log.flush()
            tree = export_variables(model)
            with open(out, "wb") as f:
                pickle.dump({"params": tree["params"],
                             "batch_stats": tree.get("batch_stats", {})}, f)
    print("saved", out)
    return model, opt


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--data-root", required=True)
    ap.add_argument("--work-dir", required=True)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--epochs", type=int, default=12)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default the card)")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    train(args.data_root, args.work_dir, args.batch, args.epochs, args.lr,
          args.seed, args.device)


if __name__ == "__main__":
    main()
