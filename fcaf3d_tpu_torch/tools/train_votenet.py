"""VoteNet training CLI of the port (the torch counterpart of
`tools/train_votenet.py`): SUN RGB-D, the reference
`configs/votenet/votenet-v2_16x8_sunrgbd-3d-10class.py` recipe, or with
`--head v1` the bin-based `votenet_16x8_sunrgbd-3d-10class.py` one.

    python -m fcaf3d_tpu_torch.tools.train_votenet --data-root data/sunrgbd \
        --work-dir work_dirs/votenet [--head v1] [--batch 16] [--epochs 36] \
        [--seed 0] [--device cpu]

Trains on `--device` (default the card) and writes `train_log.jsonl` and a
checkpoint an epoch (`ckpts/`) under the work dir. The weights start from
the seeded numpy draw of `params.init_votenet_reference_variables`
(flax's default init, as the JAX tool's `model.init`).
"""
import argparse
import dataclasses
import json
import os

import numpy as np

from ..configs import votenet_sunrgbd, votenet_v1_sunrgbd
from ..data import (SUNRGBD_CLASSES, Compose, GlobalRotScaleTrans,
                    IndoorDetDataset, Loader, PointSample, RandomFlip,
                    RepeatDataset, ShiftHeight)
from ..models.votenet_v1 import sunrgbd_coder
from ..train import (create_votenet_train_state, make_votenet_train_step,
                     make_votenet_v1_train_step, save_checkpoint)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--data-root", required=True)
    ap.add_argument("--work-dir", required=True)
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--head", choices=["v1", "v2"], default="v2",
                    help="v2 = Mobius direct regression; v1 = upstream "
                         "bin-based VoteHead (votenet_16x8_sunrgbd config)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default the card)")
    return ap.parse_args(argv)


def build_config(head, batch=None, epochs=None):
    cfg = votenet_sunrgbd() if head == "v2" else votenet_v1_sunrgbd()
    if batch:
        cfg = dataclasses.replace(cfg, batch_size=batch)
    if epochs:
        cfg = dataclasses.replace(cfg, max_epochs=epochs)
    return cfg


def build_loader(cfg, data_root, seed=0):
    """The SUN RGB-D VoteNet train set (use_dim [0, 1, 2] + shift_height)
    once over, batched by the port's `Loader`."""
    pipe = Compose([
        ShiftHeight(),
        PointSample(cfg.num_points),
        RandomFlip(0.5, 0.0),
        GlobalRotScaleTrans((-0.523599, 0.523599), (0.85, 1.15), (0, 0, 0)),
    ])
    ds = RepeatDataset(
        IndoorDetDataset(
            data_root, os.path.join(data_root, "sunrgbd_infos_train.pkl"),
            SUNRGBD_CLASSES, pipe, use_dim=(0, 1, 2),
        ), times=1,
    )
    return Loader(ds, cfg.batch_size, cfg.num_points, cfg.max_gt_boxes,
                  n_feat_dims=cfg.in_feat_dims, seed=seed)


def votenet_batch(batch):
    """A collated batch as VoteNet input: `collate` puts the height column
    in "colors"; it is folded back into the points [B, N, 4]."""
    return {"points": np.concatenate([batch["points"], batch["colors"]],
                                     axis=-1),
            **{k: batch[k] for k in ("gt_boxes", "gt_labels", "gt_valid")}}


def train(cfg, loader, work_dir, seed=0, device="cuda"):
    """Train `cfg` (v1 with `sunrgbd_coder()`) for `cfg.max_epochs` epochs
    of `loader`, logging every 50 iterations and at the last one of an
    epoch, and saving a checkpoint an epoch. Returns (model, optimizer)."""
    steps = loader.steps_per_epoch()
    v1 = cfg.head_version == "v1"
    model, opt, _ = create_votenet_train_state(
        cfg, seed=seed, device=device, steps_per_epoch=steps,
        coder=sunrgbd_coder() if v1 else None)
    step = (make_votenet_v1_train_step if v1
            else make_votenet_train_step)(model, cfg, opt)
    os.makedirs(work_dir, exist_ok=True)
    with open(os.path.join(work_dir, "train_log.jsonl"), "a") as log:
        for epoch in range(cfg.max_epochs):
            for i, batch in enumerate(loader.epoch(epoch)):
                m = step(votenet_batch(batch))
                if (i + 1) % 50 == 0 or i + 1 == steps:
                    rec = {"epoch": epoch + 1, "iter": i + 1,
                           **{k: round(float(v), 4) for k, v in m.items()}}
                    print(rec, flush=True)
                    log.write(json.dumps(rec) + "\n")
                    log.flush()
            save_checkpoint(work_dir, epoch + 1, model, opt)
    return model, opt


def main(argv=None):
    args = parse_args(argv)
    cfg = build_config(args.head, args.batch, args.epochs)
    train(cfg, build_loader(cfg, args.data_root, args.seed), args.work_dir,
          seed=args.seed, device=args.device)


if __name__ == "__main__":
    main()
