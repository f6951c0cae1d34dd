"""Data-parallel dry run on the CPU: W gloo ranks, one process each (the
counterpart of `fcaf3d_tpu/parallel/dryrun.py`, whose worker runs the same
three phases on a mesh of W virtual CPU devices).

    python -m fcaf3d_tpu_torch.parallel.dryrun 2

Each rank takes its row of a global batch of W and runs (1) one FCAF3D DP
train step at `fcaf3d_nano`, (2) a sharded eval forward with the
detections counted over the ranks, (3) one VoteNet-v2 DP train step at
`votenet_tiny`, and prints a line for each. Exits non-zero if a rank
fails.
"""
from __future__ import annotations

import sys

import numpy as np
import torch


def _boxes(rng, b, g):
    boxes = np.zeros((b, g, 7), np.float32)
    boxes[..., :3] = rng.uniform(0.5, 1.5, (b, g, 3))
    boxes[..., 2] = 0.0
    boxes[..., 3:6] = rng.uniform(0.3, 0.8, (b, g, 3))
    return boxes


def _rank(group) -> None:
    from ..configs import fcaf3d_nano, votenet_tiny
    from ..models.detector import infer_config
    from ..models.fcaf3d_head import fcaf3d_get_bboxes
    from ..train import (create_train_state, create_votenet_train_state,
                         make_train_step, make_votenet_train_step)

    torch.set_num_threads(1)
    w, r = group.world, group.rank
    tag = f"dryrun({w}) rank {r}"
    rows = slice(r, r + 1)

    cfg = fcaf3d_nano()
    model, opt, _ = create_train_state(cfg, seed=0, device="cpu",
                                       steps_per_epoch=10)
    step = make_train_step(model, cfg, opt, group=group)
    rng = np.random.RandomState(0)
    g = cfg.max_gt_boxes
    batch = {
        "points": rng.uniform(0, 2.0, (w, cfg.num_points, 3)).astype(
            np.float32),
        "colors": rng.uniform(0, 255.0, (w, cfg.num_points, 3)).astype(
            np.float32),
        "valid": np.ones((w, cfg.num_points), bool),
        "gt_boxes": _boxes(rng, w, g),
        "gt_labels": rng.randint(0, cfg.n_classes, (w, g)).astype(np.int32),
        "gt_valid": np.ones((w, g), bool),
    }
    local = {k: v[rows] for k, v in batch.items()}
    loss = float(step(local)["loss"])
    if not np.isfinite(loss):
        raise AssertionError(f"{tag}: FCAF3D loss {loss}")
    print(f"{tag}: fcaf3d DP step ok, loss={loss:.4f}", flush=True)

    model.eval()
    with torch.inference_mode():
        outs, _ = model(*(torch.as_tensor(local[k])
                          for k in ("points", "colors", "valid")))
        dets = fcaf3d_get_bboxes(outs, infer_config(cfg))
    if not torch.isfinite(dets.scores).all():
        raise AssertionError(f"{tag}: sharded eval scores not finite")
    n = int(group.all_reduce(dets.valid.sum()))
    print(f"{tag}: sharded eval ok, {n} detections", flush=True)

    vcfg = votenet_tiny()
    vmodel, vopt, _ = create_votenet_train_state(vcfg, seed=0, device="cpu")
    vstep = make_votenet_train_step(vmodel, vcfg, vopt, group=group)
    g = vcfg.max_gt_boxes
    vbatch = {
        "points": rng.uniform(0, 2.0, (w, vcfg.num_points, 4)).astype(
            np.float32),
        "gt_boxes": _boxes(rng, w, g),
        "gt_labels": rng.randint(0, vcfg.n_classes, (w, g)).astype(np.int32),
        "gt_valid": np.ones((w, g), bool),
    }
    vloss = float(vstep({k: v[rows] for k, v in vbatch.items()})["loss"])
    if not np.isfinite(vloss):
        raise AssertionError(f"{tag}: VoteNet loss {vloss}")
    print(f"{tag}: votenet DP step ok, loss={vloss:.4f}", flush=True)


def run(world_size: int) -> None:
    """The dry run at `world_size` gloo ranks on the CPU."""
    from .comm import spawn

    spawn(_rank, world_size)


if __name__ == "__main__":
    run(int(sys.argv[1]) if len(sys.argv) > 1 else 2)
