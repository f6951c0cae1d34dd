"""Training CLI of the port (the torch counterpart of `tools/train.py`).

    python -m fcaf3d_tpu_torch.tools.train --dataset scannet \
        --data-root data/scannet --work-dir work_dirs/fcaf3d_scannet \
        [--batch 16] [--resume] [--device cpu] [--set key=value ...] \
        [--profile-steps 5 --profile-out trace.json]

Trains on `--device` (default the card), evaluates mAP on the val split
after each epoch unless `--no-eval`, and writes `config.json`,
`train_log.jsonl` and `ckpts/` under the work dir. `--profile-steps N`
runs the first N steps under `torch.profiler` with the port's spans on
(`utils/tracing.py`: forward with voxelize / backbone / neck_head, loss,
backward, all_reduce_grads, optimizer) and writes their Chrome trace to
`--profile-out` (rank 0 under torchrun); open it in Perfetto
(ui.perfetto.dev) or chrome://tracing. Training goes on after them.

Data parallel, one process a rank (`--batch` stays the global batch; each
rank loads its rows of every global batch):

    torchrun --nproc_per_node=N -m fcaf3d_tpu_torch.tools.train \
        --launcher pytorch [--dist-backend nccl] ...

NCCL needs one card a rank (rank r on `cuda:LOCAL_RANK`). Several ranks
can share one card over gloo (`--dist-backend gloo --device cuda:0`), for
checks only: gloo stages every collective through the host.
"""
import argparse
import dataclasses
import json
import os

from ..apis.test import evaluate_dataset, make_test_pipeline
from ..apis.train import train_model
from ..configs import (add_set_argument, apply_overrides, fcaf3d_s3dis,
                       fcaf3d_scannet, fcaf3d_scannet_2scales,
                       fcaf3d_scannet_3scales, fcaf3d_sunrgbd)
from ..data import (S3DIS_CLASSES, SCANNET_CLASSES, SUNRGBD_CLASSES, Compose,
                    GlobalAlignment, GlobalRotScaleTrans, IndoorDetDataset,
                    Loader, PointSample, RandomFlip, RepeatDataset,
                    build_s3dis)
from ..parallel import destroy, init_from_env, rank, world
from ..utils import tracing


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dataset", choices=["scannet", "sunrgbd", "s3dis"],
                    required=True)
    ap.add_argument("--data-root", required=True)
    ap.add_argument("--work-dir", required=True)
    ap.add_argument("--batch", type=int, default=None, help="batch size")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--load-from", default=None, metavar="WORK_DIR",
                    help="weights-only init from another run's work dir "
                    "(load_from semantics; shape-mismatched heads keep "
                    "fresh init -- e.g. ScanNet-pretrained S3DIS)")
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--no-eval", action="store_true")
    ap.add_argument("--max-eval-scenes", type=int, default=None)
    ap.add_argument("--scales", type=int, default=4, choices=[2, 3, 4],
                    help="ScanNet fast variants (fcaf3d_2scales/3scales)")
    ap.add_argument("--autoscale-lr", action="store_true",
                    help="linearly scale lr by batch/16 (the reference's "
                         "world-size rule)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default the card; "
                         "under --launcher pytorch, card LOCAL_RANK)")
    ap.add_argument("--launcher", choices=["none", "pytorch"],
                    default="none",
                    help="pytorch: a data-parallel rank started by torchrun")
    ap.add_argument("--dist-backend", choices=["nccl", "gloo"],
                    default="nccl")
    tracing.add_profile_arguments(ap, "train steps")
    add_set_argument(ap)
    args = ap.parse_args(argv)
    if args.scales != 4 and args.dataset != "scannet":
        ap.error("--scales fast variants exist for ScanNet only")
    if args.profile_steps and not args.profile_out:
        ap.error("--profile-steps needs --profile-out")
    return args


def build_config(args):
    cfg = {
        "scannet": {4: fcaf3d_scannet, 3: fcaf3d_scannet_3scales,
                    2: fcaf3d_scannet_2scales}[args.scales],
        "sunrgbd": fcaf3d_sunrgbd,
        "s3dis": fcaf3d_s3dis,
    }[args.dataset]()
    if args.batch:
        cfg = dataclasses.replace(cfg, batch_size=args.batch)
    if args.epochs:
        cfg = dataclasses.replace(cfg, max_epochs=args.epochs)
    if args.overrides:
        cfg = apply_overrides(cfg, args.overrides)
    if args.autoscale_lr:
        cfg = dataclasses.replace(cfg, lr=cfg.lr * cfg.batch_size / 16)
    return cfg


def build_datasets(dataset, root, cfg):
    """(classes, train dataset, val dataset) of `dataset` under `root`: the
    reference configs' train pipelines and repeats."""
    aligned = dict(rot_range=(-0.087266, 0.087266), scale_range=(0.9, 1.1),
                   translation_std=(0.1,) * 3, with_yaw=False)
    if dataset == "scannet":
        classes = SCANNET_CLASSES
        train_pipe = Compose([
            GlobalAlignment(),
            PointSample(cfg.num_points),
            RandomFlip(0.5, 0.5, with_yaw=False),
            GlobalRotScaleTrans(**aligned),
        ])
        ds = RepeatDataset(IndoorDetDataset(
            root, os.path.join(root, "scannet_infos_train.pkl"), classes,
            train_pipe), times=10)
        val_ann, align = "scannet_infos_val.pkl", True
    elif dataset == "sunrgbd":
        classes = SUNRGBD_CLASSES
        train_pipe = Compose([
            PointSample(cfg.num_points),
            RandomFlip(0.5, 0.0),
            GlobalRotScaleTrans((-0.523599, 0.523599), (0.85, 1.15),
                                (0.1,) * 3),
        ])
        ds = RepeatDataset(IndoorDetDataset(
            root, os.path.join(root, "sunrgbd_infos_train.pkl"), classes,
            train_pipe), times=3)
        val_ann, align = "sunrgbd_infos_val.pkl", False
    else:
        classes = S3DIS_CLASSES
        train_pipe = Compose([
            PointSample(cfg.num_points),
            RandomFlip(0.5, 0.5, with_yaw=False),
            GlobalRotScaleTrans(**aligned),
        ])
        ds = build_s3dis(root, [
            os.path.join(root, f"s3dis_infos_Area_{a}.pkl")
            for a in (1, 2, 3, 4, 6)], train_pipe)
        val_ann, align = "s3dis_infos_Area_5.pkl", False
    val = IndoorDetDataset(root, os.path.join(root, val_ann), classes,
                           make_test_pipeline(cfg, align=align),
                           test_mode=True)
    return classes, ds, val


def main(argv=None):
    args = parse_args(argv)
    cfg = build_config(args)
    classes, ds, val = build_datasets(args.dataset, args.data_root, cfg)
    group, device = None, args.device
    if args.launcher == "pytorch":
        group = init_from_env(args.dist_backend, args.device)
        device = group.device
    try:
        # this rank's rows of every global batch (JAX `tools/train.py`)
        loader = Loader(ds, cfg.batch_size, cfg.num_points,
                        cfg.max_gt_boxes, seed=args.seed,
                        shard_index=rank(group), num_shards=world(group))

        eval_hook = None
        if not args.no_eval:
            def eval_hook(model, epoch):
                # one val scene a rank a batch
                metrics = evaluate_dataset(model, val, cfg,
                                           batch_size=world(group),
                                           max_scenes=args.max_eval_scenes,
                                           group=group)
                keys = [k for k in metrics if k.startswith(("mAP", "mAR"))]
                if rank(group) == 0:
                    print(f"[eval epoch {epoch}] "
                          + " ".join(f"{k}={metrics[k]:.4f}" for k in keys))
                return {k: metrics[k] for k in keys}

        os.makedirs(args.work_dir, exist_ok=True)
        if rank(group) == 0:
            with open(os.path.join(args.work_dir, "config.json"), "w") as f:
                json.dump(dataclasses.asdict(cfg), f, indent=2)
        with tracing.profiled(args.profile_steps if rank(group) == 0 else 0,
                              args.profile_out):
            train_model(cfg, loader, args.work_dir, seed=args.seed,
                        eval_hook=eval_hook, resume=args.resume,
                        load_from=args.load_from, classes=classes,
                        device=device, group=group)
    finally:
        destroy(group)


if __name__ == "__main__":
    main()
