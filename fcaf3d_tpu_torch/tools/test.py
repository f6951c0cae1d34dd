"""Evaluation CLI of the port (the torch counterpart of `tools/test.py`):
mAP / mAR of a trained run on a dataset's val split.

    python -m fcaf3d_tpu_torch.tools.test --dataset scannet \
        --data-root data/scannet --work-dir work_dirs/fcaf3d_scannet \
        [--tta] [--out metrics.json] [--show-dir vis] [--device cpu]

The config and class names come from the run's `ckpts/meta.json` when it
has them; `--set` overrides apply on top. `--sharded`, under `torchrun
--nproc_per_node=N`, shards the val scenes over the N ranks (`--batch` a
multiple of N; the reference's `multi_gpu_test`): one card a rank over
NCCL, or ranks sharing a card over gloo (`--dist-backend gloo --device
cuda:0`); rank 0 prints and writes `--out`.
"""
import argparse
import json
import os

from ..apis.inference import init_detector
from ..apis.test import evaluate_dataset, make_test_pipeline
from ..configs import (add_set_argument, apply_overrides, config_from_dict,
                       fcaf3d_s3dis, fcaf3d_scannet, fcaf3d_sunrgbd)
from ..data import (S3DIS_CLASSES, SCANNET_CLASSES, SUNRGBD_CLASSES,
                    IndoorDetDataset)
from ..parallel import destroy, init_from_env, rank
from ..train.checkpoint import load_meta


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dataset", choices=["scannet", "sunrgbd", "s3dis"],
                    required=True)
    ap.add_argument("--data-root", required=True)
    ap.add_argument("--work-dir", default=None, help="dir containing ckpts/")
    ap.add_argument("--params", default=None,
                    help="converted reference checkpoint pickle "
                         "(tools/convert_checkpoint.py) instead of --work-dir")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-scenes", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="json file for metrics")
    ap.add_argument("--show-dir", default=None,
                    help="dump per-scene points + pred/gt wireframe .obj")
    ap.add_argument("--tta", action="store_true",
                    help="4-way BEV flip test-time augmentation "
                         "(MultiScaleFlipAug3D + aug_test analog)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to evaluate on (default the card; "
                         "with --sharded, card LOCAL_RANK)")
    ap.add_argument("--sharded", action="store_true",
                    help="shard the val scenes over the ranks torchrun "
                         "started (multi_gpu_test analog; --batch a "
                         "multiple of the ranks)")
    ap.add_argument("--dist-backend", choices=["nccl", "gloo"],
                    default="nccl")
    add_set_argument(ap)
    args = ap.parse_args(argv)
    if not args.work_dir and not args.params:
        ap.error("one of --work-dir / --params is required")
    return args


def main(argv=None):
    args = parse_args(argv)

    cfg, classes, ann, align = {
        "scannet": (fcaf3d_scannet(), SCANNET_CLASSES,
                    "scannet_infos_val.pkl", True),
        "sunrgbd": (fcaf3d_sunrgbd(), SUNRGBD_CLASSES,
                    "sunrgbd_infos_val.pkl", False),
        "s3dis": (fcaf3d_s3dis(), S3DIS_CLASSES, "s3dis_infos_Area_5.pkl",
                  False),
    }[args.dataset]
    # prefer the training-time config / classes of the checkpoint meta
    meta = load_meta(args.work_dir) if args.work_dir else None
    if meta is not None and meta.get("config"):
        cfg = config_from_dict(meta["config"])
        if meta.get("classes"):
            if tuple(meta["classes"]) != tuple(classes):
                print(f"warning: checkpoint meta classes differ from "
                      f"--dataset {args.dataset}; using meta classes")
            classes = tuple(meta["classes"])
    if args.overrides:
        cfg = apply_overrides(cfg, args.overrides)

    val = IndoorDetDataset(args.data_root,
                           os.path.join(args.data_root, ann), classes,
                           make_test_pipeline(cfg, align=align),
                           test_mode=True)
    group, device = None, args.device
    if args.sharded:
        group = init_from_env(args.dist_backend, args.device)
        device = group.device
    try:
        model = init_detector(cfg, params_file=args.params,
                              work_dir=args.work_dir, device=device)
        metrics = evaluate_dataset(model, val, cfg, batch_size=args.batch,
                                   seed=args.seed,
                                   max_scenes=args.max_scenes, tta=args.tta,
                                   show_dir=args.show_dir, group=group)
    finally:
        destroy(group)
    if rank(group) == 0:
        for k in sorted(metrics):
            print(f"{k}: {metrics[k]:.4f}")
        if args.out:
            with open(args.out, "w") as f:
                json.dump(metrics, f, indent=2)


if __name__ == "__main__":
    main()
