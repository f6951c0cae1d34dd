"""Evaluation CLI of the port (the torch counterpart of `tools/test.py`):
mAP / mAR of a trained run on a dataset's val split.

    python -m fcaf3d_tpu_torch.tools.test --dataset scannet \
        --data-root data/scannet --work-dir work_dirs/fcaf3d_scannet \
        [--tta] [--out metrics.json] [--show-dir vis] [--device cpu] \
        [--profile-steps 4 --profile-out trace.json]

The config and class names come from the run's `ckpts/meta.json` when it
has them; `--set` overrides apply on top. `--sharded`, under `torchrun
--nproc_per_node=N`, shards the val scenes over the N ranks (`--batch` a
multiple of N; the reference's `multi_gpu_test`): one card a rank over
NCCL, or ranks sharing a card over gloo (`--dist-backend gloo --device
cuda:0`); rank 0 prints and writes `--out`. `--profile-steps N` runs the
first N batches under `torch.profiler` with the port's spans on
(`utils/tracing.py`: voxelize, backbone, neck_head, get_bboxes with nms,
to_numpy) and writes their Chrome trace to `--profile-out` (rank 0); open
it in Perfetto (ui.perfetto.dev) or chrome://tracing.
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
from ..utils import tracing

# --dataset -> (config factory, class names, val infos, align): the JAX
# tools' table (`tools/test.py`, `tools/test5x5.py`)
DATASETS = {
    "scannet": (fcaf3d_scannet, SCANNET_CLASSES, "scannet_infos_val.pkl",
                True),
    "sunrgbd": (fcaf3d_sunrgbd, SUNRGBD_CLASSES, "sunrgbd_infos_val.pkl",
                False),
    "s3dis": (fcaf3d_s3dis, S3DIS_CLASSES, "s3dis_infos_Area_5.pkl", False),
}


def val_dataset(data_root, ann, classes, cfg, align):
    """The val split `ann` under `data_root` through the test pipeline."""
    return IndoorDetDataset(data_root, os.path.join(data_root, ann), classes,
                            make_test_pipeline(cfg, align=align),
                            test_mode=True)


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
    tracing.add_profile_arguments(ap, "evaluation batches")
    add_set_argument(ap)
    args = ap.parse_args(argv)
    if not args.work_dir and not args.params:
        ap.error("one of --work-dir / --params is required")
    if args.profile_steps and not args.profile_out:
        ap.error("--profile-steps needs --profile-out")
    return args


def main(argv=None):
    args = parse_args(argv)

    make_cfg, classes, ann, align = DATASETS[args.dataset]
    cfg = make_cfg()
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

    val = val_dataset(args.data_root, ann, classes, cfg, align)
    group, device = None, args.device
    if args.sharded:
        group = init_from_env(args.dist_backend, args.device)
        device = group.device
    try:
        model = init_detector(cfg, params_file=args.params,
                              work_dir=args.work_dir, device=device)
        with tracing.profiled(args.profile_steps if rank(group) == 0 else 0,
                              args.profile_out):
            metrics = evaluate_dataset(model, val, cfg,
                                       batch_size=args.batch, seed=args.seed,
                                       max_scenes=args.max_scenes,
                                       tta=args.tta, show_dir=args.show_dir,
                                       group=group)
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
