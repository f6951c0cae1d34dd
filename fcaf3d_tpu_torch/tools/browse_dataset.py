"""Visualize ground truth through the port's training pipeline (the torch
counterpart of `tools/browse_dataset.py`, the reference's
`tools/misc/browse_dataset.py`): draws each sample AFTER the augmentation
pipeline (what the model sees) and dumps `<name>_points.obj` +
`<name>_gt.obj` wireframes for MeshLab.

    python -m fcaf3d_tpu_torch.tools.browse_dataset --dataset scannet \
        --data-root data/scannet --out-dir work_dirs/browse [--split val] \
        [--max-samples 10] [--no-aug]

Runs on the host with the port's datasets, pipelines and
`core/visualizer.py`; no model is built.
"""
import argparse
import os

import numpy as np

from ..apis.test import make_test_pipeline
from ..configs import fcaf3d_s3dis, fcaf3d_scannet, fcaf3d_sunrgbd
from ..core.visualizer import write_boxes_obj, write_points_obj
from ..data import (S3DIS_CLASSES, SCANNET_CLASSES, SUNRGBD_CLASSES, Compose,
                    GlobalAlignment, GlobalRotScaleTrans, IndoorDetDataset,
                    PointSample, RandomFlip)


def build_dataset(dataset, data_root, split, aug):
    if dataset == "scannet":
        cfg, classes = fcaf3d_scannet(), SCANNET_CLASSES
        ann = f"scannet_infos_{split}.pkl"
        train_pipe = Compose([
            GlobalAlignment(),
            PointSample(cfg.num_points),
            RandomFlip(0.5, 0.5, with_yaw=False),
            GlobalRotScaleTrans((-0.087266, 0.087266), (0.9, 1.1), (0.1,) * 3,
                                with_yaw=False),
        ])
        align = True
    elif dataset == "sunrgbd":
        cfg, classes = fcaf3d_sunrgbd(), SUNRGBD_CLASSES
        ann = f"sunrgbd_infos_{split}.pkl"
        train_pipe = Compose([
            PointSample(cfg.num_points),
            RandomFlip(0.5, 0.0),
            GlobalRotScaleTrans((-0.523599, 0.523599), (0.85, 1.15), (0.1,) * 3),
        ])
        align = False
    else:
        cfg, classes = fcaf3d_s3dis(), S3DIS_CLASSES
        ann = "s3dis_infos_Area_5.pkl" if split == "val" else "s3dis_infos_Area_1.pkl"
        train_pipe = Compose([
            PointSample(cfg.num_points),
            RandomFlip(0.5, 0.5, with_yaw=False),
            GlobalRotScaleTrans((-0.087266, 0.087266), (0.9, 1.1), (0.1,) * 3,
                                with_yaw=False),
        ])
        align = False
    pipe = train_pipe if aug else make_test_pipeline(cfg, align=align)
    ann_path = os.path.join(data_root, ann)
    if not os.path.isfile(ann_path):  # e.g. fixture dirs: <dataset>_infos.pkl
        ann_path = os.path.join(data_root, f"{dataset}_infos.pkl")
    return IndoorDetDataset(data_root, ann_path, classes, pipe), classes


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dataset", choices=["scannet", "sunrgbd", "s3dis"],
                    required=True)
    ap.add_argument("--data-root", required=True)
    ap.add_argument("--out-dir", required=True)
    ap.add_argument("--split", default="train", choices=["train", "val"])
    ap.add_argument("--max-samples", type=int, default=10)
    ap.add_argument("--no-aug", action="store_true",
                    help="deterministic test pipeline instead of train aug")
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args(argv)


def main(argv=None):
    """Write the samples' .obj files; returns their names."""
    args = parse_args(argv)
    ds, classes = build_dataset(
        args.dataset, args.data_root, args.split, aug=not args.no_aug
    )
    n = min(args.max_samples, len(ds))
    os.makedirs(args.out_dir, exist_ok=True)
    names = []
    for i in range(n):
        s = ds(i, np.random.default_rng([args.seed, i]))
        name = f"{args.dataset}_{args.split}_{s.get('sample_idx', i)}"
        names.append(name)
        write_points_obj(s["points"], os.path.join(args.out_dir, f"{name}_points.obj"))
        write_boxes_obj(s["gt_boxes"], os.path.join(args.out_dir, f"{name}_gt.obj"))
        labels = [classes[j] for j in s["gt_labels"]]
        print(f"{name}: {len(s['points'])} pts, {len(s['gt_boxes'])} boxes "
              f"({', '.join(sorted(set(labels)))})")
    print(f"wrote {n} samples to {args.out_dir}")
    return names


if __name__ == "__main__":
    main()
