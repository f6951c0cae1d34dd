"""The paper's evaluation protocol, 5 checkpoints x 5 test seeds, in the
port (the torch counterpart of `tools/test5x5.py`; the reference's
`tools/test5x5.py:31-61`): the last `--n-ckpts` epoch checkpoints of a
training run, each evaluated under `--n-seeds` point-sampling seeds, and
the min / mean / max of mAP@0.25 and mAP@0.50.

    python -m fcaf3d_tpu_torch.tools.test5x5 --dataset scannet \
        --data-root data/scannet --work-dir work_dirs/fcaf3d_scannet \
        [--n-ckpts 5] [--n-seeds 5] [--batch 4] [--max-scenes N] \
        [--device cpu]

The config and classes are the dataset table's (`tools.test.DATASETS`),
as the JAX tool's. `train_model` keeps one checkpoint (`max_keep=1`), so
over its work dir the protocol sees one epoch; the JAX package's does the
same.
"""
import argparse
import json

import numpy as np

from ..apis.inference import init_detector
from ..apis.test import evaluate_dataset
from ..train.checkpoint import restore_checkpoint, saved_epochs
from .test import DATASETS, val_dataset


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dataset", choices=["scannet", "sunrgbd", "s3dis"],
                    required=True)
    ap.add_argument("--data-root", required=True)
    ap.add_argument("--work-dir", required=True)
    ap.add_argument("--n-ckpts", type=int, default=5)
    ap.add_argument("--n-seeds", type=int, default=5)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-scenes", type=int, default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device to evaluate on (default the card)")
    return ap.parse_args(argv)


def test5x5(cfg, val, work_dir, n_ckpts=5, n_seeds=5, batch=4,
            max_scenes=None, device="cuda"):
    """Evaluate the last `n_ckpts` saved epochs of `work_dir` (restored
    into one `init_detector(cfg)` model) on `val` under seeds 0 ..
    `n_seeds` - 1 with `evaluate_dataset`, printing one line a run.
    Returns ([(epoch, seed, metrics)], {"mAP_0.25" | "mAP_0.50": {min,
    mean, max}})."""
    epochs = saved_epochs(work_dir)[-n_ckpts:]
    if not epochs:
        raise FileNotFoundError(f"no checkpoint under {work_dir}/ckpts")
    model = init_detector(cfg, device=device)
    runs = []
    for ep in epochs:
        restore_checkpoint(work_dir, model, epoch=ep)
        for seed in range(n_seeds):
            m = evaluate_dataset(model, val, cfg, batch_size=batch,
                                 seed=seed, max_scenes=max_scenes)
            runs.append((ep, seed, m))
            print(f"epoch {ep} seed {seed}: mAP25={m['mAP_0.25']:.4f} "
                  f"mAP50={m['mAP_0.50']:.4f}", flush=True)
    result = {}
    for key in ("mAP_0.25", "mAP_0.50"):
        maps = [m[key] for _, _, m in runs]
        result[key] = dict(min=float(np.min(maps)), mean=float(np.mean(maps)),
                           max=float(np.max(maps)))
    return runs, result


def main(argv=None):
    args = parse_args(argv)
    make_cfg, classes, ann, align = DATASETS[args.dataset]
    cfg = make_cfg()
    val = val_dataset(args.data_root, ann, classes, cfg, align)
    _, result = test5x5(cfg, val, args.work_dir, args.n_ckpts, args.n_seeds,
                        args.batch, args.max_scenes, args.device)
    print(json.dumps(result, indent=2))


if __name__ == "__main__":
    main()
