"""Fold BN multiplies into conv kernels for a saved FCAF3D checkpoint: the
port's counterpart of `tools/fuse_conv_bn.py` (reference
`tools/misc/fuse_conv_bn.py`; see `utils/fuse_bn.py` for the tree
semantics).

    python -m fcaf3d_tpu_torch.tools.fuse_conv_bn --work-dir W \
        --out-dir W_fused [--device cpu]

Reads `W/config.json` and W's latest checkpoint, and writes the fused
variables as a checkpoint of the same epoch under `--out-dir` with fresh
AdamW moments and a step count of 0, plus `config.json`.
"""
import argparse
import dataclasses
import json
import os

from ..apis.inference import init_detector
from ..configs import config_from_dict
from ..params import export_variables, load_variables
from ..train import latest_epoch, make_optimizer, save_checkpoint
from ..utils.fuse_bn import fuse_conv_bn


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--work-dir", required=True,
                    help="dir containing ckpts/ and config.json")
    ap.add_argument("--out-dir", required=True)
    ap.add_argument("--device", default="cuda",
                    help="torch device to load the model on (default the "
                         "card)")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    with open(os.path.join(args.work_dir, "config.json")) as f:
        cfg = config_from_dict(json.load(f))
    model = init_detector(cfg, work_dir=args.work_dir, device=args.device)
    fused, n = fuse_conv_bn(export_variables(model))
    load_variables(model, fused)
    del fused
    epoch = latest_epoch(args.work_dir) or 0
    os.makedirs(args.out_dir, exist_ok=True)
    save_checkpoint(args.out_dir, epoch, model,
                    make_optimizer(model.parameters()))
    with open(os.path.join(args.out_dir, "config.json"), "w") as f:
        json.dump(dataclasses.asdict(cfg), f, indent=2)
    print(f"fused {n} conv+BN pairs from epoch {epoch} -> {args.out_dir}")


if __name__ == "__main__":
    main()
