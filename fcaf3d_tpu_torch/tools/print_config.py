"""Print a resolved config of the port as JSON (the torch counterpart of
`tools/print_config.py`, the reference's `tools/misc/print_config.py`).

    python -m fcaf3d_tpu_torch.tools.print_config fcaf3d_scannet \
        [--set key=value ...]

The configs are the port's copies (`fcaf3d_tpu_torch/configs/`), held
equal to the JAX package's by a test.
"""
import argparse
import dataclasses
import json

from .. import configs as C

CONFIGS = {
    "fcaf3d_scannet": C.fcaf3d_scannet,
    "fcaf3d_scannet_3scales": C.fcaf3d_scannet_3scales,
    "fcaf3d_scannet_2scales": C.fcaf3d_scannet_2scales,
    "fcaf3d_sunrgbd": C.fcaf3d_sunrgbd,
    "fcaf3d_s3dis": C.fcaf3d_s3dis,
    "fcaf3d_tiny": C.fcaf3d_tiny,
    "fcaf3d_nano": C.fcaf3d_nano,
    "votenet_sunrgbd": C.votenet_sunrgbd,
    "votenet_v1_sunrgbd": C.votenet_v1_sunrgbd,
    "votenet_v1_scannet": C.votenet_v1_scannet,
    "votenet_tiny": C.votenet_tiny,
}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("config", choices=list(CONFIGS))
    C.add_set_argument(ap)
    return ap.parse_args(argv)


def main(argv=None):
    """Print the config; returns it as a dict."""
    args = parse_args(argv)
    cfg = CONFIGS[args.config]()
    if args.overrides:
        cfg = C.apply_overrides(cfg, args.overrides)
    out = dataclasses.asdict(cfg)
    print(json.dumps(out, indent=2))
    return out


if __name__ == "__main__":
    main()
