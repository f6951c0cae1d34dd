"""Dataset preparation CLI of the port (the torch counterpart of
`tools/create_data.py`, the reference's `tools/create_data.py`): the raw
extracted arrays -> `points/*.bin` + `<dataset>_infos_<split>.pkl`, the
layout the port's `IndoorDetDataset` reads.

    python -m fcaf3d_tpu_torch.tools.create_data scannet \
        --root-path data/scannet [--workers 8]
    python -m fcaf3d_tpu_torch.tools.create_data sunrgbd --root-path data/sunrgbd
    python -m fcaf3d_tpu_torch.tools.create_data s3dis --root-path data/s3dis

It converts what the JAX tool converts: ScanNet's train, val and test,
SUN RGB-D's train and val, S3DIS's Area_1-Area_6. Runs on the host; no
model is built.
"""
import argparse

from ..data.converters import (S3DISConverter, ScanNetConverter,
                               SUNRGBDConverter)

SPLITS = {
    "scannet": ("train", "val", "test"),
    "sunrgbd": ("train", "val"),
    "s3dis": tuple(f"Area_{a}" for a in range(1, 7)),
}
CONVERTERS = {"scannet": ScanNetConverter, "sunrgbd": SUNRGBDConverter,
              "s3dis": S3DISConverter}
UNITS = {"scannet": "scenes", "sunrgbd": "scenes", "s3dis": "rooms"}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("dataset", choices=sorted(CONVERTERS))
    ap.add_argument("--root-path", required=True)
    ap.add_argument("--workers", type=int, default=8)
    return ap.parse_args(argv)


def main(argv=None):
    """Convert each split; returns {split: number of scenes}."""
    args = parse_args(argv)
    counts = {}
    for split in SPLITS[args.dataset]:
        infos = CONVERTERS[args.dataset](args.root_path, split).convert(
            num_workers=args.workers)
        counts[split] = len(infos)
        print(f"{args.dataset} {split}: {len(infos)} {UNITS[args.dataset]}")
    return counts


if __name__ == "__main__":
    main()
