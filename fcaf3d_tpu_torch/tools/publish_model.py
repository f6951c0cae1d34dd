"""Strip a training checkpoint to inference weights + content hash: the
port's counterpart of `tools/publish_model.py` (reference
`tools/model_converters/publish_model.py`).

    python -m fcaf3d_tpu_torch.tools.publish_model --work-dir W \
        --out published/fcaf3d_scannet

Drops the optimizer state of W's latest checkpoint and pickles
{"params", "batch_stats", "epoch"} (numpy trees in the flax layout, which
`init_detector(params_file=)` reads) as `{out}-{sha256[:8]}.pkl`. Runs on
the host; no model is built.
"""
import argparse
import hashlib
import pickle

from ..params import _nest
from ..train import load_checkpoint


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--work-dir", required=True)
    ap.add_argument("--out", required=True, help="output prefix (no ext)")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    ckpt = load_checkpoint(args.work_dir)
    tree = _nest({k.replace("/", "."): v.numpy()
                  for k, v in ckpt.pop("variables").items()})
    del ckpt["mu"], ckpt["nu"]
    out = {"params": tree["params"],
           "batch_stats": tree.get("batch_stats", {}),
           "epoch": int(ckpt["epoch"])}
    blob = pickle.dumps(out)
    sha = hashlib.sha256(blob).hexdigest()[:8]
    path = f"{args.out}-{sha}.pkl"
    with open(path, "wb") as f:
        f.write(blob)
    print(f"wrote {path}")
    return path


if __name__ == "__main__":
    main()
