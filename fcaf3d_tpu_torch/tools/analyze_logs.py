"""Training-log analysis of the port (the torch counterpart of
`tools/analyze_logs.py`, the reference's
`tools/analysis_tools/analyze_logs.py`): time statistics and loss curves
from the `train_log.jsonl` that `apis.train.train_model` writes.

    python -m fcaf3d_tpu_torch.tools.analyze_logs cal_train_time \
        work_dirs/run/train_log.jsonl
    python -m fcaf3d_tpu_torch.tools.analyze_logs plot_curve \
        work_dirs/run/train_log.jsonl --keys loss loss_cls --out curve.png

`plot_curve` needs matplotlib, imported only there.
"""
import argparse
import json

import numpy as np


def load(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def cal_train_time(recs):
    """Print the logged step times' mean, extremes and spread, and each
    epoch's wall; returns them as a dict (None when no step was timed)."""
    times = [r["time"] for r in recs if "time" in r]
    if not times:
        print("no iteration timing records")
        return None
    t = np.array(times)
    print(f"average iter time: {t.mean():.4f} s/iter")
    print(f"slowest: {t.max():.4f}  fastest: {t.min():.4f}  std: {t.std():.4f}")
    epochs = {}
    for e in sorted({r["epoch"] for r in recs if "epoch_time" in r}):
        et = [r["epoch_time"] for r in recs
              if r.get("epoch") == e and "epoch_time" in r]
        epochs[e] = et[0]
        print(f"epoch {e}: {et[0]:.1f} s")
    return {"mean": float(t.mean()), "max": float(t.max()),
            "min": float(t.min()), "std": float(t.std()), "epochs": epochs}


def plot_curve(recs, keys, out):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    steps, series = [], {k: [] for k in keys}
    i = 0
    for r in recs:
        if "iter" in r and all(k in r for k in keys):
            i += 1
            steps.append(i)
            for k in keys:
                series[k].append(r[k])
    for k in keys:
        plt.plot(steps, series[k], label=k)
    plt.xlabel("log step")
    plt.legend()
    plt.savefig(out, dpi=120)
    print(f"wrote {out}")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("task", choices=["cal_train_time", "plot_curve"])
    ap.add_argument("log")
    ap.add_argument("--keys", nargs="+", default=["loss"])
    ap.add_argument("--out", default="curve.png")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    recs = load(args.log)
    if args.task == "cal_train_time":
        return cal_train_time(recs)
    return plot_curve(recs, args.keys, args.out)


if __name__ == "__main__":
    main()
