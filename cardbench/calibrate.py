"""Readings that the limits of a cell's check are set from (`limits/`):
the port's against the reference on many seeds, and on a few the
control's (the reference one precision step below the configuration's,
put in the port's place) and the faults' that a check has to fail.

    python -m cardbench.calibrate --workload <cell> --seeds 1,2,3 \
        [--control-seeds 1,2,3] [--fault-seeds 1,2,3]

One JSON line a reading: {"seed", "who": "port" | "control" |
"half_batch", "readings"}. A train cell's readings come from the first
steps of the timed step object (no window); a detection cell's from its
`checked_requests` requests run one after the other, as the window's one
caller runs them. The fault "half_batch" is the reference's step on the
first half of each batch's scans, the mean taken over them, read against
the reference on the whole batch.
"""
from __future__ import annotations

import argparse
import json
import sys

from . import checks, spec
from .run import program_steps, release
from .ref import precision
from .traffic.generator import make_pool


def kept(scan: dict) -> dict:
    """A reference scan's kept detections, as `detections_to_numpy` gives
    the port's."""
    k = scan["keep"]
    return {"boxes_3d": scan["boxes"][k], "scores_3d": scan["scores"][k],
            "labels_3d": scan["labels"][k]}


def half(batch: dict) -> dict:
    b = next(iter(batch.values())).shape[0]
    return {k: v[:b // 2] for k, v in batch.items()}


def train_readings(cell, fam, seed, who, device):
    config, traffic = cell["config"], cell["traffic"]
    pool = [fam.prepare(b) for b in make_pool(traffic, config, seed)]
    checked = pool[:traffic["checked_steps"]]
    tree = fam.draw(config, seed, device)
    if who == "port":
        model, opt, step, prog = program_steps(fam, config, tree, pool,
                                               len(checked), device)
        del model, opt, step
        release()
    elif who == "control":
        with precision.operands(fam.CONTROL):
            prog = fam.ref_train(config, tree, checked, device)
    else:
        with precision.operands("float32"):
            prog = fam.ref_train(config, tree, [half(b) for b in checked],
                                 device)
    with precision.operands("float32"):
        ref = fam.ref_train(config, tree, checked, device)
    release()
    return checks.train_readings(prog, ref)


def detection_readings(cell, fam, seed, who, device):
    if who not in ("port", "control"):
        raise ValueError(f"a detection cell reads the port or the control, "
                         f"not {who!r}")
    config, traffic = cell["config"], cell["traffic"]
    pool = [fam.prepare(b) for b in make_pool(traffic, config, seed)]
    tree = fam.draw(config, seed, device)
    n = traffic["checked_requests"]
    batches = [pool[i % len(pool)] for i in range(n)]
    if who == "port":
        model, request = fam.program_infer(config, tree, device)
        for i in range(traffic["warm_requests"]):
            request(pool[i % len(pool)])
        prog = [s for b in batches for s in request(b)]
        del model, request
        release()
    else:
        with precision.operands(fam.CONTROL):
            prog = [kept(s) for scans in fam.ref_detect(config, tree,
                                                        batches, device)
                    for s in scans]
    with precision.operands("float32"):
        ref = [s for scans in fam.ref_detect(config, tree, batches, device)
               for s in scans]
    release()
    return checks.detection_readings(prog, ref)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cell = spec.cell(args.workload, spec.benchmark())
    fam = spec.family(cell["config"]["family"])
    read = (train_readings if cell["traffic"]["mode"] == "train"
            else detection_readings)

    def seeds(s):
        return [int(x) for x in s.split(",") if x]

    for who, group in (("port", args.seeds), ("control", args.control_seeds),
                       ("half_batch", args.fault_seeds)):
        for seed in seeds(group):
            r = read(cell, fam, seed, who, args.device)
            print(json.dumps({"seed": seed, "who": who, "readings": r}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
