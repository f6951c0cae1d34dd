"""Parity-on-arrival harness of the port (the torch counterpart of
`tools/parity_check.py`): per-layer activation statistics and the final
detections of FCAF3D on converted reference weights, in the JAX dump's
JSON, so that one `--diff` compares a JAX dump, a card dump and a
reference-side dump.

1. `python -m fcaf3d_tpu_torch.tools.convert_checkpoint --pth epoch_12.pth
   --out params.pkl`
2. `python -m fcaf3d_tpu_torch.tools.parity_check --params params.pkl
   --dataset scannet --dump card_dump.json [--points scene.bin]
   [--device cpu]` runs `neck_mode="reference"`, float32 inference (the
   reference's op order) on the reference's fixture scene, or on any
   `--points` `.bin`, sampled with `np.random.RandomState(0).choice` as
   the JAX tool samples it.
3. `python -m fcaf3d_tpu_torch.tools.parity_check --diff a.json b.json
   [--rtol 1e-3]` judges two dumps as the JAX tool does.

The keys are the flax intermediates' (`module/path/__call__[k]...`): one
entry a call of each named module of the port's `FCAF3D` (forward hooks),
the folded norms' `affine()` pairs and the reference neck's transposes'
`generate()` recorded as the calls that flax records for them, a norm
called with the activation or residual add that follows it recorded as its
call without them (flax's norm returns the norm alone), and the
model's and the neck's head outputs (the flax modules sow their overflow
counts elsewhere). A `SparseTensor` gives its valid rows' statistics and a
`.n_valid` count; a plain tensor its statistics over every element,
padding rows included, as the JAX tool records them.

Without `--params` the weights are the seeded `params.init_variables(cfg,
0)` draw: flax's `model.init`, which the JAX tool uses there, cannot be
drawn in torch, so only dumps of the same `--params` pickle compare. The
fixture scene is the reference's committed test data, read from
`tests/data/reference/` in this repository (REF_FIXTURES), which does not
hold it yet; where it is missing the tool says so.
"""
import argparse
import contextlib
import dataclasses
import json
import os
import pickle
import sys

import numpy as np
import torch

from .. import configs
from ..models.blocks import SparseBatchNorm, SparseInstanceNorm
from ..models.detector import FCAF3D, infer_config
from ..models.fcaf3d_head import Fcaf3DNeckWithHead, fcaf3d_get_bboxes
from ..ops.sparse.tensor import SparseTensor
from ..params import init_variables, load_variables

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# where the reference's committed test data is to be placed in this
# repository; the fixture scene and --export-points read it
REF_FIXTURES = os.path.join(REPO, "tests", "data", "reference")
# methods that flax records as calls of their module: the folded BN's
# (inv, shift) and the reference neck's child map
RECORDED_METHODS = ("affine", "generate")


def tensor_stats(x, mask=None):
    """Summary stats of one activation array (masked rows excluded)."""
    x = np.asarray(x, np.float64)
    if mask is not None:
        m = np.asarray(mask, bool)
        x = x[m] if m.shape == x.shape[: m.ndim] else x
    if x.size == 0:
        return {"n": 0}
    return {
        "n": int(x.size),
        "mean": float(x.mean()),
        "std": float(x.std()),
        "absmax": float(np.abs(x).max()),
        "finite_frac": float(np.isfinite(x).mean()),
    }


def _host(x):
    """A tensor as a numpy array (floats in float64), anything else as it
    is."""
    if not isinstance(x, torch.Tensor):
        return x
    x = x.detach()
    return (x.double() if x.is_floating_point() else x).cpu().numpy()


def collect_stats(tree, prefix, out):
    """Walk recorded outputs; SparseTensors contribute masked feature stats,
    plain arrays contribute raw stats."""
    if isinstance(tree, SparseTensor):
        valid = _host(tree.valid)
        out[prefix] = tensor_stats(_host(tree.feats), valid)
        out[prefix + ".n_valid"] = {"n": int(valid.sum())}
        return
    if isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            collect_stats(v, f"{prefix}[{i}]", out)
        return
    if isinstance(tree, dict):
        for k, v in tree.items():
            collect_stats(v, f"{prefix}/{k}" if prefix else str(k), out)
        return
    if hasattr(tree, "shape"):
        out[prefix] = tensor_stats(_host(tree))
        return
    if dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            collect_stats(getattr(tree, f.name), f"{prefix}.{f.name}", out)


@contextlib.contextmanager
def recorded_calls(model):
    """Record every call of each named module of `model` (forward and
    RECORDED_METHODS) while the context is open. Yields {flax path, "" for
    the model: [output of each call, in call order]}; the FCAF3D's and the
    neck's outputs without their overflow dict."""
    calls = {}
    handles, patched = [], []

    def record(path, module, args, kwargs, out):
        if isinstance(module, (SparseBatchNorm, SparseInstanceNorm)) and (
                kwargs.get("act") is not None
                or kwargs.get("residual") is not None):
            with torch.no_grad():
                module(*args)  # the norm alone, recorded by this hook
            return
        if isinstance(module, (FCAF3D, Fcaf3DNeckWithHead)):
            out = out[0]
        calls.setdefault(path, []).append(out)

    for name, module in model.named_modules():
        path = name.replace(".", "/")
        handles.append(module.register_forward_hook(
            lambda m, args, kwargs, out, path=path: record(
                path, m, args, kwargs, out), with_kwargs=True))
        for method in RECORDED_METHODS:
            real = getattr(module, method, None)
            if real is None:
                continue

            def wrapped(*args, real=real, path=path, module=module, **kw):
                out = real(*args, **kw)
                record(path, module, args, {}, out)
                return out
            setattr(module, method, wrapped)
            patched.append((module, method))
    try:
        yield calls
    finally:
        for handle in handles:
            handle.remove()
        for module, method in patched:
            delattr(module, method)


def layer_stats(calls):
    """The recorded calls as the JAX dump's `layer_stats`."""
    stats = {}
    for path, outs in calls.items():
        collect_stats(outs, f"{path}/__call__" if path else "__call__",
                      stats)
    return stats


def load_fixture_points(dataset: str):
    """The reference's committed real scene through the deterministic test
    pipeline (GlobalAlignment for ScanNet; no augmentation)."""
    from ..data import (SCANNET_CLASSES, SUNRGBD_CLASSES, Compose,
                        GlobalAlignment, IndoorDetDataset)

    root = os.path.join(REF_FIXTURES, dataset)
    if not os.path.isdir(root):
        raise FileNotFoundError(
            f"the reference's fixture scene is not here: no directory "
            f"{root}; pass a cloud with --points")
    infos = {
        "scannet": ("scannet_infos.pkl", SCANNET_CLASSES, 6),
        "sunrgbd": ("sunrgbd_infos.pkl", SUNRGBD_CLASSES, 6),
    }[dataset]
    ds = IndoorDetDataset(
        root, os.path.join(root, infos[0]), infos[1],
        pipeline=Compose([GlobalAlignment()]) if dataset == "scannet" else None,
        load_dim=infos[2], test_mode=True,
    )
    sample = ds.get_sample(0, np.random.default_rng(0))
    return sample["points"]


def run_dump(args):
    cfg = getattr(configs, args.config or f"fcaf3d_{args.dataset}")()
    # exact reference op ordering: conv all children -> union add -> prune
    cfg = dataclasses.replace(cfg, neck_mode="reference",
                              compute_dtype="float32")
    device = torch.device(args.device)
    model = FCAF3D(cfg, device=device)

    if args.points:
        pts = np.fromfile(args.points, np.float32).reshape(-1, args.load_dim)
    else:
        pts = load_fixture_points(args.dataset)
    rng = np.random.RandomState(0)
    n = cfg.num_points
    idx = rng.choice(len(pts), n, replace=len(pts) < n)
    pts = pts[idx]
    points = torch.as_tensor(pts[None, :, :3], device=device)
    colors = (torch.as_tensor(pts[None, :, 3:6], device=device)
              if pts.shape[1] >= 6 else
              torch.zeros((1, n, 3), dtype=torch.float32, device=device))
    valid = torch.ones((1, n), dtype=torch.bool, device=device)

    if args.params:
        with open(args.params, "rb") as f:
            loaded = pickle.load(f)  # a file this project's tools wrote
        variables = {"params": loaded["params"],
                     "batch_stats": loaded.get("batch_stats", {})}
    else:
        print("no --params: the seeded init_variables draw (harness smoke "
              "mode)")
        variables = init_variables(cfg, 0)
    load_variables(model, variables)
    model.eval()

    with torch.inference_mode(), recorded_calls(model) as calls:
        outs, _ = model(points, colors, valid)
        dets = fcaf3d_get_bboxes(outs, infer_config(cfg))
    stats = layer_stats(calls)

    keep = _host(dets.valid[0])
    scores = _host(dets.scores[0])[keep]
    order = np.argsort(-scores)
    dump = {
        "config": f"fcaf3d_{args.dataset}",
        "layer_stats": stats,
        "detections": {
            "boxes": _host(dets.boxes[0])[keep][order].tolist(),
            "scores": scores[order].tolist(),
            "labels": _host(dets.labels[0])[keep][order].tolist(),
        },
    }
    if args.dump:
        with open(args.dump, "w") as f:
            json.dump(dump, f, indent=1)
        print(f"wrote {args.dump} ({len(stats)} layer records, "
              f"{int(keep.sum())} detections)")
    else:
        for k in sorted(stats):
            print(k, stats[k])
    return dump


def run_diff(path_a, path_b, rtol):
    with open(path_a) as f:
        a = json.load(f)
    with open(path_b) as f:
        b = json.load(f)
    worst = (0.0, None)
    missing = []
    for k, sa in a["layer_stats"].items():
        sb = b["layer_stats"].get(k)
        if sb is None:
            missing.append(k)
            continue
        for field in ("mean", "std", "absmax"):
            if field not in sa or field not in sb:
                continue
            denom = max(abs(sa[field]), abs(sb[field]), 1e-6)
            rel = abs(sa[field] - sb[field]) / denom
            if rel > worst[0]:
                worst = (rel, f"{k}.{field}: {sa[field]:.6g} vs {sb[field]:.6g}")
    na = len(a["detections"]["scores"])
    nb = len(b["detections"]["scores"])
    print(f"layers compared: {len(a['layer_stats']) - len(missing)}, "
          f"missing in b: {len(missing)}")
    print(f"detections: {na} vs {nb}")
    if worst[1]:
        print(f"worst layer-stat deviation: {worst[0]:.3e} ({worst[1]})")
    ok = worst[0] <= rtol and na == nb
    print("PARITY OK" if ok else "PARITY FAIL")
    return 0 if ok else 1


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--params", default=None,
                    help="converted checkpoint pickle (convert_checkpoint)")
    ap.add_argument("--dataset", default="scannet",
                    choices=("scannet", "sunrgbd", "s3dis"))
    ap.add_argument("--config", default=None,
                    help="config factory override (e.g. fcaf3d_tiny)")
    ap.add_argument("--points", default=None,
                    help="override: raw .bin point file instead of fixture")
    ap.add_argument("--load-dim", type=int, default=6, dest="load_dim")
    ap.add_argument("--dump", default=None, help="output JSON path")
    ap.add_argument("--diff", nargs=2, metavar=("A", "B"),
                    help="compare two dumps instead of running")
    ap.add_argument("--rtol", type=float, default=1e-3)
    ap.add_argument("--export-points", default=None, metavar="OUT.bin",
                    help="write the sampled fixture scene as a flat f32 "
                    "[N, 6] .bin and exit; feed the SAME file to the "
                    "reference side's dump so that both dumps consume "
                    "bit-identical inputs")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default the card)")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.diff:
        sys.exit(run_diff(args.diff[0], args.diff[1], args.rtol))
    if args.export_points:
        pts = load_fixture_points(args.dataset)
        rng = np.random.RandomState(0)
        cfg = getattr(configs, args.config or f"fcaf3d_{args.dataset}")()
        idx = rng.choice(len(pts), cfg.num_points,
                         replace=len(pts) < cfg.num_points)
        out = np.zeros((cfg.num_points, 6), np.float32)
        out[:, :pts.shape[1]] = pts[idx][:, :6]
        out.tofile(args.export_points)
        print(f"wrote {args.export_points} ({cfg.num_points} x 6 f32)")
        return
    run_dump(args)


if __name__ == "__main__":
    main()
