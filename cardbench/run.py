"""Run one cell of the benchmark once and print its result line.

    python -m cardbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for. Set-up draws the weights on the card and builds the cell's pool of
batches from the seed, builds the port's entry and warms it up on the
pool; the window then drives it in a closed loop for `--seconds`; after
the window the port's state is freed and the reference (`cardbench.ref`)
recomputes what the window's entry produced, which decides `correct`.
With `--trace 0` the line carries the cell's end-to-end metrics, with
`--trace 1` its per-layer metrics, the device's busy and window seconds
and a breakdown. The numbers compared with the reference, each beside its
limit, are the last lines on standard error and the line's last key.
"""
from __future__ import annotations

import os
import time


def _process_age() -> float:
    """Seconds since this process started (its start time in /proc)."""
    with open("/proc/self/stat") as f:
        stat = f.read()
    start_ticks = int(stat[stat.rindex(")") + 2:].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


STARTED = time.perf_counter() - _process_age()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from typing import Callable, Dict, List, Optional  # noqa: E402

HERE = pathlib.Path(__file__).resolve().parent
# caches of compilers the port may use, at fixed paths inside the checkout
CACHE = HERE / "_cache"
CACHE_VARS = {"TRITON_CACHE_DIR": "triton",
              "TORCH_EXTENSIONS_DIR": "torch_extensions",
              "CUDA_CACHE_PATH": "nv",
              "PYTORCH_KERNEL_CACHE_PATH": "torch_kernels"}
for _var, _dir in CACHE_VARS.items():
    os.environ[_var] = str(CACHE / _dir)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from . import checks, spec, trace, work  # noqa: E402
from .families import common  # noqa: E402
from .ref import precision, record  # noqa: E402
from .traffic.generator import make_pool  # noqa: E402
from .window import request_loop, train_loop  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "fcaf3d_tpu")
# a traced run's window: a share untraced (the MFU's rate), a share under
# spans; then the mix's profiled steps or requests under torch.profiler
PLAIN_SHARE, SPAN_SHARE = 0.5, 0.5


class NoCards(RuntimeError):
    pass


def make_caches() -> None:
    """Create the cache directories, which the compilers only fill."""
    for var in CACHE_VARS:
        os.makedirs(os.environ[var], exist_ok=True)


def require_cards(n: int):
    """The first CUDA device's name; raises NoCards unless `n` devices
    are there."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < n:
        raise NoCards(f"the cell needs {n} CUDA device(s); "
                      f"{torch.cuda.device_count()} available")
    return torch.cuda.get_device_name(0)


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def power_limit() -> Optional[str]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        and out.stdout.strip() else None


def _sync_fn(device):
    if str(device).startswith("cuda"):
        return torch.cuda.synchronize
    return lambda: None


def release():
    """Return what the freed port state held to the device."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def _peak_reset(device):
    if str(device).startswith("cuda"):
        torch.cuda.reset_peak_memory_stats()


def _peak_bytes(device) -> int:
    if str(device).startswith("cuda"):
        return int(torch.cuda.max_memory_allocated())
    return 0


def profiled(work: Callable[[], int], sync) -> dict:
    """`work()` (returning the steps or requests it made) under
    torch.profiler: {"n", "window_s", "kernels", "hosts"}."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    sync()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        n = work()
        sync()
        window = time.perf_counter() - t0
    return {"n": n, "window_s": window, "kernels": trace.kernel_events(prof),
            "hosts": trace.host_events(prof)}


def device_numbers(prof: dict, tables: Dict[str, List[str]]) -> dict:
    """What the profiled segment says of the device: busy and window
    seconds, kernel seconds a step or request by table, launches a step or
    request, and the breakdown."""
    kernels, hosts, n = prof["kernels"], prof["hosts"], prof["n"]
    if not kernels:
        return {}
    events = kernels + hosts
    lo = min(e[1] for e in events)
    hi = max(e[2] for e in events)
    busy = trace.busy_ns(kernels, lo, hi) / 1e9
    return {
        "busy_s": busy,
        "window_s": prof["window_s"],
        "per_item_s": {name: trace.kernel_seconds(kernels, pats) / n
                       for name, pats in tables.items()},
        "launches_per_item": len(kernels) / n,
        "breakdown": {"device_ops": trace.top_kernels(kernels),
                      "idle_gaps": trace.idle_gaps(kernels, hosts, lo, hi)},
    }


def program_steps(fam, config: dict, tree: dict, pool: list, checked: int,
                  device):
    """The port's train-step object, built from the drawn weights and
    driven through its first `checked` steps on pool[0..checked) (the
    window's own call and feed, rows all new): (model, optimizer, step,
    readings {"losses", "grad": the first gradient's leaf norms as the
    optimizer takes it, "change": the leaves' change norms})."""
    model, opt, step = fam.program_train(config, tree, device)
    start = common.params_copy(model)
    grad = {}

    def take_grad():
        grad.update(common.clipped_grad_norms(
            model, config["config"]["grad_clip"]))

    with trace.wrapped(opt, "step", take_grad, lambda: None):
        losses = [step(pool[0])["loss"]]
    losses += [step(pool[i])["loss"] for i in range(1, checked)]
    change = common.change_norms(model, start)
    del start
    prog = {"losses": [float(x) for x in losses],
            "grad": {k: float(v) for k, v in grad.items()},
            "change": {k: float(v) for k, v in change.items()}}
    return model, opt, step, prog


def train_cell(cell: dict, fam, pool: list, tree: dict, seed: int,
               seconds: float, traced: bool, device) -> dict:
    import fcaf3d_tpu_torch.train.trainer as trainer_module
    traffic, config = cell["traffic"], cell["config"]
    sync = _sync_fn(device)
    checked = traffic["checked_steps"]
    model, opt, step, prog = program_steps(fam, config, tree, pool,
                                           checked, device)
    sync()
    run = {"mode": "train", "batch": traffic["batch"],
           "setup_s": time.perf_counter() - STARTED}
    _peak_reset(device)
    if not traced:
        run["window"] = train_loop(step, pool, checked, seconds, sync)
    else:
        seg = train_loop(step, pool, checked, seconds * PLAIN_SHARE, sync)
        run["window"] = seg
        spans = trace.Spans(sync)
        with trace.train_spans(model, opt, trainer_module, fam.LOSS, spans):
            spans.on = True
            train_loop(step, pool, checked + seg["steps"],
                       seconds * SPAN_SHARE, sync)
            spans.on = False
        run["spans"] = {k: spans.mean_ms(k) for k in spans.count}
        n_prof = traffic["profiled_steps"]

        def work():
            for i in range(n_prof):
                step(pool[i % len(pool)])
            return n_prof

        run["device"] = device_numbers(profiled(work, sync),
                                       spec.kernel_tables())
    run["peak_bytes"] = _peak_bytes(device)
    del model, opt, step
    release()
    t0 = time.perf_counter()
    with precision.operands("float32"), record.calls() as rec:
        ref = fam.ref_train(config, tree, pool[:checked], device)
    run["reference_s"] = time.perf_counter() - t0
    run["readings"] = checks.train_readings(prog, ref)
    run["work"] = _work(rec.records, config, checked, train=True)
    return run


def _work(records, config, items, train) -> dict:
    """Model FLOPs and the sparse convolutions' least seconds a step or
    request, from the reference's records over `items` of them."""
    card = spec.peaks()["cards"]["H100"]
    dtype = config["config"].get("compute_dtype", "float32")
    elt = work.DTYPE_BYTES[dtype]
    return {
        "flops": work.model_flops(records, train) / items,
        "sparse_conv_bound_s": work.sparse_conv_bound(
            records, elt, card["flops"][dtype], card["hbm_bytes_per_s"])
        / items,
        "dtype": dtype,
    }


def infer_cell(cell: dict, fam, pool: list, tree: dict, seed: int,
               seconds: float, traced: bool, device) -> dict:
    traffic, config = cell["traffic"], cell["config"]
    sync = _sync_fn(device)
    model, request = fam.program_infer(config, tree, device)
    for i in range(traffic["warm_requests"]):
        request(pool[i % len(pool)])
    sync()
    run = {"mode": "infer", "batch": traffic["batch"],
           "setup_s": time.perf_counter() - STARTED}
    _peak_reset(device)
    if not traced:
        win = request_loop(request, pool, 0, seconds, sync)
    else:
        win = request_loop(request, pool, 0, seconds * PLAIN_SHARE, sync)
        spans = trace.Spans(sync)
        trace.hook_model(model, spans)

        def spanned(batch):
            spans.begin("request")
            out = request(batch)
            spans.end("request")
            return out

        spans.on = True
        request_loop(spanned, pool, win["requests"], seconds * SPAN_SHARE,
                     sync, keep=False)
        spans.on = False
        run["spans"] = {k: spans.mean_ms(k) for k in spans.count}
        n_prof = traffic["profiled_requests"]

        def work():
            for i in range(n_prof):
                request(pool[i % len(pool)])
            return n_prof

        run["device"] = device_numbers(profiled(work, sync),
                                       spec.kernel_tables())
    run["window"] = {k: win[k] for k in ("requests", "seconds", "latencies")}
    run["peak_bytes"] = _peak_bytes(device)
    del model, request
    release()
    # a sample of the window's requests, drawn from the seed
    rng = np.random.default_rng([seed, 1])
    k = min(traffic["checked_requests"], len(win["outputs"]))
    picked = sorted(rng.choice(len(win["outputs"]), k, replace=False))
    sample = [win["outputs"][i] for i in picked]
    need = sorted({p for p, _ in sample})
    t0 = time.perf_counter()
    with precision.operands("float32"), record.calls() as rec:
        ref = dict(zip(need, fam.ref_detect(config, tree,
                                            [pool[p] for p in need], device)))
    prog_scans = [s for _, out in sample for s in out]
    ref_scans = [s for p, _ in sample for s in ref[p]]
    run["readings"] = checks.detection_readings(prog_scans, ref_scans)
    run["reference_s"] = time.perf_counter() - t0
    run["work"] = _work(rec.records, config, len(need), train=False)
    return run


def run_cell(cell: dict, seed: int, seconds: float, traced: bool,
             device="cuda") -> dict:
    """One run of `cell` (as `spec.cell` gives it): the run record the
    metric readers read."""
    if cell["limits"] is None:
        raise ValueError(f"cell {cell['name']} has no limits file")
    config, traffic = cell["config"], cell["traffic"]
    fam = spec.family(config["family"])
    pool = [fam.prepare(b) for b in make_pool(traffic, config, seed)]
    tree = fam.draw(config, seed, device)
    drive = {"train": train_cell, "infer": infer_cell}[traffic["mode"]]
    run = drive(cell, fam, pool, tree, seed, seconds, traced, device)
    run.update(cell=cell["name"], config=config, traced=traced)
    run["checks"] = checks.judge(run["readings"], cell["limits"])
    return run


def result_line(cell: dict, run: dict, kind: str) -> dict:
    entries = cell["per_layer"] if run["traced"] else cell["end_to_end"]
    attempted = run["window"].get("steps", run["window"].get("requests"))
    device = {"platform": "gpu", "kind": kind, "count": cell["chips"],
              "memory_peak_bytes": run["peak_bytes"]}
    if run["traced"] and run.get("device"):
        device["busy_s"] = run["device"]["busy_s"]
        device["window_s"] = run["device"]["window_s"]
    line = {"correct": all(c["ok"] for c in run["checks"]),
            "attempted": attempted, "failed": 0,
            "metrics": spec.read_metrics(entries, run), "device": device}
    if run["traced"] and run.get("device"):
        line["breakdown"] = run["device"]["breakdown"]
    line["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                      for c in run["checks"]}
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = spec.cell(args.workload, spec.benchmark())
    make_caches()
    try:
        kind = require_cards(cell["chips"])
    except NoCards as e:
        print(f"cardbench: {e}", file=sys.stderr)
        return 2
    run = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"cardbench: the run imported {found}", file=sys.stderr)
        return 3
    line = result_line(cell, run, kind)
    win = run["window"]
    if "latencies" in win:
        print(f"cardbench: {len(win['latencies'])} requests timed in the "
              f"window", file=sys.stderr)
    print(f"cardbench: card {power_limit()}; the reference's check took "
          f"{run['reference_s']:.1f} s", file=sys.stderr)
    for c in run["checks"]:
        print(f"check {c['name']} {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if c['ok'] else 'FAILED'}", file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
