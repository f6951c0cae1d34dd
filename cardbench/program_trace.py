"""What the port's own spans and counters say of a profiled segment: the
records of `fcaf3d_tpu_torch.utils.tracing` laid over the profiler's
kernels and runtime calls, on the one clock they share.

`segment(call, batches, sync)` runs `call(batch)` for each batch, each
inside `tracing.item()`, under `torch.profiler` with the port's tracing
on; `read(seg)` charges to each span name, a step or request:

- device ms: each kernel's duration, to the innermost span open when its
  launch call started (the runtime call that shares the kernel's
  correlation id; kernels the autograd engine launches from its own thread
  fall inside the caller's `backward` span by time);
- idle ms: each gap between kernels (the union of their intervals, as
  `device_idle` counts it), to the innermost span open at the gap's
  middle, or to `outside`;
- launches: the kernels so charged;
- host waits: synchronise calls, and copy calls whose copy on the device
  runs device to host (a blocking copy and the synchronise that completes
  it count once);
- the spans' counters, summed (a list entry by entry: one entry a level).

Each name carries its numbers with its children's (`total`) and without
(`self`); the `self` numbers of every name and `outside` add up to the
segment's. `metrics(prog, mode)` gives the per-layer metrics that read
them, `value(run, name)` one of them from a run record. The arithmetic
lives here, so an edit to the port moves these numbers only by what it
changes in the program, or by moving a span.
"""
from __future__ import annotations

import bisect
import collections
import re
import time
from typing import Callable, Dict, List, Optional, Sequence

from . import trace

# the CUDA runtime's and driver's calls (cudaLaunchKernel, cuLaunchKernel)
API = re.compile(r"cu(da)?[A-Z]")
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
         "cudaEventSynchronize")
FIELDS = ("device_ms", "idle_ms", "launches", "waits")


def segment(call: Callable, batches: Sequence, sync) -> dict:
    """`call(batch)` for each batch, each a `tracing.item()`, under
    torch.profiler with the port's tracing on: {"n", "window_s",
    "events": `events(prof)`, "spans": the drained records}."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from fcaf3d_tpu_torch.utils import tracing

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    tracing.drain()
    sync()
    tracing.enable()
    try:
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for batch in batches:
                with tracing.item():
                    call(batch)
            sync()
            window = time.perf_counter() - t0
    finally:
        tracing.disable()
    return {"n": len(batches), "window_s": window, "events": events(prof),
            "spans": [s._asdict() for s in tracing.drain()]}


def events(prof) -> dict:
    """The profile as `read` takes it: kernels and copies on the device
    (name, start, end, corr), the CUDA runtime's and driver's calls (name,
    start, end, corr, thread), and the profile's first and last ns. A
    device event and the call that launched it share a correlation id."""
    kernels, copies, runtime = [], [], []
    lo, hi = None, None
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        end = start + e.duration_ns()
        lo = start if lo is None else min(lo, start)
        hi = end if hi is None else max(hi, end)
        row = (e.name(), start, end, e.correlation_id())
        if "cuda" in str(e.device_type()).lower():
            if trace._is_kernel(e):
                kernels.append(row)
            elif e.name().startswith("Memcpy"):
                copies.append(row)
        elif API.match(e.name()):
            runtime.append(row + (e.start_thread_id(),))
    return {"kernels": kernels, "copies": copies,
            "runtime": sorted(runtime, key=lambda r: r[1]), "lo": lo,
            "hi": hi}


def _owners(spans: List[dict]):
    """(boundaries, owner): from boundaries[i] on, until the next, the id
    of the innermost span open (the latest started), or None."""
    points = sorted({s["t0_ns"] for s in spans} | {s["t1_ns"] for s in spans})
    owner = []
    for p in points:
        open_ = [s for s in spans if s["t0_ns"] <= p < s["t1_ns"]]
        owner.append(max(open_, key=lambda s: (s["t0_ns"], s["id"]))["id"]
                     if open_ else None)
    return points, owner


def _gaps(kernels, lo: int, hi: int):
    """The device's idle intervals in [lo, hi): between the union of the
    kernels' intervals."""
    out, cur = [], lo
    for _, s, e, _ in sorted(kernels, key=lambda k: k[1]):
        if s > cur:
            out.append((cur, min(s, hi)))
        cur = max(cur, e)
        if cur >= hi:
            break
    if cur < hi:
        out.append((cur, hi))
    return [(a, b) for a, b in out if b > a]


def _waits(runtime, copies) -> list:
    """The runtime calls that wait on the device: synchronises, and copy
    calls whose device copy runs device to host; a synchronise right after
    such a copy on the same thread is the copy's own wait."""
    dtoh = {c[3] for c in copies if "DtoH" in c[0]}
    out, last = [], {}
    for call in sorted(runtime, key=lambda r: r[1]):
        name, thread = call[0], call[4]
        is_copy = "Memcpy" in name and call[3] in dtoh
        if is_copy or (name in SYNCS and not last.get(thread)):
            out.append(call)
        last[thread] = is_copy
    return out


def read(seg: dict) -> dict:
    """The segment's numbers a step or request: {"items", "idle_ms",
    "device_ms", "launches", "waits", "unlinked" (kernels whose launch
    was not found, charged at their start), "spans": {name: {"calls",
    "host_ms", "total": {field}, "self": {field}, "counters"}}, "outside":
    {field}}."""
    ev, spans, n = seg["events"], seg["spans"], seg["n"]
    by_id = {s["id"]: s for s in spans}
    points, owner = _owners(spans)

    def at(t: int) -> Optional[int]:
        i = bisect.bisect_right(points, t) - 1
        return owner[i] if i >= 0 else None

    self_ = collections.defaultdict(lambda: dict.fromkeys(FIELDS, 0.0))

    def charge(t, field, value):
        self_[at(t)][field] += value

    launch_at = {r[3]: r[1] for r in ev["runtime"]}
    unlinked = 0
    for _, s, e, corr in ev["kernels"]:
        t = launch_at.get(corr)
        if t is None:
            unlinked += 1
            t = s
        charge(t, "device_ms", (e - s) / 1e6)
        charge(t, "launches", 1)
    idle = 0.0
    if ev["kernels"]:
        for a, b in _gaps(ev["kernels"], ev["lo"], ev["hi"]):
            charge((a + b) // 2, "idle_ms", (b - a) / 1e6)
            idle += (b - a) / 1e6
    waits = _waits(ev["runtime"], ev["copies"])
    for call in waits:
        charge(call[1], "waits", 1)

    names: Dict[str, dict] = {}
    for s in spans:
        d = names.setdefault(s["name"], {
            "calls": 0, "host_ms": 0.0,
            "total": dict.fromkeys(FIELDS, 0.0),
            "self": dict.fromkeys(FIELDS, 0.0), "counters": {}})
        d["calls"] += 1
        d["host_ms"] += (s["t1_ns"] - s["t0_ns"]) / 1e6
        for k, v in s["counters"].items():  # lists add entry by entry
            have = d["counters"].get(k)
            d["counters"][k] = v if have is None else (
                [a + b for a, b in zip(have, v)] if isinstance(v, list)
                else have + v)
    for sid, f in self_.items():
        if sid is None:
            continue
        own = names[by_id[sid]["name"]]["self"]
        for k in FIELDS:
            own[k] += f[k]
        seen, cur = set(), sid
        while cur is not None:  # the span and its ancestors, a name once
            name = by_id[cur]["name"]
            if name not in seen:
                seen.add(name)
                tot = names[name]["total"]
                for k in FIELDS:
                    tot[k] += f[k]
            cur = by_id[cur]["parent"]

    def per(d: dict) -> dict:
        return {k: [x / n for x in v] if isinstance(v, list) else v / n
                for k, v in d.items()}

    out = {"items": n, "idle_ms": idle / n,
           "device_ms": sum((e - s) for _, s, e, _ in ev["kernels"])
           / 1e6 / n,
           "launches": len(ev["kernels"]) / n, "waits": len(waits) / n,
           "unlinked": unlinked,
           "outside": per(self_.get(None, dict.fromkeys(FIELDS, 0.0))),
           "spans": {}}
    for name, d in names.items():
        out["spans"][name] = {
            "calls": d["calls"] / n, "host_ms": d["host_ms"] / n,
            "total": per(d["total"]), "self": per(d["self"]),
            "counters": per(d["counters"])}
    return out


def _total(prog: dict, name: str, field: str) -> float:
    s = prog["spans"].get(name)
    return s["total"][field] if s else 0.0


def _fill(prog: dict) -> Optional[float]:
    """% of the budgets' rows (input voxels and backbone levels) that hold
    a voxel."""
    budget = valid = 0
    for name in ("voxelize", "backbone"):
        c = prog["spans"].get(name, {}).get("counters", {})
        budget += sum(c.get("budget_rows", []))
        valid += sum(c.get("valid_rows", []))
    return 100.0 * valid / budget if budget else None


def value(run: dict, name: str) -> Optional[float]:
    """Metric `name` of a run record holding `run["program"]` (`read` of
    its segment) and `run["mode"]`; None where the run has no spans."""
    prog = run.get("program")
    return None if prog is None else metrics(prog, run["mode"]).get(name)


def metrics(prog: dict, mode: str) -> Dict[str, float]:
    """The per-layer metrics of a segment read by `read`, a step (mode
    "train") or request ("infer"); a metric whose spans the segment lacks
    is left out."""
    spans = prog["spans"]
    if mode == "infer":
        if "get_bboxes" not in spans:
            return {}
        out = {f"{n}_idle_ms.infer": _total(prog, n, "idle_ms")
               for n in ("voxelize", "backbone", "neck_head")}
        out["postproc_idle_ms.infer"] = (_total(prog, "get_bboxes",
                                                "idle_ms")
                                         + _total(prog, "to_numpy",
                                                  "idle_ms"))
        out["nms_launches.infer"] = _total(prog, "nms", "launches")
        out["host_waits.infer"] = prog["waits"]
        fill = _fill(prog)
        if fill is not None:
            out["budget_fill.infer"] = fill
        return out
    if "optimizer" not in spans:
        return {}
    out = {f"{n}_idle_ms.train": _total(prog, n, "idle_ms")
           for n in ("forward", "loss", "backward", "optimizer")}
    out["optimizer_launches.train"] = _total(prog, "optimizer", "launches")
    out["host_waits.train"] = prog["waits"]
    fill = _fill(prog)
    if fill is not None:
        out["budget_fill.train"] = fill
    return out
