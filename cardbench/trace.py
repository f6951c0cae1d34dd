"""What a traced run reads, from the benchmark's own files: host-clock
spans around the calls into the port's layers, and the device's kernels
from `torch.profiler`.

Spans: forward hooks on the model (its forward), a wrapper around the
train step's loss function as `train.trainer` looks it up, and one around
the optimizer's `step`; backward is the time between the loss's end and
the optimizer's start. Each boundary synchronises the device, so a span is
the device work and the host work between its ends. A span is recorded
only while `Spans.on` is set."""
from __future__ import annotations

import collections
import contextlib
import time
from typing import Callable, Dict, List, Optional, Tuple


class Spans:
    def __init__(self, sync: Callable[[], None],
                 clock: Callable[[], float] = time.perf_counter):
        self.sync, self.clock = sync, clock
        self.on = False
        self.total: Dict[str, float] = collections.defaultdict(float)
        self.count: Dict[str, int] = collections.defaultdict(int)
        self._open: Dict[str, float] = {}
        self.marks: Dict[str, float] = {}

    def now(self) -> float:
        self.sync()
        return self.clock()

    def begin(self, name: str) -> None:
        if self.on:
            self._open[name] = self.now()

    def end(self, name: str) -> None:
        if self.on and name in self._open:
            t = self.now()
            self.total[name] += t - self._open.pop(name)
            self.count[name] += 1
            self.marks[name] = t

    def between(self, name: str, since: str) -> None:
        """Record `name` from the last end of `since` to now."""
        if self.on and since in self.marks:
            t = self.now()
            self.total[name] += t - self.marks.pop(since)
            self.count[name] += 1

    def mean_ms(self, name: str) -> Optional[float]:
        n = self.count.get(name, 0)
        return self.total[name] / n * 1e3 if n else None


def hook_model(model, spans: Spans) -> None:
    model.register_forward_pre_hook(lambda m, a: spans.begin("forward"))
    model.register_forward_hook(lambda m, a, o: spans.end("forward"))


@contextlib.contextmanager
def wrapped(owner, attr: str, before: Callable[[], None],
            after: Callable[[], None]):
    """`owner.attr` wrapped by `before()` and `after()` calls."""
    fn = getattr(owner, attr)

    def call(*args, **kwargs):
        before()
        try:
            return fn(*args, **kwargs)
        finally:
            after()

    setattr(owner, attr, call)
    try:
        yield
    finally:
        if owner.__dict__.get(attr) is call:
            setattr(owner, attr, fn)


@contextlib.contextmanager
def train_spans(model, optimizer, trainer_module, loss_name: str,
                spans: Spans):
    """forward, loss, backward and optimizer spans of a train step."""
    hook_model(model, spans)

    def opt_begin():
        spans.between("backward", "loss")
        spans.begin("optimizer")

    with wrapped(trainer_module, loss_name, lambda: spans.begin("loss"),
                 lambda: spans.end("loss")), \
            wrapped(optimizer, "step", opt_begin,
                    lambda: spans.end("optimizer")):
        yield


def _is_kernel(e) -> bool:
    """A kernel on the device: not a copy, a fill or an annotation range
    that the profiler draws on the device's timeline."""
    if "cuda" not in str(e.device_type()).lower():
        return False
    kind = e.activity_type() if hasattr(e, "activity_type") else None
    if kind is not None:
        return str(kind) == "kernel"
    return not (e.is_user_annotation()
                or e.name().startswith(("Memcpy", "Memset")))


def kernel_events(prof) -> List[Tuple[str, int, int]]:
    """(name, start ns, end ns) of every kernel the profiler saw on the
    device (copies, fills and annotations left out), by start."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if not _is_kernel(e):
            continue
        name = e.name()
        start = e.start_ns()
        out.append((name, start, start + e.duration_ns()))
    return sorted(out, key=lambda k: k[1])


def host_events(prof) -> List[Tuple[str, int, int]]:
    """(name, start ns, end ns) of the host's operator events."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if "cpu" not in str(e.device_type()).lower():
            continue
        start = e.start_ns()
        out.append((e.name(), start, start + e.duration_ns()))
    return out


def busy_ns(kernels: List[Tuple[str, int, int]], lo: int, hi: int) -> int:
    """Nanoseconds of [lo, hi) in which some kernel ran: the union of the
    kernels' intervals."""
    total, cur_lo, cur_hi = 0, None, None
    for _, s, e in kernels:
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if cur_hi is None or s > cur_hi:
            if cur_hi is not None:
                total += cur_hi - cur_lo
            cur_lo, cur_hi = s, e
        else:
            cur_hi = max(cur_hi, e)
    if cur_hi is not None:
        total += cur_hi - cur_lo
    return total


def kernel_seconds(kernels, patterns: List[str]) -> float:
    """Summed device seconds of the kernels whose name holds a pattern."""
    return sum(e - s for n, s, e in kernels
               if any(p in n for p in patterns)) / 1e9


def top_kernels(kernels, n: int = 10) -> List[list]:
    by = collections.defaultdict(int)
    for name, s, e in kernels:
        by[name] += e - s
    return [[k, v / 1e9] for k, v in sorted(by.items(),
                                            key=lambda kv: -kv[1])[:n]]


def idle_gaps(kernels, hosts, lo: int, hi: int, n: int = 10) -> List[list]:
    """The device's idle time in [lo, hi), summed by what the host was
    doing at each gap's middle (the innermost host operator covering it,
    or "host python" where none does), the `n` largest."""
    gaps, cur = [], lo
    for _, s, e in kernels:
        if s > cur:
            gaps.append((cur, min(s, hi)))
        cur = max(cur, e)
        if cur >= hi:
            break
    if cur < hi:
        gaps.append((cur, hi))
    hosts = sorted(hosts, key=lambda h: h[1])
    by = collections.defaultdict(int)
    active, i = [], 0
    for g0, g1 in gaps:  # in time order: sweep the host events
        if g1 <= g0:
            continue
        mid = (g0 + g1) // 2
        while i < len(hosts) and hosts[i][1] <= mid:
            active.append(hosts[i])
            i += 1
        active = [h for h in active if h[2] > mid]
        label = (min(active, key=lambda h: h[2] - h[1])[0] if active
                 else "host python")
        by[label] += g1 - g0
    return [[k, v / 1e9] for k, v in sorted(by.items(),
                                            key=lambda kv: -kv[1])[:n]]
