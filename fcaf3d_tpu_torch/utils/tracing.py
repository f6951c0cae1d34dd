"""Spans and counters of the port's layers, for profiling a training run or
an evaluation.

Tracing is off by default. Off, `span()` and `item()` return one shared
null context and `count()` returns at once: the calls placed in the models,
the train steps and the evaluation loop cost nothing, launch nothing and
never wait on the device. `enable()` turns them on:

- `span(name)` records (id, parent id, item id, name, thread, t0_ns, t1_ns)
  and the counters attached to it, and enters
  `torch.profiler.record_function(name)`, so the range also shows in a
  profiler trace and an exported Chrome trace. t0 / t1 are
  `time.time_ns()`, the Unix-epoch nanoseconds on which the profiler
  stamps its events, so the records line up with its kernels and runtime
  calls. A span never synchronises the device.
- `item()` marks one train step or one evaluation batch; the spans opened
  inside it carry its id.
- `count(name, value)` adds `value` (a number, a list, or a tensor, which
  may live on the device) to the innermost open span of the thread. A
  tensor is kept as it is and read only by `drain()`, so counting adds no
  host wait; a value that needs a kernel of its own is computed only under
  `if tracing.enabled():`.
- `drain()` reads the counters, returns the finished spans and forgets
  them.

The spans of the port: FCAF3D's forward `voxelize`, `backbone`,
`neck_head`; its post-processing `get_bboxes` (with `nms` inside) and
`to_numpy`; VoteNet's forward `backbone`, `vote_head`; a train step's
`forward`, `loss`, `backward`, `all_reduce_grads` and `optimizer`. The
counters `budget_rows` / `valid_rows` of `voxelize` and `backbone` are the
rows of each level's static budget over the batch and the rows that hold a
voxel (one entry a level). The counters `norm_budget_rows` / `norm_rows`
(`ops/sparse/masked_norm.py`, kernel K7 on the card) are the rows each
norm call was launched over and the valid rows its kernels touched,
summed over the calls in the span open at each (`backbone`, `neck_head`):
how far K7's skipping of the padding engages. The counter
`const_table_builds` (`ops/sparse/tables.py`) is the constant tables the
sparse ops made in the span (`voxelize`, `backbone`, `neck_head`): the
distinct tables on a device's first forward, 0 after. The autograd engine
runs the backward on a thread of its own; its kernels fall inside the
caller's `backward` span by time.

`profiled(n, path)` runs a block with its first `n` items under
`torch.profiler` and tracing on, and writes their Chrome trace to `path`
(the `--profile-steps` / `--profile-out` options of `tools.train` and
`tools.test`).
"""
from __future__ import annotations

import contextlib
import functools
import itertools
import threading
import time
from typing import Any, Dict, Iterator, List, NamedTuple, Optional

import torch

_NULL = contextlib.nullcontext()
_on = False
_ids = itertools.count(1)
_item_ids = itertools.count(1)
_records: List["Span"] = []
_local = threading.local()
# the window `profiled` armed, while it has one
_window: Optional["_Window"] = None


class Span(NamedTuple):
    id: int
    parent: Optional[int]  # the enclosing span's id on the same thread
    item: Optional[int]  # the enclosing `item()`'s id
    name: str
    thread: int
    t0_ns: int
    t1_ns: int
    counters: Dict[str, Any]


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def enabled() -> bool:
    return _on


def _open() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Span:
    __slots__ = ("name", "id", "parent", "item", "t0", "counters", "rf")

    def __init__(self, name: str):
        self.name, self.counters = name, {}

    def __enter__(self):
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        stack = _open()
        self.id = next(_ids)
        self.parent = stack[-1].id if stack else None
        self.item = getattr(_local, "item", None)
        stack.append(self)
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.time_ns()
        _open().pop()
        _records.append(Span(self.id, self.parent, self.item, self.name,
                             threading.get_ident(), self.t0, t1,
                             self.counters))
        self.rf.__exit__(*exc)
        return False


def span(name: str):
    """A context that records `name`'s time on the host while tracing is
    on; the shared null context while it is off."""
    return _Span(name) if _on else _NULL


def spanned(name: str):
    """Decorator: each call of the function runs inside `span(name)`."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not _on:
                return fn(*args, **kwargs)
            with _Span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


class _Item:
    __slots__ = ("prev",)

    def __enter__(self):
        self.prev = getattr(_local, "item", None)
        _local.item = next(_item_ids)
        if _window is not None and _window.prof is None:
            _window.start()
        return self

    def __exit__(self, *exc):
        _local.item = self.prev
        if _window is not None and _window.prof is not None:
            _window.left -= 1
            if _window.left <= 0:
                _close_window()
        return False


def item():
    """A context around one train step or evaluation batch: the spans
    opened inside carry its id. The null context while tracing is off."""
    return _Item() if _on else _NULL


def count(name: str, value) -> None:
    """Add `value` to counter `name` of the thread's innermost open span
    (nothing while tracing is off, or outside every span)."""
    if not _on:
        return
    stack = _open()
    if not stack:
        return
    if torch.is_tensor(value):
        value = value.detach()
    counters = stack[-1].counters
    counters[name] = counters[name] + value if name in counters else value


def _read(value):
    return value.tolist() if torch.is_tensor(value) else value


def drain() -> List[Span]:
    """The finished spans in order of their start, counters read; the
    record is cleared."""
    out = sorted(_records, key=lambda s: (s.t0_ns, s.id))
    _records.clear()
    return [s._replace(counters={k: _read(v) for k, v in s.counters.items()})
            for s in out]


class _Window:
    """The items `profiled` profiles: how many are left, the trace's path,
    the profile once the first item starts, whether tracing was on
    before."""

    def __init__(self, n: int, path: str, was_on: bool):
        self.left, self.path, self.was_on, self.prof = n, path, was_on, None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.__enter__()


def _close_window() -> None:
    """End the profile (if it started), write its trace, and put tracing
    back as it was."""
    global _window
    window, _window = _window, None
    if window is None:
        return
    if window.prof is not None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        window.prof.__exit__(None, None, None)
        window.prof.export_chrome_trace(window.path)
    if not window.was_on:
        disable()
        drain()


def add_profile_arguments(parser, items: str) -> None:
    """Attach a CLI's `--profile-steps N` and `--profile-out FILE`
    (`profiled`); `items` names what N counts."""
    parser.add_argument(
        "--profile-steps", type=int, default=0, metavar="N",
        help=f"run the first N {items} under torch.profiler with the "
             "port's spans on, and write their Chrome trace to "
             "--profile-out (rank 0 alone under torchrun)")
    parser.add_argument(
        "--profile-out", default=None, metavar="FILE",
        help="the Chrome trace file of --profile-steps (JSON; open it in "
             "Perfetto or chrome://tracing)")


@contextlib.contextmanager
def profiled(n_items: int, path: Optional[str]) -> Iterator[None]:
    """Run the block with its first `n_items` items (`item()`: train steps,
    evaluation batches) under `torch.profiler` and tracing on, and write
    their Chrome trace to `path` when the last of them ends, or when the
    block does. With `n_items` 0 the block runs as it is."""
    global _window
    if not n_items:
        yield
        return
    if path is None:
        raise ValueError("profiling needs a path for the trace")
    _window = _Window(n_items, path, _on)
    enable()
    try:
        yield
    finally:
        _close_window()
