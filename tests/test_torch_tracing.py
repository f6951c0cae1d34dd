"""The port's spans and counters (`utils/tracing.py`), on the CPU at the
miniature configs: FCAF3D detection, an FCAF3D train step and a VoteNet-v2
train step.

Off, tracing leaves no range in a profile and the operators the same, in
the same order, as with the tracing calls replaced by nothing. On, the
spans nest as the port places them, carry one item id a step or request,
stamp the profiler's clock, and the counters read the voxels each budget
holds.
"""
import contextlib
import dataclasses
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from chip_smoke import TINY_EXTENT, head_batch, vote_head_batch
from fcaf3d_tpu_torch import configs
from fcaf3d_tpu_torch.apis import train as train_api
from fcaf3d_tpu_torch.apis.test import detect_batch, detections_to_numpy
from fcaf3d_tpu_torch.apis.train import train_model
from fcaf3d_tpu_torch.ops.sparse.tensor import voxelize
from fcaf3d_tpu_torch.train import (create_train_state,
                                    create_votenet_train_state,
                                    make_train_step, make_votenet_train_step)
from fcaf3d_tpu_torch.utils import tracing

SPANS = {"voxelize", "backbone", "neck_head", "get_bboxes", "nms",
         "to_numpy", "vote_head", "forward", "loss", "backward",
         "all_reduce_grads", "optimizer"}
TRAIN = [("forward", None), ("loss", None), ("backward", None),
         ("all_reduce_grads", None), ("optimizer", None)]
# (name, parent name) of each span of one step or request, by start
NESTING = {
    "fcaf3d_infer": [("voxelize", None), ("backbone", None),
                     ("neck_head", None), ("get_bboxes", None),
                     ("nms", "get_bboxes"), ("to_numpy", None),
                     ("to_numpy", None)],
    "fcaf3d_train": TRAIN[:1] + [("voxelize", "forward"),
                                 ("backbone", "forward"),
                                 ("neck_head", "forward")] + TRAIN[1:],
    "votenet_train": TRAIN[:1] + [("backbone", "forward"),
                                  ("vote_head", "forward")] + TRAIN[1:],
}
CASES = sorted(NESTING)


@pytest.fixture(autouse=True)
def tracing_off():
    """Every test starts and ends with tracing off and nothing recorded."""
    tracing.disable()
    tracing.drain()
    yield
    tracing.disable()
    tracing.drain()


def _fcaf3d_infer():
    cfg = configs.fcaf3d_nano()
    batch = head_batch(torch, cfg, TINY_EXTENT)
    model, _, _ = create_train_state(cfg, 0, "cpu")
    model.eval()

    @torch.inference_mode()
    def request():
        dets = detect_batch(model, cfg, batch["points"], batch)
        return [detections_to_numpy(dets, j)
                for j in range(batch["points"].shape[0])]

    return model, batch, request


def _fcaf3d_train():
    cfg = configs.fcaf3d_nano()
    batch = head_batch(torch, cfg, TINY_EXTENT)
    model, opt, _ = create_train_state(cfg, 0, "cpu")
    step = make_train_step(model, cfg, opt)
    return model, batch, lambda: step(batch)


def _votenet_train():
    cfg = configs.votenet_tiny()
    batch = vote_head_batch(cfg)
    model, opt, _ = create_votenet_train_state(cfg, 0, "cpu")
    step = make_votenet_train_step(model, cfg, opt)
    return model, batch, lambda: step(batch)


BUILD = {"fcaf3d_infer": _fcaf3d_infer, "fcaf3d_train": _fcaf3d_train,
         "votenet_train": _votenet_train}


@pytest.fixture(scope="module")
def built():
    """Each case built once and run once (the optimizer's moments exist,
    so every later step issues the same operators)."""
    torch.manual_seed(0)
    out = {}
    for case, build in BUILD.items():
        model, batch, run = build()
        run()
        out[case] = (model, batch, run)
    return out


def _profiled(run):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run()
    return list(prof.profiler.kineto_results.events())


def _ops(events):
    return [e.name() for e in sorted(events, key=lambda e: e.start_ns())
            if e.name().startswith("aten::")]


@pytest.mark.parametrize("case", CASES)
def test_tracing_off_adds_no_range_and_no_operator(built, case,
                                                   monkeypatch):
    _, _, run = built[case]
    off = _profiled(run)
    assert not {e.name() for e in off if e.is_user_annotation()} & SPANS
    with monkeypatch.context() as m:
        m.setattr(tracing, "span", lambda name: contextlib.nullcontext())
        m.setattr(tracing, "item", lambda: contextlib.nullcontext())
        m.setattr(tracing, "count", lambda name, value: None)
        m.setattr(tracing, "enabled", lambda: False)
        none = _profiled(run)
    assert _ops(off) == _ops(none)
    assert tracing.drain() == []


@pytest.mark.parametrize("case", CASES)
def test_spans_nest_with_one_item_a_step(built, case):
    _, _, run = built[case]
    tracing.enable()
    for _ in range(2):
        with tracing.item():
            run()
    tracing.disable()
    spans = tracing.drain()
    by_id = {s.id: s for s in spans}
    items = sorted({s.item for s in spans})
    assert len(items) == 2 and None not in items
    for it in items:
        got = [(s.name, by_id[s.parent].name if s.parent else None)
               for s in spans if s.item == it]
        assert got == NESTING[case]
    for s in spans:
        assert s.t0_ns <= s.t1_ns
        if s.parent:
            p = by_id[s.parent]
            assert p.t0_ns <= s.t0_ns and s.t1_ns <= p.t1_ns
            assert p.item == s.item


@pytest.mark.parametrize("case", CASES)
def test_counters_read_the_budgets_rows_at_drain(built, case):
    model, batch, run = built[case]
    levels = []
    hook = model.backbone.register_forward_hook(
        lambda m, a, out: levels.append(out))
    tracing.enable()
    try:
        run()
    finally:
        tracing.disable()
        hook.remove()
    spans = tracing.drain()
    counters = {s.name: s.counters for s in spans if s.counters}
    if case.endswith("train"):  # CPU leaves: the plain loop, none fused
        assert counters.pop("optimizer") == {
            "adamw_leaves": len(list(model.parameters())),
            "adamw_fused_leaves": 0}
    if case.startswith("votenet"):
        assert counters == {}
        return
    cfg = model.cfg
    with torch.no_grad():
        st = voxelize(torch.as_tensor(batch["points"]),
                      torch.as_tensor(batch["colors"]) / 255.0,
                      torch.as_tensor(batch["valid"]),
                      voxel_size=cfg.voxel_size, budget=cfg.input_budget)
    b = batch["points"].shape[0]
    assert counters["voxelize"] == {
        "budget_rows": [b * cfg.input_budget],
        "valid_rows": [int(st.valid.sum())]}
    (feats,) = levels
    assert counters["backbone"] == {
        "budget_rows": [f.keys.numel() for f in feats],
        "valid_rows": [int(f.valid.sum()) for f in feats]}
    for c in counters.values():
        assert all(isinstance(v, int) for vs in c.values() for v in vs)
        assert all(0 < v <= n for v, n in zip(c["valid_rows"],
                                               c["budget_rows"]))


@pytest.mark.parametrize("case", CASES)
def test_spans_stamp_the_profilers_clock(built, case):
    _, _, run = built[case]
    tracing.enable()
    try:
        with tracing.item():
            events = _profiled(run)
    finally:
        tracing.disable()
    spans = tracing.drain()
    ranges = {}
    for e in sorted(events, key=lambda e: e.start_ns()):
        if e.is_user_annotation() and e.name() in SPANS:
            ranges.setdefault(e.name(), []).append(e.start_ns())
    assert sorted(ranges) == sorted({s.name for s in spans})
    for name, starts in ranges.items():
        mine = [s.t0_ns for s in spans if s.name == name]
        assert len(mine) == len(starts)
        for t0, start in zip(mine, starts):
            assert abs(t0 - start) < 1_000_000, (name, t0 - start)


def test_off_returns_one_shared_null_context_and_counts_nothing():
    assert not tracing.enabled()
    assert tracing.span("a") is tracing.span("b") is tracing.item()
    with tracing.span("a"):
        tracing.count("n", torch.ones(()))
    assert tracing.drain() == []
    tracing.enable()
    tracing.count("n", 1)  # outside every span: dropped
    with tracing.span("a"):
        tracing.count("n", torch.tensor(2))
        tracing.count("n", 3)
        with tracing.span("b"):
            tracing.count("m", [1, 2])
    (a, b) = tracing.drain()
    assert (a.name, a.counters, b.parent) == ("a", {"n": 5}, a.id)
    assert b.counters == {"m": [1, 2]} and tracing.drain() == []


def test_profiled_writes_the_chrome_trace_of_its_first_items(tmp_path):
    path = str(tmp_path / "trace.json")
    with tracing.profiled(2, path):
        for i in range(3):
            with tracing.item():
                with tracing.span(f"step{i}"):
                    torch.ones(4).sum()
        # the profile ended with the second item: tracing is off again
        assert not tracing.enabled()
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"step0", "step1"} <= names and "step2" not in names
    assert not tracing.enabled() and tracing.drain() == []


class _Loader:
    def __init__(self, batch, n):
        self.batch, self.n = batch, n

    def steps_per_epoch(self):
        return self.n

    def epoch(self, e):
        return iter([self.batch] * self.n)


def test_train_model_logs_the_wall_time_a_step(tmp_path, monkeypatch):
    """A record's `time` is the wall from the previous logged step's end
    (the epoch's start first) over the steps between, waits included; each
    step is an item."""
    clock = [100.0]
    monkeypatch.setattr(train_api.time, "time", lambda: clock[0])

    def make_step(model, cfg, opt, group=None):
        def step(batch):
            with tracing.span("step"):
                pass
            clock[0] += 0.25
            return {"loss": torch.tensor(1.0)}
        return step

    monkeypatch.setattr(train_api, "make_train_step", make_step)
    cfg = dataclasses.replace(configs.fcaf3d_nano(), max_epochs=1)
    tracing.enable()
    train_model(cfg, _Loader({}, 5), str(tmp_path), log_interval=2,
                device="cpu")
    tracing.disable()
    items = {s.item for s in tracing.drain() if s.name == "step"}
    with open(tmp_path / "train_log.jsonl") as f:
        recs = [json.loads(line) for line in f]
    assert [r["iter"] for r in recs if "iter" in r] == [2, 4, 5]
    np.testing.assert_allclose([r["time"] for r in recs if "iter" in r],
                               [0.25, 0.25, 0.25])
    assert len(items) == 5
