"""The harness found by name and its arithmetic: cells, configurations,
traffic mixes, limits, metric readers and kernel tables from
BENCHMARK.json and the files under `cardbench/`; rates over the whole
window and the 95th percentile over every request, against a fake clock;
the device's busy time and idle gaps; the weights' draw; the first
gradient's leaf norms as a clipped optimizer step takes them; the shape
of a run's last line."""
import json
import math

import numpy as np
import pytest
import torch

from cardbench import run, spec, trace, weights, window, work
from cardbench.families import common

from . import tiny

BENCH = spec.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]


@pytest.mark.parametrize("name", CELLS)
def test_each_cell_is_found_by_name(name):
    cell = spec.cell(name, BENCH)
    assert cell["chips"] in (1, 4)
    assert cell["traffic"]["mode"] in ("train", "infer")
    fam = spec.family(cell["config"]["family"])
    assert callable(fam.program_config) and callable(fam.draw)
    fam.program_config(cell["config"])
    fam.ref_config(cell["config"])
    assert cell["limits"], "a cell's check needs its limits"
    names = {m["name"] for m in cell["end_to_end"]}
    assert "setup_s" in names and len(names) >= 2
    assert cell["per_layer"]


@pytest.mark.parametrize("name", METRICS)
def test_each_metric_has_a_reader(name):
    assert callable(spec.metric_reader(name))


def test_per_layer_metrics_move_an_end_to_end_metric_of_their_cells():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        moved = e2e[m["moves"]]
        for w in m.get("workloads", CELLS):
            assert w in moved.get("workloads", CELLS), (m["name"], w)


def test_kernel_tables_are_found_by_name():
    tables = spec.kernel_tables()
    assert "gather_gemm_tc_kernel" in tables["sparse_conv"]
    assert "fps_cluster_kernel" in tables["pointnet"]


def test_names_and_units_keep_to_the_contract():
    import re
    name = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
    unit = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert name.match(m["name"]) and unit.match(m["unit"])
    for w in BENCH["workloads"]:
        assert name.match(w["name"]) and len(w["why"]) <= 200
    assert len(json.dumps(BENCH)) < 64 * 1024


class FakeClock:
    """Each read advances the time by `tick`; a call advances it by its
    own cost through `spend`."""

    def __init__(self, tick=0.0):
        self.t, self.tick = 0.0, tick

    def __call__(self):
        self.t += self.tick
        return self.t

    def spend(self, s):
        self.t += s


def test_train_rate_is_over_the_whole_window():
    clock = FakeClock()
    syncs = []

    def step(batch):
        clock.spend(0.3)

    w = window.train_loop(step, [0, 1, 2], 0, 1.0, lambda: syncs.append(1),
                          clock)
    assert w == {"steps": 4, "seconds": pytest.approx(1.2)}
    assert len(syncs) == 2  # the window starts and ends with a synchronise
    assert window.rate(w["steps"] * 16, w["seconds"]) == pytest.approx(
        64 / 1.2)


def test_p95_is_over_every_request():
    clock = FakeClock()
    costs = iter([0.1] * 90 + [1.0] * 10 + [0.1] * 100)

    def request(batch):
        clock.spend(next(costs))
        return batch

    w = window.request_loop(request, ["a", "b"], 0, 18.5, lambda: None,
                            clock)
    assert w["requests"] == 100
    assert [o[1] for o in w["outputs"][:3]] == ["a", "b", "a"]
    assert window.percentile(w["latencies"], 95) == pytest.approx(1.0)
    assert window.percentile(w["latencies"], 90) == pytest.approx(0.1)
    assert window.percentile([3, 1, 2, 4], 50) == 2
    assert window.percentile(list(range(1, 21)), 95) == 19


def test_busy_time_is_the_union_of_kernels_and_gaps_are_labelled():
    kernels = [("a", 10, 20), ("b", 15, 30), ("c", 50, 60)]
    hosts = [("outer", 0, 100), ("inner", 35, 45)]
    assert trace.busy_ns(kernels, 0, 100) == 30
    assert trace.idle_gaps(kernels, hosts, 0, 100) == [
        ["outer", 5e-08], ["inner", 2e-08]]
    assert trace.kernel_seconds(kernels, ["a", "c"]) == 20e-9
    assert trace.top_kernels(kernels)[0] == ["b", 15e-9]


def test_spans_record_only_while_on():
    clock = FakeClock(tick=1.0)
    s = trace.Spans(lambda: None, clock)
    s.begin("forward")
    s.end("forward")
    assert s.mean_ms("forward") is None
    s.on = True
    s.begin("loss")
    s.end("loss")
    s.between("backward", "loss")
    assert s.mean_ms("loss") == 1000.0 and s.mean_ms("backward") == 1000.0


def test_gemm_work_is_the_frozen_arithmetic():
    idx = torch.tensor([[[0, 1, 3], [2, 3, 3]]], dtype=torch.int32)
    hits = int((idx < 3).sum())
    assert work.gemm_work(1, 2, 3, 4, 5, 3, hits, 2) == (
        2.0 * 3 * 4 * 5, 1 * 3 * 4 * 2 + 2 * 3 * 4 + 3 * 4 * 5 * 2
        + 2 * 5 * 2)
    ops, nbytes = work.gemm_work(1, 2, 3, 4, 5, 3, hits, 2, weight_grad=True)
    assert nbytes == 3 * 4 * 2 + 2 * 3 * 4 + 2 * 5 * 2 + 3 * 4 * 5 * 4
    assert work.bound(1e12, 1e9, 1e12, 1e12) == 1.0


def test_weights_follow_the_draw_rules_and_the_seed():
    from cardbench.ref.models.detector import FCAF3D
    cell = tiny.cell("fcaf3d_train")
    fam = spec.family("fcaf3d")
    a = fam.draw(cell["config"], 2 ** 40 + 3, "cpu")
    b = fam.draw(cell["config"], 2 ** 40 + 3, "cpu")
    c = fam.draw(cell["config"], 2 ** 40 + 4, "cpu")
    flat_a, flat_b, flat_c = (weights_flat(t) for t in (a, b, c))
    pshapes, sshapes = weights.model_shapes(FCAF3D(
        fam.ref_config(cell["config"]), device="meta"))
    assert set(flat_a) == set(pshapes) | set(sshapes)
    for n in flat_a:
        assert torch.equal(flat_a[n], flat_b[n])
    kernel = "backbone.conv1.kernel"
    assert not torch.equal(flat_a[kernel], flat_c[kernel])
    k, cin, cout = pshapes[kernel]
    std = float(flat_a[kernel].std())
    assert std == pytest.approx(math.sqrt(2.0 / (k * cout)), rel=0.1)
    scales = torch.cat([v.reshape(-1) for n, v in flat_a.items()
                        if n.endswith(".scale") and "norm3" not in n])
    assert 0.5 <= float(scales.min()) and float(scales.max()) < 1.5
    var = torch.cat([v.reshape(-1) for n, v in flat_a.items()
                     if n.endswith(".var")])
    assert 0.5 <= float(var.min()) and float(var.max()) < 2.0
    assert float(flat_a["neck_with_head.cls_conv.bias"].abs().max()) == 0.0


@pytest.mark.parametrize("grad_clip", [0.5, 100.0])
def test_first_gradient_norms_are_read_as_the_step_is_entered(grad_clip):
    model = torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.Linear(4, 2))
    model[1].bias.requires_grad_(False)  # a leaf with no gradient
    opt = torch.optim.SGD([p for p in model.parameters() if p.requires_grad],
                          lr=0.1)
    read = {}
    model(torch.ones(5, 3)).square().sum().backward()
    grads = {n: p.grad.clone() for n, p in model.named_parameters()
             if p.grad is not None}
    with trace.wrapped(opt, "step",
                       lambda: read.update(common.clipped_grad_norms(
                           model, grad_clip)), lambda: None):
        opt.step()
    total = math.sqrt(sum(float(g.square().sum()) for g in grads.values()))
    scale = min(1.0, grad_clip / total)
    assert set(read) == {n for n, _ in model.named_parameters()}
    assert float(read["1.bias"]) == 0.0
    for n, g in grads.items():
        assert float(read[n]) == pytest.approx(float(g.norm()) * scale,
                                               rel=1e-6)


def weights_flat(tree):
    from cardbench.ref.params import flatten
    return {**flatten(tree["params"]), **flatten(tree["batch_stats"])}


@pytest.mark.parametrize("kind,traced", [
    ("fcaf3d_train", False), ("fcaf3d_train", True),
    ("fcaf3d_eval", False), ("fcaf3d_eval", True),
    ("votenet_train", False), ("votenet_train", True)])
def test_result_line_has_the_contract_shape(kind, traced):
    torch.set_num_threads(2)
    cell = tiny.cell(kind)
    r = run.run_cell(cell, 12345, 0.5, traced, device="cpu")
    line = run.result_line(cell, r, "cpu")
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["attempted"] >= 1
    assert set(line["checks"]) == set(cell["limits"])
    for v in line["checks"].values():
        assert set(v) == {"value", "limit"}
    entries = cell["per_layer"] if traced else cell["end_to_end"]
    assert set(line["metrics"]) <= {m["name"] for m in entries}
    if not traced:
        assert set(line["metrics"]) == {m["name"] for m in entries}
    else:
        assert any(k.endswith("_ms.train") or k.endswith("_ms.infer")
                   for k in line["metrics"])
    for v in line["metrics"].values():
        assert set(v) == {"value", "unit"} and np.isfinite(v["value"])
    json.dumps(line)
