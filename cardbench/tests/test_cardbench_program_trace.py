"""`program_trace`: the port's spans laid over the profiler's events, on
synthetic events (times in ns) and on a CPU segment of a real step."""
import pytest
import torch

from cardbench import program_trace as pt


def span(id_, name, t0, t1, parent=None, item=1, counters=None):
    return {"id": id_, "parent": parent, "item": item, "name": name,
            "thread": 1, "t0_ns": t0, "t1_ns": t1,
            "counters": counters or {}}


# one train step: forward [100, 500) holding backbone [150, 300), loss
# [500, 600), backward [600, 900), optimizer [900, 1000)
SPANS = [span(1, "forward", 100, 500), span(2, "backbone", 150, 300, 1),
         span(3, "loss", 500, 600), span(4, "backward", 600, 900),
         span(5, "optimizer", 900, 1000)]


def segment(kernels, runtime=(), copies=(), lo=0, hi=1100, spans=SPANS,
            n=1):
    return {"n": n, "events": {"kernels": list(kernels),
                               "runtime": list(runtime),
                               "copies": list(copies), "lo": lo, "hi": hi},
            "spans": spans}


def test_a_gap_goes_to_the_innermost_span_open_at_its_middle():
    # kernels [0, 160) and [280, 1100): one gap [160, 280), middle 220,
    # inside backbone (and forward)
    prog = pt.read(segment([("k", 0, 160, 1), ("k", 280, 1100, 2)]))
    assert prog["idle_ms"] == pytest.approx(120 / 1e6)
    assert prog["spans"]["backbone"]["self"]["idle_ms"] == \
        pytest.approx(120 / 1e6)
    assert prog["spans"]["forward"]["self"]["idle_ms"] == 0
    assert prog["spans"]["forward"]["total"]["idle_ms"] == \
        pytest.approx(120 / 1e6)
    # a gap whose middle no span covers: outside
    prog = pt.read(segment([("k", 0, 20, 1), ("k", 100, 1100, 2)]))
    assert prog["outside"]["idle_ms"] == pytest.approx(80 / 1e6)


def test_a_kernel_goes_to_the_span_of_its_launch_by_correlation_id():
    runtime = [("cudaLaunchKernel", 200, 210, 7, 1),  # backbone
               # the autograd engine's thread, inside backward
               ("cudaLaunchKernel", 650, 655, 8, 2),
               ("cuLaunchKernel", 920, 925, 9, 1)]  # optimizer
    # each kernel runs well after its launch, in another span's time
    kernels = [("a", 520, 560, 7), ("b", 940, 1000, 8), ("c", 1010, 1020, 9),
               ("d", 1030, 1040, 99)]  # no launch found: at its start
    prog = pt.read(segment(kernels, runtime))
    s = prog["spans"]
    assert s["backbone"]["self"]["launches"] == 1
    assert s["backbone"]["self"]["device_ms"] == pytest.approx(40 / 1e6)
    assert s["forward"]["total"]["launches"] == 1
    assert s["backward"]["self"]["launches"] == 1
    assert s["backward"]["self"]["device_ms"] == pytest.approx(60 / 1e6)
    assert s["optimizer"]["self"]["launches"] == 1
    assert s["loss"]["self"]["launches"] == 0
    assert prog["outside"]["launches"] == 1 and prog["unlinked"] == 1
    assert prog["launches"] == 4


def test_device_to_host_copies_and_synchronises_are_host_waits():
    runtime = [
        # a blocking copy to the host: the copy and its synchronise, once
        ("cudaMemcpyAsync", 160, 170, 1, 1),
        ("cudaStreamSynchronize", 171, 190, 2, 1),
        # a copy to the device waits for nothing
        ("cudaMemcpyAsync", 510, 520, 3, 1),
        # a synchronise on its own
        ("cudaDeviceSynchronize", 700, 720, 4, 1),
        # a copy on the device, not a wait
        ("cudaMemcpyAsync", 930, 940, 5, 1),
    ]
    copies = [("Memcpy DtoH (Device -> Pageable)", 172, 175, 1),
              ("Memcpy HtoD (Pageable -> Device)", 521, 530, 3),
              ("Memcpy DtoD (Device -> Device)", 941, 950, 5)]
    prog = pt.read(segment([("k", 0, 1100, 9)], runtime, copies))
    s = prog["spans"]
    assert s["backbone"]["self"]["waits"] == 1
    assert s["loss"]["self"]["waits"] == 0
    assert s["backward"]["self"]["waits"] == 1
    assert s["optimizer"]["self"]["waits"] == 0
    assert prog["waits"] == 2


def test_charged_idle_and_outside_add_up_to_the_segments_idle():
    kernels = [("k", 10, 40, 1), ("k", 120, 130, 2), ("k", 135, 400, 3),
               ("k", 380, 450, 4), ("k", 610, 620, 5), ("k", 960, 990, 6)]
    prog = pt.read(segment(kernels, n=2))
    busy = 30 + 10 + 315 + 10 + 30
    assert prog["idle_ms"] == pytest.approx((1100 - busy) / 1e6 / 2)
    charged = sum(s["self"]["idle_ms"] for s in prog["spans"].values())
    assert charged + prog["outside"]["idle_ms"] == \
        pytest.approx(prog["idle_ms"])
    # the per-item numbers halve the segment's
    assert prog["spans"]["forward"]["calls"] == 0.5


def test_metrics_read_spans_and_counters_and_skip_what_is_missing():
    spans = [span(1, "voxelize", 100, 200, counters={
                 "budget_rows": [100], "valid_rows": [80]}),
             span(2, "backbone", 200, 300, counters={
                 "budget_rows": [60, 40], "valid_rows": [30, 10]}),
             span(3, "neck_head", 300, 400), span(4, "get_bboxes", 400, 600),
             span(5, "nms", 450, 550, 4), span(6, "to_numpy", 600, 650),
             span(7, "to_numpy", 650, 700)]
    runtime = [("cudaLaunchKernel", 460 + i, 461 + i, i, 1)
               for i in range(1, 3)]
    copies = [("Memcpy DtoH (Device -> Pageable)", 700, 701, 10)]
    runtime.append(("cudaMemcpyAsync", 660, 670, 10, 1))
    kernels = [("k", 0, 100, 0)] + [("k", 900, 901, i) for i in range(1, 3)]
    m = pt.metrics(pt.read(segment(kernels, runtime, copies, hi=1000,
                                   spans=spans)), "infer")
    assert m["nms_launches.infer"] == 2
    assert m["host_waits.infer"] == 1
    assert m["budget_fill.infer"] == pytest.approx(100 * 120 / 200)
    # the gap [100, 900): middle 500, in nms, within get_bboxes
    assert m["postproc_idle_ms.infer"] == pytest.approx(800 / 1e6)
    assert m["voxelize_idle_ms.infer"] == 0
    assert pt.metrics(pt.read(segment(kernels, runtime, copies, hi=1000,
                                      spans=spans)), "train") == {}
    # a program without spans gives nothing to read
    assert pt.metrics(pt.read(segment(kernels, spans=[])), "infer") == {}
    prog = pt.read(segment(kernels, runtime, copies, hi=1000, spans=spans))
    run = {"mode": "infer", "program": prog}
    assert pt.value(run, "nms_launches.infer") == 2
    assert pt.value(run, "optimizer_launches.train") is None
    assert pt.value({"mode": "infer"}, "nms_launches.infer") is None


def test_a_cpu_segment_of_a_real_step_reads_its_spans():
    from fcaf3d_tpu_torch.utils import tracing

    def step(x):
        with tracing.span("forward"):
            tracing.count("valid_rows", torch.tensor([x, 1]))
            torch.ones(8).sum()
        with tracing.span("optimizer"):
            pass

    seg = pt.segment(step, [3, 4], lambda: None)
    assert not tracing.enabled()
    assert [s["item"] for s in seg["spans"]] == [seg["spans"][0]["item"]] \
        * 2 + [seg["spans"][2]["item"]] * 2
    prog = pt.read(seg)
    assert prog["items"] == 2 and prog["launches"] == 0
    assert prog["spans"]["forward"]["counters"] == {"valid_rows": [3.5, 1]}
    assert pt.metrics(prog, "train")["optimizer_launches.train"] == 0
