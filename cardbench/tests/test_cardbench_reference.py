"""The reference (`cardbench.ref`) and the traffic generator held equal to
the port on the CPU, where the port runs its plain versions, at the tiny
configurations; and the benchmark's FLOP count held to the port's
`utils.flops` counter, so that a drift of either shows."""
import numpy as np
import pytest
import torch

from cardbench import checks, run, spec, work
from cardbench.ref import precision, record
from cardbench.traffic import generator
from cardbench.traffic.generator import make_pool

from . import tiny

SEED = 2 ** 31 + 5  # wider than 32 signed bits, as a run's seed may be


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _setup(kind):
    cell = tiny.cell(kind)
    fam = spec.family(cell["config"]["family"])
    pool = [fam.prepare(b) for b in make_pool(cell["traffic"],
                                              cell["config"], SEED)]
    return cell, fam, pool, fam.draw(cell["config"], SEED, "cpu")


@pytest.mark.parametrize("kind", ["fcaf3d_train", "votenet_train"])
def test_reference_train_steps_equal_the_port(kind):
    cell, fam, pool, tree = _setup(kind)
    checked = pool[:cell["traffic"]["checked_steps"]]
    *_, prog = run.program_steps(fam, cell["config"], tree, pool,
                                 len(checked), "cpu")
    with precision.operands("float32"):
        ref = fam.ref_train(cell["config"], tree, checked, "cpu")
    np.testing.assert_allclose(prog["losses"], ref["losses"], rtol=1e-6)
    assert set(prog["grad"]) == set(ref["grad"])
    readings = checks.train_readings(prog, ref)
    assert max(readings.values()) <= 1e-5, readings
    assert all(np.isfinite(v) and v > 0 for v in prog["losses"])


def test_reference_detections_equal_the_port():
    cell, fam, pool, tree = _setup("fcaf3d_eval")
    model, request = fam.program_infer(cell["config"], tree, "cpu")
    prog = [s for b in pool for s in request(b)]
    with precision.operands("float32"):
        ref = [s for scans in fam.ref_detect(cell["config"], tree, pool,
                                             "cpu") for s in scans]
    assert sum(len(p["scores_3d"]) for p in prog) > 0
    for p, r in zip(prog, ref):
        k = r["keep"]
        np.testing.assert_allclose(p["boxes_3d"], r["boxes"][k], atol=1e-6)
        np.testing.assert_allclose(p["scores_3d"], r["scores"][k],
                                   atol=1e-6)
        np.testing.assert_array_equal(p["labels_3d"], r["labels"][k])
    readings = checks.detection_readings(prog, ref)
    assert readings["det_gap_p99"] <= 1e-6


@pytest.mark.parametrize("train", [True, False], ids=["step", "forward"])
def test_flop_count_equals_the_port_counter(train):
    from fcaf3d_tpu_torch.utils.flops import flop_counter
    cell, fam, pool, tree = _setup("fcaf3d_train")
    config = cell["config"]
    with flop_counter() as fc:
        if train:
            run.program_steps(fam, config, tree, pool, 1, "cpu")
        else:
            _, request = fam.program_infer(config, tree, "cpu")
            request(pool[0])
    with precision.operands("float32"), record.calls() as rec:
        if train:
            fam.ref_train(config, tree, pool[:1], "cpu")
        else:
            fam.ref_detect(config, tree, pool[:1], "cpu")
    assert fc.model > 0
    assert work.model_flops(rec.records, train) == fc.model


def test_dense_layer_flops_count_each_pass():
    records = [("dense", 10, 4, 8, False), ("dense", 10, 8, 2, True)]
    fwd = 2 * 10 * 4 * 8 + 2 * 10 * 8 * 2
    assert work.model_flops(records, train=False) == fwd
    assert work.model_flops(records, train=True) == (
        2 * (2 * 10 * 4 * 8) + 3 * (2 * 10 * 8 * 2))


def test_generators_equal_the_port():
    from fcaf3d_tpu_torch.data import points, synth
    for with_yaw in (False, True):
        a = synth.densify(synth.crowded_scene(
            20, 18, np.random.default_rng(3), 5.0, with_yaw), 60, 50,
            np.random.default_rng(4))
        b = generator.densify(generator.crowded_scene(
            20, 18, np.random.default_rng(3), 5.0, with_yaw), 60, 50,
            np.random.default_rng(4))
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    xa, ca = synth.synth_scene(np.random.RandomState(7), 5000)
    xb, cb = generator.synth_scene(np.random.RandomState(7), 5000)
    np.testing.assert_array_equal(xa, xb)
    np.testing.assert_array_equal(ca, cb)
    np.testing.assert_array_equal(points.add_height(xa),
                                  generator.add_height(xa))


def test_pool_is_the_seeds_and_every_seed_gets_the_same_sizes():
    cell = tiny.cell("fcaf3d_train")
    a = make_pool(cell["traffic"], cell["config"], SEED)
    b = make_pool(cell["traffic"], cell["config"], SEED)
    c = make_pool(cell["traffic"], cell["config"], SEED + 1)
    for x, y, z in zip(a, b, c):
        for k in x:
            np.testing.assert_array_equal(x[k], y[k])
            assert x[k].shape == z[k].shape
    assert not np.array_equal(a[0]["points"], c[0]["points"])
    rows = np.concatenate([p["points"][:, 0] for p in a])
    assert len({r.tobytes() for r in rows}) == len(rows)  # rows all differ
