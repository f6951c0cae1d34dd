"""On the card, at each cell's own size: the control (the reference one
precision step below the configuration's, in the port's place) fails the
cell's check, a train cell's check fails a step on half the batch, and a
short run of the port passes it.

    python -m pytest cardbench/tests/test_cardbench_card.py -q -m card
"""
import pytest

from cardbench import calibrate, checks, run, spec

BENCH = spec.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
TRAIN_CELLS = [w["name"] for w in BENCH["workloads"]
               if spec.traffic(w["traffic"])["mode"] == "train"]
SEED = 2 ** 31 + 1001


def _fails(cell, who, device):
    fam = spec.family(cell["config"]["family"])
    read = (calibrate.train_readings if cell["traffic"]["mode"] == "train"
            else calibrate.detection_readings)
    judged = checks.judge(read(cell, fam, SEED, who, device),
                          cell["limits"])
    return [c["name"] for c in judged if not c["ok"]]


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_the_check(name, card):
    cell = spec.cell(name, BENCH)
    assert _fails(cell, "control", card)


@pytest.mark.card
@pytest.mark.parametrize("name", TRAIN_CELLS)
def test_a_step_on_half_the_batch_fails_a_train_check(name, card):
    assert _fails(spec.cell(name, BENCH), "half_batch", card)


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_a_short_run_is_correct(name, card):
    import torch
    cell = spec.cell(name, BENCH)
    if torch.cuda.device_count() < cell["chips"]:
        pytest.skip(f"the cell needs {cell['chips']} cards")
    r = run.run_cell(cell, SEED + 1, 3.0, False, device=card)
    assert run.result_line(cell, r, "card")["correct"], r["checks"]
