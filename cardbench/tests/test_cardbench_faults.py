"""The check fails a broken timed path: each test drives a whole run at
the tiny size on the CPU (past the look for a card), with the port broken
underneath, and sees `correct` come out false. The faults a cell can
have: a step that returns its state unchanged; half of the batch left
out, the mean taken over the rest; a scan's answer altered where it is
made, with detections moved, lost or kept where the reference drops
them."""
import pytest
import torch

from cardbench import run, spec

from . import tiny


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def correct(kind):
    cell = tiny.cell(kind)
    r = run.run_cell(cell, 99, 0.3, False, device="cpu")
    return run.result_line(cell, r, "cpu")["correct"]


@pytest.mark.parametrize("kind", ["fcaf3d_train", "votenet_train"])
def test_a_sound_run_is_correct(kind):
    assert correct(kind)


@pytest.mark.parametrize("kind", ["fcaf3d_train", "votenet_train"])
def test_a_step_that_leaves_the_state_unchanged_fails(kind, monkeypatch):
    from fcaf3d_tpu_torch.train import optim

    def frozen(self, closure=None):
        grads = [p.grad for g in self.param_groups for p in g["params"]
                 if p.grad is not None]
        return torch.sqrt(sum(torch.sum(g * g) for g in grads))

    monkeypatch.setattr(optim.ClipAdamW, "step", frozen)
    assert not correct(kind)


@pytest.mark.parametrize("kind", ["fcaf3d_train", "votenet_train"])
def test_a_step_on_half_the_batch_fails(kind, monkeypatch):
    fam = spec.family(tiny.cell(kind)["config"]["family"])
    program_train = fam.program_train

    def halved(config, tree, device):
        model, opt, step = program_train(config, tree, device)

        def half_step(batch):
            b = batch["points"].shape[0]
            return step({k: v[:b // 2] for k, v in batch.items()})

        return model, opt, half_step

    monkeypatch.setattr(fam, "program_train", halved)
    assert not correct(kind)


def test_a_sound_detection_run_is_correct():
    assert correct("fcaf3d_eval")


def _broken_requests(monkeypatch, breaks):
    fam = spec.family("fcaf3d")
    program_infer = fam.program_infer

    def broken(config, tree, device):
        model, request = program_infer(config, tree, device)
        return model, lambda batch: breaks(request, batch)

    monkeypatch.setattr(fam, "program_infer", broken)


def test_an_altered_answer_fails(monkeypatch):
    def moved(request, batch):
        out = request(batch)
        out[0]["boxes_3d"] = out[0]["boxes_3d"].copy()
        out[0]["boxes_3d"][:, 0] += 0.25  # a quarter of a metre
        return out

    _broken_requests(monkeypatch, moved)
    assert not correct("fcaf3d_eval")


def test_detections_of_half_the_batch_fail(monkeypatch):
    def halved(request, batch):
        b = batch["points"].shape[0]
        out = request({k: v[:b // 2] for k, v in batch.items()})
        empty = {k: v[:0] for k, v in out[0].items()}
        return out + [dict(empty) for _ in range(b - len(out))]

    _broken_requests(monkeypatch, halved)
    assert not correct("fcaf3d_eval")


def _nms_skipped(nms_bev, boxes7, scores, iou_thr, valid, rotated):
    return valid


def _nms_at_a_looser_overlap(nms_bev, boxes7, scores, iou_thr, valid,
                             rotated):
    return nms_bev(boxes7, scores, 0.9, valid=valid, rotated=rotated)


@pytest.mark.parametrize("nms", [_nms_skipped, _nms_at_a_looser_overlap])
def test_detections_the_reference_drops_fail(nms, monkeypatch):
    from fcaf3d_tpu_torch.models import fcaf3d_head
    nms_bev = fcaf3d_head.nms_bev
    monkeypatch.setattr(
        fcaf3d_head, "nms_bev",
        lambda boxes7, scores, iou_thr, valid=None, rotated=True:
        nms(nms_bev, boxes7, scores, iou_thr, valid, rotated))
    assert not correct("fcaf3d_eval")
