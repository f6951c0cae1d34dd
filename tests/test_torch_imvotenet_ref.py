"""The port's ImVoteNet stage 2 held to the benchmark's plain reference
(`cardbench/ref/models/imvotenet.py`) on the CPU, at `votenet_tiny` with 32
resampled seeds, 2 scans and seeded random weights, through the step the
benchmark cell `imvotenet_sunrgbd.train_b16` times
(`create_imvotenet_train_state`, `make_imvotenet_train_step`); the cell's
adapter (`cardbench/families/imvotenet.py`), which turns a generic train
batch into SUN RGB-D-like frames; the step's spans and counters; and a
broken fusion that the cell's check sees.

Tolerances: on the CPU the port runs its plain FPS, ball query and dense
layers, the same float32 operations in the same order as the reference, so
the two agree to the last bit in practice. The tolerances leave room for
one reassociated sum (a BLAS product or a reduction split otherwise) and
nothing more: 1e-6 relative, 1e-7 absolute on outputs and losses, 1e-5
relative on gradients and updated parameters (each the sum of many such
products), far below what a wrong cue, pair or statistic moves.
"""
import contextlib
import dataclasses
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from cardbench import spec
from cardbench.families import imvotenet as fam
from cardbench.ref import precision
from cardbench.ref.models import imvotenet as ref_iv
from cardbench.ref.params import flatten
from cardbench.ref.params import load_variables as ref_load
from cardbench.ref.train.optim import ClipAdamW, constant_schedule
from cardbench.traffic.generator import make_pool
from fcaf3d_tpu_torch.configs import votenet_tiny
from fcaf3d_tpu_torch.data.calib import sunrgbd_depth2img
from fcaf3d_tpu_torch.models import imvotenet as port_iv
from fcaf3d_tpu_torch.utils import tracing

SEED = 2 ** 31 + 21  # wider than 32 signed bits, as a run's seed may be
CELL = "imvotenet_sunrgbd.train_b16"
TRAFFIC = {"mode": "train", "batch": 2, "pool": 2, "scene": "crowded",
           "scene_args": {"n_boxes": 4, "extent": 2.0, "box_points": 100,
                          "floor_points": 100},
           "checked_steps": 1, "profiled_steps": 1}
OUTPUTS = ("seed_points", "seed_indices", "vote_points", "vote_offset",
           "aggregated_points", "obj_scores", "sem_scores", "bbox_preds")
TIGHT = {"rtol": 1e-6, "atol": 1e-7}
SUMS = {"rtol": 1e-5, "atol": 1e-7}


def _config() -> dict:
    fields = json.loads(json.dumps(dataclasses.asdict(votenet_tiny())))
    return {"family": "imvotenet", "steps_per_epoch": 41,
            "imvotenet": {"num_sampled_seed": 32, "max_imvote": 3,
                          "image_hw": list(fam.IMAGE_HW),
                          "max_boxes2d": fam.MAX_BOXES2D},
            "config": fields}


@pytest.fixture(autouse=True)
def quiet():
    """Two intra-op threads, tracing off and nothing recorded, around
    every test."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    tracing.disable()
    tracing.drain()
    yield
    tracing.disable()
    tracing.drain()
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    config = _config()
    pool = [fam.prepare(b) for b in make_pool(TRAFFIC, config, SEED)]
    return config, pool, fam.draw(config, SEED, "cpu")


def _tensors(batch):
    return {k: torch.as_tensor(batch[k]) for k in fam.TRAIN_KEYS}


def _ref_step(config, tree, batch, towers=ref_iv.TOWERS):
    """The reference's step as the cell's check replays it: (tower
    outputs, losses, leaf gradients, model after AdamW)."""
    cfg = fam.ref_config(config)
    model = ref_iv.ImVoteNet(cfg, 32, 3, device="cpu")
    ref_load(model, tree)
    opt = ClipAdamW(model.parameters(), constant_schedule(cfg.lr),
                    weight_decay=cfg.weight_decay, grad_clip=cfg.grad_clip)
    t = _tensors(batch)
    model.train()
    with precision.operands("float32"):
        outs = model(t["points"], t["images"], t["boxes2d"],
                     t["boxes2d_valid"], t["depth2img"], towers=towers)
        losses = ref_iv.imvotenet_loss(outs, t["points"], t["gt_boxes"],
                                       t["gt_labels"], t["gt_valid"],
                                       n_classes=cfg.n_classes)
        sum(losses.values()).backward()
        grads = {n: p.grad.clone() for n, p in model.named_parameters()}
        opt.step()
    return outs, losses, grads, model


def _port_step(config, tree, batch):
    """The port's step, as the cell builds and drives it: (tower outputs,
    step metrics, leaf gradients, model after AdamW)."""
    model, _, step = fam.program_train(config, tree, "cpu")
    outs = []
    hook = model.register_forward_hook(lambda m, a, o: outs.append(o))
    metrics = step(batch)
    hook.remove()
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    return outs[0], metrics, grads, model


@pytest.fixture(scope="module")
def stepped(setup):
    config, pool, tree = setup
    torch.set_num_threads(2)
    return _port_step(config, tree, pool[0]), _ref_step(config, tree,
                                                        pool[0])


@pytest.mark.parametrize("tower", ref_iv.TOWERS)
def test_tower_outputs_equal_the_reference(stepped, tower):
    (port, *_), (ref, *_) = stepped
    assert list(port) == list(ref) == list(ref_iv.TOWERS)
    for key in OUTPUTS:
        torch.testing.assert_close(port[tower][key], ref[tower][key],
                                   **TIGHT, msg=f"{tower} {key}")


def test_loss_terms_equal_the_reference(stepped):
    (_, metrics, *_), (_, losses, *_) = stepped
    assert len(losses) == 15
    for key, value in losses.items():
        torch.testing.assert_close(metrics[key], value.detach(), **TIGHT,
                                   msg=key)
    torch.testing.assert_close(metrics["loss"],
                               sum(losses.values()).detach(), **TIGHT)


def test_every_leaf_gradient_equals_the_reference(stepped):
    (_, _, grads, _), (_, _, ref_grads, _) = stepped
    assert set(grads) == set(ref_grads)
    top = max(float(g.abs().max()) for g in ref_grads.values())
    for name, g in ref_grads.items():
        # a Dense bias ahead of a train-mode BN has an exact zero gradient
        # up to rounding: held to the largest leaf's scale
        torch.testing.assert_close(grads[name], g, rtol=SUMS["rtol"],
                                   atol=1e-6 * top, msg=name)


def test_chained_bn_statistics_equal_the_reference(stepped, setup):
    """The towers share their BatchNorms and update the running statistics
    in turn: joint, pts, img. The statistics after the step are the
    reference's, and they are not those of the joint tower alone."""
    config, pool, tree = setup
    (*_, model), (*_, ref_model) = stepped
    bufs = dict(model.named_buffers())
    ref_bufs = dict(ref_model.named_buffers())
    assert set(bufs) == set(ref_bufs)
    for name, b in ref_bufs.items():
        torch.testing.assert_close(bufs[name], b, **SUMS, msg=name)
    *_, joint_only = _ref_step(config, tree, pool[0], towers=("joint",))
    moved = dict(joint_only.named_buffers())
    assert not torch.equal(moved["shared_conv0.BatchNorm_0.mean"],
                           ref_bufs["shared_conv0.BatchNorm_0.mean"])
    torch.testing.assert_close(moved["backbone.sa0.mlp0.BatchNorm_0.mean"],
                               ref_bufs["backbone.sa0.mlp0.BatchNorm_0.mean"],
                               **TIGHT)


def test_parameters_after_adamw_equal_the_reference(stepped, setup):
    *_, tree = setup
    (*_, model), (*_, ref_model) = stepped
    params = dict(model.named_parameters())
    for name, p in ref_model.named_parameters():
        torch.testing.assert_close(params[name], p, **SUMS, msg=name)
    start = flatten(tree["params"])
    assert set(start) == set(params)
    moved = [n for n, p in params.items()
             if not torch.equal(p.detach(), torch.as_tensor(start[n]))]
    assert len(moved) == len(params)  # AdamW's decay moves every leaf


# --- the adapter ----------------------------------------------------------

def test_prepare_is_deterministic_and_keeps_the_batch(setup):
    config, pool, _ = setup
    raw = make_pool(TRAFFIC, config, SEED)[0]
    again = fam.prepare(raw)
    assert set(again) == set(fam.TRAIN_KEYS)
    for k in fam.TRAIN_KEYS:
        np.testing.assert_array_equal(again[k], pool[0][k])
    np.testing.assert_array_equal(again["points"][..., :3],
                                  raw["points"] + fam.SHIFT)
    np.testing.assert_array_equal(again["gt_labels"], raw["gt_labels"])
    np.testing.assert_array_equal(again["gt_valid"], raw["gt_valid"])
    assert again["images"].shape == (2, 480, 640, 3)


def test_depth2img_is_the_ports_sunrgbd_calibration():
    k_t = np.float32([[fam.FOCAL, 0, 0], [0, fam.FOCAL, 0],
                      [fam.CENTRE[0], fam.CENTRE[1], 1]])
    np.testing.assert_allclose(
        fam.depth2img(), sunrgbd_depth2img({"K": k_t, "Rt": np.eye(3)}),
        rtol=1e-7)


def _centres(batch):
    b = batch["gt_boxes"]
    return b[..., :3] + np.stack([0 * b[..., 5], 0 * b[..., 5],
                                  b[..., 5] / 2], -1)


def test_every_box_centre_lies_in_the_image_ahead_of_the_camera(setup):
    _, pool, _ = setup
    for batch in pool:
        v = batch["gt_valid"]
        uv, z = port_iv.project_to_image(
            torch.as_tensor(_centres(batch)), torch.as_tensor(
                batch["depth2img"]))
        uv, z = uv.numpy()[v], z.numpy()[v]
        assert (z >= fam.MIN_DEPTH).all()
        assert ((uv >= 0) & (uv < [640, 480])).all()


def test_boxes2d_are_the_clipped_labelled_projections(setup):
    _, pool, _ = setup
    for batch in pool:
        for i in range(len(batch["gt_valid"])):
            v = batch["gt_valid"][i]
            n = int(v.sum())
            b2 = batch["boxes2d"][i]
            assert batch["boxes2d_valid"][i].tolist() == [True] * n + [
                False] * (fam.MAX_BOXES2D - n)
            assert (b2[n:] == 0).all()
            x1, y1, x2, y2, conf, label = b2[:n].T
            assert (0 <= x1).all() and (x1 < x2).all() and (x2 <= 639).all()
            assert (0 <= y1).all() and (y1 < y2).all() and (y2 <= 479).all()
            assert (conf == 1).all()
            np.testing.assert_array_equal(label,
                                          batch["gt_labels"][i][v])
            uv, _ = port_iv.project_to_image(
                torch.as_tensor(_centres(batch)[i][v][None]),
                torch.as_tensor(batch["depth2img"][i][None]))
            u, vv = uv[0].numpy().T
            assert ((x1 <= u) & (u <= x2) & (y1 <= vv) & (vv <= y2)).all()


def test_image_paints_the_nearest_point_of_each_pixel(setup):
    config, pool, _ = setup
    raw = make_pool(TRAFFIC, config, SEED)[0]
    batch = pool[0]
    for i in range(2):
        xyz = batch["points"][i, :, :3]
        uvz = xyz.astype(np.float64) @ batch["depth2img"][i].T
        nearest = {}
        for j, (u, v, z) in enumerate(uvz):
            px = (int(np.round(u / z - 1)), int(np.round(v / z - 1)))
            if 0 <= px[0] < 640 and 0 <= px[1] < 480 and (
                    px not in nearest or z < nearest[px][0]):
                nearest[px] = (z, j)
        image = batch["images"][i]
        painted = np.zeros((480, 640), bool)
        for (u, v), (_, j) in nearest.items():
            np.testing.assert_array_equal(image[v, u], raw["colors"][i, j])
            painted[v, u] = True
        assert len(nearest) > 100
        assert (image[~painted] == fam.GREY).all()


def test_prepare_refuses_a_box_outside_the_view(setup):
    config, _, _ = setup
    raw = make_pool(TRAFFIC, config, SEED)[0]
    raw["gt_boxes"][0, 0, :2] = [-20.0, -3.0]  # behind and aside
    with pytest.raises(ValueError):
        fam.prepare(raw)


def test_full_size_cell_batch_places_every_box_in_view():
    """The cell's own first scans (train_b16's crowded rooms at the
    configuration's 20 000 points) meet the adapter's check."""
    cell = spec.cell(CELL, spec.benchmark())
    traffic = {**cell["traffic"], "batch": 2}
    batch = fam.prepare(make_pool(traffic, cell["config"], SEED)[0])
    v = batch["gt_valid"]
    assert v.sum(1).tolist() == [20, 20]
    assert batch["boxes2d_valid"].sum(1).tolist() == [20, 20]
    assert batch["points"].shape == (2, 20000, 4)
    assert cell["config"]["imvotenet"] == {
        "num_sampled_seed": 1024, "max_imvote": 3, "image_hw": [480, 640],
        "max_boxes2d": 32}


# --- spans and counters ---------------------------------------------------

NESTING = [("forward", None), ("backbone", "forward"), ("fusion", "forward"),
           ("tower_joint", "forward"), ("tower_pts", "forward"),
           ("tower_img", "forward"), ("loss", None), ("backward", None),
           ("all_reduce_grads", None), ("optimizer", None)]


def _traced_step(config, tree, batch):
    model, _, step = fam.program_train(config, tree, "cpu")
    seeds = []
    hook = model.backbone.register_forward_hook(
        lambda m, a, o: seeds.append(o["fp_xyz"][-1].detach()))
    tracing.enable()
    try:
        with tracing.item():
            step(batch)
    finally:
        tracing.disable()
        hook.remove()
    return tracing.drain(), seeds[0], len(list(model.parameters()))


@pytest.mark.parametrize("conf", [1.0, 0.5], ids=["gt_conf", "half_conf"])
def test_spans_nest_and_fusion_counts_its_pairs(setup, conf):
    """At confidence 1 every pair of a valid box is valid, so each seed
    keeps 3; at 0.5 only the pairs inside a box are. The counters are the
    reference fusion's own counts on the same seeds."""
    config, pool, tree = setup
    batch = dict(pool[0])
    batch["boxes2d"] = batch["boxes2d"].copy()
    batch["boxes2d"][..., 4] = np.where(batch["boxes2d_valid"], conf, 0)
    spans, seeds, n_leaves = _traced_step(config, tree, batch)
    by_id = {s.id: s for s in spans}
    assert [(s.name, by_id[s.parent].name if s.parent else None)
            for s in spans] == NESTING
    assert len({s.item for s in spans}) == 1
    counters = {s.name: s.counters for s in spans if s.counters}
    assert set(counters) == {"fusion", "optimizer"}
    # CPU leaves: the optimizer's plain loop, none fused
    assert counters["optimizer"] == {"adamw_leaves": n_leaves,
                                     "adamw_fused_leaves": 0}
    t = _tensors(batch)
    _, mask = ref_iv.vote_fusion(t["images"], t["boxes2d"],
                                 t["boxes2d_valid"], seeds, t["depth2img"],
                                 4, 3)
    b, s = seeds.shape[:2]
    got = counters["fusion"]
    assert got == {
        "fusion_pairs": int(mask.sum()), "fusion_slots": b * s * 3,
        "fusion_seeds": int(mask.reshape(b, s, 3).any(-1).sum()),
        "boxes2d_valid": int(batch["boxes2d_valid"].sum())}
    assert all(isinstance(v, int) for v in got.values())
    if conf == 1.0:
        assert got["fusion_pairs"] == got["fusion_slots"]
    else:
        assert 0 < got["fusion_seeds"] < b * s
        assert got["fusion_pairs"] < got["fusion_slots"]


def _ops(run):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run()
    events = sorted(prof.profiler.kineto_results.events(),
                    key=lambda e: e.start_ns())
    return ([e.name() for e in events if e.name().startswith("aten::")],
            {e.name() for e in events if e.is_user_annotation()})


def test_tracing_off_adds_no_range_and_no_operator(setup, monkeypatch):
    config, pool, tree = setup
    model, _, step = fam.program_train(config, tree, "cpu")
    step(pool[0])  # the optimizer's moments exist from here on
    off, ranges = _ops(lambda: step(pool[1]))
    assert not ranges & {name for name, _ in NESTING}
    with monkeypatch.context() as m:
        m.setattr(tracing, "span", lambda name: contextlib.nullcontext())
        m.setattr(tracing, "count", lambda name, value: None)
        m.setattr(tracing, "enabled", lambda: False)
        none, _ = _ops(lambda: step(pool[1]))
    assert off == none
    assert tracing.drain() == []


# --- a broken fusion ------------------------------------------------------

def _joint(losses):
    return float(sum(v.detach() for k, v in losses.items()
                     if k.startswith("joint")))


@pytest.mark.parametrize("fault", ["zero_cues", "no_boxes2d"])
def test_a_broken_fusion_fails_the_cells_first_loss_check(setup, fault,
                                                          monkeypatch):
    """The port with its image cues zeroed, or with the 2D boxes dropped,
    against the intact reference: the joint tower's loss and the step's
    loss move by more than the cell's `loss1_gap` limit, so its check
    fails."""
    config, pool, tree = setup
    limit = spec.limits(CELL)["loss1_gap"]["limit"]
    batch = dict(pool[0])
    if fault == "zero_cues":
        fusion = port_iv.vote_fusion

        def zeroed(*args):
            cues, mask = fusion(*args)
            return torch.zeros_like(cues), mask

        monkeypatch.setattr(port_iv, "vote_fusion", zeroed)
    else:
        batch["boxes2d_valid"] = np.zeros_like(batch["boxes2d_valid"])
    _, metrics, _, _ = _port_step(config, tree, batch)
    _, losses, _, _ = _ref_step(config, tree, pool[0])
    joint = abs(_joint(metrics) - _joint(losses)) / abs(_joint(losses))
    total = float(sum(losses.values()))
    gap = abs(float(metrics["loss"]) - total) / abs(total)
    assert joint > 10 * limit and gap > 10 * limit, (joint, gap, limit)
