"""The port's training pieces around the model, held against the JAX
package on the same numpy inputs, on the CPU: box geometry, the
axis-aligned IoU, the assigner, the losses (values and gradients), the
optimizer against optax on identical gradients, the epoch loop's log
records, and the copy of the synthetic-scene helpers.

Integer outputs (labels) must be exactly equal; floats within the
tolerance stated at each test.
"""
import dataclasses
import json
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fcaf3d_tpu import configs as jconfigs
from fcaf3d_tpu.apis.train import train_model as j_train_model
from fcaf3d_tpu.core import geometry as jg
from fcaf3d_tpu.core.rotated_iou import axis_aligned_iou as j_iou
from fcaf3d_tpu.data import synth as jsynth
from fcaf3d_tpu.data.loader import Loader
from fcaf3d_tpu.models import losses as jl
from fcaf3d_tpu.models.assigner import fcaf3d_assign as j_assign
from fcaf3d_tpu.train import make_optimizer as j_make_optimizer
from fcaf3d_tpu.train import step_lr_schedule as j_schedule
from fcaf3d_tpu_torch import configs as tconfigs
from fcaf3d_tpu_torch.apis import train_model
from fcaf3d_tpu_torch.core import geometry as tg
from fcaf3d_tpu_torch.core.rotated_iou import axis_aligned_iou
from fcaf3d_tpu_torch.data import synth as tsynth
from fcaf3d_tpu_torch.models import losses as tl
from fcaf3d_tpu_torch.models.assigner import fcaf3d_assign
from fcaf3d_tpu_torch.train import make_optimizer, step_lr_schedule
from tests.test_torch_ops import jax_without_persistent_cache  # noqa: F401


def close(got, want, rtol=1e-6, atol=1e-6, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=what)


def test_geometry_matches_jax():
    """Rotation matrices, rotated points and gravity centres within 1e-6."""
    rng = np.random.default_rng(0)
    angles = rng.uniform(-np.pi, np.pi, (3, 4)).astype(np.float32)
    pts = rng.uniform(-3, 3, (3, 4, 10, 3)).astype(np.float32)
    boxes = rng.uniform(0.1, 2, (5, 7)).astype(np.float32)
    close(tg.rotation_matrix_z(torch.as_tensor(angles)),
          jg.rotation_matrix_z(jnp.asarray(angles)))
    close(tg.rotate_points_z(torch.as_tensor(pts), torch.as_tensor(angles)),
          jg.rotate_points_z(jnp.asarray(pts), jnp.asarray(angles)))
    np.testing.assert_array_equal(
        tg.gravity_center(torch.as_tensor(boxes)).numpy(),
        np.asarray(jg.gravity_center(jnp.asarray(boxes))))


def random_box_pairs(rng, n):
    """Gravity-centred (pred, target) [n, 6] pairs: overlapping, touching
    and disjoint."""
    target = np.concatenate([rng.uniform(0, 2, (n, 3)),
                             rng.uniform(0.2, 1, (n, 3))], 1)
    pred = target + np.concatenate([rng.normal(0, 0.3, (n, 3)),
                                    rng.normal(0, 0.1, (n, 3))], 1)
    pred[: n // 4, :3] += 5.0  # disjoint
    return pred.astype(np.float32), target.astype(np.float32)


def test_axis_aligned_iou_matches_jax():
    """Values and gradients within 1e-6."""
    pred, target = random_box_pairs(np.random.default_rng(1), 64)
    w = np.random.default_rng(2).random(64).astype(np.float32)

    def j_fn(p):
        return jnp.sum(j_iou(p, jnp.asarray(target)) * w)

    p_t = torch.tensor(pred, requires_grad=True)
    iou_t = axis_aligned_iou(p_t, torch.as_tensor(target))
    (iou_t * torch.as_tensor(w)).sum().backward()
    close(iou_t.detach(), j_iou(jnp.asarray(pred), jnp.asarray(target)))
    close(p_t.grad, jax.grad(j_fn)(jnp.asarray(pred)))
    assert (iou_t == 0).any() and (iou_t > 0.3).any()


def assign_scene(seed, b=2, p=1500, g=8, n_scales=3):
    """Head locations at three scales on nested lattices, boxes around
    some of them (one padding box per sample, some padding locations)."""
    rng = np.random.default_rng(seed)
    points = np.zeros((b, p, 3), np.float32)
    scales = np.zeros((b, p), np.int32)
    per = p // n_scales
    for s in range(n_scales):
        step = 0.08 * 2 ** s
        cells = rng.choice(9 ** 3, per, replace=False)
        grid = np.stack(np.unravel_index(cells, (9,) * 3), -1) * step
        points[:, s * per:(s + 1) * per] = grid
        scales[:, s * per:(s + 1) * per] = s
    valid = rng.random((b, p)) < 0.95
    boxes = np.zeros((b, g, 7), np.float32)
    centers = points[np.arange(b)[:, None], rng.integers(0, p // 2, (b, g))]
    dims = rng.uniform(0.15, 1.2, (b, g, 3))
    boxes[..., :3] = centers + rng.normal(0, 0.01, (b, g, 3))
    boxes[..., 2] -= dims[..., 2] / 2
    boxes[..., 3:6] = dims
    labels = rng.integers(0, 5, (b, g)).astype(np.int32)
    gt_valid = np.ones((b, g), bool)
    gt_valid[:, -1] = False
    return points, scales, valid, boxes, labels, gt_valid


@pytest.mark.parametrize("limit,topk", [(3, 4), (27, 18)])
def test_assigner_matches_jax(limit, topk):
    """Labels exactly equal, centerness and box targets within 1e-6, on
    scenes whose boxes pick at least two different scales."""
    points, scales, valid, boxes, labels, gt_valid = assign_scene(limit)
    got = fcaf3d_assign(*map(torch.as_tensor, (points, scales, valid, boxes,
                                               labels, gt_valid)),
                        n_scales=3, limit=limit, topk=topk)
    want = jax.vmap(partial(j_assign, n_scales=3, limit=limit, topk=topk))(
        *map(jnp.asarray, (points, scales, valid, boxes, labels, gt_valid)))
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    close(got.centerness, want.centerness)
    close(got.bbox_targets, want.bbox_targets)
    pos = got.labels.numpy() >= 0
    assert len(np.unique(scales[pos])) >= 2, np.unique(scales[pos])


def test_losses_match_jax():
    """Focal, BCE, axis-aligned and rotated IoU loss sums: values and
    gradients within 1e-6 relative (gradients also within 1e-7, the rotated
    IoU's 1e-6), per sample (batched) and on one sample."""
    rng = np.random.default_rng(3)
    b, p, c = 2, 80, 5
    logits = (rng.standard_normal((b, p, c)) * 3).astype(np.float32)
    logits[0, 0, 0] = 0.0  # max(x, 0) at its tie
    labels = rng.integers(-1, c, (b, p)).astype(np.int32)
    valid = rng.random((b, p)) < 0.9
    ctr = rng.standard_normal((b, p)).astype(np.float32)
    ctr_t = rng.random((b, p)).astype(np.float32)
    pred, target = random_box_pairs(rng, b * p)
    pred7 = np.concatenate([pred, np.zeros((b * p, 1), np.float32)], 1)
    target7 = np.concatenate([target, np.zeros((b * p, 1), np.float32)], 1)
    pred7, target7 = pred7.reshape(b, p, 7), target7.reshape(b, p, 7)
    w = np.where(valid, ctr_t, 0.0).astype(np.float32)
    yaws = rng.uniform(-np.pi, np.pi, (2, b, p)).astype(np.float32)
    pred7y, target7y = pred7.copy(), target7.copy()
    pred7y[..., 6], target7y[..., 6] = yaws

    cases = {
        "focal": (lambda x: tl.focal_loss_sum(x, torch.as_tensor(labels),
                                              torch.as_tensor(valid)),
                  lambda x, i: jl.focal_loss_sum(x, labels[i], valid[i]),
                  logits),
        "bce": (lambda x: tl.bce_loss_sum(x, torch.as_tensor(ctr_t),
                                          torch.as_tensor(valid)),
                lambda x, i: jl.bce_loss_sum(x, ctr_t[i], valid[i]), ctr),
        "iou": (lambda x: tl.iou3d_loss_sum(x, torch.as_tensor(target7),
                                            torch.as_tensor(w), False),
                lambda x, i: jl.iou3d_loss_sum(x, target7[i], w[i], False),
                pred7),
        "rotated_iou": (
            lambda x: tl.iou3d_loss_sum(x, torch.as_tensor(target7y),
                                        torch.as_tensor(w), True),
            lambda x, i: jl.iou3d_loss_sum(x, jnp.asarray(target7y[i]), w[i],
                                           True),
            pred7y),
    }
    # the rotated IoU's corners take the sine and cosine of the yaw, which
    # XLA and torch may round an ulp apart
    grad_atol = {"rotated_iou": 1e-6}
    for name, (fn_t, fn_j, x) in cases.items():
        x_t = torch.tensor(x, requires_grad=True)
        got = fn_t(x_t)
        assert got.shape == (b,)
        got.sum().backward()
        for i in range(b):
            want, g = jax.value_and_grad(fn_j)(jnp.asarray(x[i]), i)
            close(got[i].detach(), want, atol=0, what=f"{name} value")
            close(x_t.grad[i], g, atol=grad_atol.get(name, 1e-7),
                  what=f"{name} grad")
        # one sample in, the JAX function's scalar out
        assert fn_t(torch.as_tensor(x))[0].dim() == 0


def test_optimizer_matches_optax():
    """Clip + AdamW + step LR on the same numpy gradients for 5 steps across
    an LR boundary, with and without the clip triggering: the pre-clip norm
    and every parameter within 1e-6 of optax's."""
    rng = np.random.default_rng(4)
    shapes = {"a": (27, 4, 8), "b": (8,), "c": ()}
    init = {k: rng.standard_normal(s).astype(np.float32)
            for k, s in shapes.items()}
    kw = dict(lr=1e-2, weight_decay=1e-2, grad_clip=10.0, steps_per_epoch=2,
              lr_steps=(1, 2))
    tx = j_make_optimizer(**kw)
    params_j = {k: jnp.asarray(v) for k, v in init.items()}
    opt_state = tx.init(params_j)
    # copies: jnp.asarray may alias the numpy buffers the port updates
    params_t = {k: torch.nn.Parameter(torch.tensor(v))
                for k, v in init.items()}
    opt = make_optimizer(list(params_t.values()), **kw)
    for step, scale in enumerate((0.1, 5.0, 0.3, 8.0, 0.05)):
        grads = {k: (rng.standard_normal(s) * scale).astype(np.float32)
                 for k, s in shapes.items()}
        for k, p in params_t.items():
            p.grad = torch.as_tensor(grads[k])
        norm = opt.step()
        gj = {k: jnp.asarray(v) for k, v in grads.items()}
        updates, opt_state = tx.update(gj, opt_state, params_j)
        params_j = optax.apply_updates(params_j, updates)
        close(norm, optax.global_norm(gj), what=f"norm step {step}")
        for k in shapes:
            close(params_t[k].detach(), params_j[k], what=f"{k} step {step}")
    assert opt.count == 5


def test_step_lr_schedule_matches_optax():
    got = step_lr_schedule(1e-3, 10, (8, 11))
    want = j_schedule(1e-3, 10, (8, 11))
    for count in (0, 79, 80, 109, 110, 500):
        assert got(count) == float(want(count)), count


def test_synth_copy_matches_jax():
    """Same seed, same scenes, exactly."""
    for fn in ("crowded_scene",):
        a = getattr(tsynth, fn)(12, 5, np.random.default_rng(0))
        b = getattr(jsynth, fn)(12, 5, np.random.default_rng(0))
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    sample = jsynth.crowded_scene(6, 3, np.random.default_rng(1))
    a = tsynth.densify(sample, 50, 80, np.random.default_rng(2))
    b = jsynth.densify(sample, 50, 80, np.random.default_rng(2))
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    box = np.array([1, 2, 0.1, 0.5, 0.7, 0.4, 0.3], np.float32)
    np.testing.assert_array_equal(
        tsynth.sample_box_surface(box, 40, np.random.default_rng(3)),
        jsynth.sample_box_surface(box, 40, np.random.default_rng(3)))


class _Scenes:
    """A dataset of crowded synthetic scenes: `ds(i, rng)` -> sample."""

    def __init__(self, n, n_classes):
        self.n, self.n_classes = n, n_classes

    def __len__(self):
        return self.n

    def __call__(self, i, rng):
        sample = jsynth.crowded_scene(3, self.n_classes,
                                      np.random.default_rng(i), extent=0.3)
        return jsynth.densify(sample, 40, 60, rng)


def test_train_model_writes_the_jax_records(tmp_path):
    """A 2-epoch run at fcaf3d_nano writes train_log.jsonl lines with the
    same keys as the JAX loop's, finite losses included."""
    cfg = dataclasses.replace(tconfigs.fcaf3d_nano(), max_epochs=2)
    jcfg = dataclasses.replace(jconfigs.fcaf3d_nano(), max_epochs=2)

    def loader():
        return Loader(_Scenes(2, cfg.n_classes), batch_size=2,
                      num_points=cfg.num_points, max_gt=cfg.max_gt_boxes,
                      shuffle=False, num_workers=1)

    train_model(cfg, loader(), str(tmp_path / "port"), log_interval=1,
                device="cpu")
    j_train_model(jcfg, loader(), str(tmp_path / "jax"), log_interval=1,
                  use_mesh=False)
    records = {}
    for side in ("port", "jax"):
        with open(tmp_path / side / "train_log.jsonl") as f:
            records[side] = [json.loads(line) for line in f]
    assert [sorted(r) for r in records["port"]] == \
        [sorted(r) for r in records["jax"]]
    assert len(records["port"]) == 4
    assert all(np.isfinite(r["loss"]) for r in records["port"] if "loss" in r)
    # resuming the finished run restores its last checkpoint and takes no
    # further step
    _, opt = train_model(cfg, loader(), str(tmp_path / "port"), resume=True,
                         device="cpu")
    assert opt.count == 2
    with open(tmp_path / "port" / "train_log.jsonl") as f:
        assert len(f.readlines()) == 4
