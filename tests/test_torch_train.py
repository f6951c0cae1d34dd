"""The port's whole train step held against the JAX package, on the CPU.

At `fcaf3d_nano` in f32 with batch 2, both packages start from the same
numpy `params.init_variables` tree and take the same numpy batch, whose GT
boxes surround head locations that survive the miniature budgets (so the
assigner finds positives and the box loss is live on both sides). The port
runs `make_train_step`; the JAX side `jax.value_and_grad` of
`FCAF3D.apply(train=True)` + `fcaf3d_loss`, as its trainer does.

Compared: the per-level head outputs of the training forward (valid masks
exact, floats atol 1e-4), the overflow counts (exact), the three losses and
the global gradient norm (rtol 1e-4), every parameter's gradient (within
1e-4 of the leaf's largest |g|; f32 summation order through the forward
and backward of ~20 layers gave 3.1e-6 at most), and the updated batch
statistics (atol 1e-5; 1.2e-7 seen).
Parameters after the Adam step are not compared: Adam maps a gradient of
~0 +- rounding to +-lr. The optimizer is held against optax on identical
gradients in `test_torch_loss.py`.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from chip_smoke import head_batch
from fcaf3d_tpu import configs as jconfigs
from fcaf3d_tpu.models.detector import FCAF3D as JFCAF3D
from fcaf3d_tpu.models.detector import loss_config as j_loss_config
from fcaf3d_tpu.models.fcaf3d_head import fcaf3d_loss as j_fcaf3d_loss
from fcaf3d_tpu_torch import configs as tconfigs
from fcaf3d_tpu_torch.params import flatten, init_variables
from fcaf3d_tpu_torch.train import create_train_state, make_train_step
from tests.test_torch_model import EXTENT
from tests.test_torch_ops import jax_without_persistent_cache  # noqa: F401

LOSSES = ("loss_cls", "loss_centerness", "loss_bbox")


def step_on_both_sides(cfg, jcfg, batch):
    """One training step of each package at the same config, weights and
    batch: (the port's {metrics, outs, overflow, grads, stats}, the JAX
    package's {total, losses, stats, overflow, outs, grads, grad_norm})."""
    variables = init_variables(cfg, seed=0)

    model = JFCAF3D(jcfg)
    lcfg = j_loss_config(jcfg)

    def loss_fn(params, batch_stats, b):
        outs, mut = model.apply(
            {"params": params, "batch_stats": batch_stats}, b["points"],
            b["colors"], b["valid"], train=True,
            mutable=["batch_stats", "overflow"])
        losses = j_fcaf3d_loss(outs, b["gt_boxes"], b["gt_labels"],
                               b["gt_valid"], lcfg)
        total = sum(losses[k] for k in LOSSES)
        return total, (losses, mut["batch_stats"], mut["overflow"], outs)

    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jv = jax.tree_util.tree_map(jnp.asarray, variables)
    (total, (losses, stats, overflow, outs)), grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(
        jv["params"], jv["batch_stats"], jb)
    want = {"total": float(total), "losses": losses, "stats": stats,
            "overflow": overflow, "outs": outs, "grads": grads,
            "grad_norm": float(optax.global_norm(grads))}

    port, opt, _ = create_train_state(cfg, seed=0, device="cpu")
    fwd_model = copy.deepcopy(port)
    with torch.no_grad():
        outs_t, ovf_t = fwd_model(*(torch.as_tensor(batch[k])
                                    for k in ("points", "colors", "valid")))
    metrics = make_train_step(port, cfg, opt)(batch)
    got = {"metrics": metrics, "outs": outs_t, "overflow": ovf_t,
           "grads": {n: p.grad for n, p in port.named_parameters()},
           "stats": dict(port.named_buffers())}
    return got, want


@pytest.fixture(scope="module")
def nano_step():
    """Both packages' results of one training step at fcaf3d_nano, B = 2."""
    cfg, jcfg = tconfigs.fcaf3d_nano(), jconfigs.fcaf3d_nano()
    return step_on_both_sides(cfg, jcfg,
                              head_batch(torch, cfg, EXTENT["fcaf3d_nano"]))


def test_train_forward_matches_jax(nano_step):
    """Per-level head outputs of the training forward and the overflow
    counts."""
    got, want = nano_step
    for i, (a, b) in enumerate(zip(got["outs"], want["outs"])):
        np.testing.assert_array_equal(a.valid.numpy(), np.asarray(b.valid))
        for f in ("centerness", "bbox_pred", "cls_scores", "points"):
            np.testing.assert_allclose(
                getattr(a, f).numpy(), np.asarray(getattr(b, f)), rtol=0,
                atol=1e-4, err_msg=f"level {i} {f}")
    sown = dict(want["overflow"])
    sown.update(sown.pop("neck_with_head"))
    assert {k: got["overflow"][k].tolist() for k in got["overflow"]} == \
        {k: np.asarray(v[0]).tolist() for k, v in sown.items()}
    assert int(got["metrics"]["overflow_max"]) == max(
        int(np.asarray(v[0]).max()) for v in sown.values())


def test_train_step_losses_and_grads_match_jax(nano_step):
    """Losses (the box loss live on both sides), the gradient norm before
    the clip, every gradient leaf and the updated batch statistics."""
    assert_step_matches(*nano_step)


def assert_step_matches(got, want):
    """`step_on_both_sides`' results agree: losses within 1e-4 relative
    (the box loss live on both sides), the gradient norm, every gradient
    element within 1e-4 of its leaf's largest, batch statistics within
    1e-5."""
    m = got["metrics"]
    for k in LOSSES:
        np.testing.assert_allclose(float(m[k]), float(want["losses"][k]),
                                   rtol=1e-4, err_msg=k)
    assert float(m["loss_bbox"]) > 0 and float(want["losses"]["loss_bbox"]) > 0
    np.testing.assert_allclose(float(m["loss"]), want["total"], rtol=1e-4)
    np.testing.assert_allclose(float(m["grad_norm"]), want["grad_norm"],
                               rtol=1e-4)
    jgrads = flatten(want["grads"])
    assert set(jgrads) == set(got["grads"])
    for name, g in jgrads.items():
        g = np.asarray(g)
        tol = 1e-4 * max(float(np.abs(g).max()), 1e-12)
        np.testing.assert_allclose(got["grads"][name].numpy(), g, rtol=0,
                                   atol=tol, err_msg=name)
    for name, v in flatten(want["stats"]).items():
        np.testing.assert_allclose(got["stats"][name].numpy(), np.asarray(v),
                                   rtol=0, atol=1e-5, err_msg=name)


def test_tiny_loss_falls_over_six_steps():
    """Six port steps at fcaf3d_tiny on one batch: finite losses, the last
    below the first, a positive gradient norm and the step count kept."""
    cfg = tconfigs.fcaf3d_tiny()
    batch = head_batch(torch, cfg, EXTENT["fcaf3d_tiny"])
    model, opt, _ = create_train_state(cfg, seed=0, device="cpu",
                                       steps_per_epoch=100)
    step = make_train_step(model, cfg, opt)
    metrics = [step(batch) for _ in range(6)]
    losses = [float(m["loss"]) for m in metrics]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    assert float(metrics[0]["loss_bbox"]) > 0
    assert float(metrics[-1]["grad_norm"]) > 0
    assert opt.count == 6
