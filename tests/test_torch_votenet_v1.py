"""The port's bin-based VoteNet-v1 (`fcaf3d_tpu_torch.models.votenet_v1`)
held against the JAX package on the CPU: the box coder of both factory
configs and of the JAX tests' miniature coder, and at `votenet_tiny` with
`head_version="v1"`, batch 2, the forward, the loss and its gradients,
NMS and the whole train step against the JAX trainer's.

The JAX side's ball query and the batch are those of
`test_torch_votenet_train.py` (the XLA formulation of `ball_query_grid`,
`chip_smoke.vote_head_batch`); the train step is compared against the JAX
trainer in float64 for the reason given there.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import tiny_coder
from fcaf3d_tpu.models import pointnet2 as jp2
from fcaf3d_tpu.models import votenet_v1 as jv1
from fcaf3d_tpu_torch import configs as tconfigs
from fcaf3d_tpu_torch.apis import init_votenet
from fcaf3d_tpu_torch.models import votenet_v1 as tv1
from fcaf3d_tpu_torch.params import init_votenet_variables
from tests.test_torch_ops import jax_without_persistent_cache  # noqa: F401
from tests.test_torch_votenet_train import (
    assert_float32_step_near,
    assert_rel,
    assert_step_matches,
    grid_ball_query,  # noqa: F401
    grid_ball_query_into,
    jax_votenet,
    loss_falls,
    step_on_both_sides,
    tiny_batch,
    to_jax,
)

V1_LOSSES = ("vote_loss", "objectness_loss", "center_loss", "dir_class_loss",
             "dir_res_loss", "size_class_loss", "size_res_loss",
             "semantic_loss")
CODERS = {"sunrgbd": (tv1.sunrgbd_coder, jv1.sunrgbd_coder),
          "scannet": (tv1.scannet_coder, jv1.scannet_coder),
          "tiny": (tiny_coder, None)}


def coder_pair(name):
    """(the port's coder, the JAX package's coder of the same fields)."""
    port = CODERS[name][0]()
    return port, jv1.PartialBinBasedBBoxCoder(**dataclasses.asdict(port))


def tiny_v1():
    return dataclasses.replace(tconfigs.votenet_tiny(), head_version="v1")


def to_numpy(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


@pytest.mark.parametrize("name", ["sunrgbd", "scannet"])
def test_factory_coders_match_jax(name):
    port, jax_coder = CODERS[name][0](), CODERS[name][1]()
    assert dataclasses.asdict(port) == dataclasses.asdict(jax_coder)


@pytest.mark.parametrize("name", sorted(CODERS))
def test_angle2class_at_bin_edges_matches_jax(name):
    """`angle2class` and `class2angle` on angles at every bin edge (and at
    0, +-pi, +-2 pi) and one f32 ulp to either side, from -2 pi to 2 pi:
    bins exactly equal, residuals and angles within 1e-6."""
    port, jax_coder = coder_pair(name)
    width = np.float32(port.angle_per_class)
    edges = (np.arange(-2 * port.num_dir_bins - 1, 2 * port.num_dir_bins + 2)
             * width + width / 2).astype(np.float32)
    edges = np.concatenate([edges, np.float32([0, np.pi, -np.pi, 2 * np.pi,
                                               -2 * np.pi])])
    angles = np.concatenate([edges, np.nextafter(edges, np.float32(np.inf)),
                             np.nextafter(edges, np.float32(-np.inf))])
    want_cls, want_res = jax_coder.angle2class(jnp.asarray(angles))
    got_cls, got_res = port.angle2class(torch.as_tensor(angles))
    np.testing.assert_array_equal(got_cls.numpy(), np.asarray(want_cls))
    np.testing.assert_allclose(got_res.numpy(), np.asarray(want_res), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(
        port.class2angle(got_cls, got_res).numpy(),
        np.asarray(jax_coder.class2angle(want_cls, want_res)), rtol=0,
        atol=1e-6)


@pytest.mark.parametrize("name", sorted(CODERS))
def test_coder_encode_split_decode_match_jax(name):
    """`encode` of random gravity-centred boxes and `split_pred` / `decode`
    of random head outputs [2, 30, ...]: classes exactly equal, floats
    within 1e-6."""
    port, jax_coder = coder_pair(name)
    rng = np.random.default_rng(len(name))
    boxes = np.concatenate([rng.uniform(-2, 2, (2, 30, 3)),
                            rng.uniform(0.2, 2.5, (2, 30, 3)),
                            rng.uniform(-4, 4, (2, 30, 1))], -1).astype(
        np.float32)
    labels = rng.integers(0, port.num_sizes, (2, 30)).astype(np.int32)
    want = jax_coder.encode(jnp.asarray(boxes), jnp.asarray(labels))
    got = port.encode(torch.as_tensor(boxes), torch.as_tensor(labels))
    for i, (a, b) in enumerate(zip(got, want)):
        if i in (1, 3):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        else:
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=1e-6, err_msg=str(i))
    cls_out = rng.standard_normal((2, 30, 6)).astype(np.float32)
    reg_out = rng.standard_normal(
        (2, 30, 3 + 2 * port.num_dir_bins + 4 * port.num_sizes)).astype(
        np.float32)
    base = rng.uniform(-2, 2, (2, 30, 3)).astype(np.float32)
    want = jax_coder.split_pred(*map(jnp.asarray, (cls_out, reg_out, base)))
    got = port.split_pred(*map(torch.as_tensor, (cls_out, reg_out, base)))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(port.decode(got).numpy(),
                               np.asarray(jax_coder.decode(want)), rtol=0,
                               atol=1e-6)


@pytest.fixture(scope="module")
def v1_preds():
    """(cfg, coder, batch, the JAX module's eval-mode predictions with "vote"
    sampling, the port's on the same variables) at tiny v1."""
    cfg, coder = tiny_v1(), tiny_coder()
    batch = tiny_batch(cfg)
    model = init_votenet(cfg, seed=0, device="cpu", coder=coder)
    overflows = []
    jmodel = jax_votenet(cfg, coder_pair("tiny")[1])

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jp2, "ball_query", grid_ball_query_into(overflows))
        want = jax.jit(lambda v, x: jmodel.apply(
            v, x, train=False, sample_mod="vote"))(
            to_jax(init_votenet_variables(cfg, 0, coder)),
            jnp.asarray(batch["points"]))
        want = to_numpy(want)
    assert len(overflows) == 5 and max(overflows) <= 0
    with torch.no_grad():
        got = model(torch.as_tensor(batch["points"]), sample_mod="vote")
    return cfg, coder, batch, want, got


def test_votenet_v1_forward_matches_jax(v1_preds):
    """Every output of the forward: seed indices and decoded bins exactly
    equal, floats within 1e-4 (summation order over ~20 dense layers)."""
    _, _, _, want, got = v1_preds
    assert set(got) == set(want)
    np.testing.assert_array_equal(got["seed_indices"].numpy(),
                                  want["seed_indices"])
    for k in ("dir_class", "size_class"):
        np.testing.assert_array_equal(got[k].argmax(-1).numpy(),
                                      want[k].argmax(-1), err_msg=k)
    for k in sorted(set(want) - {"seed_indices"}):
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=0,
                                   atol=1e-4, err_msg=k)


GRAD_KEYS = ("vote_points", "obj_scores", "sem_scores", "center",
             "dir_class", "dir_res_norm", "size_class", "size_res_norm")


def test_votenet_v1_loss_matches_jax(v1_preds):
    """The eight losses (each live) within 1e-5 relative and their sum's
    gradients with respect to the predictions within 1e-5 of each
    prediction's largest, on the JAX predictions."""
    cfg, coder, batch, preds, _ = v1_preds
    _, jax_coder = coder_pair("tiny")
    gt = [batch[k] for k in ("points", "gt_boxes", "gt_labels", "gt_valid")]

    def jloss(p):
        losses = jv1.votenet_v1_loss(
            {**preds, **p}, *map(jnp.asarray, gt), coder=jax_coder,
            n_classes=cfg.n_classes, gt_per_seed=cfg.gt_per_seed)
        return sum(losses.values()), losses

    (_, want), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        {k: jnp.asarray(preds[k]) for k in GRAD_KEYS})
    leaves = {k: torch.tensor(preds[k], requires_grad=True)
              for k in GRAD_KEYS}
    tpreds = {k: torch.as_tensor(v) for k, v in preds.items()}
    got = tv1.votenet_v1_loss({**tpreds, **leaves}, *map(torch.as_tensor, gt),
                              coder=coder, n_classes=cfg.n_classes,
                              gt_per_seed=cfg.gt_per_seed)
    sum(got.values()).backward()
    assert list(got) == list(V1_LOSSES) and set(want) == set(V1_LOSSES)
    for k in V1_LOSSES:
        assert float(want[k]) > 0, k
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5,
                                   err_msg=k)
    for k in GRAD_KEYS:
        assert_rel(leaves[k].grad.numpy(), jgrads[k], 1e-5, k)


@pytest.mark.parametrize("per_class_proposal", [True, False])
def test_votenet_v1_get_bboxes_matches_jax(v1_preds, per_class_proposal):
    """On the same (JAX) predictions: valid masks and labels exactly equal,
    boxes and scores within 1e-6, some detections kept."""
    cfg, _, batch, preds, _ = v1_preds
    kw = dict(nms_thr=cfg.nms_thr, score_thr=cfg.score_thr,
              per_class_proposal=per_class_proposal)
    want = jv1.votenet_v1_get_bboxes(
        {k: jnp.asarray(v) for k, v in preds.items()},
        jnp.asarray(batch["points"]), cfg.n_classes, **kw)
    got = tv1.votenet_v1_get_bboxes(
        {k: torch.as_tensor(v) for k, v in preds.items()},
        torch.as_tensor(batch["points"]), cfg.n_classes, **kw)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    for f in ("boxes", "scores"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=0,
                                   atol=1e-6, err_msg=f)
    assert np.asarray(want.valid).sum() > 0


def test_votenet_v1_train_step_matches_jax(grid_ball_query):  # noqa: F811
    """The port's `make_votenet_v1_train_step` against the JAX trainer's
    `make_votenet_v1_train_step` at tiny v1 with the miniature coder, batch
    2, in float64 (`assert_step_matches`), and the port's float32 step near
    them (`assert_float32_step_near`); ten ball queries, none
    overflowing."""
    cfg = tiny_v1()
    _, jax_coder = coder_pair("tiny")
    got, want, lr = step_on_both_sides(cfg, tiny_batch(cfg), tiny_coder(),
                                       jax_coder)
    assert len(grid_ball_query) == 10 and max(grid_ball_query) <= 0
    assert_step_matches(got[torch.float64], want, lr, V1_LOSSES)
    assert_float32_step_near(got[torch.float32], want)


def test_votenet_v1_loss_falls_over_six_steps():
    loss_falls(tiny_v1(), tiny_coder())
