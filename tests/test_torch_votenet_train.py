"""The port's VoteNet-v2 training (`fcaf3d_tpu_torch`) held against the JAX
package on the CPU at `votenet_tiny`, batch 2: the train-mode PointNet++
BatchNorm against flax's, the targets, the loss and its gradients, and the
whole train step against the JAX trainer's.

Both packages start from the same numpy `init_votenet_variables` tree and
the same numpy batch (`chip_smoke.vote_head_batch`: nested GT boxes about
scan points, so points lie in 0, 1, 2 and 3 boxes and proposals near them
are positives). The JAX side's `ball_query` is `ball_query_grid` in its
XLA formulation (`interpret=False`: the TPU kernel's direct distance and
first-in-index-order selection, which the port's K6 computes, without the
~85 s that tracing its Pallas kernels in interpret mode costs a traced
forward on a CPU), every call's overflow held <= 0; its FPS is the XLA
loop.
Every JAX function runs under `jax.jit`.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as fnn

from chip_smoke import vote_head_batch
from fcaf3d_tpu.models import pointnet2 as jp2
from fcaf3d_tpu.models import votenet as jv
from fcaf3d_tpu.models import votenet_v1 as jv1
from fcaf3d_tpu.ops.pointnet.ballq_kernel import ball_query_grid
from fcaf3d_tpu.train.optim import make_optimizer as j_make_optimizer
from fcaf3d_tpu.train.trainer import TrainState
from fcaf3d_tpu.train.trainer import (
    make_votenet_train_step as j_make_votenet_train_step)
from fcaf3d_tpu.train.trainer import (
    make_votenet_v1_train_step as j_make_votenet_v1_train_step)
from fcaf3d_tpu_torch import configs as tconfigs
from fcaf3d_tpu_torch.models import pointnet2 as tp2
from fcaf3d_tpu_torch.models import votenet as tv
from fcaf3d_tpu_torch.params import flatten, init_votenet_variables
from fcaf3d_tpu_torch.train import (
    create_votenet_train_state,
    make_votenet_train_step,
    make_votenet_v1_train_step,
)
from tests.test_torch_ops import jax_without_persistent_cache  # noqa: F401

V2_LOSSES = ("vote_loss", "objectness_loss", "center_loss", "semantic_loss",
             "iou_loss")


def jax_votenet(cfg, coder=None):
    """The JAX module of a config (v1 with its coder)."""
    kw = dict(n_classes=cfg.n_classes, num_proposal=cfg.num_proposal,
              backbone_num_points=cfg.backbone_num_points)
    if cfg.head_version == "v1":
        return jv1.VoteNetV1(coder=coder, **kw)
    return jv.VoteNet(n_reg_outs=cfg.n_reg_outs,
                      yaw_parametrization=cfg.yaw_parametrization, **kw)


def grid_ball_query_into(overflows):
    """A stand-in for the JAX modules' `ball_query`: `ball_query_grid` in
    its XLA formulation; each call's overflow is appended to `overflows`
    when the call runs (also under `jax.jit`)."""
    def ball_query(c, p, r, k, v=None):
        idx, overflow = ball_query_grid(c, p, r, k, v, interpret=False)
        jax.debug.callback(lambda o: overflows.append(int(o)), overflow)
        return idx

    return ball_query


@pytest.fixture
def grid_ball_query(monkeypatch):
    """`grid_ball_query_into` in place of the JAX modules' `ball_query`;
    returns the list of overflows."""
    overflows = []
    monkeypatch.setattr(jp2, "ball_query", grid_ball_query_into(overflows))
    return overflows


def to_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def assert_rel(got, want, rtol, what=""):
    """Every element of `got` within `rtol` of the largest |want|."""
    want = np.asarray(want)
    tol = rtol * max(float(np.abs(want).max()), 1e-12)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=tol,
                               err_msg=what)


# ----------------------------------------------------------------- BatchNorm

@pytest.mark.parametrize("shape,dense", [((2, 9, 5, 4), True),
                                         ((2, 64, 16, 8), False),
                                         ((3, 40, 24), False)])
def test_batch_norm_train_matches_flax(shape, dense):
    """`DenseBNReLU` (dense) or `BatchNorm` alone in training mode against
    flax's (`use_running_average=False`, fast variance) on inputs whose
    mean is of the order of their spread, as the layers' inputs are:
    outputs within 1e-5, the new batch statistics within 1e-6, input and
    parameter gradients within 1e-5 of their largest (the Dense bias, whose
    exact gradient ahead of a train-mode BN is 0, within 1e-5 of the
    kernel's largest on both sides)."""
    rng = np.random.default_rng(sum(shape))
    x = (rng.normal(0.5, 0.5, shape) * rng.uniform(0.5, 2.0, shape[-1])
         ).astype(np.float32)
    c_in, c = shape[-1], (16 if dense else shape[-1])
    params = {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
              "bias": rng.normal(0, 0.1, c).astype(np.float32)}
    stats = {"mean": rng.normal(0, 0.1, c).astype(np.float32),
             "var": rng.uniform(0.5, 2.0, c).astype(np.float32)}
    cot = rng.standard_normal(shape[:-1] + (c,)).astype(np.float32)
    if dense:
        kernel = (rng.standard_normal((c_in, c)) / 2).astype(np.float32)
        dense_p = {"kernel": kernel,
                   "bias": rng.normal(0, 0.1, c).astype(np.float32)}
        jmod = jp2.DenseBNReLU(c)
        variables = {"params": {"Dense_0": dense_p, "BatchNorm_0": params},
                     "batch_stats": {"BatchNorm_0": stats}}
        tmod = tp2.DenseBNReLU(c_in, c)
    else:
        jmod = fnn.BatchNorm(use_running_average=False, momentum=0.9,
                             epsilon=1e-5)
        variables = {"params": params, "batch_stats": stats}
        tmod = tp2.BatchNorm(c)
    flat = {**flatten(variables["params"]),
            **flatten(variables["batch_stats"])}
    tmod.load_state_dict({k: torch.as_tensor(v) for k, v in flat.items()})

    def f(p, xx):
        args = (xx, True) if dense else (xx,)
        y, mut = jmod.apply({"params": p,
                             "batch_stats": variables["batch_stats"]},
                            *args, mutable=["batch_stats"])
        return jnp.sum(y * cot), (y, mut["batch_stats"])

    (_, (y, new_stats)), (gp, gx) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(to_jax(variables["params"]),
                                         jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    tmod.train()
    yt = tmod(xt)
    (yt * torch.as_tensor(cot)).sum().backward()
    np.testing.assert_allclose(yt.detach().numpy(), np.asarray(y), rtol=0,
                               atol=1e-5)
    buffers = dict(tmod.named_buffers())
    for name, v in flatten(new_stats).items():
        np.testing.assert_allclose(buffers[name].numpy(), np.asarray(v),
                                   rtol=0, atol=1e-6, err_msg=name)
    assert_rel(xt.grad.numpy(), gx, 1e-5, "input gradient")
    grads = {n: p.grad.numpy() for n, p in tmod.named_parameters()}
    jgrads = flatten(gp)
    for name, g in jgrads.items():
        if name == "Dense_0.bias":
            scale = np.abs(jgrads["Dense_0.kernel"]).max()
            assert max(np.abs(grads[name]).max(),
                       np.abs(g).max()) <= 1e-5 * scale
        else:
            assert_rel(grads[name], g, 1e-5, name)


def test_batch_norm_fast_variance_against_float64():
    """Far from zero mean (|mean| / std ~ 6) the fast variance loses digits
    on both sides; the port's batch statistics and outputs stay at least as
    close to float64 as flax's (whose f32 reductions sum in order)."""
    shape = (2, 64, 16, 8)
    rng = np.random.default_rng(0)
    x = (rng.normal(3.0, 0.5, shape) * rng.uniform(0.5, 2.0, 8)).astype(
        np.float32)
    jmod = fnn.BatchNorm(use_running_average=False, momentum=0.9,
                         epsilon=1e-5)
    variables = {"params": {"scale": jnp.ones(8), "bias": jnp.zeros(8)},
                 "batch_stats": {"mean": jnp.zeros(8), "var": jnp.ones(8)}}
    y, mut = jmod.apply(variables, jnp.asarray(x), mutable=["batch_stats"])
    tmod = tp2.BatchNorm(8).train()
    with torch.no_grad():
        yt = tmod(torch.as_tensor(x)).numpy()
    x64 = x.astype(np.float64).reshape(-1, 8)
    mean = x64.mean(0)
    var = (x64 ** 2).mean(0) - mean ** 2
    y64 = (x64 - mean) / np.sqrt(var + 1e-5)
    flax_err = np.abs(np.asarray(y).reshape(-1, 8) - y64).max()
    assert np.abs(yt.reshape(-1, 8) - y64).max() <= flax_err
    want_var = 0.9 + 0.1 * var
    flax_var_err = np.abs(np.asarray(mut["batch_stats"]["var"])
                          - want_var).max()
    assert np.abs(tmod.var.numpy() - want_var).max() <= flax_var_err


# ------------------------------------------------------- targets and losses

def tiny_batch(cfg, with_yaw=None):
    """`vote_head_batch` at `cfg` (yawed boxes when `with_yaw`)."""
    import dataclasses

    if with_yaw is not None:
        cfg = dataclasses.replace(cfg, with_yaw=with_yaw)
    return vote_head_batch(cfg)


def jax_preds(cfg, batch, coder=None):
    """The JAX module's train-mode forward on the batch from the seed-0
    variables, with the grid ball query (no overflow): numpy arrays."""
    model = jax_votenet(cfg, coder)
    overflows = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jp2, "ball_query", grid_ball_query_into(overflows))
        preds, _ = jax.jit(lambda v, x: model.apply(
            v, x, train=True, mutable=["batch_stats"]))(
            to_jax(init_votenet_variables(cfg, 0, coder)),
            jnp.asarray(batch["points"]))
        preds = {k: np.asarray(v) for k, v in preds.items()}
    assert len(overflows) == 5 and max(overflows) <= 0
    return preds


@pytest.fixture(scope="module")
def tiny_preds():
    """(cfg, batch, the JAX train-mode predictions) at votenet_tiny."""
    cfg = tconfigs.votenet_tiny()
    batch = tiny_batch(cfg)
    return cfg, batch, jax_preds(cfg, batch)


def test_batch_has_points_in_zero_to_three_boxes(tiny_preds):
    _, batch, _ = tiny_preds
    from fcaf3d_tpu_torch.core.geometry import points_in_boxes

    inside = points_in_boxes(torch.as_tensor(batch["points"][..., :3]),
                             torch.as_tensor(batch["gt_boxes"]))
    counts = (inside & torch.as_tensor(batch["gt_valid"])[:, None]).sum(-1)
    assert set(counts.flatten().tolist()) == {0, 1, 2, 3}


def test_votenet_targets_matches_jax(tiny_preds):
    """Integer and mask outputs exactly equal, floats within 1e-6, with
    positives and definite negatives among the proposals."""
    cfg, batch, preds = tiny_preds
    args = (batch["points"][..., :3], batch["gt_boxes"], batch["gt_labels"],
            batch["gt_valid"], preds["aggregated_points"])
    want = jv.votenet_targets(*map(jnp.asarray, args), cfg.gt_per_seed)
    got = tv.votenet_targets(*map(torch.as_tensor, args), cfg.gt_per_seed)
    for f in ("vote_mask", "objectness", "objectness_mask",
              "assigned_labels"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)
    for f in ("vote_targets", "assigned_boxes"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=0,
                                   atol=1e-6, err_msg=f)
    obj = np.asarray(want.objectness)
    mask = np.asarray(want.objectness_mask)
    assert obj.sum() > 0 and (mask - obj).sum() > 0


GRAD_KEYS = ("vote_points", "obj_scores", "sem_scores", "bbox_preds")


@pytest.mark.parametrize("with_yaw", [True, False])
def test_votenet_loss_matches_jax(tiny_preds, with_yaw):
    """The five losses (each live) within 1e-5 relative and their sum's
    gradients with respect to the predictions within 1e-5 of each
    prediction's largest, on the JAX train-mode predictions."""
    cfg, batch, preds = tiny_preds
    gt = [batch[k] for k in ("points", "gt_boxes", "gt_labels", "gt_valid")]

    def jloss(p):
        losses = jv.votenet_loss({**preds, **p}, *map(jnp.asarray, gt),
                                 n_classes=cfg.n_classes, with_yaw=with_yaw,
                                 gt_per_seed=cfg.gt_per_seed)
        return sum(losses.values()), losses

    (_, want), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        {k: jnp.asarray(preds[k]) for k in GRAD_KEYS})
    leaves = {k: torch.tensor(preds[k], requires_grad=True)
              for k in GRAD_KEYS}
    tpreds = {k: torch.as_tensor(v) for k, v in preds.items()}
    got = tv.votenet_loss({**tpreds, **leaves}, *map(torch.as_tensor, gt),
                          n_classes=cfg.n_classes, with_yaw=with_yaw,
                          gt_per_seed=cfg.gt_per_seed)
    sum(got.values()).backward()
    assert list(got) == list(V2_LOSSES) and set(want) == set(V2_LOSSES)
    for k in V2_LOSSES:
        assert float(want[k]) > 0, k
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5,
                                   err_msg=k)
    for k in GRAD_KEYS:
        assert_rel(leaves[k].grad.numpy(), jgrads[k], 1e-5, k)


# ------------------------------------------------------------ train steps

def to_float64(tree):
    """numpy float32 leaves as float64 JAX arrays (others as they are), for
    use under `jax.enable_x64`."""
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(np.asarray(a, np.float64)
                              if np.asarray(a).dtype == np.float32 else a),
        tree)


def step_on_both_sides(cfg, batch, coder=None, jax_coder=None):
    """One train step of each package from the same variables and batch (a
    v1 config with the port's `coder` and the JAX package's `jax_coder` of
    the same fields), in float64, and the port's step in float32.

    The JAX side runs in float64 (`jax.enable_x64`): its trainer's
    `make_votenet_train_step` (v1: `make_votenet_v1_train_step`) for the
    metrics, the new parameters and batch statistics, and `jax.grad` of the
    same loss for the gradients. In float32 the two packages' gradients
    cannot be held element by element: flax's train-mode BN sums its
    statistics in order (`mean(x^2)` over SA1's 16 384 rows ~1e-5 off,
    ~10x the port's pairwise sums), and at these sizes one near-tie of a
    max-pool or a ReLU moves a gradient by ~1e-3 of its leaf (the port's
    own float32 step is 0.8% from its float64 step at tiny v1; every FPS
    index and group equal). In float64 nothing is that close to a tie.
    Returns ({torch.float64: port results, torch.float32: port results},
    JAX results, lr), results {metrics, grads, stats, params} as numpy."""
    variables = init_votenet_variables(cfg, seed=0, coder=coder)
    model = jax_votenet(cfg, jax_coder)
    if cfg.head_version == "v1":
        make_step = j_make_votenet_v1_train_step

        def loss_of(preds, b):
            return jv1.votenet_v1_loss(
                preds, b["points"], b["gt_boxes"], b["gt_labels"],
                b["gt_valid"], coder=jax_coder, n_classes=cfg.n_classes,
                gt_per_seed=cfg.gt_per_seed)
    else:
        make_step = j_make_votenet_train_step

        def loss_of(preds, b):
            return jv.votenet_loss(
                preds, b["points"], b["gt_boxes"], b["gt_labels"],
                b["gt_valid"], n_classes=cfg.n_classes,
                with_yaw=cfg.with_yaw, gt_per_seed=cfg.gt_per_seed)

    with jax.enable_x64(True):
        tx = j_make_optimizer(lr=cfg.lr, weight_decay=cfg.weight_decay,
                              grad_clip=cfg.grad_clip, steps_per_epoch=1,
                              lr_steps=cfg.lr_steps)
        jb = to_float64(batch)
        jvars = to_float64(variables)

        def grads_of(params):
            def f(p):
                preds, _ = model.apply(
                    {"params": p, "batch_stats": jvars["batch_stats"]},
                    jb["points"], train=True, mutable=["batch_stats"])
                return sum(loss_of(preds, jb).values())
            return jax.grad(f)(params)

        grads = jax.jit(grads_of)(jvars["params"])
        state = TrainState(step=jnp.zeros((), jnp.int32),
                           params=jvars["params"],
                           batch_stats=jvars["batch_stats"],
                           opt_state=tx.init(jvars["params"]))
        new_state, metrics = make_step(model, cfg, tx)(state, jb)
        want = jax.tree_util.tree_map(np.asarray, {
            "metrics": metrics, "grads": grads,
            "stats": new_state.batch_stats, "params": new_state.params})
    want["metrics"] = {k: float(v) for k, v in want["metrics"].items()}

    make_port_step = (make_votenet_v1_train_step if cfg.head_version == "v1"
                      else make_votenet_train_step)
    got = {}
    for dtype in (torch.float64, torch.float32):
        port, opt, _ = create_votenet_train_state(cfg, seed=0, device="cpu",
                                                  coder=coder)
        port.to(dtype)  # in place: the optimizer keeps the parameters
        b = {k: v.astype(np.float64) if dtype == torch.float64
             and v.dtype == np.float32 else v for k, v in batch.items()}
        metrics = make_port_step(port, cfg, opt)(b)
        got[dtype] = {
            "metrics": {k: float(v) for k, v in metrics.items()},
            "grads": {n: p.grad.numpy() for n, p in port.named_parameters()},
            "stats": {n: v.numpy() for n, v in port.named_buffers()},
            "params": {n: p.detach().numpy()
                       for n, p in port.named_parameters()}}
    return got, want, cfg.lr


def assert_step_matches(got, want, lr, live):
    """Losses (those in `live` live on both sides), the loss and the
    gradient norm within 1e-4 relative; every gradient element within 1e-4
    of its leaf's largest; batch statistics within 1e-5.

    A Dense bias ahead of a train-mode BN has an exact gradient of 0 (the
    BN removes the batch mean): both sides' rounding noise is held within
    1e-4 of the largest gradient of the layer's kernel instead.

    Parameters after the clip and the AdamW step within 1e-6 wherever the
    reference's clipped gradient exceeds 1e-4 and its leaf's tolerance:
    there the first step's update, g / (|g| + 1e-8), is fixed to ~1e-4 of
    lr. Elsewhere it maps gradients at rounding level to anything in
    [-lr, lr], and those parameters are held within 2 lr plus the decay
    (the step's bound)."""
    assert set(got["metrics"]) == set(want["metrics"])
    for k, v in want["metrics"].items():
        np.testing.assert_allclose(got["metrics"][k], v, rtol=1e-4,
                                   err_msg=k)
    for k in live:
        assert got["metrics"][k] > 0 and want["metrics"][k] > 0, k
    jgrads = flatten(want["grads"])
    assert set(jgrads) == set(got["grads"])
    clip = min(1.0, 10.0 / want["metrics"]["grad_norm"])
    for name, g in jgrads.items():
        if name.endswith("Dense_0.bias"):
            scale = np.abs(jgrads[name[:-4] + "kernel"]).max()
            for side in (got["grads"][name], g):
                assert np.abs(side).max() <= 1e-4 * scale, name
            tol = None
        else:
            tol = 1e-4 * max(float(np.abs(g).max()), 1e-12)
            np.testing.assert_allclose(got["grads"][name], g, rtol=0,
                                       atol=tol, err_msg=name)
        p_want = np.asarray(flatten(want["params"])[name])
        p_got = got["params"][name]
        fixed = (np.zeros(g.shape, bool) if tol is None
                 else (np.abs(g) * clip > 1e-4) & (np.abs(g) > 10 * tol))
        np.testing.assert_allclose(p_got[fixed], p_want[fixed], rtol=0,
                                   atol=1e-6, err_msg=name)
        assert (np.abs(p_got - p_want)[~fixed]
                <= 2 * lr * (1 + 0.01 * np.abs(p_want[~fixed])) + 1e-6).all()
    for name, v in flatten(want["stats"]).items():
        np.testing.assert_allclose(got["stats"][name], v, rtol=0, atol=1e-5,
                                   err_msg=name)


def assert_float32_step_near(got, want):
    """The port's float32 step against the float64 reference: losses, loss
    and gradient norm within 1e-4 relative, each gradient leaf within 5e-2
    of the reference in L2 norm (the near-ties of `step_on_both_sides`)
    but the Dense biases ahead of a BN, batch statistics within 1e-4."""
    for k, v in want["metrics"].items():
        np.testing.assert_allclose(got["metrics"][k], v, rtol=1e-4,
                                   err_msg=k)
    for name, g in flatten(want["grads"]).items():
        if not name.endswith("Dense_0.bias"):
            err = np.linalg.norm(got["grads"][name] - g) / np.linalg.norm(g)
            assert err <= 5e-2, (name, err)
    for name, v in flatten(want["stats"]).items():
        np.testing.assert_allclose(got["stats"][name], v, rtol=0, atol=1e-4,
                                   err_msg=name)


def test_votenet_train_step_matches_jax(grid_ball_query):
    """The port's `make_votenet_train_step` against the JAX trainer's at
    votenet_tiny, batch 2, both in float64 (`assert_step_matches`), and the
    port's float32 step near them (`assert_float32_step_near`); ten ball
    queries (two runs of five), none overflowing."""
    cfg = tconfigs.votenet_tiny()
    got, want, lr = step_on_both_sides(cfg, tiny_batch(cfg))
    assert len(grid_ball_query) == 10 and max(grid_ball_query) <= 0
    assert_step_matches(got[torch.float64], want, lr, V2_LOSSES)
    assert_float32_step_near(got[torch.float32], want)


def loss_falls(cfg, coder=None):
    """Six port steps on one batch at a low LR: finite losses, the last
    below the first, a positive gradient norm and the step count kept."""
    import dataclasses

    cfg = dataclasses.replace(cfg, lr=1e-3)
    batch = tiny_batch(cfg)
    model, opt, _ = create_votenet_train_state(cfg, seed=0, device="cpu",
                                               steps_per_epoch=100,
                                               coder=coder)
    step = (make_votenet_v1_train_step if cfg.head_version == "v1"
            else make_votenet_train_step)(model, cfg, opt)
    metrics = [step(batch) for _ in range(6)]
    losses = [float(m["loss"]) for m in metrics]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    assert float(metrics[-1]["grad_norm"]) > 0
    assert opt.count == 6


def test_votenet_loss_falls_over_six_steps():
    loss_falls(tconfigs.votenet_tiny())


def test_k5_max_active_clusters_hands_the_plan(monkeypatch):
    """`max_active_clusters` hands the cluster kernel's occupancy query
    (`fcaf3d_fps_cluster_occupancy`, declared in `csrc/fps.cu`) the plan's
    cluster size, CTA size and points a thread, and returns the count it
    writes; a non-zero cudaError_t raises."""
    import pathlib

    from fcaf3d_tpu_torch import _native
    from fcaf3d_tpu_torch.ops.pointnet import fps as tfps

    src = (pathlib.Path(tfps.__file__).parents[2] / "csrc" / "fps.cu")
    assert "fcaf3d_fps_cluster_occupancy(int cs, int threads, int ppt," \
        in src.read_text()
    calls = []

    class Lib:
        err = 0

        def fcaf3d_fps_cluster_occupancy(self, cs, threads, ppt, out):
            calls.append((cs, threads, ppt))
            out._obj.value = 45
            return self.err

    lib = Lib()
    monkeypatch.setattr(_native, "load", lambda: lib)
    plan = tfps.fps_plan(16, 20000, 2048)
    assert tfps.max_active_clusters(plan) == 45
    assert calls == [(plan.cs, plan.threads, plan.points_per_thread)]
    lib.err = 2
    with pytest.raises(RuntimeError):
        tfps.max_active_clusters(plan)
