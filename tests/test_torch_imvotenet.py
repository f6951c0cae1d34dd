"""The port's ImVoteNet stage 2 (`fcaf3d_tpu_torch.models.imvotenet`) held
against the JAX package on the CPU at the JAX tests' size: `ImVoteNet(
n_classes=4, num_proposal=16, num_sampled_seed=32, backbone_num_points=(64,
32, 16, 8))` on 256-point clouds with 16 x 24 images, B = 2.

The frames are `chip_smoke.imvote_frame`'s camera-consistent scenes (y
forward, z up, a 10-pixel focal length at the image centre): boxes on a
floor in front of the camera, their projections painted into the image and
given as GT 2D boxes with confidence 1, so that the fusion's pair scores
tie. Both packages start from the same numpy `init_imvotenet_variables`
tree (flax `init` runs only under `jax.eval_shape`). The JAX side's ball
query is `ball_query_grid` in its XLA formulation (`interpret=False`), as
in `tests/test_torch_votenet_train.py`, every call's overflow held <= 0;
its FPS is the XLA loop. Integers, masks, FPS indices and groups are
exactly equal; each float tolerance is stated where it is used. The train
step is held to the JAX side run in float64 (`jax.enable_x64`), as
`tests/test_torch_votenet_train.py` holds VoteNet's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from chip_smoke import (
    imvote_tiny_cfg,
    recorder,
    tiny_imvote_batch,
    tiny_imvote_frames,
    wrapped_selections,
)
from fcaf3d_tpu.apis.inference import inference_imvotenet as j_inference
from fcaf3d_tpu.models import imvotenet as ji
from fcaf3d_tpu.models import pointnet2 as jp2
from fcaf3d_tpu.ops.pointnet.ballq_kernel import ball_query_grid
from fcaf3d_tpu_torch.apis import inference_imvotenet, init_imvotenet
from fcaf3d_tpu_torch.models import imvotenet as ti
from fcaf3d_tpu_torch.params import (
    flatten,
    init_imvotenet_variables,
    load_variables,
)
from fcaf3d_tpu_torch.train import (
    create_imvotenet_train_state,
    make_imvotenet_train_step,
)
from tests.test_torch_ops import jax_without_persistent_cache  # noqa: F401
from tests.test_torch_votenet_train import (
    V2_LOSSES,
    assert_float32_step_near,
    assert_rel,
    assert_step_matches,
    to_float64,
    to_jax,
)

K_SEEDS, MAX_IMVOTE = 32, 3
TOWERS = ("joint", "pts", "img")
INPUTS = ("points", "images", "boxes2d", "boxes2d_valid")


def jax_net(cfg):
    return ji.ImVoteNet(n_classes=cfg.n_classes, n_reg_outs=cfg.n_reg_outs,
                        yaw_parametrization=cfg.yaw_parametrization,
                        num_proposal=cfg.num_proposal,
                        num_sampled_seed=K_SEEDS, max_imvote=MAX_IMVOTE,
                        backbone_num_points=cfg.backbone_num_points)


def port_net(cfg, variables):
    model = ti.ImVoteNet(cfg, K_SEEDS, MAX_IMVOTE, device="cpu")
    load_variables(model, variables)
    return model


def jax_selections(store):
    """Stand-ins for the JAX modules' FPS and ball query that append each
    call's result (and the ball query's overflow) to `store` as the call
    runs (ordered debug callbacks, also under `jax.jit`); the ball query is
    `ball_query_grid`'s XLA formulation."""
    fps = jp2.furthest_point_sample

    def furthest_point_sample(points, n, valid=None):
        out = fps(points, n, valid)
        jax.debug.callback(lambda o: store.append(("fps", np.asarray(o), 0)),
                           out, ordered=True)
        return out

    def ball_query(c, p, r, k, v=None):
        idx, overflow = ball_query_grid(c, p, r, k, v, interpret=False)
        jax.debug.callback(lambda o, ov: store.append(
            ("ball_query", np.asarray(o), int(ov))), idx, overflow,
            ordered=True)
        return idx

    return furthest_point_sample, ball_query


@pytest.fixture
def jax_calls(monkeypatch):
    """The JAX modules' FPS and ball query recorded (`jax_selections`);
    returns the list of (kind, result, overflow)."""
    store = []
    fps, bq = jax_selections(store)
    monkeypatch.setattr(jp2, "furthest_point_sample", fps)
    monkeypatch.setattr(jp2, "ball_query", bq)
    return store


@pytest.fixture(scope="module")
def setup():
    """(cfg, the frames, their training batch, the seed-0 variables). The
    batch's second frame has its 2D boxes at confidence 0.8, as a
    detector's: with confidence 1 a pair's score `inside + conf` floors to
    1 whether or not the seed is inside, so every pair with a valid box is
    kept; below 1 only the inside pairs are, fewer than the sampled seeds,
    and the resampling cycles (`chip_smoke.tiny_imvote_batch`)."""
    cfg = imvote_tiny_cfg()
    return (cfg, tiny_imvote_frames(cfg.n_classes, cfg.with_yaw),
            tiny_imvote_batch(cfg),
            init_imvotenet_variables(cfg, 0, K_SEEDS, MAX_IMVOTE))


def test_tree_matches_flax_init(setup):
    """The drawn tree has the paths, shapes and dtypes of the flax init's,
    and the port's state dict holds exactly those."""
    cfg, _, batch, variables = setup
    want = jax.eval_shape(
        lambda *a: jax_net(cfg).init(jax.random.PRNGKey(0), *a[:4],
                                     depth2img=a[4]),
        *(jnp.asarray(batch[k]) for k in INPUTS + ("depth2img",)))
    assert set(variables) == set(want) == {"params", "batch_stats"}
    want = {k: (v.shape, v.dtype) for k, v in flatten(want).items()}
    assert {k: (v.shape, v.dtype)
            for k, v in flatten(variables).items()} == want
    state = port_net(cfg, variables).state_dict()
    assert {k: tuple(v.shape) for k, v in state.items()} == {
        k.split(".", 1)[1]: s for k, (s, _) in want.items()}


def fusion_case(setup, case):
    """(image, boxes2d, valid, seeds, depth2img) numpy batches, B = 2, of
    40 seeds drawn from each frame's cloud and the batch's 2D boxes (frame
    0's at conf 1, frame 1's at 0.8): "boxes" as they are, "d_below_max"
    the first two boxes only (D = 2 < max_imvote), "none_valid" every box
    invalid, and "guard": seeds at y =
    0 (the forward-axis guard's den is exactly 0) and y = -1e-6, and two
    seeds projecting to x.5 pixels exactly (rounded half to even), one onto
    the left edge of an added integer box (not inside: the tests are
    strict)."""
    _, frames, batch, _ = setup
    rng = np.random.default_rng(0)
    seeds = np.stack([f["points"][rng.choice(len(f["points"]), 40,
                                             replace=False)]
                      for f in frames]).astype(np.float32)
    boxes, valid = batch["boxes2d"].copy(), batch["boxes2d_valid"].copy()
    if case == "d_below_max":
        boxes, valid = boxes[:, :2], valid[:, :2]
    elif case == "none_valid":
        valid[:] = False
    elif case == "guard":
        # u = 8 x + 12, v = 8 - 8 z at y = 1.25: (5.5, 10.5) and (4.5, 9.5)
        seeds[:, :4] = [[0.3, 0.0, -0.2], [0.3, -1e-6, -0.2],
                        [-0.8125, 1.25, -0.3125], [-0.9375, 1.25, -0.1875]]
        boxes[:, -1] = [4.0, 8.0, 12.0, 14.0, 0.7, 2.0]
        valid[:, -1] = True
    return (batch["images"], boxes, valid, seeds, batch["depth2img"])


@pytest.mark.parametrize("case", ["boxes", "d_below_max", "none_valid",
                                  "guard"])
def test_vote_fusion_matches_jax(setup, case):
    """Cues within 1e-5 of their largest |value|, the mask exactly equal
    (`vote_fusion` vmapped over the batch on the JAX side). At conf 1
    (frame 0) every pair with a valid box is kept, at 0.8 (frame 1) only
    the inside pairs; padded pairs (D < max_imvote) never are."""
    cfg = setup[0]
    args = fusion_case(setup, case)
    wcues, wmask = jax.jit(jax.vmap(lambda *a: ji.vote_fusion(
        *a, cfg.n_classes, MAX_IMVOTE)))(*map(jnp.asarray, args))
    cues, mask = ti.vote_fusion(*map(torch.as_tensor, args), cfg.n_classes,
                                MAX_IMVOTE)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(wmask))
    assert_rel(cues.numpy(), wcues, 1e-5)
    assert np.isfinite(cues.numpy()).all()
    n_valid = mask.reshape(2, 40, MAX_IMVOTE).sum((1, 2)).tolist()
    if case == "none_valid":
        assert n_valid == [0, 0]
    else:
        per_seed = MAX_IMVOTE if case != "d_below_max" else 2
        assert n_valid[0] == 40 * per_seed and 0 < n_valid[1] < 40
    if case == "guard":
        texture = cues.numpy().reshape(2, 40, MAX_IMVOTE, -1)[:, :, 0, -3:]
        image = args[0] / 255.0
        # the x.5 seeds sample the even pixels (4, 10) and (4, 8) (u - 1
        # and v - 1 rounded half to even); neither is inside the box at
        # u = 4 (strict)
        np.testing.assert_allclose(texture[:, 2], image[:, 10, 4], rtol=1e-6)
        np.testing.assert_allclose(texture[:, 3], image[:, 8, 4], rtol=1e-6)


@pytest.mark.parametrize("n_valid", [0, 1, 20, 96])
def test_sample_valid_seeds_matches_jax(n_valid):
    """Exactly equal indices with none, one, fewer than k (cycled) and all
    of the 96 imvotes valid, k = 32."""
    rng = np.random.default_rng(n_valid)
    mask = np.zeros((2, 96), bool)
    for row in mask:
        row[rng.choice(96, n_valid, replace=False)] = True
    want = jax.vmap(lambda m: ji.sample_valid_seeds(m, K_SEEDS))(
        jnp.asarray(mask))
    got = ti.sample_valid_seeds(torch.as_tensor(mask), K_SEEDS)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


OUT_KEYS = ("vote_points", "aggregated_points", "obj_scores", "sem_scores",
            "bbox_preds")


@pytest.mark.parametrize("towers", [("joint",), TOWERS])
def test_forward_matches_jax(setup, jax_calls, towers):
    """The evaluation-mode forward against `apply`: every FPS index and
    ball-query group exactly equal (four SA modules, then each tower's
    aggregation; no overflow), seed indices exactly equal, votes, proposals
    and the head's outputs within 1e-4 of each output's largest |value|.
    Frame 1's fusion keeps fewer imvotes than it samples (cycled)."""
    cfg, _, batch, variables = setup
    net = jax_net(cfg)
    want = jax.jit(lambda v, *a: net.apply(
        v, *a[:4], depth2img=a[4], towers=towers))(
        to_jax(variables),
        *(jnp.asarray(batch[k]) for k in INPUTS + ("depth2img",)))
    calls = []
    with torch.no_grad(), wrapped_selections(recorder(torch, calls)):
        got = port_net(cfg, variables).eval()(
            *(torch.as_tensor(batch[k]) for k in INPUTS),
            depth2img=torch.as_tensor(batch["depth2img"]), towers=towers)
    assert len(calls) == 8 + 2 * len(towers)
    assert [c[0] for c in calls] == [c[0] for c in jax_calls]
    for (kind, _, out), (_, w, overflow) in zip(calls, jax_calls):
        np.testing.assert_array_equal(out.numpy(), w, err_msg=kind)
        assert overflow <= 0
    assert list(got) == list(towers)
    for t in towers:
        np.testing.assert_array_equal(got[t]["seed_indices"].numpy(),
                                      np.asarray(want[t]["seed_indices"]))
        for k in OUT_KEYS:
            assert_rel(got[t][k].numpy(), want[t][k], 1e-4, f"{t} {k}")
    _, mask = ti.vote_fusion(
        *(torch.as_tensor(batch[k]) for k in ("images", "boxes2d",
                                              "boxes2d_valid")),
        _seeds_of(cfg, variables, batch),
        torch.as_tensor(batch["depth2img"]), cfg.n_classes, MAX_IMVOTE)
    assert mask[0].all() and 0 < mask[1].sum() < K_SEEDS


def _seeds_of(cfg, variables, batch):
    """The backbone's seeds of the batch (the port's, evaluation mode)."""
    with torch.no_grad():
        feat = port_net(cfg, variables).eval().backbone(
            torch.as_tensor(batch["points"]))
    return feat["fp_xyz"][-1]


@pytest.fixture
def grid_ball_query(monkeypatch):
    store = []
    _, bq = jax_selections(store)
    monkeypatch.setattr(jp2, "ball_query", bq)
    return store


def test_train_step_matches_jax(setup, grid_ball_query):
    """One `make_imvotenet_train_step` step against the tool's step
    (`tools/train_imvotenet.py`: three towers, `imvotenet_loss`, clip
    `cfg.grad_clip`, AdamW `cfg.lr`, `cfg.weight_decay`, constant) run in
    float64, with GT 2D boxes: the port's float64 step by VoteNet's rule
    (`assert_step_matches`: the fifteen losses, loss and gradient norm
    within 1e-4 relative, each tower's vote, centre and IoU loss live,
    gradients within 1e-4 of each leaf's largest, the running statistics
    after the chained joint, pts and img updates within 1e-5, the updated
    parameters), and its float32 step near it (`assert_float32_step_near`:
    each gradient leaf within 5% in L2 norm, statistics within 1e-4)."""
    cfg, _, batch, variables = setup
    net = jax_net(cfg)
    tx = optax.chain(optax.clip_by_global_norm(cfg.grad_clip),
                     optax.adamw(cfg.lr, weight_decay=cfg.weight_decay))
    with jax.enable_x64(True):
        jvars, jb = to_float64(variables), to_float64(batch)

        def loss_fn(p):
            outs, mut = net.apply(
                {"params": p, "batch_stats": jvars["batch_stats"]},
                *(jb[k] for k in INPUTS), depth2img=jb["depth2img"],
                train=True, mutable=["batch_stats"])
            losses = ji.imvotenet_loss(outs, jb["points"], jb["gt_boxes"],
                                       jb["gt_labels"], jb["gt_valid"],
                                       n_classes=cfg.n_classes)
            return sum(losses.values()), (losses, mut["batch_stats"])

        @jax.jit
        def step(params):
            (total, (losses, stats)), grads = jax.value_and_grad(
                loss_fn, has_aux=True)(params)
            updates, _ = tx.update(grads, tx.init(params), params)
            return {"metrics": {**losses, "loss": total,
                                "grad_norm": optax.global_norm(grads)},
                    "grads": grads, "stats": stats,
                    "params": optax.apply_updates(params, updates)}

        want = jax.tree_util.tree_map(np.asarray, step(jvars["params"]))
    want["metrics"] = {k: float(v) for k, v in want["metrics"].items()}
    assert len(grid_ball_query) == 7 and max(
        c[2] for c in grid_ball_query) <= 0
    got = {}
    for dtype in (torch.float64, torch.float32):
        port, opt, _ = create_imvotenet_train_state(
            cfg, seed=0, device="cpu", num_sampled_seed=K_SEEDS,
            max_imvote=MAX_IMVOTE)
        load_variables(port, variables)
        port.to(dtype)
        b = {k: v.astype(np.float64) if dtype == torch.float64
             and v.dtype == np.float32 else v for k, v in batch.items()}
        metrics = make_imvotenet_train_step(port, cfg, opt)(b)
        assert list(metrics)[:15] == [f"{t}_{k}" for t in TOWERS
                                      for k in V2_LOSSES]
        got[dtype] = {
            "metrics": {k: float(v) for k, v in metrics.items()},
            "grads": {n: p.grad.numpy() for n, p in port.named_parameters()},
            "stats": {n: v.numpy() for n, v in port.named_buffers()},
            "params": {n: p.detach().numpy()
                       for n, p in port.named_parameters()}}
    live = [f"{t}_{k}" for t in TOWERS
            for k in ("vote_loss", "center_loss", "iou_loss")]
    assert_step_matches(got[torch.float64], want, cfg.lr, live)
    assert_float32_step_near(got[torch.float32], want)


@pytest.mark.parametrize("empty", [False, True])
def test_inference_imvotenet_matches_jax(setup, grid_ball_query, empty):
    """`inference_imvotenet` against the JAX package's on one raw frame
    (400 points sampled to 256), with its GT 2D boxes and with an empty box
    array (the `ar % m` fallback): the same detections (labels exactly
    equal), boxes within 1e-4 and scores within 1e-5; non-empty. An empty
    list, which JAX's entry point also takes, gives exactly the empty
    array's detections."""
    cfg, frames, _, variables = setup
    f = frames[0]
    boxes = np.zeros((0, 6), np.float32) if empty else f["boxes2d"]
    args = (f["points"], f["image"], boxes, f["depth2img"])
    kw = dict(num_points=cfg.num_points, n_classes=cfg.n_classes)
    want = j_inference(jax_net(cfg), to_jax(variables), *args, **kw)
    model = init_imvotenet(cfg, 0, device="cpu", num_sampled_seed=K_SEEDS,
                           max_imvote=MAX_IMVOTE)
    got = inference_imvotenet(model, *args, **kw)
    assert len(want["scores_3d"]) > 0
    np.testing.assert_array_equal(got["labels_3d"], want["labels_3d"])
    np.testing.assert_allclose(got["boxes_3d"], want["boxes_3d"], rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(got["scores_3d"], want["scores_3d"], rtol=0,
                               atol=1e-5)
    if empty:
        from_list = inference_imvotenet(model, f["points"], f["image"], [],
                                        f["depth2img"], **kw)
        for k, v in got.items():
            np.testing.assert_array_equal(from_list[k], v)
