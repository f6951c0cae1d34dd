"""The port's ImVoteNet 2D detector (`fcaf3d_tpu_torch.models.detector2d`)
held against the JAX package on the CPU at the JAX tests' size:
`Detector2D(n_classes=4, width=16, fpn_ch=32)` on 96 x 128 images, B = 2.

Both packages start from the same numpy `init_detector2d_variables` tree
(flax modules are applied to it; flax `init` runs only under
`jax.eval_shape`) and the same numpy images, painted with flat boxes as
`tests/test_detector2d.py` paints them, so scores tie over flat regions.
Integer outputs, top-k indices and keep masks are exactly equal; each float
tolerance is stated where it is used. The loss and the train step are held
to the JAX side run in float64 (`jax.enable_x64`): in float32 the order of
the sums moves them by more than the port's own rounding.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as fnn

from chip_smoke import DET2D_TINY, det2d_tiny_batch
from fcaf3d_tpu.models import detector2d as jd
from fcaf3d_tpu_torch.models import detector2d as td
from fcaf3d_tpu_torch.params import (
    flatten,
    init_detector2d_variables,
    load_variables,
)
from fcaf3d_tpu_torch.train import (
    create_detector2d_train_state,
    make_detector2d_train_step,
)
from tests.test_torch_ops import jax_without_persistent_cache  # noqa: F401
from tests.test_torch_votenet_train import assert_rel, to_float64, to_jax

N_CLASSES, WIDTH, FPN_CH = DET2D_TINY.values()
HW = (96, 128)
LOSSES = ("cls_loss", "reg_loss", "ctr_loss")


@pytest.fixture(scope="module")
def setup():
    """(variables, batch, the JAX forward's outputs as numpy, the JAX
    module)."""
    model = jd.Detector2D(n_classes=N_CLASSES, width=WIDTH, fpn_ch=FPN_CH)
    variables = init_detector2d_variables(N_CLASSES, WIDTH, FPN_CH, seed=0)
    batch = det2d_tiny_batch()
    outs = jax.jit(model.apply)(to_jax(variables),
                                jnp.asarray(batch["images"]))
    return variables, batch, jax.tree_util.tree_map(np.asarray, outs), model


def port_model(variables):
    model = td.Detector2D(N_CLASSES, WIDTH, FPN_CH, device="cpu")
    load_variables(model, variables)
    return model


def test_tree_matches_flax_init():
    """The drawn tree has the paths, shapes and dtypes of the flax init's
    (no batch_stats), and the port's state dict holds exactly those."""
    model = jd.Detector2D(n_classes=N_CLASSES, width=WIDTH, fpn_ch=FPN_CH)
    want = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                          jnp.zeros((1,) + HW + (3,)))
    got = init_detector2d_variables(N_CLASSES, WIDTH, FPN_CH)
    assert set(got) == set(want) == {"params"}
    shapes = {k: (v.shape, v.dtype) for k, v in flatten(want).items()}
    assert {k: (v.shape, v.dtype) for k, v in flatten(got).items()} == shapes
    state = port_model(got).state_dict()
    assert {k: tuple(v.shape) for k, v in state.items()} == {
        k[len("params."):]: s for k, (s, _) in shapes.items()}


@pytest.mark.parametrize("hw", [HW, (80, 112)])
def test_forward_matches_flax(setup, hw):
    """Each level's cls, ctr and reg within 1e-4 of the level's largest |x|.
    96 x 128 has a 3 x 4 map at /32 (odd), upsampled exactly 2x; 80 x 112
    (not a multiple of 32) has odd maps at /16 and /32 and a 3 -> 5 nearest
    resize, with (0, 1) and (1, 1) "SAME" pads on the way."""
    variables, _, _, model = setup
    batch = det2d_tiny_batch(seed=1, hw=hw, noise=True)
    outs = jax.tree_util.tree_map(np.asarray, jax.jit(model.apply)(
        to_jax(variables), jnp.asarray(batch["images"])))
    assert outs[2]["ctr"].shape[1:] == (3, 4)
    assert outs[1]["ctr"].shape[1:] == ((6, 8) if hw == HW else (5, 7))
    with torch.no_grad():
        got = port_model(variables)(torch.as_tensor(batch["images"]))
    for lvl, (g, w) in enumerate(zip(got, outs)):
        for k in ("cls", "ctr", "reg"):
            assert tuple(g[k].shape) == w[k].shape, (lvl, k)
            assert_rel(g[k].numpy(), w[k], 1e-4, f"level {lvl} {k}")


@pytest.mark.parametrize("n,k,stride", [(96, 3, 2), (12, 3, 2), (13, 3, 2),
                                        (96, 1, 2), (24, 3, 1)])
def test_conv_pads_same_as_flax(n, k, stride):
    """One conv against flax `nn.Conv` within 1e-5 of the largest output;
    where flax pads (0, 1) (a 3 x 3 stride-2 conv on an even size),
    PyTorch's symmetric padding of 1 gives another result (its outputs
    differ from flax's by more than 1e-2 of their largest)."""
    rng = np.random.default_rng(n + k)
    x = rng.standard_normal((2, n, n + 4, 5)).astype(np.float32)
    kernel = rng.standard_normal((k, k, 5, 6)).astype(np.float32)
    bias = rng.standard_normal(6).astype(np.float32)
    want = np.asarray(fnn.Conv(6, (k, k), strides=(stride, stride)).apply(
        {"params": {"kernel": kernel, "bias": bias}}, jnp.asarray(x)))
    conv = td.Conv(5, 6, k, stride)
    conv.load_state_dict({"kernel": torch.as_tensor(kernel),
                          "bias": torch.as_tensor(bias)})
    xt = torch.as_tensor(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        got = conv(xt).permute(0, 2, 3, 1).numpy()
        sym = torch.nn.functional.conv2d(
            xt, conv.kernel.permute(3, 2, 0, 1), conv.bias, stride,
            k // 2).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    assert_rel(got, want, 1e-5)
    if k == 3 and stride == 2 and n % 2 == 0:
        assert np.abs(sym - want).max() > 1e-2 * np.abs(want).max()
    elif sym.shape == want.shape:
        assert_rel(sym, want, 1e-5)


@pytest.mark.parametrize("ch", [8, 16, 64])
def test_group_norm_matches_flax(ch):
    """`GroupNorm` against flax's `nn.GroupNorm(gcd(32, ch))` on inputs
    whose |mean| is of the order of their spread: outputs within 1e-5 of
    their largest, input and parameter gradients within 1e-5 of each
    one's largest."""
    rng = np.random.default_rng(ch)
    x = (rng.normal(1.0, 1.0, (2, 6, 10, ch))
         * rng.uniform(0.5, 2.0, ch)).astype(np.float32)
    params = {"scale": rng.uniform(0.5, 1.5, ch).astype(np.float32),
              "bias": rng.normal(0, 0.1, ch).astype(np.float32)}
    cot = rng.standard_normal(x.shape).astype(np.float32)
    jmod = fnn.GroupNorm(num_groups=math.gcd(32, ch))

    def f(p, xx):
        y = jmod.apply({"params": p}, xx)
        return jnp.sum(y * cot), y

    (_, y), (gp, gx) = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True))(to_jax(params), jnp.asarray(x))
    mod = td.GroupNorm(ch)
    mod.load_state_dict({k: torch.as_tensor(v) for k, v in params.items()})
    xt = torch.tensor(x, requires_grad=True)
    yt = mod(xt.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    (yt * torch.as_tensor(cot)).sum().backward()
    assert_rel(yt.detach().numpy(), y, 1e-5, "output")
    assert_rel(xt.grad.numpy(), gx, 1e-5, "input gradient")
    for k in params:
        assert_rel(getattr(mod, k).grad.numpy(), gp[k], 1e-5, k)


def gt_with_ties(batch):
    """The batch's GT with box 0 of image 0 on whole pixels and box 1 its
    copy shifted by half its size, rounded to whole pixels (an equal area,
    overlapping it, exactly in f32 and f64): pixels inside both take box
    0, the first at the area tie."""
    gt = {k: batch[k].copy() for k in ("gt_boxes", "gt_labels", "gt_valid")}
    b0 = np.round(gt["gt_boxes"][0, 0])
    half = np.round((b0[2:] - b0[:2]) / 2)
    gt["gt_boxes"][0, 0] = b0
    gt["gt_boxes"][0, 1] = np.concatenate([b0[:2] + half, b0[2:] + half])
    return gt


def test_fcos_targets_match_jax(setup):
    """Labels and pos exactly equal, ltrb and ctr within 1e-5, with
    positives on levels 0 and 1 (at 96 x 128 no box reaches level 2's
    range) and an area tie that the first box wins."""
    _, batch, outs, _ = setup
    gt = gt_with_ties(batch)
    want = jax.jit(jd.fcos_targets)(to_jax(outs),
                                    *map(jnp.asarray, gt.values()))
    got = td.fcos_targets(
        jax.tree_util.tree_map(torch.as_tensor, outs),
        *map(torch.as_tensor, gt.values()))
    tie = 0
    for lvl, (g, w) in enumerate(zip(got, want)):
        for k in ("labels", "pos"):
            np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]),
                                          err_msg=f"{lvl} {k}")
        for k in ("ltrb", "ctr"):
            np.testing.assert_allclose(g[k].numpy(), np.asarray(w[k]),
                                       rtol=0, atol=1e-5, err_msg=f"{lvl} {k}")
        assert lvl == 2 or np.asarray(w["pos"]).any(), lvl
        tie += int((np.asarray(w["labels"])[0]
                    == gt["gt_labels"][0, 0]).sum())
    assert tie > 0


def loss_grads_jax(outs, gt, x64):
    """JAX `detector2d_loss` and its gradients with respect to every
    output, in float64 when `x64`."""
    with jax.enable_x64(x64):
        cast = to_float64 if x64 else to_jax
        jouts, jgt = cast(outs), cast(gt)

        def f(o):
            losses = jd.detector2d_loss(o, *jgt.values())
            return sum(losses.values()), losses

        (_, losses), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(
            jouts)
        return ({k: float(v) for k, v in losses.items()},
                jax.tree_util.tree_map(np.asarray, grads))


def loss_grads_port(outs, gt, dtype):
    leaves = jax.tree_util.tree_map(
        lambda a: torch.tensor(a, dtype=dtype, requires_grad=True), outs)
    losses = td.detector2d_loss(leaves, *(torch.as_tensor(
        v.astype(np.float64) if dtype == torch.float64 and v.dtype
        == np.float32 else v) for v in gt.values()))
    assert list(losses) == list(LOSSES)
    sum(losses.values()).backward()
    return ({k: float(v) for k, v in losses.items()},
            jax.tree_util.tree_map(lambda t: t.grad.numpy(), leaves))


def test_detector2d_loss_and_grads_match_jax(setup):
    """The three losses (each live) and their sum's gradients with respect
    to every output against `jax.value_and_grad`: both sides in float64
    within 1e-10 relative / 1e-10 of each gradient's largest; the port's
    float32 losses within 1e-5 relative of the float64 reference and its
    gradients within 1e-4 of each one's largest."""
    _, batch, outs, _ = setup
    gt = gt_with_ties(batch)
    want, wgrads = loss_grads_jax(outs, gt, True)
    for dtype, rtol, gtol in ((torch.float64, 1e-10, 1e-10),
                              (torch.float32, 1e-5, 1e-4)):
        got, grads = loss_grads_port(outs, gt, dtype)
        for k in LOSSES:
            assert want[k] > 0, k
            np.testing.assert_allclose(got[k], want[k], rtol=rtol,
                                       err_msg=f"{dtype} {k}")
        for lvl, (g, w) in enumerate(zip(grads, wgrads)):
            for k in g:
                assert_rel(g[k], w[k], gtol, f"{dtype} level {lvl} {k}")


@pytest.mark.parametrize("case", ["random", "ties", "offsets"])
def test_nms_2d_keep_masks_match_jax(case):
    """`nms_2d` (the port's reuses `core.nms._greedy_suppress`) against the
    JAX package's `fori_loop` NMS: keep masks exactly equal, on random
    overlapping boxes, on exact-tie scores with duplicated boxes, and on
    boxes offset by the class-offset trick (`cls * 1e4`, f32)."""
    rng = np.random.default_rng(["random", "ties", "offsets"].index(case))
    n = 192
    xy = rng.uniform(0, 100, (n, 2))
    wh = rng.uniform(5, 40, (n, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    scores = rng.uniform(0, 1, n).astype(np.float32)
    valid = rng.uniform(0, 1, n) > 0.1
    if case == "ties":
        scores = np.round(scores * 4) / 4  # five distinct values
        boxes[1::7] = boxes[0::7][:len(boxes[1::7])]
    if case == "offsets":
        cls = rng.integers(0, 10, n).astype(np.float32)
        boxes = boxes + cls[:, None] * np.float32(1e4)
    want = np.asarray(jax.jit(jd.nms_2d)(jnp.asarray(boxes),
                                         jnp.asarray(scores),
                                         jnp.asarray(valid)))
    got = td.nms_2d(torch.as_tensor(boxes), torch.as_tensor(scores),
                    torch.as_tensor(valid))
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.sum() < valid.sum()


def painted_outputs(outs):
    """The forward's outputs with flat regions painted in: at this size
    every output's receptive field spans the image, so no two pixels' scores
    tie. Each level gets a rectangle of equal cls, ctr and reg at the
    highest scores and one at a middling score, so the top-k takes tied
    scores and ranks them by index."""
    outs = jax.tree_util.tree_map(np.copy, outs)
    for lvl, o in enumerate(outs):
        h, w = o["ctr"].shape[1:]
        for (y0, y1, x0, x1), logit in (
                ((0, h // 2 + 1, 1, w // 2 + 1), 4.0),
                ((h // 2, h, w // 2, w), 0.5)):
            o["cls"][:, y0:y1, x0:x1] = np.float32(logit) * np.arange(
                1, N_CLASSES + 1, dtype=np.float32) / N_CLASSES
            o["ctr"][:, y0:y1, x0:x1] = np.float32(logit)
            o["reg"][:, y0:y1, x0:x1] = np.float32(4 << lvl)
    return outs


def test_get_bboxes_on_painted_outputs_match_jax(setup):
    """`detector2d_get_bboxes` on painted outputs (`painted_outputs`: flat
    regions, tied scores), with the image clip: ranks, classes and the
    keep masks exactly equal, boxes and scores within 1e-6 of their
    largest; every level's top-k holds tied scores."""
    _, batch, outs, _ = setup
    outs = painted_outputs(outs)
    kw = dict(topk=16, max_det=24, image_hw=HW)
    want = jax.jit(lambda o: jd.detector2d_get_bboxes(o, N_CLASSES, **kw))(
        to_jax(outs))
    got = td.detector2d_get_bboxes(
        jax.tree_util.tree_map(torch.as_tensor, outs), N_CLASSES, **kw)
    wb = np.asarray(want.boxes)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.boxes[..., 5].numpy(), wb[..., 5])
    assert_rel(got.boxes[..., :5].numpy(), wb[..., :5], 1e-6)
    assert np.asarray(want.valid).sum() > 0
    sig = jax.nn.sigmoid
    for o in outs:
        best = np.asarray(jnp.max(sig(o["cls"]) * sig(o["ctr"])[..., None],
                                  -1)).reshape(2, -1)
        top = -np.sort(-best, -1)[:, :16]
        assert (np.diff(top, axis=-1) == 0).any()


def test_extract_bboxes_2d_matches_jax(setup):
    """With `train=False`, the port's whole branch (forward and decode) on
    noise-background images against the JAX package's: valid masks and
    classes exactly equal, boxes and confidences within 1e-4 of their
    largest. With `train=True` and a generator, each draw's valid mask is
    a subset of the eval mask, boxes are zero where not valid, and over
    eight draws the kept share of >= 400 eval-valid boxes is 0.5 +- 0.1."""
    variables, _, _, model = setup
    images = det2d_tiny_batch(seed=2, noise=True)["images"]
    kw = dict(max_det=64, score_thr=0.0)
    wboxes, wvalid = jax.jit(lambda v, x: jd.extract_bboxes_2d(
        model, v, x, **kw))(to_jax(variables), jnp.asarray(images))
    port = port_model(variables)
    boxes, valid = td.extract_bboxes_2d(port, torch.as_tensor(images), **kw)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(wvalid))
    np.testing.assert_array_equal(boxes[..., 5].numpy(),
                                  np.asarray(wboxes)[..., 5])
    assert_rel(boxes[..., :5].numpy(), np.asarray(wboxes)[..., :5], 1e-4)
    kept = total = 0
    for seed in range(8):
        gen = torch.Generator().manual_seed(seed)
        b, v = td.extract_bboxes_2d(port, torch.as_tensor(images),
                                    generator=gen, train=True, **kw)
        assert not (v & ~valid).any()
        assert (b[~v] == 0).all() and torch.equal(b[v], boxes[v])
        kept += int(v.sum())
        total += int(valid.sum())
    assert total >= 400 and abs(kept / total - 0.5) <= 0.1, (kept, total)


def test_detector2d_train_step_matches_jax(setup):
    """One `make_detector2d_train_step` step against the tool's step
    (`tools/train_detector2d.py`: clip 10, AdamW 1e-3, weight decay 1e-4,
    constant), the JAX side in float64: the port's float64 losses, loss
    and gradient norm within 1e-8 relative, gradients within 1e-8 of each
    leaf's largest and the updated parameters within 1e-8 (a gradient's
    rounding at 0 moves Adam's first update by up to ~1e-7 of the leaf's
    largest gradient, times lr); the port's float32 step's losses and
    gradient norm within 1e-5 relative and gradients within 1e-3 of each
    leaf's largest. Every kernel's gradient is non-zero."""
    variables, batch, _, model = setup
    batch = {**batch, **gt_with_ties(batch)}
    tx = optax.chain(optax.clip_by_global_norm(10.0),
                     optax.adamw(1e-3, weight_decay=1e-4))
    with jax.enable_x64(True):
        params = to_float64(variables)["params"]
        jb = to_float64(batch)

        def loss_fn(p):
            losses = jd.detector2d_loss(
                model.apply({"params": p}, jb["images"], train=True),
                jb["gt_boxes"], jb["gt_labels"], jb["gt_valid"])
            return sum(losses.values()), losses

        @jax.jit
        def step(p):
            (total, losses), grads = jax.value_and_grad(
                loss_fn, has_aux=True)(p)
            updates, _ = tx.update(grads, tx.init(p), p)
            return (total, losses, grads, optax.apply_updates(p, updates),
                    optax.global_norm(grads))

        total, losses, grads, new_params, norm = jax.tree_util.tree_map(
            np.asarray, step(params))
    grads, new_params = flatten(grads), flatten(new_params)
    for dtype, ltol, gtol in ((torch.float64, 1e-8, 1e-8),
                              (torch.float32, 1e-5, 1e-3)):
        port, opt, _ = create_detector2d_train_state(
            N_CLASSES, WIDTH, FPN_CH, seed=0, device="cpu")
        port.to(dtype)
        b = {k: v.astype(np.float64) if dtype == torch.float64
             and v.dtype == np.float32 else v for k, v in batch.items()}
        metrics = make_detector2d_train_step(port, opt)(b)
        assert list(metrics) == list(LOSSES) + ["loss", "grad_norm"]
        for k in LOSSES:
            np.testing.assert_allclose(float(metrics[k]), float(losses[k]),
                                       rtol=ltol, err_msg=k)
        np.testing.assert_allclose(float(metrics["loss"]), float(total),
                                   rtol=ltol)
        np.testing.assert_allclose(float(metrics["grad_norm"]), float(norm),
                                   rtol=ltol)
        for name, p in port.named_parameters():
            assert_rel(p.grad.numpy(), grads[name], gtol, name)
            if name.endswith("kernel"):
                assert np.abs(p.grad.numpy()).max() > 0, name
            if dtype == torch.float64:
                np.testing.assert_allclose(p.detach().numpy(),
                                           new_params[name], rtol=0,
                                           atol=1e-8, err_msg=name)
        assert opt.count == 1


def test_detector2d_loss_falls():
    """Six port steps on one painted batch at the tool's recipe: finite
    losses, the last total below the first."""
    batch = det2d_tiny_batch(seed=3)
    model, opt, _ = create_detector2d_train_state(
        N_CLASSES, WIDTH, FPN_CH, seed=0, device="cpu")
    step = make_detector2d_train_step(model, opt)
    losses = [float(step(batch)["loss"]) for _ in range(6)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses

