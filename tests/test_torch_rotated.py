"""The port's rotated-box code held against the JAX package on the same
numpy inputs: BEV corners, the rotated 2D / 3D IoU and their pairwise
forms, the smallest enclosing rectangle and the GIoU, the rotated BEV NMS,
the three yaw decodes of the FCAF3D head and `fcaf3d_loss` with rotated
boxes. Values and gradients (against `jax.grad`), with the tolerances each
test states.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fcaf3d_tpu.core import geometry as jg
from fcaf3d_tpu.core import rotated_iou as jr
from fcaf3d_tpu.core.nms import nms_bev as j_nms_bev
from fcaf3d_tpu.models import fcaf3d_head as jh
from fcaf3d_tpu.models import losses as jl
from fcaf3d_tpu_torch.core import geometry as tgeo
from fcaf3d_tpu_torch.core import rotated_iou as tr
from fcaf3d_tpu_torch.core.nms import nms_bev as t_nms_bev
from fcaf3d_tpu_torch.models import fcaf3d_head as th
from fcaf3d_tpu_torch.models import losses as tl
from tests.test_torch_ops import jax_without_persistent_cache  # noqa: F401

BEV = [0, 1, 3, 4, 6]
PI = float(np.pi)
# gravity-centred box7 pairs (x, y, z, dx, dy, dz, yaw) where the clipping
# is degenerate: coincident candidates, collinear edges, zero areas, ties
DEGENERATE = {
    "identical": ([0.3, -0.2, 0.5, 1.0, 0.6, 0.8, 0.4],
                  [0.3, -0.2, 0.5, 1.0, 0.6, 0.8, 0.4]),
    # the intersection's centroid at the origin, where the invalid
    # candidates (zeroed) sit: atan2(0, 0) on the vertex sort's path
    "identical_at_origin": ([0, 0, 0, 2.0, 1.0, 1.0, 0.0],
                            [0, 0, 0, 2.0, 1.0, 1.0, 0.0]),
    "cross_at_origin": ([0, 0, 0, 2.0, 1.0, 1.0, 0.0],
                        [0, 0, 0, 1.0, 2.0, 1.0, 0.0]),
    "rotated_at_origin": ([0, 0, 0, 2.0, 1.0, 1.0, 0.3],
                          [0, 0, 0, 2.0, 1.0, 1.0, -0.3]),
    "shared_edge": ([0, 0, 0, 1.0, 1.0, 1.0, 0.0],
                    [1.0, 0, 0, 1.0, 1.0, 1.0, 0.0]),
    "half_overlap": ([0, 0, 0, 1.0, 1.0, 1.0, 0.0],
                     [0.5, 0, 0, 1.0, 1.0, 1.0, 0.0]),
    "contained": ([0.1, 0.2, 0.3, 3.0, 2.0, 2.0, 0.5],
                  [0.2, 0.1, 0.2, 0.8, 0.5, 0.6, 1.1]),
    "contained_centred": ([0, 0, 0, 3.0, 2.0, 2.0, 0.0],
                          [0, 0, 0, 1.0, 1.0, 1.0, 0.0]),
    "touching_corners": ([0, 0, 0, 1.0, 1.0, 1.0, 0.0],
                         [1.0, 1.0, 0, 1.0, 1.0, 1.0, 0.0]),
    "touching_z": ([0, 0, 0, 1.0, 1.0, 1.0, 0.3],
                   [0, 0, 1.0, 1.0, 1.0, 1.0, 0.3]),
    "disjoint": ([0, 0, 0, 1.0, 1.0, 1.0, 0.3],
                 [5.0, 0, 0, 1.0, 1.0, 1.0, 0.0]),
    "yaw_minus_half_pi": ([0.2, 0.1, 0, 2.0, 1.0, 1.0, -PI / 2],
                          [0.5, 0.1, 0, 1.0, 2.0, 1.0, 0.0]),
    # the same footprint twice, once through a yaw of pi/2: cos(pi/2) is
    # not 0 in float32, so the candidates only nearly coincide and their
    # angle order may differ by an ulp of atan2 between XLA and torch
    "yaw_half_pi": ([0.2, 0.1, 0, 2.0, 1.0, 1.0, PI / 2],
                    [0.2, 0.1, 0, 1.0, 2.0, 1.0, 0.0]),
}
# pairs whose gradient depends on the order of nearly coincident vertices:
# values only
ORDER_DEPENDENT_GRADS = {"yaw_half_pi"}


def random_pairs(rng, n):
    """Gravity-centred box7 pairs [n, 7]: overlapping at random yaws, some
    disjoint."""
    b = np.concatenate([rng.uniform(-1, 1, (n, 3)),
                        rng.uniform(0.2, 2, (n, 3)),
                        rng.uniform(-PI, PI, (n, 1))], 1)
    a = b + np.concatenate([rng.normal(0, 0.4, (n, 3)),
                            rng.normal(0, 0.2, (n, 3)),
                            rng.normal(0, 0.5, (n, 1))], 1)
    a[:, 3:6] = np.abs(a[:, 3:6]) + 0.05
    a[: n // 8, :2] += 6.0
    return a.astype(np.float32), b.astype(np.float32)


def degenerate_pairs():
    a, b = zip(*DEGENERATE.values())
    return np.asarray(a, np.float32), np.asarray(b, np.float32)


# (name, JAX function, port function) of box7 pairs
PAIR_FNS = [
    ("rotated_iou_2d",
     lambda a, b: jr.rotated_iou_2d(a[..., jnp.array(BEV)],
                                    b[..., jnp.array(BEV)]),
     lambda a, b: tr.rotated_iou_2d(a[..., BEV], b[..., BEV])),
    ("iou_3d", jr.iou_3d, tr.iou_3d),
    ("giou_3d", lambda a, b: jr.giou_3d(a, b)[0],
     lambda a, b: tr.giou_3d(a, b)[0]),
]


# XLA's CPU backend with LLVM's optimisations off: at the default level it
# contracts the edges' cross product r0 s1 - r1 s0 into an FMA, so exactly
# parallel edges get a denominator of ~1e-8, a rounding residual, instead of
# 0, and the identical pairs' gradients reach 1e7. That is the compiler's,
# not the function's.
NO_FMA = {"xla_backend_optimization_level": 0}


def values_and_grads(jfn, tfn, a, b, compiler_options=None):
    """((port value, JAX value), [(port grad, JAX grad) for a and b]) of
    sum(fn(a, b)); the JAX side compiled with `compiler_options`."""
    ja, jb = jnp.asarray(a), jnp.asarray(b)

    def run(f):
        return jax.jit(f).lower(ja, jb).compile(compiler_options)(ja, jb)

    want = np.asarray(run(jfn))
    jgrads = run(jax.grad(lambda x, y: jnp.sum(jfn(x, y)), argnums=(0, 1)))
    ta = torch.tensor(a, requires_grad=True)
    tb = torch.tensor(b, requires_grad=True)
    got = tfn(ta, tb)
    got.sum().backward()
    return ((got.detach().numpy(), want),
            [(ta.grad.numpy(), np.asarray(jgrads[0])),
             (tb.grad.numpy(), np.asarray(jgrads[1]))])


def test_bev_corners_match_jax():
    """Corners within 1e-6 (counter-clockwise from (+dx/2, +dy/2))."""
    rng = np.random.default_rng(0)
    boxes = np.concatenate([rng.uniform(-3, 3, (3, 5, 2)),
                            rng.uniform(0.1, 2, (3, 5, 2)),
                            rng.uniform(-PI, PI, (3, 5, 1))], -1)
    boxes = boxes.astype(np.float32)
    np.testing.assert_allclose(
        tgeo.bev_corners(torch.as_tensor(boxes)).numpy(),
        np.asarray(jg.bev_corners(jnp.asarray(boxes))), rtol=0, atol=1e-6)


@pytest.mark.parametrize("name,jfn,tfn", PAIR_FNS,
                         ids=[f[0] for f in PAIR_FNS])
def test_pair_functions_match_jax_on_random_pairs(name, jfn, tfn):
    """384 random pairs: values within 1e-5 and both boxes' gradients
    within 1e-5 of the JAX package's."""
    a, b = random_pairs(np.random.default_rng(1), 384)
    (got, want), grads = values_and_grads(jfn, tfn, a, b)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    if not name.startswith("giou"):  # overlapping and disjoint pairs
        assert (want > 0.3).any() and (want == 0).any()
    for g, w in grads:
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)


@pytest.mark.parametrize("name,jfn,tfn", PAIR_FNS,
                         ids=[f[0] for f in PAIR_FNS])
def test_pair_functions_match_jax_on_degenerate_pairs(name, jfn, tfn):
    """Every degenerate pair: values within 1e-5; gradients within 1e-5
    with NaN where the JAX package's gradient is NaN (the smallest
    enclosing rectangle's sqrt at coincident corners), except the pairs of
    ORDER_DEPENDENT_GRADS. At the origin pairs the gradient is finite:
    atan2 only orders the vertices, so no cotangent reaches its (0, 0).
    The JAX side of the IoUs is compiled without FMA contraction (NO_FMA);
    the GIoU's gradients agree either way."""
    a, b = degenerate_pairs()
    (got, want), grads = values_and_grads(
        jfn, tfn, a, b, None if name == "giou_3d" else NO_FMA)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    rows = [i for i, n in enumerate(DEGENERATE)
            if n not in ORDER_DEPENDENT_GRADS]
    for g, w in grads:
        np.testing.assert_allclose(g[rows], w[rows], rtol=0, atol=1e-5)
    origin = [list(DEGENERATE).index(n) for n in DEGENERATE
              if n.endswith("at_origin")]
    if name != "giou_3d":
        assert np.isfinite(grads[0][0][origin]).all()


def test_pairwise_ious_match_jax():
    """[N, M] BEV and 3D IoU matrices within 1e-5; the port's pairwise BEV
    IoU also broadcasts over leading dims."""
    rng = np.random.default_rng(2)
    a, _ = random_pairs(rng, 24)
    b, _ = random_pairs(rng, 17)
    b[:5] = a[:5]
    b[:5, :2] += 0.01  # IoU near 1
    got = tr.pairwise_iou_bev(torch.as_tensor(a[:, BEV]),
                              torch.as_tensor(b[:, BEV])).numpy()
    want = np.asarray(jax.jit(jr.pairwise_iou_bev)(jnp.asarray(a[:, BEV]),
                                          jnp.asarray(b[:, BEV])))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    got3 = tr.pairwise_iou_3d(torch.as_tensor(a), torch.as_tensor(b)).numpy()
    np.testing.assert_allclose(
        got3, np.asarray(jax.jit(jr.pairwise_iou_3d)(jnp.asarray(a),
                                                     jnp.asarray(b))),
        rtol=0, atol=1e-5)
    batched = tr.pairwise_iou_bev(torch.as_tensor(np.stack([a, a])[..., BEV]),
                                  torch.as_tensor(np.stack([b, b])[..., BEV]))
    np.testing.assert_array_equal(batched.numpy(), np.stack([got, got]))
    assert (want > 0.9).sum() >= 5 and (want == 0).any()


def test_min_enclosing_rect_area_matches_jax():
    """Point sets [.., 8, 2]: random, a rotated rectangle's corners twice
    (many tied directions) and with coincident points; values within 1e-5,
    gradients within 1e-5 (NaN where the JAX package's is NaN)."""
    rng = np.random.default_rng(3)
    pts = rng.normal(0, 1, (6, 8, 2)).astype(np.float32)
    rect = np.asarray(jg.bev_corners(jnp.asarray([0.3, 0.1, 2.0, 1.0, 0.7])))
    pts[0] = np.concatenate([rect, rect])
    pts[1, 4:] = pts[1, :4]
    want = np.asarray(jax.jit(jr.min_enclosing_rect_area)(jnp.asarray(pts)))
    jgrad = np.asarray(jax.jit(jax.grad(lambda p: jnp.sum(
        jr.min_enclosing_rect_area(p))))(jnp.asarray(pts)))
    t = torch.tensor(pts, requires_grad=True)
    got = tr.min_enclosing_rect_area(t)
    got.sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(t.grad.numpy(), jgrad, rtol=0, atol=1e-5)
    np.testing.assert_allclose(want[0], 2.0, rtol=1e-5)


def test_rotated_nms_keep_masks_match_jax():
    """Rotated BEV NMS over [B, C, K] candidates: keep masks exactly equal
    to the JAX package's (vmapped), with no pairwise IoU within 1e-5 of
    the threshold, so that no flip can come from rounding."""
    rng = np.random.default_rng(4)
    b, c, k, thr = 2, 3, 40, 0.3
    centers = rng.uniform(0, 2.5, (b, c, k, 3))
    dims = rng.uniform(0.3, 1.2, (b, c, k, 3))
    yaw = rng.uniform(-PI, PI, (b, c, k, 1))
    boxes = np.concatenate([centers, dims, yaw], -1).astype(np.float32)
    scores = np.round(rng.random((b, c, k)), 2).astype(np.float32)
    valid = scores > 0.1
    iou = np.asarray(jax.jit(jr.pairwise_iou_bev)(
        jnp.asarray(boxes.reshape(-1, 7)[:, BEV]),
        jnp.asarray(boxes.reshape(-1, 7)[:, BEV])))
    assert np.abs(iou - thr).min() > 1e-5
    got = t_nms_bev(torch.as_tensor(boxes), torch.as_tensor(scores), thr,
                    valid=torch.as_tensor(valid), rotated=True)
    want = jax.jit(jax.vmap(jax.vmap(lambda bx, s, v: j_nms_bev(
        bx, s, thr, valid=v, rotated=True))))(
        jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(valid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0 < int(got.sum()) < int(valid.sum())
    aligned = t_nms_bev(torch.as_tensor(boxes), torch.as_tensor(scores), thr,
                        valid=torch.as_tensor(valid), rotated=False)
    assert not torch.equal(aligned, got)  # the yaw matters


def head_regressions(rng, n, n_reg):
    """Head locations [n, 3] and regressions [n, n_reg]: positive distances,
    raw yaw outputs, with the (0, 0) yaw pair in rows 0 and 1."""
    points = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    pred = np.concatenate([rng.uniform(0.05, 1.5, (n, 6)),
                           rng.normal(0, 1, (n, n_reg - 6))], 1)
    pred[:2, 6:] = 0.0
    return points, pred.astype(np.float32)


@pytest.mark.parametrize("param,n_reg", [("naive", 7), ("sin-cos", 8),
                                         ("fcaf3d", 8), ("fcaf3d", 6)])
def test_yaw_decodes_match_jax(param, n_reg):
    """`bbox_pred_to_bbox`: boxes within 1e-5 and gradients (of a weighted
    sum) within 1e-5 of the JAX package's, finite at the (0, 0) yaw
    outputs."""
    rng = np.random.default_rng(5)
    points, pred = head_regressions(rng, 64, n_reg)
    w = rng.normal(0, 1, (64, 7 if n_reg > 6 else 6)).astype(np.float32)
    want = np.asarray(jh.bbox_pred_to_bbox(jnp.asarray(points),
                                           jnp.asarray(pred), param))
    jgrad = np.asarray(jax.jit(jax.grad(lambda p: jnp.sum(jh.bbox_pred_to_bbox(
        jnp.asarray(points), p, param) * w)))(jnp.asarray(pred)))
    t = torch.tensor(pred, requires_grad=True)
    got = th.bbox_pred_to_bbox(torch.as_tensor(points), t, param)
    (got * torch.as_tensor(w)).sum().backward()
    assert got.shape == want.shape
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(t.grad.numpy(), jgrad, rtol=0, atol=1e-5)
    assert np.isfinite(jgrad).all() and np.isfinite(t.grad.numpy()).all()


def test_rotated_iou_loss_sums_match_jax():
    """`iou3d_loss_sum(with_yaw=True)` and `giou3d_loss_sum` per sample on
    [B, P, 7] (vmapped on the JAX side): values within 1e-5 relative,
    gradients within 1e-5."""
    rng = np.random.default_rng(6)
    a, b = random_pairs(rng, 2 * 48)
    a, b = a.reshape(2, 48, 7), b.reshape(2, 48, 7)
    w = rng.random((2, 48)).astype(np.float32)
    for name, tfn, jfn in [
            ("iou", lambda x, y, v: tl.iou3d_loss_sum(x, y, v, True),
             lambda x, y, v: jl.iou3d_loss_sum(x, y, v, True)),
            ("giou", tl.giou3d_loss_sum, jl.giou3d_loss_sum)]:
        x = torch.tensor(a, requires_grad=True)
        got = tfn(x, torch.as_tensor(b), torch.as_tensor(w))
        got.sum().backward()
        want, g = jax.jit(jax.vmap(jax.value_and_grad(jfn)))(
            jnp.asarray(a), jnp.asarray(b), jnp.asarray(w))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=1e-5, err_msg=name)
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(g), rtol=0,
                                   atol=1e-5, err_msg=name)


def yaw_head_outputs(rng, b=2, sizes=(120, 40, 12), n_classes=4):
    """Per-level head outputs of a with-yaw head (8 regressions), with the
    GT boxes (bottom-centred, yawed) placed on head locations."""
    outs = []
    for i, n in enumerate(sizes):
        step = 0.1 * 2 ** i
        pts = (rng.integers(0, 12, (b, n, 3)) * step).astype(np.float32)
        reg = np.concatenate([rng.uniform(0.05, 0.6, (b, n, 6)),
                              rng.normal(0, 0.7, (b, n, 2))], -1)
        outs.append(jh.HeadLevelOutput(
            centerness=rng.normal(0, 1, (b, n, 1)).astype(np.float32),
            bbox_pred=reg.astype(np.float32),
            cls_scores=rng.normal(0, 1, (b, n, n_classes)).astype(np.float32),
            points=pts, valid=rng.random((b, n)) < 0.95))
    g = 5
    gt = np.zeros((b, g, 7), np.float32)
    for s in range(b):
        centre = outs[0].points[s, rng.choice(sizes[0], g, replace=False)]
        dims = rng.uniform(0.3, 0.9, (g, 3))
        gt[s, :, :3] = centre
        gt[s, :, 2] -= dims[:, 2] / 2
        gt[s, :, 3:6] = dims
        gt[s, :, 6] = rng.uniform(-PI, PI, g)
    labels = rng.integers(0, n_classes, (b, g)).astype(np.int32)
    gt_valid = np.ones((b, g), bool)
    gt_valid[1, -1] = False
    return outs, gt, labels, gt_valid


@pytest.mark.parametrize("param", ["fcaf3d", "sin-cos"])
def test_fcaf3d_loss_with_yaw_matches_jax(param):
    """`fcaf3d_loss(with_yaw=True)` on head outputs: the three losses
    within 1e-5 relative (the rotated box loss live) and the gradients of
    their sum w.r.t. the regressions, centerness and class scores within
    1e-5 of each leaf's largest."""
    rng = np.random.default_rng(7)
    outs, gt, labels, gt_valid = yaw_head_outputs(rng)
    jcfg = jh.FcafLossConfig(n_scales=3, with_yaw=True,
                             yaw_parametrization=param)
    tcfg = th.FcafLossConfig(n_scales=3, with_yaw=True,
                             yaw_parametrization=param)
    fields = ("centerness", "bbox_pred", "cls_scores")

    def j_total(leaves):
        levels = tuple(o._replace(**dict(zip(fields, lv)))
                       for o, lv in zip(outs, leaves))
        losses = jh.fcaf3d_loss(levels, jnp.asarray(gt), jnp.asarray(labels),
                                jnp.asarray(gt_valid), jcfg)
        return sum(losses.values()), losses

    leaves = [tuple(jnp.asarray(getattr(o, f)) for f in fields) for o in outs]
    (_, want), jgrads = jax.jit(jax.value_and_grad(j_total, has_aux=True))(
        leaves)
    tleaves = [tuple(torch.tensor(getattr(o, f), requires_grad=True)
                     for f in fields) for o in outs]
    levels = tuple(th.HeadLevelOutput(
        *lv, points=torch.as_tensor(o.points),
        valid=torch.as_tensor(o.valid)) for o, lv in zip(outs, tleaves))
    got = th.fcaf3d_loss(levels, torch.as_tensor(gt), torch.as_tensor(labels),
                         torch.as_tensor(gt_valid), tcfg)
    sum(got.values()).backward()
    for k, v in want.items():
        np.testing.assert_allclose(float(got[k].detach()), float(v),
                                   rtol=1e-5, err_msg=k)
    assert 0 < float(want["loss_bbox"]) < 1
    for lv_t, lv_j in zip(tleaves, jgrads):
        for f, t, j in zip(fields, lv_t, lv_j):
            j = np.asarray(j)
            tol = 1e-5 * max(float(np.abs(j).max()), 1e-12)
            np.testing.assert_allclose(t.grad.numpy(), j, rtol=0, atol=tol,
                                       err_msg=f)
