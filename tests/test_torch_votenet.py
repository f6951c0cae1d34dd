"""The port's VoteNet-v2 inference (`fcaf3d_tpu_torch`) held against the JAX
package on the CPU at `votenet_tiny`: the parameter tree, the config and
preprocessing copies, every module of the slice, post-processing and the
whole slice through `inference_votenet`.

Both packages run on the same numpy parameters (`init_votenet_variables`,
fed to the flax modules' `apply`; no flax `init`) and the same numpy scans.
The JAX side's `ball_query` is replaced by `ball_query_grid` with its Pallas
kernel in interpret mode (the TPU kernel's direct distance, which the
port's K6 computes; on the CPU the JAX package would take the brute
expansion), and every call's overflow is held <= 0. Integers (indices,
labels, masks) must be exactly equal; floats within f32 atol 1e-4
(summation order over ~20 dense layers).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from fcaf3d_tpu import configs as jconfigs
from fcaf3d_tpu.core.points import Points3D
from fcaf3d_tpu.data.pipelines import ShiftHeight
from fcaf3d_tpu.models import pointnet2 as jp2
from fcaf3d_tpu.models import votenet as jv
from fcaf3d_tpu.models import votenet_v1 as jv1
from fcaf3d_tpu.ops.pointnet.ballq_kernel import ball_query_grid
from fcaf3d_tpu_torch import configs as tconfigs
from fcaf3d_tpu_torch.apis import init_votenet, inference_votenet
from fcaf3d_tpu_torch.data.points import add_height
from fcaf3d_tpu_torch.models import pointnet2 as tp2
from fcaf3d_tpu_torch.models import votenet as tv
from fcaf3d_tpu_torch.models import votenet_v1 as tv1
from fcaf3d_tpu_torch.params import init_votenet_variables
from tests.test_torch_ops import jax_without_persistent_cache  # noqa: F401

ATOL = 1e-4
EXTENT = (2.0, 2.0, 1.4)  # a small room: the tiny radii see real groups


def jax_votenet(cfg):
    return jv.VoteNet(n_classes=cfg.n_classes, num_proposal=cfg.num_proposal,
                      backbone_num_points=cfg.backbone_num_points)


# the v1 configs' box coders (port, JAX)
V1_CODERS = {"votenet_v1_sunrgbd": (tv1.sunrgbd_coder, jv1.sunrgbd_coder),
             "votenet_v1_scannet": (tv1.scannet_coder, jv1.scannet_coder)}
CONFIGS = ["votenet_sunrgbd", "votenet_tiny", *V1_CODERS]


@pytest.mark.parametrize("name", CONFIGS)
def test_init_votenet_variables_tree_matches_flax(name):
    """Paths and shapes equal `jax.eval_shape(VoteNet(...).init, ...)`, for
    a v1 config of `VoteNetV1(coder=...)` with the config's coder."""
    cfg = getattr(tconfigs, name)()
    x = jnp.zeros((1, cfg.num_points, 3 + cfg.in_feat_dims))
    if name in V1_CODERS:
        tcoder, jcoder = (f() for f in V1_CODERS[name])
        module = jv1.VoteNetV1(coder=jcoder, n_classes=cfg.n_classes,
                               num_proposal=cfg.num_proposal,
                               backbone_num_points=cfg.backbone_num_points)
    else:
        tcoder, module = None, jax_votenet(cfg)
    want = jax.eval_shape(lambda k, a: module.init(k, a, train=False),
                          jax.random.PRNGKey(0), x)
    got = init_votenet_variables(cfg, seed=0, coder=tcoder)
    for coll in ("params", "batch_stats"):
        w = {jax.tree_util.keystr(p): x.shape for p, x in
             jax.tree_util.tree_flatten_with_path(want[coll])[0]}
        g = {jax.tree_util.keystr(p): x.shape for p, x in
             jax.tree_util.tree_flatten_with_path(got[coll])[0]}
        assert g == w, coll
        assert all(x.dtype == np.float32
                   for x in jax.tree_util.tree_leaves(got[coll]))
    if name == "votenet_sunrgbd":
        leaves = jax.tree_util.tree_leaves(got)
        assert (len(leaves), sum(x.size for x in leaves)) == (144, 954902)


@pytest.mark.parametrize("name", CONFIGS)
def test_votenet_configs_match_jax(name):
    assert dataclasses.asdict(getattr(tconfigs, name)()) == \
        dataclasses.asdict(getattr(jconfigs, name)())


def test_votenet_refuses_a_v1_config():
    """`VoteNet` builds only the v2 head: a v1 config raises and names
    `VoteNetV1`."""
    with pytest.raises(ValueError, match="VoteNetV1"):
        tv.VoteNet(tconfigs.votenet_v1_sunrgbd(), device="meta")


def test_init_votenet_needs_a_coder_for_v1():
    """A v1 config without its box coder raises; with it, `init_votenet`
    builds a `VoteNetV1` in eval mode."""
    with pytest.raises(ValueError, match="coder"):
        init_votenet(tconfigs.votenet_v1_sunrgbd(), device="meta")
    model = init_votenet(tconfigs.votenet_v1_scannet(), device="cpu",
                         coder=tv1.scannet_coder())
    assert isinstance(model, tv1.VoteNetV1) and not model.training


def test_add_height_matches_jax():
    """Exactly `Points3D.add_height` and the `ShiftHeight` transform, with
    and without extra columns."""
    rng = np.random.default_rng(0)
    pts = rng.uniform(-1, 3, (500, 6)).astype(np.float32)
    np.testing.assert_array_equal(add_height(pts),
                                  Points3D(pts).add_height().arr)
    np.testing.assert_array_equal(
        add_height(pts[:, :3]),
        ShiftHeight()({"points": pts[:, :3]}, rng)["points"])


def grid_ball_query_into(overflows):
    """A stand-in for the JAX modules' `ball_query`: `ball_query_grid` in
    Pallas interpret mode, appending each call's overflow to `overflows`."""
    def ball_query(c, p, r, k, v=None):
        idx, overflow = ball_query_grid(c, p, r, k, v, interpret=True)
        overflows.append(int(overflow))
        return idx

    return ball_query


@pytest.fixture
def grid_ball_query(monkeypatch):
    """The JAX modules' `ball_query` as `ball_query_grid` in Pallas
    interpret mode; returns the list of each call's overflow."""
    overflows = []
    monkeypatch.setattr(jp2, "ball_query", grid_ball_query_into(overflows))
    return overflows


class Tiny:
    """`votenet_tiny` on both sides: the numpy variables, the loaded torch
    model (eval), the JAX variables and one scan [P, 4] (xyz + height)."""

    def __init__(self):
        self.cfg = tconfigs.votenet_tiny()
        self.variables = init_votenet_variables(self.cfg, seed=0)
        self.model = init_votenet(self.cfg, seed=0, device="cpu")
        self.jvars = jax.tree_util.tree_map(jnp.asarray, self.variables)
        xyz, _ = bench.synth_scene(np.random.RandomState(0),
                                   self.cfg.num_points, extent=EXTENT)
        self.raw = xyz
        self.points = add_height(xyz)

    def sub(self, *path):
        """The flax variables of the submodule at `path`."""
        out = {}
        for coll in ("params", "batch_stats"):
            node = self.jvars[coll]
            for p in path:
                node = node[p]
            out[coll] = node
        return out

    def tmod(self, *path):
        mod = self.model
        for p in path:
            mod = getattr(mod, p)
        return mod


@pytest.fixture(scope="module")
def tiny():
    return Tiny()


def close(a, b, what=""):
    np.testing.assert_allclose(np.asarray(a.detach() if hasattr(a, "detach")
                                          else a), np.asarray(b), rtol=0,
                               atol=ATOL, err_msg=what)


def test_dense_bn_relu_matches_jax(tiny):
    """The first backbone layer on random inputs, in evaluation mode and in
    training mode (batch statistics; `test_torch_votenet_train.py` holds
    training mode to flax in detail)."""
    x = np.random.default_rng(1).standard_normal((2, 9, 5, 4)).astype(
        np.float32)
    layer = tiny.tmod("backbone", "sa0", "mlp0")
    variables = tiny.sub("backbone", "sa0", "mlp0")
    want = jp2.DenseBNReLU(64).apply(variables, jnp.asarray(x), False)
    with torch.no_grad():
        close(layer(torch.as_tensor(x)), want)
    want, _ = jp2.DenseBNReLU(64).apply(variables, jnp.asarray(x), True,
                                        mutable=["batch_stats"])
    saved = {k: v.clone() for k, v in layer.state_dict().items()}
    layer.train()
    try:
        with torch.no_grad():
            close(layer(torch.as_tensor(x)), want)
    finally:
        layer.eval()
        layer.load_state_dict(saved)


@pytest.mark.parametrize("mode", ["fps", "indices", "target_xyz"])
def test_point_sa_module_matches_jax(tiny, grid_ball_query, mode):
    """SA1 of the tiny backbone with a valid mask (FPS, given indices or
    given centres): indices exact, centres and features within atol."""
    x = tiny.points[None]
    xyz, feats = x[..., :3], x[..., 3:]
    valid = np.ones(x.shape[:2], bool)
    valid[0, :7] = False
    kw_t, kw_j = {}, {}
    if mode == "indices":
        idx = np.random.default_rng(2).choice(np.flatnonzero(valid[0]), 128,
                                              replace=False)[None]
        kw_t["indices"] = torch.as_tensor(idx.astype(np.int32))
        kw_j["indices"] = jnp.asarray(idx.astype(np.int32))
    elif mode == "target_xyz":
        tgt = xyz[:, 100:228] + np.float32(0.05)
        kw_t["target_xyz"], kw_j["target_xyz"] = torch.as_tensor(tgt), \
            jnp.asarray(tgt)
    sa = jp2.PointSAModule(num_point=128, radius=0.2, num_sample=64,
                           mlp_channels=(64, 64, 128))
    want = sa.apply(tiny.sub("backbone", "sa0"), jnp.asarray(xyz),
                    jnp.asarray(feats), jnp.asarray(valid), train=False,
                    **kw_j)
    with torch.no_grad():
        got = tiny.tmod("backbone", "sa0")(
            torch.as_tensor(np.ascontiguousarray(xyz)),
            torch.as_tensor(feats), torch.as_tensor(valid), **kw_t)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    close(got[0], want[0], "new_xyz")
    close(got[1], want[1], "features")
    assert grid_ball_query and max(grid_ball_query) <= 0


def test_point_fp_module_matches_jax(tiny):
    rng = np.random.default_rng(3)
    tgt = rng.uniform(0, 2, (2, 40, 3)).astype(np.float32)
    src = rng.uniform(0, 2, (2, 16, 3)).astype(np.float32)
    tf = rng.standard_normal((2, 40, 256)).astype(np.float32)
    sf = rng.standard_normal((2, 16, 256)).astype(np.float32)
    want = jp2.PointFPModule((256, 256)).apply(
        tiny.sub("backbone", "fp0"), *map(jnp.asarray, (tgt, src, tf, sf)),
        train=False)
    with torch.no_grad():
        got = tiny.tmod("backbone", "fp0")(*map(torch.as_tensor,
                                                (tgt, src, tf, sf)))
    close(got, want)


@pytest.fixture(scope="module")
def backbone_pair(tiny):
    """The tiny backbone on both sides, the JAX side with the grid ball
    query (checked <= 0 overflow in the test that reads it)."""
    x = tiny.points[None]
    with torch.no_grad():
        got = tiny.tmod("backbone")(torch.as_tensor(x))
    mp = pytest.MonkeyPatch()
    overflows = []
    mp.setattr(jp2, "ball_query", grid_ball_query_into(overflows))
    try:
        backbone = jp2.PointNet2SASSG(
            num_points=tiny.cfg.backbone_num_points)
        want = backbone.apply(tiny.sub("backbone"), jnp.asarray(x),
                              train=False)
    finally:
        mp.undo()
    return got, want, overflows


def test_pointnet2_backbone_matches_jax(backbone_pair):
    """Every level: indices exact, xyz and features within atol; four ball
    queries, none overflowing."""
    got, want, overflows = backbone_pair
    assert len(overflows) == 4 and max(overflows) <= 0
    for key in ("sa_indices", "fp_indices"):
        for i, (a, b) in enumerate(zip(got[key], want[key])):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                          err_msg=f"{key}[{i}]")
    for key in ("sa_xyz", "sa_features", "fp_xyz", "fp_features"):
        for i, (a, b) in enumerate(zip(got[key], want[key])):
            if b is None:
                assert a is None
            else:
                close(a, b, f"{key}[{i}]")


def test_vote_module_matches_jax(tiny, backbone_pair):
    got_b, want_b, _ = backbone_pair
    seed_xyz, seed_feats = want_b["fp_xyz"][-1], want_b["fp_features"][-1]
    want = jv.VoteModule().apply(tiny.sub("vote_module"), seed_xyz,
                                 seed_feats, False)
    with torch.no_grad():
        got = tiny.tmod("vote_module")(
            torch.as_tensor(np.asarray(seed_xyz)),
            torch.as_tensor(np.asarray(seed_feats)))
    for a, b, what in zip(got, want, ("vote_xyz", "vote_feats", "offset")):
        close(a, b, what)


@pytest.mark.parametrize("mode,width", [("fcaf3d", 7), ("naive", 7),
                                        ("sin-cos", 8)])
def test_decode_vote_bbox_matches_jax(mode, width):
    """All three yaw parametrisations, with exact zeros in the yaw columns
    (the atan2 guard)."""
    rng = np.random.default_rng(width)
    pts = rng.uniform(0, 3, (2, 30, 3)).astype(np.float32)
    pred = rng.normal(0, 0.5, (2, 30, width)).astype(np.float32)
    pred[0, :3, 5:] = 0.0
    want = jv.decode_vote_bbox(jnp.asarray(pts), jnp.asarray(pred), mode)
    got = tv.decode_vote_bbox(torch.as_tensor(pts), torch.as_tensor(pred),
                              mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("sample_mod", ["seed", "vote"])
def test_votenet_forward_matches_jax(tiny, grid_ball_query, sample_mod):
    """The whole forward: five ball queries (SA1-4, aggregation) without
    overflow; seed indices exact, every float output within atol."""
    x = tiny.points[None]
    want = jax_votenet(tiny.cfg).apply(tiny.jvars, jnp.asarray(x),
                                       train=False, sample_mod=sample_mod)
    with torch.no_grad():
        got = tiny.model(torch.as_tensor(x), sample_mod=sample_mod)
    assert len(grid_ball_query) == 5 and max(grid_ball_query) <= 0
    assert set(got) == set(want)
    np.testing.assert_array_equal(got["seed_indices"].numpy(),
                                  np.asarray(want["seed_indices"]))
    for key in sorted(set(want) - {"seed_indices"}):
        close(got[key], want[key], key)


@pytest.mark.parametrize("per_class_proposal", [True, False])
def test_votenet_get_bboxes_matches_jax(tiny, grid_ball_query,
                                        per_class_proposal):
    """On the same (JAX) predictions: valid masks and labels exactly equal,
    boxes and scores within 1e-6; at B = 2 (the scan and a shifted copy,
    each through the batch-1 forward, whose compilation the other tests
    share)."""
    x = np.stack([tiny.points, tiny.points + np.float32(0.01)])
    preds = [jax_votenet(tiny.cfg).apply(tiny.jvars, jnp.asarray(x[i:i + 1]),
                                         train=False, sample_mod="seed")
             for i in range(2)]
    preds = {k: jnp.concatenate([p[k] for p in preds]) for k in preds[0]}
    kw = dict(nms_thr=0.25, score_thr=0.05,
              per_class_proposal=per_class_proposal)
    want = jv.votenet_get_bboxes(preds, jnp.asarray(x), tiny.cfg.n_classes,
                                 **kw)
    got = tv.votenet_get_bboxes(
        {k: torch.as_tensor(np.asarray(v)) for k, v in preds.items()},
        torch.as_tensor(x), tiny.cfg.n_classes, **kw)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    for f in ("boxes", "scores"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=0,
                                   atol=1e-6, err_msg=f)
    assert 0 < np.asarray(want.valid).sum(1).min()


@pytest.mark.parametrize("sample_mod", ["seed", "vote"])
def test_inference_votenet_matches_jax(tiny, grid_ball_query, sample_mod):
    """The whole slice through the entry point, against the JAX
    composition (`ShiftHeight`, sampling, `apply`, `votenet_get_bboxes`):
    the same non-empty detections (labels exact, boxes and scores within
    atol)."""
    cfg = tiny.cfg
    got = inference_votenet(tiny.model, tiny.raw, seed=3,
                            sample_mod=sample_mod)
    rng = np.random.default_rng(3)
    pts = ShiftHeight()({"points": tiny.raw.astype(np.float32)},
                        rng)["points"]
    pts = jnp.asarray(pts[rng.choice(len(pts), cfg.num_points,
                                     replace=len(pts) < cfg.num_points)][None])
    preds = jax_votenet(cfg).apply(tiny.jvars, pts, train=False,
                                   sample_mod=sample_mod)
    dets = jv.votenet_get_bboxes(preds, pts, cfg.n_classes,
                                 nms_thr=cfg.nms_thr, score_thr=cfg.score_thr)
    keep = np.asarray(dets.valid[0])
    assert max(grid_ball_query) <= 0
    assert len(got["scores_3d"]) == keep.sum() > 0
    np.testing.assert_array_equal(got["labels_3d"],
                                  np.asarray(dets.labels[0])[keep])
    close(got["boxes_3d"], np.asarray(dets.boxes[0])[keep], "boxes")
    close(got["scores_3d"], np.asarray(dets.scores[0])[keep], "scores")
    if sample_mod == "seed":  # the entry point's default is the test mode
        again = inference_votenet(tiny.model, tiny.raw, seed=3)
        np.testing.assert_array_equal(again["labels_3d"], got["labels_3d"])
