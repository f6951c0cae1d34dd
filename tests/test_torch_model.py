"""The port's model (`fcaf3d_tpu_torch`) held against the JAX package: the
parameter tree, blocks, backbone stages, head levels and the whole slice
through `inference_detector`, on the CPU at `fcaf3d_tiny` (depth 34,
4 scales) and `fcaf3d_nano` (depth 14, 2 scales).

Both packages run on the same numpy parameters (`params.init_variables`,
fed to the flax model's `apply`; no flax `init`), drawn so that detections
exist, and on the same numpy scans. Integer outputs (keys, valid masks,
overflow counts, labels) must be exactly equal; float outputs within f32
atol 1e-4 (summation order over ~40 layers).
"""
import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from fcaf3d_tpu import configs as jconfigs
from fcaf3d_tpu.apis.inference import inference_detector as j_inference
from fcaf3d_tpu.models import blocks as jb
from fcaf3d_tpu.models.detector import FCAF3D as JFCAF3D
from fcaf3d_tpu.models.me_resnet import MEResNet3D as JMEResNet3D
from fcaf3d_tpu.ops.sparse import tensor as jt
from fcaf3d_tpu_torch import configs as tconfigs
from fcaf3d_tpu_torch.apis import (inference_detector, init_detector,
                                   init_votenet, train_model)
from fcaf3d_tpu_torch.models import blocks as tb
from fcaf3d_tpu_torch.ops.sparse.masked_norm import elu_masked, relu_half_tie
from fcaf3d_tpu_torch.ops.sparse import tensor as tt
from fcaf3d_tpu_torch.params import init_variables, load_variables
from fcaf3d_tpu_torch.train import create_train_state
from tests.test_torch_ops import (  # noqa: F401
    eq, j_map, jax_without_persistent_cache, rand_map, t_map)

ATOL = 1e-4
# scene extents: ~1/10 of a room, so the miniature budgets see real
# neighbourhoods (tiny still overflows some maps, identically on both sides)
EXTENT = {"fcaf3d_tiny": (0.6, 0.6, 0.3), "fcaf3d_nano": (0.3, 0.3, 0.15)}


@pytest.mark.parametrize("name", ["fcaf3d_scannet", "fcaf3d_tiny",
                                  "fcaf3d_scannet_3scales",
                                  "fcaf3d_scannet_2scales", "fcaf3d_sunrgbd",
                                  "fcaf3d_s3dis", "fcaf3d_scannet:depth=50",
                                  "fcaf3d_scannet:depth=101",
                                  "fcaf3d_scannet:neck_mode=reference"])
def test_init_variables_tree_matches_flax(name):
    """Paths and shapes equal `jax.eval_shape(FCAF3D(cfg).init, ...)`;
    `name` is a config, optionally with one field replaced
    ("config:field=value")."""
    name, _, field = name.partition(":")
    over = {}
    if field:
        key, value = field.split("=")
        over[key] = int(value) if value.isdigit() else value
    cfg = dataclasses.replace(getattr(jconfigs, name)(), **over)
    z = jnp.zeros((1, cfg.num_points, 3))
    want = jax.eval_shape(JFCAF3D(cfg).init, jax.random.PRNGKey(0), z, z,
                          jnp.ones((1, cfg.num_points), bool))
    got = init_variables(
        dataclasses.replace(getattr(tconfigs, name)(), **over), seed=0)
    for coll in ("params", "batch_stats"):
        w = {jax.tree_util.keystr(p): x.shape for p, x in
             jax.tree_util.tree_flatten_with_path(want[coll])[0]}
        g = {jax.tree_util.keystr(p): x.shape for p, x in
             jax.tree_util.tree_flatten_with_path(got[coll])[0]}
        assert g == w, coll
        assert all(x.dtype == np.float32
                   for x in jax.tree_util.tree_leaves(got[coll]))


class Pair:
    """One config on both sides: numpy variables, the loaded torch model,
    the JAX variables and one scan [P, 6]."""

    def __init__(self, name):
        self.name = name
        self.cfg = getattr(tconfigs, name)()
        self.jcfg = getattr(jconfigs, name)()
        self.variables = init_variables(self.cfg, seed=0)
        self.model = init_detector(self.cfg, seed=0, device="cpu")
        self.jvars = jax.tree_util.tree_map(jnp.asarray, self.variables)
        xyz, rgb = bench.synth_scene(np.random.RandomState(0),
                                     self.cfg.num_points, extent=EXTENT[name])
        self.points = np.concatenate([xyz, rgb], axis=1)

    def batch(self):
        p = self.points[None, :, :3].astype(np.float32)
        c = self.points[None, :, 3:6].astype(np.float32)
        v = np.ones(p.shape[:2], bool)
        return p, c, v


@pytest.fixture(scope="module", params=["fcaf3d_tiny", "fcaf3d_nano"])
def pair(request):
    return Pair(request.param)


def test_backbone_stages_match_jax(pair):
    """Per-stage maps exactly equal, features within atol 1e-4."""
    p, c, v = pair.batch()
    cfg = pair.cfg
    st_t = tt.voxelize(torch.as_tensor(p), torch.as_tensor(c) / 255.0,
                       torch.as_tensor(v), cfg.voxel_size, cfg.input_budget)
    with torch.no_grad():
        outs_t = pair.model.backbone(st_t)
    backbone = JMEResNet3D(depth=cfg.depth, n_outs=cfg.n_outs,
                           budgets=cfg.backbone_budgets)
    bvars = {"params": pair.jvars["params"]["backbone"],
             "batch_stats": pair.jvars["batch_stats"]["backbone"]}
    st_j = jt.voxelize(jnp.asarray(p), jnp.asarray(c) / 255.0, jnp.asarray(v),
                       cfg.voxel_size, cfg.input_budget)
    outs_j = jax.jit(lambda vs, st: backbone.apply(vs, st, False))(bvars, st_j)
    assert len(outs_t) == len(outs_j) == cfg.n_outs
    for i, (a, b) in enumerate(zip(outs_t, outs_j)):
        assert a.stride == b.stride
        eq(a.keys, b.keys, f"stage {i} keys")
        eq(a.dropped, b.dropped, f"stage {i} dropped")
        np.testing.assert_allclose(a.feats.numpy(), np.asarray(b.feats),
                                   rtol=0, atol=ATOL)


def test_head_levels_and_overflow_match_jax(pair):
    """Per-level head outputs within atol 1e-4 (valid masks exact) and the
    overflow telemetry exactly equal to what the JAX package sows."""
    p, c, v = pair.batch()
    with torch.no_grad():
        outs_t, ovf_t = pair.model(torch.as_tensor(p), torch.as_tensor(c),
                                   torch.as_tensor(v))
    model = JFCAF3D(pair.jcfg)
    outs_j, mut = jax.jit(lambda vs, a, b, m: model.apply(
        vs, a, b, m, train=False, mutable=["overflow"]))(
        pair.jvars, jnp.asarray(p), jnp.asarray(c), jnp.asarray(v))
    for i, (a, b) in enumerate(zip(outs_t, outs_j)):
        eq(a.valid, b.valid, f"level {i} valid")
        for f in ("centerness", "bbox_pred", "cls_scores", "points"):
            np.testing.assert_allclose(
                getattr(a, f).numpy(), np.asarray(getattr(b, f)), rtol=0,
                atol=ATOL, err_msg=f"level {i} {f}")
    sown = mut["overflow"]
    want = {k: int(x[0][0]) for k, x in sown.items() if k != "neck_with_head"}
    want.update({k: int(x[0][0]) for k, x in sown["neck_with_head"].items()})
    assert {k: int(x[0]) for k, x in ovf_t.items()} == want


def test_inference_detector_matches_jax(pair):
    """The whole slice through the entry points: same non-empty detections
    (labels exact, boxes and scores within atol 1e-4)."""
    got, _ = inference_detector(pair.model, pair.points, seed=0)
    want = j_inference(JFCAF3D(pair.jcfg), pair.jvars, pair.points, pair.jcfg,
                       seed=0)
    assert len(got["scores_3d"]) == len(want["scores_3d"]) > 0
    np.testing.assert_array_equal(got["labels_3d"], want["labels_3d"])
    np.testing.assert_allclose(got["boxes_3d"], want["boxes_3d"], rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(got["scores_3d"], want["scores_3d"], rtol=0,
                               atol=ATOL)


def test_load_variables_rejects_a_mismatched_tree(pair):
    bad = init_variables(pair.cfg, seed=1)
    bad["params"]["backbone"]["conv1"]["kernel"] = np.zeros((1, 1, 1),
                                                            np.float32)
    with pytest.raises(ValueError, match="shape"):
        load_variables(init_detector(pair.cfg, device="cpu"), bad)
    del bad["params"]["backbone"]["conv1"]
    with pytest.raises(ValueError, match="missing"):
        load_variables(init_detector(pair.cfg, device="cpu"), bad)


def _bn_vars(rng, c):
    return ({"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
             "bias": rng.normal(0, 0.1, c).astype(np.float32)},
            {"mean": rng.normal(0, 0.1, c).astype(np.float32),
             "var": rng.uniform(0.5, 2, c).astype(np.float32)})


def test_norms_and_activations_match_jax():
    """BatchNorm (running stats and the folded affine), InstanceNorm,
    ReLU and ELU (expm1) on a padded map: within atol 1e-6."""
    rng = np.random.default_rng(0)
    coords, keys, feats = rand_map(rng, 40, 48, channels=16)
    st_t, st_j = t_map(coords, keys, feats, 2), j_map(coords, keys, feats, 2)
    params, stats = _bn_vars(rng, 16)
    bn_t = tb.SparseBatchNorm(16).eval()
    load_variables(bn_t, {"params": params, "batch_stats": stats})
    jvars = {"params": params, "batch_stats": stats}
    bn_j = jb.SparseBatchNorm()
    np.testing.assert_allclose(bn_t(st_t).feats.detach().numpy(), np.asarray(
        bn_j.apply(jvars, st_j, False).feats), atol=1e-6)
    for a, b in zip(bn_t.affine(), bn_j.apply(jvars, None, False,
                                              features=16)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   atol=1e-6)
    inorm_t = tb.SparseInstanceNorm(16)
    load_variables(inorm_t, {"params": params})
    np.testing.assert_allclose(
        inorm_t(st_t).feats.detach().numpy(),
        np.asarray(jb.SparseInstanceNorm().apply({"params": params},
                                                 st_j).feats), atol=1e-6)
    for fn_t, fn_j in (
            (lambda st: st.with_feats(relu_half_tie(st.feats)),
             jb.sparse_relu),
            (lambda st: st.with_feats(elu_masked(st.feats, st.valid)),
             jb.sparse_elu)):
        np.testing.assert_allclose(fn_t(st_t).feats.numpy(),
                                   np.asarray(fn_j(st_j).feats), atol=1e-6)


@pytest.mark.parametrize("stride,inplanes", [(2, 16), (1, 32)])
def test_basic_block_matches_jax(stride, inplanes):
    """One SparseBasicBlock (folded epilogues, with and without the
    downsample skip) on the same plans: within atol 1e-5."""
    from fcaf3d_tpu.ops.sparse import conv as jc
    from fcaf3d_tpu_torch.ops.sparse import conv as tc

    rng = np.random.default_rng(stride)
    coords, keys, feats = rand_map(rng, 100, 112, grid=7, stride=2,
                                   channels=inplanes)
    st_t, st_j = t_map(coords, keys, feats, 2), j_map(coords, keys, feats, 2)
    block_t = tb.SparseBasicBlock(inplanes, 32, stride=stride,
                                  out_budget=64).eval()
    skip = ["downsample"] if block_t.has_ds else []
    variables = {"params": {}, "batch_stats": {}}
    for name, shape in [("conv1", (27, inplanes, 32)), ("conv2", (27, 32, 32))] \
            + [("downsample_conv", (1, inplanes, 32))] * len(skip):
        variables["params"][name] = {"kernel": (rng.standard_normal(shape)
                                                / np.sqrt(shape[0] * shape[1])
                                                ).astype(np.float32)}
    for name in ["norm1", "norm2"] + ["downsample_norm"] * len(skip):
        variables["params"][name], variables["batch_stats"][name] = \
            _bn_vars(rng, 32)
    load_variables(block_t, variables)
    if stride == 2:
        plans_t = _stage_plans(tc, st_t)
        plans_j = _stage_plans(jc, st_j)
    else:
        plans_t = plans_j = None
    out_t = block_t(st_t, plans_t)
    block_j = jb.SparseBasicBlock(32, stride=stride, out_budget=64)
    out_j = block_j.apply(jax.tree_util.tree_map(jnp.asarray, variables),
                          st_j, False, plans_j)
    eq(out_t.keys, out_j.keys, "keys")
    np.testing.assert_allclose(out_t.feats.detach().numpy(),
                               np.asarray(out_j.feats), atol=1e-5)


def _stage_plans(conv, st):
    """The (s2, s1, downsample) plans a stage's first block gets."""
    plan_s2 = conv.conv_plan(st, 3, 2, 64)
    oc, ok, _, drop = plan_s2
    ds = (oc, ok, conv.build_kernel_map(st.keys, oc,
                                        conv.kernel_offsets(1, st.stride)),
          drop)
    s1 = (oc, ok, conv.build_kernel_map_self(ok, oc, st.stride * 2), drop)
    return plan_s2, s1, ds


def test_bf16_forward_runs_on_cpu():
    """The ScanNet dtype (bf16) path runs end to end on the plain ops at
    tiny budgets: finite outputs of the expected shapes."""
    cfg = dataclasses.replace(tconfigs.fcaf3d_tiny(), compute_dtype="bfloat16")
    model = init_detector(cfg, seed=0, device="cpu")
    xyz, rgb = bench.synth_scene(np.random.RandomState(1), cfg.num_points,
                                 extent=EXTENT["fcaf3d_tiny"])
    dets, overflow = inference_detector(model, np.concatenate([xyz, rgb], 1))
    n = len(dets["scores_3d"])
    assert n > 0 and dets["boxes_3d"].shape == (n, 7)
    assert np.isfinite(dets["boxes_3d"]).all()
    assert set(overflow) == {"input", "backbone_s8", "backbone_s16",
                             "backbone_s32", "backbone_s64",
                             "neck_lateral_missed_0", "neck_lateral_missed_1",
                             "neck_lateral_missed_2"}


@pytest.mark.parametrize("entry", [init_detector, init_votenet, train_model,
                                   create_train_state])
def test_entry_points_default_to_the_card(entry):
    """The port's entry points run on the card unless the caller asks for
    the CPU (as every test here does)."""
    assert inspect.signature(entry).parameters["device"].default == "cuda"
