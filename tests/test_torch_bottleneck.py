"""The port's depth-50/101 backbones (`SparseBottleneck`, `MEResNet3D` at
depth 50 and 101) held against the JAX package on the same numpy inputs
and parameters, on the CPU.

- One Bottleneck at stride 1 and 2, with and without the downsample skip:
  folded-BN evaluation within atol 1e-5; training within atol 1e-5, batch
  statistics within 1e-6 and every gradient within 1e-4 of its leaf's
  largest value.
- The depth-50 backbone at `fcaf3d_nano`: per-stage maps exactly equal
  and features within atol 1e-4; the depth-50 model at `fcaf3d_tiny`'s
  budgets through `inference_detector` (labels exact, boxes and scores
  within atol 1e-4).
- The depth-50 train step at `fcaf3d_nano` B = 2 against
  `jax.value_and_grad`, at the gates of `test_torch_train.py`.
- Depth 101's module tree: its Bottleneck count per stage and widths.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from chip_smoke import head_batch
from fcaf3d_tpu import configs as jconfigs
from fcaf3d_tpu.apis.inference import inference_detector as j_inference
from fcaf3d_tpu.models import blocks as jb
from fcaf3d_tpu.models.detector import FCAF3D as JFCAF3D
from fcaf3d_tpu.models.me_resnet import MEResNet3D as JMEResNet3D
from fcaf3d_tpu.ops.sparse import conv as jc
from fcaf3d_tpu.ops.sparse import tensor as jt
from fcaf3d_tpu_torch import configs as tconfigs
from fcaf3d_tpu_torch.apis import inference_detector, init_detector
from fcaf3d_tpu_torch.models import blocks as tb
from fcaf3d_tpu_torch.models.me_resnet import MEResNet3D, out_channels
from fcaf3d_tpu_torch.ops.sparse import conv as tc
from fcaf3d_tpu_torch.ops.sparse import tensor as tt
from fcaf3d_tpu_torch.params import flatten, init_variables, load_variables
from tests.test_torch_backward import batch_map, leaf_close
from tests.test_torch_model import EXTENT, _bn_vars, _stage_plans
from tests.test_torch_ops import (  # noqa: F401
    eq, j_map, jax_without_persistent_cache, t_map)
from tests.test_torch_train import assert_step_matches, step_on_both_sides

ATOL = 1e-4
PLANES = 16  # a Bottleneck's inner width here; its output is 4x


def depth50(name):
    """A miniature config (port, JAX) at depth 50."""
    return (dataclasses.replace(getattr(tconfigs, name)(), depth=50),
            dataclasses.replace(getattr(jconfigs, name)(), depth=50))


def bottleneck_vars(rng, inplanes, has_ds):
    """A Bottleneck's numpy {"params", "batch_stats"} tree."""
    out = PLANES * 4
    shapes = [("conv1", (1, inplanes, PLANES)), ("conv2", (27, PLANES, PLANES)),
              ("conv3", (1, PLANES, out))]
    if has_ds:
        shapes.append(("downsample_conv", (1, inplanes, out)))
    variables = {"params": {}, "batch_stats": {}}
    for name, shape in shapes:
        variables["params"][name] = {"kernel": (
            rng.standard_normal(shape) / np.sqrt(shape[0] * shape[1])
        ).astype(np.float32)}
    norms = [("norm1", PLANES), ("norm2", PLANES), ("norm3", out)]
    if has_ds:
        norms.append(("downsample_norm", out))
    for name, c in norms:
        variables["params"][name], variables["batch_stats"][name] = \
            _bn_vars(rng, c)
    return variables


# stride 2 opens a stage (always with the skip conv); at stride 1 the skip
# conv is there only where the width changes
CASES = [(2, 32), (1, 32), (1, 4 * PLANES)]


@pytest.mark.parametrize("stride,inplanes", CASES)
def test_bottleneck_inference_matches_jax(stride, inplanes):
    """Folded-BN evaluation (relu epilogues, the residual add on conv3)
    against flax `apply(train=False)`: within atol 1e-5."""
    rng = np.random.default_rng(10 * stride + inplanes)
    coords, keys, feats = batch_map(stride, 100, 112, channels=inplanes)
    st_t, st_j = t_map(coords, keys, feats, 2), j_map(coords, keys, feats, 2)
    block_t = tb.SparseBottleneck(inplanes, PLANES, stride=stride,
                                  out_budget=64).eval()
    assert block_t.has_ds == (stride == 2 or inplanes != 4 * PLANES)
    variables = bottleneck_vars(rng, inplanes, block_t.has_ds)
    load_variables(block_t, variables)
    plans_t = _stage_plans(tc, st_t) if stride == 2 else None
    plans_j = _stage_plans(jc, st_j) if stride == 2 else None
    with torch.no_grad():
        out_t = block_t(st_t, plans_t)
    block_j = jb.SparseBottleneck(PLANES, stride=stride, out_budget=64)
    out_j = jax.jit(lambda v, st: block_j.apply(v, st, False, plans_j))(
        jax.tree_util.tree_map(jnp.asarray, variables), st_j)
    eq(out_t.keys, out_j.keys, "keys")
    np.testing.assert_allclose(out_t.feats.numpy(), np.asarray(out_j.feats),
                               atol=1e-5)


@pytest.mark.parametrize("stride,inplanes", CASES)
def test_bottleneck_train_matches_jax(stride, inplanes):
    """Training (the unfused path): output within atol 1e-5, batch
    statistics within 1e-6, the gradients of every parameter and of the
    input features within 1e-4 of each leaf's largest value."""
    rng = np.random.default_rng(10 * stride + inplanes + 1)
    coords, keys, feats = batch_map(stride, 100, 112, channels=inplanes)
    st_t, st_j = t_map(coords, keys, feats, 2), j_map(coords, keys, feats, 2)
    block_t = tb.SparseBottleneck(inplanes, PLANES, stride=stride,
                                  out_budget=64)
    variables = bottleneck_vars(rng, inplanes, block_t.has_ds)
    load_variables(block_t, variables)
    plans_t = _stage_plans(tc, st_t) if stride == 2 else None
    plans_j = _stage_plans(jc, st_j) if stride == 2 else None
    dout = rng.standard_normal(
        (2, 64 if stride == 2 else 112, 4 * PLANES)).astype(np.float32)
    block_j = jb.SparseBottleneck(PLANES, stride=stride, out_budget=64)

    def loss(params, f):
        out, mut = block_j.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            st_j.with_feats(f), True, plans_j, mutable=["batch_stats"])
        return jnp.sum(out.feats * dout), (out.feats, mut["batch_stats"])

    (_, (out_j, stats_j)), (g_p, g_f) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, variables["params"]),
        jnp.asarray(feats))

    f_t = st_t.feats.clone().requires_grad_()
    out_t = block_t.train()(st_t.with_feats(f_t), plans_t)
    (out_t.feats * torch.as_tensor(dout)).sum().backward()
    np.testing.assert_allclose(out_t.feats.detach().numpy(), np.asarray(out_j),
                               atol=1e-5)
    leaf_close(f_t.grad.numpy(), g_f, 1e-4, "dfeats")
    named = dict(block_t.named_parameters())
    for name, g in flatten(g_p).items():
        leaf_close(named[name].grad.numpy(), g, 1e-4, name)
    bufs = dict(block_t.named_buffers())
    for name, v in flatten(stats_j).items():
        np.testing.assert_allclose(bufs[name].numpy(), np.asarray(v),
                                   atol=1e-6, err_msg=name)


def test_depth50_backbone_stages_match_jax():
    """The depth-50 backbone at `fcaf3d_nano` (2 stages, 256 and 512
    wide): per-stage maps exactly equal, features within atol 1e-4."""
    cfg, _ = depth50("fcaf3d_nano")
    model = init_detector(cfg, seed=0, device="cpu")
    jvars = jax.tree_util.tree_map(jnp.asarray, init_variables(cfg, seed=0))
    xyz, rgb = bench.synth_scene(np.random.RandomState(0), cfg.num_points,
                                 extent=EXTENT["fcaf3d_nano"])
    p = xyz[None].astype(np.float32)
    c = rgb[None].astype(np.float32) / 255.0
    v = np.ones(p.shape[:2], bool)
    st_t = tt.voxelize(torch.as_tensor(p), torch.as_tensor(c),
                       torch.as_tensor(v), cfg.voxel_size, cfg.input_budget)
    with torch.no_grad():
        outs_t = model.backbone(st_t)
    backbone = JMEResNet3D(depth=50, n_outs=cfg.n_outs,
                           budgets=cfg.backbone_budgets)
    bvars = {"params": jvars["params"]["backbone"],
             "batch_stats": jvars["batch_stats"]["backbone"]}
    st_j = jt.voxelize(jnp.asarray(p), jnp.asarray(c), jnp.asarray(v),
                       cfg.voxel_size, cfg.input_budget)
    outs_j = jax.jit(lambda vs, st: backbone.apply(vs, st, False))(bvars, st_j)
    assert [o.num_channels for o in outs_t] == [256, 512]
    for i, (a, b) in enumerate(zip(outs_t, outs_j)):
        eq(a.keys, b.keys, f"stage {i} keys")
        eq(a.dropped, b.dropped, f"stage {i} dropped")
        np.testing.assert_allclose(a.feats.numpy(), np.asarray(b.feats),
                                   rtol=0, atol=ATOL, err_msg=f"stage {i}")


def test_depth50_inference_detector_matches_jax():
    """The whole depth-50 slice at `fcaf3d_tiny` (4 scales, outputs up to
    2048 wide) through the entry points: the same non-empty detections
    (labels exact, boxes and scores within 1e-4)."""
    cfg, jcfg = depth50("fcaf3d_tiny")
    model = init_detector(cfg, seed=0, device="cpu")
    jvars = jax.tree_util.tree_map(jnp.asarray, init_variables(cfg, seed=0))
    xyz, rgb = bench.synth_scene(np.random.RandomState(0), cfg.num_points,
                                 extent=EXTENT["fcaf3d_tiny"])
    points = np.concatenate([xyz, rgb], axis=1)
    got, _ = inference_detector(model, points, seed=0)
    want = j_inference(JFCAF3D(jcfg), jvars, points, jcfg, seed=0)
    assert len(got["scores_3d"]) == len(want["scores_3d"]) > 0
    np.testing.assert_array_equal(got["labels_3d"], want["labels_3d"])
    np.testing.assert_allclose(got["boxes_3d"], want["boxes_3d"], rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(got["scores_3d"], want["scores_3d"], rtol=0,
                               atol=ATOL)


def test_depth50_train_step_matches_jax():
    """One depth-50 train step at `fcaf3d_nano` (2 stages), B = 2: losses,
    gradient norm, every gradient leaf and the batch statistics at the
    gates of `test_torch_train.py`."""
    cfg, jcfg = depth50("fcaf3d_nano")
    batch = head_batch(torch, cfg, EXTENT["fcaf3d_nano"])
    assert_step_matches(*step_on_both_sides(cfg, jcfg, batch))


@pytest.mark.parametrize("depth,blocks", [(50, (4, 3, 6, 3)),
                                          (101, (3, 4, 23, 3))])
def test_bottleneck_depths_build(depth, blocks):
    """Depth 50 and 101 build Bottleneck stages of the reference's block
    counts, 4x the BasicBlock widths, with the skip conv on each stage's
    first block alone."""
    net = MEResNet3D(depth=depth, device="meta")
    assert out_channels(depth, 4) == (256, 512, 1024, 2048)
    for i, n in enumerate(blocks):
        names = [f"layer{i + 1}_{j}" for j in range(n)]
        assert all(isinstance(getattr(net, m), tb.SparseBottleneck)
                   for m in names)
        assert [getattr(net, m).has_ds for m in names] == \
            [True] + [False] * (n - 1)
        assert not hasattr(net, f"layer{i + 1}_{n}")
    with pytest.raises(ValueError, match="depth"):
        MEResNet3D(depth=26, device="meta")
