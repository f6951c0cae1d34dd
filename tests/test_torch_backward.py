"""The port's training forward and backward of the sparse engine and the
backbone, held against `jax.grad` of the JAX package on the same numpy
inputs, on the CPU (plain PyTorch versions of the kernels; XLA or Pallas
interpret mode on the JAX side).

- gather-GEMM backward (dFeats on the reversed or inverted map, dW) on a
  self map, a k3 s2 map and a k1 s2 map: within 2e-4 (the JAX package's own
  fused-vs-scatter tolerance), against both of its backwards;
- max-pool backward with tied maxima: exactly equal;
- ReLU / ELU gradients at exact zeros: within 1e-6;
- BatchNorm in training (output and running statistics): atol 1e-6;
- a BasicBlock and the tiny backbone in training, forward and backward.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fcaf3d_tpu.models import blocks as jb
from fcaf3d_tpu.models.me_resnet import MEResNet3D as JMEResNet3D
from fcaf3d_tpu.ops.sparse import conv as jc
from fcaf3d_tpu.ops.sparse import tensor as jt
from fcaf3d_tpu_torch import configs as tconfigs
from fcaf3d_tpu_torch.apis import init_detector
from fcaf3d_tpu_torch.models import blocks as tb
from fcaf3d_tpu_torch.ops.sparse import conv as tc
from fcaf3d_tpu_torch.ops.sparse import tensor as tt
from fcaf3d_tpu_torch.params import flatten, init_variables, load_variables
from tests.test_torch_model import EXTENT, _bn_vars, _stage_plans
from tests.test_torch_ops import (  # noqa: F401
    eq, j_map, jax_without_persistent_cache, rand_map, t_map)

import bench


def batch_map(seed, n, cap, channels, grid=7, stride=2):
    """Two sorted maps stacked into one B = 2 map (numpy coords, keys,
    feats)."""
    rng = np.random.default_rng(seed)
    maps = [rand_map(rng, n - 9 * i, cap, grid=grid, stride=stride,
                     channels=channels) for i in range(2)]
    return tuple(np.concatenate(parts, axis=0) for parts in zip(*maps))


def leaf_close(got, want, rel, what):
    """Every element within `rel` times the leaf's largest |value|."""
    want = np.asarray(want)
    tol = rel * max(float(np.abs(want).max()), 1e-12)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=tol,
                               err_msg=what)


@pytest.mark.parametrize("jax_bwd", ["default", "force"])
@pytest.mark.parametrize("kind", ["k3s1_self", "k3s2", "k1s2"])
def test_gather_gemm_backward_matches_jax(kind, jax_bwd, monkeypatch):
    """dFeats and dW of `gather_gemm` within 2e-4 of `jax.grad` of the JAX
    package's, with its default (scatter) and its fused (Pallas interpret)
    backward; the port's backward is the fused one on both maps."""
    monkeypatch.setenv("FCAF3D_FUSED_BWD", "1" if jax_bwd == "default"
                       else "force")
    coords, keys, feats = batch_map(1, 120, 128, channels=12)
    ksize, stride = {"k3s1_self": (3, 1), "k3s2": (3, 2),
                     "k1s2": (1, 2)}[kind]
    st_j = j_map(coords, keys, feats, 2)
    _, _, idx, _ = jc.conv_plan(st_j, ksize, stride, 40)
    idx = np.array(idx)
    sym = kind == "k3s1_self"
    rng = np.random.default_rng(2)
    w = (rng.standard_normal((ksize ** 3, 12, 20)) * 0.2).astype(np.float32)
    dout = rng.standard_normal(idx.shape[:2] + (20,)).astype(np.float32)

    def loss(f, ww):
        return jnp.sum(jc.gather_gemm(f, jnp.asarray(idx), ww, 3, True, sym)
                       * dout)

    df_j, dw_j = jax.jit(jax.grad(loss, argnums=(0, 1)))(jnp.asarray(feats),
                                                jnp.asarray(w))
    f_t = torch.tensor(feats, requires_grad=True)
    w_t = torch.tensor(w, requires_grad=True)
    out = tc.gather_gemm(f_t, torch.as_tensor(idx), w_t, sym)
    (out * torch.as_tensor(dout)).sum().backward()
    np.testing.assert_allclose(f_t.grad.numpy(), np.asarray(df_j), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(w_t.grad.numpy(), np.asarray(dw_j), rtol=2e-4,
                               atol=2e-4)


def test_invert_kernel_map_matches_the_map():
    """rev[i, k] == m exactly where idx[m, k] == i, else M."""
    coords, keys, feats = batch_map(3, 100, 112, channels=2)
    st = t_map(coords, keys, feats, 2)
    _, _, idx, _ = tc.conv_plan(st, 3, 2, 40)
    rev = tc.invert_kernel_map(idx, st.capacity)
    assert rev.is_contiguous()  # the kernels take only contiguous maps
    rev = rev.numpy()
    idx = idx.numpy()
    b, m, k = idx.shape
    want = np.full((b, st.capacity, k), m, np.int32)
    bb, mm, kk = np.nonzero(idx < st.capacity)
    want[bb, idx[bb, mm, kk], kk] = mm
    np.testing.assert_array_equal(rev, want)
    assert (rev < m).any() and (rev == m).any()


def graph_nodes(t, depth=3):
    """Type names of the autograd nodes within `depth` steps of t."""
    names, frontier = set(), [t.grad_fn]
    for _ in range(depth):
        nxt = []
        for node in frontier:
            if node is not None:
                names.add(type(node).__name__)
                nxt += [n for n, _ in node.next_functions]
        frontier = nxt
    return names


@pytest.mark.parametrize("ksize,stride", [(3, 1), (3, 2), (1, 2)])
def test_conv_and_pool_record_their_functions(ksize, stride):
    """On the CPU the outputs carry the same autograd Functions the card
    runs, so the CPU tests exercise the card's graph."""
    coords, keys, feats = rand_map(np.random.default_rng(4), 60, 64,
                                   channels=4)
    st = t_map(coords, keys, feats, 2)
    st = st.with_feats(st.feats.requires_grad_())
    w = torch.ones(ksize ** 3, 4, 3, requires_grad=True)
    out = tc.sparse_conv(st, w, ksize, stride, out_budget=32)
    assert "_GatherGemmBackward" in graph_nodes(out.feats)
    pooled = tc.sparse_max_pool(st, 2, 2, 32)
    assert "_MaxPoolFeatsBackward" in graph_nodes(pooled.feats)
    with pytest.raises(ValueError, match="kernel_size == stride"):
        tc.sparse_max_pool(st, 3, 2, 32)


def test_max_pool_builds_inverse_map_only_for_backward(monkeypatch):
    """The inverse map `parent_row` costs one more search; inference (no
    gradient recorded) skips it and pools the same values."""
    coords, keys, feats = rand_map(np.random.default_rng(6), 60, 64,
                                   channels=4)
    calls = []
    lookup = tc.lookup
    monkeypatch.setattr(tc, "lookup", lambda *a, **kw: calls.append(1)
                        or lookup(*a, **kw))
    f = torch.as_tensor(feats).requires_grad_()
    with torch.no_grad():
        inf = tc.sparse_max_pool(t_map(coords, keys, f, 2), 2, 2, 32)
    n_inference = len(calls)
    train = tc.sparse_max_pool(t_map(coords, keys, f, 2), 2, 2, 32)
    assert (n_inference, len(calls) - n_inference) == (1, 2)
    assert inf.feats.grad_fn is None and train.feats.grad_fn is not None
    eq(inf.feats, train.feats.detach(), "pooled")


def test_max_pool_backward_ties_match_jax():
    """Windows holding tied maxima: every tied element gets the full
    gradient, exactly as the JAX package's inverse-map backward gives it
    (torch's `amax` backward would split it)."""
    coords, keys, _ = batch_map(5, 150, 160, channels=6, grid=9, stride=2)
    rng = np.random.default_rng(5)
    feats = rng.integers(0, 3, (2, 160, 6)).astype(np.float32)  # many ties
    feats[keys == jt.SENTINEL] = 0.0
    dout = rng.standard_normal((2, 48, 6)).astype(np.float32)

    def loss(f):
        out = jc.sparse_max_pool(j_map(coords, keys, f, 2), 2, 2, 48)
        return jnp.sum(out.feats * dout), out.feats

    (_, out_j), g_j = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        jnp.asarray(feats))
    f_t = torch.tensor(feats, requires_grad=True)
    out_t = tc.sparse_max_pool(t_map(coords, keys, f_t, 2), 2, 2, 48)
    (out_t.feats * torch.as_tensor(dout)).sum().backward()
    eq(out_t.feats.detach(), out_j, "pooled")
    eq(f_t.grad, g_j, "dfeats")
    # ties did occur: without them each valid output element would give
    # its gradient to exactly one input element
    assert np.count_nonzero(f_t.grad.numpy()) > int(out_t.valid.sum()) * 6


def test_activation_gradients_at_zero_match_jax():
    """ReLU and ELU of exact zeros (as every padding row is, and valid rows
    can be): the same gradients as `jax.grad` of the JAX package's,
    including `maximum`'s 1/2 at the tie."""
    coords, keys, feats = rand_map(np.random.default_rng(9), 40, 48,
                                   channels=4)
    feats[0, :20:3] = 0.0
    dout = np.random.default_rng(10).standard_normal(feats.shape).astype(
        np.float32)
    for fn_t, fn_j in ((tb.sparse_relu, jb.sparse_relu),
                       (tb.sparse_elu, jb.sparse_elu)):
        f_t = torch.tensor(feats, requires_grad=True)
        (fn_t(t_map(coords, keys, f_t, 2)).feats
         * torch.as_tensor(dout)).sum().backward()
        g_j = jax.grad(lambda f: jnp.sum(
            fn_j(j_map(coords, keys, f, 2)).feats * dout))(jnp.asarray(feats))
        np.testing.assert_allclose(f_t.grad.numpy(), np.asarray(g_j),
                                   rtol=1e-6, atol=1e-7)


def test_batch_norm_train_matches_jax():
    """Normalised output and the updated running mean/var (momentum 0.1,
    biased variance) within atol 1e-6 of flax's mutated batch_stats."""
    coords, keys, feats = batch_map(6, 40, 48, channels=16)
    params, stats = _bn_vars(np.random.default_rng(6), 16)
    bn_t = tb.SparseBatchNorm(16)
    load_variables(bn_t, {"params": params, "batch_stats": stats})
    out_t = bn_t.train()(t_map(coords, keys, feats, 2))
    out_j, mut = jb.SparseBatchNorm().apply(
        {"params": params, "batch_stats": stats}, j_map(coords, keys, feats, 2),
        True, mutable=["batch_stats"])
    np.testing.assert_allclose(out_t.feats.detach().numpy(),
                               np.asarray(out_j.feats), atol=1e-6)
    for name in ("mean", "var"):
        np.testing.assert_allclose(getattr(bn_t, name).numpy(),
                                   np.asarray(mut["batch_stats"][name]),
                                   atol=1e-6, err_msg=name)
    # evaluation still uses the running statistics
    assert not np.allclose(bn_t.eval()(t_map(coords, keys, feats, 2))
                           .feats.detach().numpy(), np.asarray(out_j.feats))


@pytest.mark.parametrize("stride,inplanes", [(2, 16), (1, 32)])
def test_basic_block_train_matches_jax(stride, inplanes):
    """One SparseBasicBlock in training: output within atol 1e-5, batch
    statistics within 1e-6, and the gradients of every parameter and of the
    input features within 1e-4 of each leaf's largest value."""
    coords, keys, feats = batch_map(stride, 100, 112, channels=inplanes)
    rng = np.random.default_rng(stride)
    st_t, st_j = t_map(coords, keys, feats, 2), j_map(coords, keys, feats, 2)
    block_t = tb.SparseBasicBlock(inplanes, 32, stride=stride, out_budget=64)
    skip = ["downsample"] if block_t.has_ds else []
    variables = {"params": {}, "batch_stats": {}}
    shapes = [("conv1", (27, inplanes, 32)), ("conv2", (27, 32, 32))] \
        + [("downsample_conv", (1, inplanes, 32))] * len(skip)
    for name, shape in shapes:
        variables["params"][name] = {"kernel": (rng.standard_normal(shape)
                                                / np.sqrt(shape[0] * shape[1])
                                                ).astype(np.float32)}
    for name in ["norm1", "norm2"] + ["downsample_norm"] * len(skip):
        variables["params"][name], variables["batch_stats"][name] = \
            _bn_vars(rng, 32)
    load_variables(block_t, variables)
    plans_t = _stage_plans(tc, st_t) if stride == 2 else None
    plans_j = _stage_plans(jc, st_j) if stride == 2 else None
    dout = rng.standard_normal((2, 64 if stride == 2 else 112, 32)).astype(
        np.float32)

    block_j = jb.SparseBasicBlock(32, stride=stride, out_budget=64)

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


def test_backbone_train_matches_jax():
    """The tiny backbone (depth 34, 4 stages) in training: per-stage maps
    exact, features within atol 1e-4, batch statistics within 1e-5, and
    every parameter's gradient within 1e-3 of its leaf's largest value
    (f32 summation order over ~40 layers, forward and backward)."""
    cfg = tconfigs.fcaf3d_tiny()
    variables = init_variables(cfg, seed=0)
    model = init_detector(cfg, seed=0, device="cpu")
    pts, cols = [], []
    for seed in range(2):
        xyz, rgb = bench.synth_scene(np.random.RandomState(seed),
                                     cfg.num_points,
                                     extent=EXTENT["fcaf3d_tiny"])
        pts.append(xyz)
        cols.append(rgb)
    p = np.stack(pts).astype(np.float32)
    c = np.stack(cols).astype(np.float32) / 255.0
    v = np.ones(p.shape[:2], bool)
    st_t = tt.voxelize(torch.as_tensor(p), torch.as_tensor(c),
                       torch.as_tensor(v), cfg.voxel_size, cfg.input_budget)
    st_j = jt.voxelize(jnp.asarray(p), jnp.asarray(c), jnp.asarray(v),
                       cfg.voxel_size, cfg.input_budget)
    backbone = JMEResNet3D(depth=cfg.depth, n_outs=cfg.n_outs,
                           budgets=cfg.backbone_budgets)
    stats = jax.tree_util.tree_map(jnp.asarray,
                                   variables["batch_stats"]["backbone"])
    rng = np.random.default_rng(7)
    outs_t = model.backbone.train()(st_t)
    douts = [rng.standard_normal(o.feats.shape).astype(np.float32)
             for o in outs_t]

    def loss(params):
        outs, mut = backbone.apply({"params": params, "batch_stats": stats},
                                   st_j, True, mutable=["batch_stats"])
        total = sum(jnp.sum(o.feats * d) for o, d in zip(outs, douts))
        return total, (outs, mut["batch_stats"])

    (_, (outs_j, stats_j)), g_j = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(jax.tree_util.tree_map(
            jnp.asarray, variables["params"]["backbone"]))
    sum((o.feats * torch.as_tensor(d)).sum()
        for o, d in zip(outs_t, douts)).backward()
    for i, (a, b) in enumerate(zip(outs_t, outs_j)):
        eq(a.keys, b.keys, f"stage {i} keys")
        np.testing.assert_allclose(a.feats.detach().numpy(),
                                   np.asarray(b.feats), atol=1e-4,
                                   err_msg=f"stage {i}")
    named = dict(model.backbone.named_parameters())
    for name, g in flatten(g_j).items():
        leaf_close(named[name].grad.numpy(), g, 1e-3, name)
    bufs = dict(model.backbone.named_buffers())
    for name, v in flatten(stats_j).items():
        np.testing.assert_allclose(bufs[name].numpy(), np.asarray(v),
                                   atol=1e-5, err_msg=name)
