"""The port's reference-order neck (`neck_mode="reference"`) and its ops,
held against the JAX package on the same numpy inputs, on the CPU.

Integer outputs (route tables, child maps, union and prune keys, coords,
`dropped`, valid masks, detection labels) must be exactly equal. Floats:
the generative transpose, union-add, add-into and interpolation within
1e-6; `gen_gather_gemm` and its gradients (against `jax.vjp`, on maps with
invalid parents) within 1e-5 of each leaf's largest value;
`voxelize_reduce` within 1e-6; the whole model within the atol 1e-4 of
`test_torch_model.py`, its train step at the gates of
`test_torch_train.py`.
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
from fcaf3d_tpu.models.detector import FCAF3D as JFCAF3D
from fcaf3d_tpu.ops.sparse import conv as jc
from fcaf3d_tpu.ops.sparse import tensor as jt
from fcaf3d_tpu_torch import configs as tconfigs
from fcaf3d_tpu_torch.apis import inference_detector, init_detector
from fcaf3d_tpu_torch.ops.sparse import conv as tc
from fcaf3d_tpu_torch.ops.sparse import tensor as tt
from fcaf3d_tpu_torch.params import init_variables
from tests.test_torch_backward import batch_map, leaf_close
from tests.test_torch_model import ATOL, EXTENT
from tests.test_torch_ops import (  # noqa: F401
    SENT, eq, j_map, jax_without_persistent_cache, t_map)
from tests.test_torch_train import assert_step_matches, step_on_both_sides


def reference(name):
    """A miniature config (port, JAX) with the reference-order neck."""
    return (dataclasses.replace(getattr(tconfigs, name)(),
                                neck_mode="reference"),
            dataclasses.replace(getattr(jconfigs, name)(),
                                neck_mode="reference"))


def parents(seed, channels=6):
    """A B = 2 parent map at stride 4 with padding rows (invalid parents):
    (port map, JAX map)."""
    coords, keys, feats = batch_map(seed, 40, 48, channels=channels, grid=6,
                                    stride=4)
    return t_map(coords, keys, feats, 4), j_map(coords, keys, feats, 4)


def weights(rng, *shape):
    return (rng.standard_normal(shape) / np.sqrt(shape[0] * shape[1])).astype(
        np.float32)


def lateral_of(child_t, seed, cap=256, extra=30):
    """A sorted B = 2 stride-2 map: half of the children's voxels plus
    `extra` voxels whose parents are absent (numpy coords, keys, feats)."""
    rng = np.random.default_rng(seed)
    b = child_t.keys.shape[0]
    coords = np.tile(np.array(jt.EXTENT, np.int32), (b, cap, 1))
    keys = np.full((b, cap), SENT, np.uint32)
    feats = np.zeros((b, cap, child_t.num_channels), np.float32)
    for i in range(b):
        valid = child_t.valid[i].numpy()
        cc = child_t.coords[i].numpy()[valid]
        cc = cc[rng.random(len(cc)) < 0.5]
        far = rng.integers(0, 10, (extra, 3)) * 2 + 200
        cc = np.unique(np.concatenate([cc, far]), axis=0)
        k = ((cc[:, 0].astype(np.uint32) << 21)
             | (cc[:, 1].astype(np.uint32) << 10) | cc[:, 2])
        order = np.argsort(k)
        n = len(k)
        coords[i, :n], keys[i, :n] = cc[order], k[order]
        feats[i, :n] = rng.standard_normal((n, feats.shape[-1]))
    return coords, keys, feats


def test_gen_route_tables_and_child_maps_match_jax():
    """The route table, the child map of a parent map with invalid parents
    and `gen_conv_plan` exactly equal; the child map is the k3 self map of
    the key-sorted children, row for row."""
    np.testing.assert_array_equal(tc.gen_route_tables(),
                                  jc._gen_route_tables())
    pt, pj = parents(0)
    pidx_t = tc.build_kernel_map(pt.keys, pt.coords, tc.kernel_offsets(3, 4))
    pidx_j = jc.build_kernel_map(pj.keys, pj.coords, jc.kernel_offsets(3, 4))
    eq(pidx_t, pidx_j, "parent map")
    eq(tc.gen_child_idx(pidx_t), jc._gen_child_idx(pidx_j), "child map")
    w = np.zeros((8, 6, 6), np.float32)
    child_t = tc.generative_transpose_conv2x2(pt, torch.as_tensor(w), False)
    child_j = jc.generative_transpose_conv2x2(pj, jnp.asarray(w), False)
    for a, b, what in zip(tc.gen_conv_plan(pt, child_t),
                          jc.gen_conv_plan(pj, child_j),
                          ("coords", "keys", "idx")):
        eq(a, b, what)
    # against a search over the children themselves
    idx = tc.gen_child_idx(pidx_t)
    valid = child_t.valid
    order = torch.argsort(child_t.keys, dim=1, stable=True)
    skeys = torch.gather(child_t.keys, 1, order)
    searched = tc.build_kernel_map(skeys, child_t.coords,
                                   tc.kernel_offsets(3, 2))
    n = idx.shape[1]
    mapped = torch.where(searched < n, torch.gather(
        torch.cat([order, torch.full_like(order[:, :1], n)], 1), 1,
        searched.reshape(2, -1).long()).reshape(searched.shape), n).int()
    assert torch.equal(idx[valid], mapped[valid])
    with pytest.raises(ValueError, match="parent-major"):
        tc.gen_conv_plan(pt, tc.generative_transpose_conv2x2(
            pt, torch.as_tensor(w)))


@pytest.mark.parametrize("sort_output", [False, True])
def test_generative_transpose_matches_jax(sort_output):
    """Keys and coords exactly, features within 1e-6, both orders."""
    pt, pj = parents(1)
    w = weights(np.random.default_rng(1), 8, 6, 5)
    a = tc.generative_transpose_conv2x2(pt, torch.as_tensor(w), sort_output)
    b = jc.generative_transpose_conv2x2(pj, jnp.asarray(w), sort_output)
    assert a.stride == b.stride == 2 and a.is_sorted == b.is_sorted
    eq(a.keys, b.keys, "keys")
    eq(a.coords, b.coords, "coords")
    np.testing.assert_allclose(a.feats.numpy(), np.asarray(b.feats),
                               atol=1e-6)


def test_gen_gather_gemm_and_vjp_match_jax():
    """Forward, dFeats and dW against `jax.vjp(gen_gather_gemm)` on a map
    with invalid parents, random features and cotangents on every row
    (the padding children's too): within 1e-5 of each leaf's largest."""
    rng = np.random.default_rng(2)
    pt, pj = parents(2)
    pidx_t = tc.build_kernel_map(pt.keys, pt.coords, tc.kernel_offsets(3, 4))
    pidx_j = jc.build_kernel_map(pj.keys, pj.coords, jc.kernel_offsets(3, 4))
    assert bool((~pt.valid).any())
    b, p = pt.keys.shape
    feats = rng.standard_normal((b, 8 * p, 12)).astype(np.float32)
    w = weights(rng, 27, 12, 10)
    dout = rng.standard_normal((b, 8 * p, 10)).astype(np.float32)
    out_j, vjp = jax.vjp(lambda f, ww: jc.gen_gather_gemm(f, pidx_j, ww),
                         jnp.asarray(feats), jnp.asarray(w))
    df_j, dw_j = vjp(jnp.asarray(dout))
    f_t = torch.as_tensor(feats).requires_grad_()
    w_t = torch.as_tensor(w).requires_grad_()
    out_t = tc.gen_gather_gemm(f_t, pidx_t, w_t)
    out_t.backward(torch.as_tensor(dout))
    leaf_close(out_t.detach().numpy(), out_j, 1e-5, "forward")
    leaf_close(f_t.grad.numpy(), df_j, 1e-5, "dfeats")
    leaf_close(w_t.grad.numpy(), dw_j, 1e-5, "dW")


@pytest.mark.parametrize("budget", [None, 150])  # exact bound / overflowing
def test_sparse_union_add_matches_jax(budget):
    """A parent-major child map plus a lateral that shares half of its
    voxels and has voxels of its own: keys, coords and `dropped` exactly,
    features within 1e-6."""
    rng = np.random.default_rng(3)
    pt, pj = parents(3)
    w = weights(rng, 8, 6, 6)
    ct = tc.generative_transpose_conv2x2(pt, torch.as_tensor(w), False)
    cj = jc.generative_transpose_conv2x2(pj, jnp.asarray(w), False)
    lc, lk, lf = lateral_of(ct, 3)
    a = tc.sparse_union_add(ct, t_map(lc, lk, lf, 2), budget)
    b = jc.sparse_union_add(cj, j_map(lc, lk, lf, 2), budget)
    for name in ("keys", "coords", "dropped"):
        eq(getattr(a, name), getattr(b, name), name)
    np.testing.assert_allclose(a.feats.numpy(), np.asarray(b.feats),
                               atol=1e-6)
    assert (int(a.dropped.max()) > 0) == (budget is not None)


def test_sparse_add_into_matches_jax():
    """b's voxels a subset of a's: features within 1e-6, a's map kept."""
    rng = np.random.default_rng(4)
    pt, pj = parents(4)
    w = weights(rng, 8, 6, 6)
    ct = tc.generative_transpose_conv2x2(pt, torch.as_tensor(w))
    cj = jc.generative_transpose_conv2x2(pj, jnp.asarray(w))
    lc, lk, lf = lateral_of(ct, 4, extra=0)
    a = tc.sparse_add_into(ct, t_map(lc, lk, lf, 2))
    b = jc.sparse_add_into(cj, j_map(lc, lk, lf, 2))
    eq(a.keys, b.keys, "keys")
    np.testing.assert_allclose(a.feats.numpy(), np.asarray(b.feats),
                               atol=1e-6)


@pytest.mark.parametrize("budget", [20, 37, 200])
@pytest.mark.parametrize("levels", [4, 1000])  # heavy ties / few ties
def test_sparse_prune_matches_jax(budget, levels):
    """Top-`budget` by score with ties ranked in row order: keys and
    coords exactly, features equal (a compaction)."""
    rng = np.random.default_rng(budget + levels)
    coords, keys, feats = batch_map(5, 60, 72, channels=3)
    scores = rng.integers(0, levels, (2, 72)).astype(np.float32)
    a = tc.sparse_prune(t_map(coords, keys, feats, 2),
                        torch.as_tensor(scores), budget)
    b = jc.sparse_prune(j_map(coords, keys, feats, 2), jnp.asarray(scores),
                        budget)
    for name in ("keys", "coords", "feats"):
        eq(getattr(a, name), getattr(b, name), name)
    kept = (a.keys != SENT).sum(dim=1)
    assert kept.tolist() == [min(budget, v) for v in
                             (keys != SENT).sum(axis=1).tolist()]


def test_interpolate_at_matches_jax():
    """At child voxels (the neck's queries, on the half-stride lattice) and
    at random float positions, some outside the map: within 1e-6."""
    rng = np.random.default_rng(6)
    pt, pj = parents(6, channels=3)
    ct = tc.generative_transpose_conv2x2(pt, torch.zeros(8, 3, 3), False)
    lo, hi = 60, 60 + 4 * 7
    pos = np.concatenate([ct.coords.numpy().astype(np.float32),
                          rng.uniform(lo, hi, (2, 200, 3)).astype(np.float32)],
                         axis=1)
    a = tc.interpolate_at(pt, torch.as_tensor(pos))
    b = jc.interpolate_at(pj, jnp.asarray(pos))
    np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
    assert float(a.abs().max()) > 0


@pytest.mark.parametrize("budget", [60, 900])  # overflowing / roomy
@pytest.mark.parametrize("reduce", ["mean", "max"])
def test_voxelize_reduce_matches_jax(reduce, budget):
    """Keys, coords, shift and `dropped` exactly, features within 1e-6."""
    rng = np.random.RandomState(7)
    xyz, rgb = bench.synth_scene(rng, 1000, extent=(0.3, 0.3, 0.15))
    p = np.stack([xyz, xyz[::-1] + 0.05])
    c = np.stack([rgb, rgb[::-1]]) / 255.0
    valid = rng.rand(2, 1000) < 0.9
    st_t = tt.voxelize_reduce(torch.as_tensor(p), torch.as_tensor(c),
                              torch.as_tensor(valid), 0.01, budget, reduce)
    st_j = jt.voxelize_reduce(jnp.asarray(p), jnp.asarray(c),
                              jnp.asarray(valid), 0.01, budget, reduce)
    for name in ("coords", "keys", "shift", "dropped"):
        eq(getattr(st_t, name), getattr(st_j, name), name)
    np.testing.assert_allclose(st_t.feats.numpy(), np.asarray(st_j.feats),
                               rtol=0, atol=1e-6)
    assert (int(st_t.dropped.max()) > 0) == (budget == 60)
    with pytest.raises(ValueError, match="reduce"):
        tt.voxelize_reduce(torch.as_tensor(p), torch.as_tensor(c),
                           torch.as_tensor(valid), 0.01, budget, "sum")


def test_reference_inference_detector_matches_jax():
    """The whole reference-neck slice at `fcaf3d_tiny` (three up levels)
    through the entry points: the same non-empty detections (labels
    exact, boxes and scores within 1e-4)."""
    cfg, jcfg = reference("fcaf3d_tiny")
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


def test_reference_train_step_matches_jax():
    """One reference-neck train step at `fcaf3d_nano`, B = 2: the training
    forward's head levels within atol 1e-4 (valid masks, i.e. the pruned
    maps, exactly); the overflow counts the JAX package sows exactly equal
    and the union's dropped keys, which it does not sow, zero; losses,
    gradient norm, every gradient leaf (the up block's generated-map conv
    and transpose among them) and the batch statistics at the gates of
    `test_torch_train.py`; the up-block gradients non-zero."""
    cfg, jcfg = reference("fcaf3d_nano")
    got, want = step_on_both_sides(
        cfg, jcfg, head_batch(torch, cfg, EXTENT["fcaf3d_nano"]))
    for i, (a, b) in enumerate(zip(got["outs"], want["outs"])):
        eq(a.valid, b.valid, f"level {i} valid")
        for f in ("centerness", "bbox_pred", "cls_scores", "points"):
            np.testing.assert_allclose(
                getattr(a, f).numpy(), np.asarray(getattr(b, f)), rtol=0,
                atol=ATOL, err_msg=f"level {i} {f}")
    sown = {k: np.asarray(v[0]).tolist() for k, v in want["overflow"].items()}
    assert "neck_with_head" not in sown
    neck = {f"neck_lateral_missed_{i}": [0, 0] for i in range(cfg.n_outs - 1)}
    assert {k: v.tolist() for k, v in got["overflow"].items()} == \
        {**sown, **neck}
    assert_step_matches(got, want)
    for name in ("up_block_1_conv.kernel", "up_block_1_tr.kernel"):
        assert float(got["grads"][f"neck_with_head.{name}"].abs().max()) > 0


def test_neck_modes_equal_when_nothing_pruned():
    """With budgets above every generated child and no backbone overflow,
    the two neck orders give the same maps and, up to summation order, the
    same head outputs (the port's counterpart of
    `tests/test_neck_ops.py::test_neck_modes_equivalent_when_nothing_pruned`,
    on the port's seeded weights: within atol 1e-4)."""
    base = tconfigs.fcaf3d_tiny()
    big = dataclasses.replace(base, n_outs=3,
                              backbone_budgets=(64,) * 6,
                              neck_budgets=(2560, 320, 64, 64))
    rng = np.random.RandomState(0)
    centers = rng.choice(16 ** 3, size=40, replace=False)
    cc = np.stack(np.unravel_index(centers, (16,) * 3), 1).astype(np.float32)
    pick = rng.randint(0, 40, base.num_points)
    pts = torch.as_tensor((cc[pick] * 4 + 0.5) * base.voxel_size)[None]
    colors = torch.as_tensor(rng.uniform(0, 255, (1, base.num_points, 3))
                             .astype(np.float32))
    valid = torch.ones((1, base.num_points), dtype=torch.bool)
    outs = {}
    for mode in ("prune_early", "reference"):
        cfg = dataclasses.replace(big, neck_mode=mode)
        model = init_detector(cfg, seed=0, device="cpu")
        with torch.no_grad():
            outs[mode], ovf = model(pts, colors, valid)
        assert not any(int(v.max()) for v in ovf.values()), ovf
    for i, (a, b) in enumerate(zip(outs["prune_early"], outs["reference"])):
        assert torch.equal(a.valid, b.valid), f"level {i}"
        assert torch.equal(a.points, b.points), f"level {i}"
        for f in ("centerness", "bbox_pred", "cls_scores"):
            np.testing.assert_allclose(getattr(a, f).numpy(),
                                       getattr(b, f).numpy(), rtol=0,
                                       atol=ATOL, err_msg=f"level {i} {f}")
