"""The port's sparse ops and NMS (`fcaf3d_tpu_torch`) held against the JAX
package on the same numpy inputs, on the CPU (plain PyTorch paths; XLA on
the JAX side).

Integer outputs (keys, coords, kernel maps, source rows, keep masks,
dropped counts) must be exactly equal; float outputs within the tolerance
stated at each test.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from fcaf3d_tpu.core.nms import nms_bev as j_nms_bev
from fcaf3d_tpu.ops.sparse import conv as jc
from fcaf3d_tpu.ops.sparse import neck_ops as jn
from fcaf3d_tpu.ops.sparse import tensor as jt
from fcaf3d_tpu_torch.core.nms import nms_bev as t_nms_bev
from fcaf3d_tpu_torch.ops.sparse import conv as tc
from fcaf3d_tpu_torch.ops.sparse import neck_ops as tn
from fcaf3d_tpu_torch.ops.sparse import tensor as tt

SENT = 0xFFFFFFFF


@pytest.fixture(scope="module", autouse=True)
def jax_without_persistent_cache():
    """Runs a module's JAX side without JAX's persistent compilation cache
    (which `tests/conftest.py` turns on for the whole suite), and without
    executables compiled before it in this process, so that the reference
    side of every comparison is compiled here, for this machine. Restores
    the setting afterwards."""
    from jax.experimental.compilation_cache import compilation_cache

    was = jax.config.jax_enable_compilation_cache
    jax.config.update("jax_enable_compilation_cache", False)
    compilation_cache.reset_cache()
    jax.clear_caches()
    yield
    jax.config.update("jax_enable_compilation_cache", was)
    compilation_cache.reset_cache()


def tkeys(keys):
    """uint32 numpy keys -> the port's int64 key tensor."""
    return torch.as_tensor(np.asarray(keys).astype(np.int64))


def eq(port, ref, what=""):
    """Exact equality of a port tensor and a JAX array (keys compared as
    uint32)."""
    got = port.numpy()
    want = np.asarray(ref)
    if want.dtype == np.uint32:
        got = got.astype(np.uint32)
    np.testing.assert_array_equal(got, want, err_msg=what)


def rand_map(rng, n, cap, grid=8, stride=2, channels=3, origin=64):
    """A sorted batch-1 coordinate map of `n` voxels on a stride-`stride`
    lattice, padded to `cap` rows: (coords, keys uint32, feats) numpy."""
    occ = rng.choice(grid ** 3, size=n, replace=False)
    cc = (np.stack(np.unravel_index(occ, (grid,) * 3), 1).astype(np.int32)
          * stride + origin)
    keys = (cc[:, 0].astype(np.uint32) << 21) | (cc[:, 1].astype(np.uint32)
                                                 << 10) | cc[:, 2]
    order = np.argsort(keys)
    coords = np.tile(np.array(jt.EXTENT, np.int32), (cap, 1))
    k = np.full(cap, SENT, np.uint32)
    feats = np.zeros((cap, channels), np.float32)
    coords[:n], k[:n] = cc[order], keys[order]
    feats[:n] = rng.standard_normal((n, channels)).astype(np.float32)
    return coords[None], k[None], feats[None]


def j_map(coords, keys, feats, stride):
    return jt.SparseTensor(coords=jnp.asarray(coords), feats=jnp.asarray(feats),
                           keys=jnp.asarray(keys),
                           shift=jnp.zeros((1, 3), jnp.int32), stride=stride)


def t_map(coords, keys, feats, stride):
    return tt.SparseTensor(coords=torch.as_tensor(coords),
                           feats=torch.as_tensor(feats), keys=tkeys(keys),
                           shift=torch.zeros((1, 3), dtype=torch.int32),
                           stride=stride)


def test_encode_decode_match_jax():
    rng = np.random.default_rng(0)
    coords = rng.integers(-6, 2100, (2, 300, 3)).astype(np.int32)
    coords[0, :5] = [[0, 0, 0], [2046, 2047, 1023], [2047, 0, 0],
                     [0, 2048, 0], [0, 0, -1]]
    keys_t = tt.encode_coords(torch.as_tensor(coords))
    keys_j = jt.encode_coords(jnp.asarray(coords))
    eq(keys_t, keys_j, "keys")
    eq(tt.decode_coords(keys_t), jt.decode_coords(keys_j), "decoded coords")


@pytest.mark.parametrize("budget", [64, 900])  # overflowing / roomy
def test_voxelize_matches_jax(budget):
    rng = np.random.RandomState(0)
    xyz, rgb = bench.synth_scene(rng, 1000, extent=(0.4, 0.4, 0.2))
    valid = rng.rand(1, 1000) < 0.9
    p, c = xyz[None], rgb[None]
    st_t = tt.voxelize(torch.as_tensor(p), torch.as_tensor(c),
                       torch.as_tensor(valid), 0.01, budget)
    st_j = jt.voxelize(jnp.asarray(p), jnp.asarray(c), jnp.asarray(valid),
                       0.01, budget)
    for name in ("coords", "keys", "feats", "shift", "dropped"):
        eq(getattr(st_t, name), getattr(st_j, name), name)
    assert (int(st_t.dropped[0]) > 0) == (budget == 64)


def test_compact_positions_and_downsample_match_jax():
    rng = np.random.default_rng(1)
    mask = rng.random((2, 200)) < 0.3
    for budget in (10, 120):
        sel_t, tot_t = tt.compact_positions(torch.as_tensor(mask), budget)
        sel_j, tot_j = jt.compact_positions(jnp.asarray(mask), budget)
        eq(sel_t, sel_j, f"sel budget {budget}")
        eq(tot_t, tot_j, "total")
    coords, keys, feats = rand_map(np.random.default_rng(2), 150, 160,
                                   grid=9, stride=2)
    for budget in (20, 100):
        out_t = tt.downsample_coords(t_map(coords, keys, feats, 2), 2, budget)
        out_j = jt.downsample_coords(j_map(coords, keys, feats, 2), 2, budget)
        for a, b, name in zip(out_t, out_j, ("coords", "keys", "dropped")):
            eq(a, b, f"{name} budget {budget}")


def test_lookup_matches_jax():
    rng = np.random.default_rng(3)
    coords, keys, _ = rand_map(rng, 60, 64, grid=6, stride=1)
    q = np.concatenate([keys[:, :40], rng.integers(0, 2 ** 31, (1, 30)),
                        np.full((1, 5), SENT)], axis=1).astype(np.uint32)
    eq(tt.lookup(tkeys(keys), tkeys(q)),
       jt.lookup(jnp.asarray(keys), jnp.asarray(q)))


@pytest.mark.parametrize("kernel_size", [1, 2, 3])
@pytest.mark.parametrize("stride", [1, 2, 4])
@pytest.mark.parametrize("origin", [0, 64])  # 0: rows at the z < 0 edge
def test_build_kernel_map_matches_jax(kernel_size, stride, origin):
    """[B, M, K] maps exactly equal, for the self map and for a strided
    output map, including padding (EXTENT) rows."""
    rng = np.random.default_rng(10 * kernel_size + stride)
    coords, keys, feats = rand_map(rng, 80, 96, grid=7, stride=stride,
                                   origin=origin)
    offs = jc.kernel_offsets(kernel_size, stride)
    np.testing.assert_array_equal(tc.kernel_offsets(kernel_size, stride), offs)
    got = tc.build_kernel_map(tkeys(keys), torch.as_tensor(coords), offs)
    want = jc.build_kernel_map(jnp.asarray(keys), jnp.asarray(coords), offs)
    eq(got, want, "self map")
    oc_t, _, _ = tt.downsample_coords(t_map(coords, keys, feats, stride), 2, 48)
    oc_j, _, _ = jt.downsample_coords(j_map(coords, keys, feats, stride), 2, 48)
    got = tc.build_kernel_map(tkeys(keys), oc_t, offs)
    want = jc.build_kernel_map(jnp.asarray(keys), oc_j, offs)
    eq(got, want, "strided map")
    if kernel_size == 3:
        eq(tc.build_kernel_map_self(tkeys(keys), torch.as_tensor(coords),
                                    stride),
           jc.build_kernel_map_self(jnp.asarray(keys), jnp.asarray(coords),
                                    stride), "build_kernel_map_self")


@pytest.mark.parametrize("kernel_size,stride", [(3, 1), (3, 2), (1, 2)])
def test_sparse_conv_matches_jax(kernel_size, stride):
    """Features within f32 atol 1e-5 (summation order), maps exact; with
    and without the fused epilogue."""
    rng = np.random.default_rng(4)
    coords, keys, feats = rand_map(rng, 100, 112, grid=7, stride=2,
                                   channels=16)
    w = rng.standard_normal((kernel_size ** 3, 16, 24)).astype(np.float32)
    w /= np.sqrt(kernel_size ** 3 * 16)
    scale = rng.uniform(0.5, 1.5, 24).astype(np.float32)
    shift = rng.normal(0, 0.1, 24).astype(np.float32)
    for act in (None, "relu", "elu"):
        out_t = tc.sparse_conv(
            t_map(coords, keys, feats, 2), torch.as_tensor(w), kernel_size,
            stride, out_budget=64,
            epilogue=tc.ConvEpilogue(torch.as_tensor(scale),
                                     torch.as_tensor(shift), act))
        out_j = jc.sparse_conv(
            j_map(coords, keys, feats, 2), jnp.asarray(w), kernel_size, stride,
            out_budget=64,
            epilogue=jc.ConvEpilogue(jnp.asarray(scale), jnp.asarray(shift),
                                     act))
        eq(out_t.keys, out_j.keys, "out keys")
        np.testing.assert_allclose(out_t.feats.numpy(), np.asarray(out_j.feats),
                                   rtol=1e-5, atol=1e-5)
    out_t = tc.sparse_conv(t_map(coords, keys, feats, 2), torch.as_tensor(w),
                           kernel_size, stride, out_budget=64)
    out_j = jc.sparse_conv(j_map(coords, keys, feats, 2), jnp.asarray(w),
                           kernel_size, stride, out_budget=64)
    np.testing.assert_allclose(out_t.feats.numpy(), np.asarray(out_j.feats),
                               rtol=1e-5, atol=1e-5)


def test_sparse_max_pool_matches_jax():
    """Stem k2 s2 pool: exactly equal (a max is exact)."""
    rng = np.random.default_rng(5)
    coords, keys, feats = rand_map(rng, 150, 160, grid=9, stride=2,
                                   channels=8)
    out_t = tc.sparse_max_pool(t_map(coords, keys, feats, 2), 2, 2, 40)
    out_j = jc.sparse_max_pool(j_map(coords, keys, feats, 2), 2, 2, 40)
    for name in ("coords", "keys", "feats", "dropped"):
        eq(getattr(out_t, name), getattr(out_j, name), name)


def test_neck_scores_and_children_match_jax():
    """Slot weights, child prune scores and lateral rows exactly equal;
    generated child features within f32 atol 1e-6."""
    np.testing.assert_array_equal(tn.trilinear_slot_weights(),
                                  jn.trilinear_slot_weights())
    rng = np.random.default_rng(6)
    coords, keys, feats = rand_map(rng, 30, 36, grid=5, stride=4, channels=6)
    pt, pj = t_map(coords, keys, feats, 4), j_map(coords, keys, feats, 4)
    kmap_t = tc.build_kernel_map_self(pt.keys, pt.coords, 4)
    kmap_j = jc.build_kernel_map_self(pj.keys, pj.coords, 4)
    eq(tn.child_prune_scores(pt.feats[..., :1], kmap_t),
       jn.child_prune_scores(pj.feats[..., :1], kmap_j), "child scores")

    w = rng.standard_normal((8, 6, 5)).astype(np.float32)
    ct, kt, ft = tn.gen_children(pt, torch.as_tensor(w))
    cj, kj, fj = jn.gen_children(pj, jnp.asarray(w))
    eq(ct, cj, "child coords")
    eq(kt, kj, "child keys")
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), atol=1e-6)

    # laterals: children of the first parents, plus voxels with no parent
    lc = (coords[0, :6, None, :] + np.array([[0, 0, 0], [2, 0, 2],
                                              [2, 2, 2]])[None]).reshape(-1, 3)
    lc = np.concatenate([lc, [[200, 200, 200], [202, 200, 200]]])
    lk = ((lc[:, 0].astype(np.uint32) << 21)
          | (lc[:, 1].astype(np.uint32) << 10) | lc[:, 2].astype(np.uint32))
    order = np.argsort(lk)
    lcoords = np.tile(np.array(jt.EXTENT, np.int32), (24, 1))
    lkeys = np.full(24, SENT, np.uint32)
    lcoords[:20], lkeys[:20] = lc[order], lk[order]
    lat = (lcoords[None], lkeys[None], np.zeros((1, 24, 2), np.float32))
    eq(tn.lateral_child_rows(pt, t_map(*lat, 2)),
       jn.lateral_child_rows(pj, j_map(*lat, 2)), "lateral rows")


def test_threshold_select_and_compact_select_match_jax():
    """Keep masks, compacted rows and old2new exactly equal, with score
    ties, must-keep rows and budgets on both sides of the valid count."""
    rng = np.random.default_rng(7)
    for trial in range(4):
        n = 200
        s = np.round(rng.standard_normal((2, n)), 1).astype(np.float32)  # ties
        valid = rng.random((2, n)) < 0.8
        must = rng.random((2, n)) < 0.05 if trial % 2 else None
        for budget in (17, 60, 250):
            kt = tn.threshold_select(
                torch.as_tensor(s), torch.as_tensor(valid), budget,
                must_keep=None if must is None else torch.as_tensor(must))
            kj = jn.threshold_select(
                jnp.asarray(s), jnp.asarray(valid), budget,
                must_keep=None if must is None else jnp.asarray(must))
            eq(kt, kj, f"keep trial {trial} budget {budget}")
    coords, keys, feats = rand_map(rng, 90, 100, grid=6, stride=2)
    keep = rng.random((1, 100)) < 0.5
    out_t = tn.compact_select(torch.as_tensor(coords), tkeys(keys),
                              torch.as_tensor(feats), torch.as_tensor(keep), 32)
    out_j = jn.compact_select(jnp.asarray(coords), jnp.asarray(keys),
                              jnp.asarray(feats), jnp.asarray(keep), 32)
    for a, b, name in zip(out_t, out_j, ("coords", "keys", "feats", "old2new")):
        eq(a, b, name)
    perm = rng.permutation(100)
    unsorted = (coords[:, perm], keys[:, perm], feats[:, perm])
    st_t = tn.sort_tensor(t_map(*unsorted, 2))
    st_j = jn.sort_tensor(j_map(*unsorted, 2))
    for name in ("coords", "keys", "feats"):
        eq(getattr(st_t, name), getattr(st_j, name), f"sorted {name}")


def test_nms_bev_keep_masks_match_jax():
    """Axis-aligned BEV NMS keep masks exactly equal, batched over classes
    on the port's side and vmapped on the JAX side; tied scores included."""
    rng = np.random.default_rng(8)
    c, k = 5, 48
    boxes = np.concatenate([rng.uniform(0, 3, (c, k, 3)),
                            rng.uniform(0.2, 1.5, (c, k, 3)),
                            np.zeros((c, k, 1))], axis=-1).astype(np.float32)
    scores = np.round(rng.random((c, k)), 2).astype(np.float32)
    valid = scores > 0.1
    got = t_nms_bev(torch.as_tensor(boxes), torch.as_tensor(scores), 0.3,
                    valid=torch.as_tensor(valid), rotated=False)
    want = jax.vmap(lambda b, s, v: j_nms_bev(b, s, 0.3, valid=v,
                                              rotated=False))(
        jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(valid))
    eq(got, want, "keep")
    assert 0 < int(got.sum()) < int(valid.sum())
