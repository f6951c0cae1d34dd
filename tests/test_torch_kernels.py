"""The port's kernels K1-K4 (plain PyTorch versions, which the CPU runs)
held against the JAX package's Pallas kernels in interpret mode, on the
same numpy inputs; plus guards on the port's CUDA boundary.

The CUDA kernels themselves run only on a GPU: `chip_smoke.py` holds each
against its plain version there.
"""
import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fcaf3d_tpu import configs as jconfigs
from fcaf3d_tpu.ops.sparse import conv as jc
from fcaf3d_tpu.ops.sparse.gather_kernel import (
    fused_gather_dw as j_gather_dw,
    fused_gather_gemm as j_gather_gemm,
    fused_gather_max as j_gather_max,
)
from fcaf3d_tpu.ops.sparse.search import T_QUERIES
from fcaf3d_tpu.ops.sparse.search import searchsorted_segments as j_search
from fcaf3d_tpu_torch import _native
from fcaf3d_tpu_torch import configs as tconfigs
from fcaf3d_tpu_torch.ops.pointnet import ops as pointnet_ops
from fcaf3d_tpu_torch.ops.sparse import conv as tc
from fcaf3d_tpu_torch.ops.sparse import gather_kernel as tg
from fcaf3d_tpu_torch.ops.sparse import search as ts
from tests.test_torch_ops import (  # noqa: F401
    jax_without_persistent_cache, rand_map, t_map, tkeys)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SENT = 0xFFFFFFFF


def real_map(seed, kernel_size=3, n=300, cap=320):
    """A kernel map over a random sorted map (near-monotone columns, misses
    and padding rows included): (idx [1, cap, K] int32, cap)."""
    coords, keys, _ = rand_map(np.random.default_rng(seed), n, cap, grid=9,
                               stride=1)
    idx = jc.build_kernel_map(jnp.asarray(keys), jnp.asarray(coords),
                              jc.kernel_offsets(kernel_size, 1))
    return np.array(idx), cap


@pytest.mark.parametrize("with_miss", [False, True])
@pytest.mark.parametrize("layout", ["ms", "sm"])
def test_k1_plain_matches_pallas(with_miss, layout):
    """Exactly equal to the Pallas kernel, hits, misses and SENTINEL
    queries included."""
    rng = np.random.default_rng(0)
    b, n, m, s = 2, 300, T_QUERIES, 3
    keys = np.sort(rng.integers(0, 2 ** 31, (b, n)), axis=1).astype(np.uint32)
    keys[:, -40:] = SENT
    q = rng.integers(0, 2 ** 31, (b, m, s)).astype(np.uint32)
    q[:, :200, 0] = keys[:, :200]  # exact hits
    q[:, -7:, :] = SENT
    q = np.sort(q, axis=1)
    if layout == "sm":
        q = np.ascontiguousarray(np.swapaxes(q, 1, 2))
    got = ts.searchsorted_segments(tkeys(keys), tkeys(q), with_miss=with_miss,
                                   layout=layout)
    want = j_search(jnp.asarray(keys), jnp.asarray(q), interpret=True,
                    with_miss=with_miss, layout=layout)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


K2_CASES = [(3, 64, 27), (1, 8, 27), (16, 24, 1)]  # stem, prune scores, k1


def k2_float64(feats, idx, w, scale=None, shift=None, act=None, vmask=None,
               add=None):
    """K2 in float64 numpy: act(sum over (k, c) of the gathered rows times
    W, * scale + shift [+ add]) * vmask; a miss (idx == N) gathers zeros."""
    b, n, c = feats.shape
    fpad = np.concatenate([feats, np.zeros((b, 1, c), feats.dtype)], 1)
    g = np.take_along_axis(fpad.astype(np.float64),
                           idx.reshape(b, -1, 1).astype(np.int64), 1)
    y = np.einsum("bmkc,kce->bme", g.reshape(idx.shape + (c,)),
                  w.astype(np.float64))
    if scale is None:
        return y
    y = y * scale + shift
    if add is not None:
        y = y + add
    if act == "relu":
        y = np.maximum(y, 0.0)
    elif act == "elu":
        y = np.where(y > 0, y, np.exp(np.minimum(y, 0.0)) - 1.0)
    return y * vmask[..., None]


def assert_k2_close(got, want, ref, capfd):
    """`got` (port) within rtol / atol 1e-5 of `want` (Pallas, interpret).
    On a mismatch the message says which side moved: each side's largest
    distance from the float64 reference `ref`, and whether XLA printed, in
    this test, that it loaded an executable compiled for another machine
    type."""
    try:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    except AssertionError as err:
        logged = capfd.readouterr().err
        foreign = ("Machine type" in logged
                   and "doesn't match" in logged)
        raise AssertionError(
            f"{err}\nlargest distance from the float64 reference: port "
            f"{np.abs(got - ref).max():.3e}, JAX {np.abs(want - ref).max():.3e}"
            f"; XLA loaded an executable for another machine type in this "
            f"test: {foreign}\n{logged[-2000:]}") from None


@pytest.mark.parametrize("c,e,k", K2_CASES)
@pytest.mark.parametrize("act", [None, "relu", "elu"])
@pytest.mark.parametrize("with_add", [False, True])
def test_k2_plain_matches_pallas(c, e, k, act, with_add, capfd):
    """f32 within rtol 1e-5 / atol 1e-5 of the Pallas kernel (summation
    order), with the fused epilogue; valid rows with no hit get act(shift).
    A mismatch reports each side's distance from a float64 reference."""
    idx, n = real_map(c + e, kernel_size=3 if k == 27 else 1)
    rng = np.random.default_rng(k + c)
    b, m, _ = idx.shape
    feats = rng.standard_normal((b, n, c)).astype(np.float32)
    w = (rng.standard_normal((k, c, e)) / np.sqrt(k * c)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, e).astype(np.float32)
    shift = rng.normal(0, 0.1, e).astype(np.float32)
    vmask = rng.random((b, m)) < 0.9
    add = rng.standard_normal((b, m, e)).astype(np.float32) if with_add else None
    got = tg.fused_gather_gemm(
        torch.as_tensor(feats), torch.as_tensor(idx), torch.as_tensor(w),
        scale=torch.as_tensor(scale), shift=torch.as_tensor(shift), act=act,
        vmask=torch.as_tensor(vmask),
        add=None if add is None else torch.as_tensor(add))
    want = j_gather_gemm(
        jnp.asarray(feats), jnp.asarray(idx), jnp.asarray(w), interpret=True,
        scale=jnp.asarray(scale), shift=jnp.asarray(shift), act=act,
        vmask=jnp.asarray(vmask), add=None if add is None else jnp.asarray(add))
    assert_k2_close(got.numpy(), np.asarray(want),
                    k2_float64(feats, idx, w, scale, shift, act, vmask, add),
                    capfd)
    if not with_add and act is None:  # the bare sum, without an epilogue
        got = tg.fused_gather_gemm(torch.as_tensor(feats), torch.as_tensor(idx),
                                   torch.as_tensor(w))
        want = j_gather_gemm(jnp.asarray(feats), jnp.asarray(idx),
                             jnp.asarray(w), interpret=True)
        assert_k2_close(got.numpy(), np.asarray(want),
                        k2_float64(feats, idx, w), capfd)


def test_k3_plain_matches_pallas():
    """Stem pool map (k2 s2): exactly equal, all-miss rows included."""
    coords, keys, feats = rand_map(np.random.default_rng(1), 300, 320, grid=9,
                                   stride=1, channels=64)
    oc, _, _ = jc.downsample_coords(
        jc.SparseTensor(coords=jnp.asarray(coords), feats=jnp.asarray(feats),
                        keys=jnp.asarray(keys),
                        shift=jnp.zeros((1, 3), jnp.int32)), 2, 160)
    idx = np.array(jc.build_kernel_map(jnp.asarray(keys), oc,
                                       jc.kernel_offsets(2, 1)))
    got = tg.fused_gather_max(torch.as_tensor(feats), torch.as_tensor(idx))
    want = j_gather_max(jnp.asarray(feats), jnp.asarray(idx), interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (idx == 320).all(axis=-1).any()  # padding rows: all miss


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k4_plain_matches_pallas(dtype):
    """dW within f32 rtol/atol 2e-3 of the Pallas kernel in interpret mode
    (the JAX package's own tolerance): B = 2, C and E not multiples of 8,
    random sorted maps with misses, and a real k3 s1 map."""
    rng = np.random.default_rng(11)
    b, n, m, k, c, e = 2, 200, 96, 9, 21, 37
    idx = np.sort(rng.integers(0, n + 1, (b, m, k)), axis=1).astype(np.int32)
    cases = [(idx, n, c, e)]
    real, cap = real_map(5)
    cases.append((np.concatenate([real, real[:, ::-1]]), cap, 12, 19))
    for idx, n, c, e in cases:
        feats = rng.standard_normal((idx.shape[0], n, c)).astype(np.float32)
        dout = rng.standard_normal(idx.shape[:2] + (e,)).astype(np.float32)
        dt = getattr(torch, dtype)
        ft = torch.as_tensor(feats).to(dt)
        dtt = torch.as_tensor(dout).to(dt)
        got = tg.fused_gather_dw(ft, torch.as_tensor(idx), dtt)
        assert got.dtype == torch.float32 and got.shape == (idx.shape[2], c, e)
        want = j_gather_dw(jnp.asarray(ft.float().numpy()), jnp.asarray(idx),
                           jnp.asarray(dtt.float().numpy()), interpret=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-3,
                                   atol=2e-3)
    assert (idx == cap).any()  # misses


@pytest.mark.parametrize("b,m,k,c,e", [(8, 43520, 27, 3, 64),
                                       (1, 1024, 27, 512, 512),
                                       (1, 30, 1, 8, 8), (2, 0, 27, 4, 4)])
def test_k4_slices_cover_the_rows(b, m, k, c, e):
    """K4's row slices are whole row tiles, cover every row, leave no slice
    empty and keep the grid's offset x slice axis in range."""
    per, n = tg.dw_slices(b, m, k, c, e)
    assert per % tg.DW_TILE_ROWS == 0 and per > 0
    assert n * per >= b * m and (n - 1) * per < max(b * m, 1)
    assert k * n <= 65535


def test_port_imports_no_jax():
    """Importing the whole port loads neither jax nor the JAX package."""
    code = ("import sys, fcaf3d_tpu_torch.apis, fcaf3d_tpu_torch.params; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'fcaf3d_tpu')]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)
    for root, _, files in os.walk(os.path.join(REPO, "fcaf3d_tpu_torch")):
        for name in files:
            if name.endswith(".py"):
                with open(os.path.join(root, name)) as f:
                    src = f.read()
                assert "import jax" not in src and "from jax" not in src, name


class _CudaLooking(torch.Tensor):
    """A CPU tensor that reports a CUDA device, to reach the kernel path of
    a wrapper on a machine without a GPU."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def _cuda_looking(t):
    return torch.Tensor._make_subclass(_CudaLooking, t)


def test_cuda_wrappers_raise_without_kernel(monkeypatch):
    """On a CUDA tensor a wrapper launches its kernel or raises: with no
    kernel library it must not fall back to the plain version."""
    def no_library():
        raise RuntimeError("kernel library not built")

    monkeypatch.setattr(_native, "load", no_library)
    before = dict(_native.LAUNCHES)
    keys = _cuda_looking(torch.arange(8, dtype=torch.int64)[None])
    feats = _cuda_looking(torch.ones(1, 8, 4))
    idx = _cuda_looking(torch.zeros(1, 4, 27, dtype=torch.int32))
    w = _cuda_looking(torch.ones(27, 4, 2))
    with pytest.raises(RuntimeError, match="not built"):
        ts.searchsorted_segments(keys, keys[:, :, None], with_miss=True)
    with pytest.raises(RuntimeError, match="not built"):
        tg.fused_gather_gemm(feats, idx, w)
    with pytest.raises(RuntimeError, match="not built"):
        tg.fused_gather_max(feats, idx[..., :8])
    with pytest.raises(RuntimeError, match="not built"):
        tg.fused_gather_dw(feats, idx, _cuda_looking(torch.ones(1, 4, 2)))
    xyz = _cuda_looking(torch.zeros(1, 8, 3))
    valid = _cuda_looking(torch.ones(1, 8, dtype=torch.bool))
    with pytest.raises(RuntimeError, match="not built"):
        pointnet_ops.furthest_point_sample(xyz, 4, valid)
    with pytest.raises(RuntimeError, match="not built"):
        pointnet_ops.ball_query(xyz, xyz, 0.2, 4, valid)
    assert _native.LAUNCHES == before


def test_cuda_kernels_refuse_to_cut_the_graph(monkeypatch):
    """K2 and K3 on a CUDA tensor that requires grad, with autograd
    recording, raise instead of returning a tensor without grad_fn; the
    autograd Functions call them with recording off."""
    def library_reached():
        raise RuntimeError("library reached")

    monkeypatch.setattr(_native, "load", library_reached)
    feats = _cuda_looking(torch.ones(1, 8, 4)).requires_grad_()
    idx = _cuda_looking(torch.zeros(1, 4, 27, dtype=torch.int32))
    w = _cuda_looking(torch.ones(27, 4, 2))
    with pytest.raises(RuntimeError, match="not differentiable"):
        tg.fused_gather_gemm(feats, idx, w)
    with pytest.raises(RuntimeError, match="not differentiable"):
        tg.fused_gather_max(feats, idx[..., :8])
    with torch.no_grad(), pytest.raises(RuntimeError,
                                        match="library reached"):
        tg.fused_gather_gemm(feats, idx, w)


def test_build_raises_without_nvcc(monkeypatch):
    monkeypatch.setattr(_native, "find_nvcc", lambda: None)
    with pytest.raises(RuntimeError, match="nvcc"):
        _native.build()


def test_epilogue_arguments_are_checked():
    """act/vmask/add without scale, and an epilogue with a conv bias, raise
    (the JAX package drops the first silently and asserts the second)."""
    feats, w = torch.ones(1, 4, 2), torch.ones(1, 2, 3)
    idx = torch.zeros(1, 4, 1, dtype=torch.int32)
    with pytest.raises(ValueError):
        tg.fused_gather_gemm(feats, idx, w, act="relu")
    coords, keys, f = rand_map(np.random.default_rng(0), 4, 4, channels=2)
    epi = tc.ConvEpilogue(torch.ones(3), torch.zeros(3), "relu")
    with pytest.raises(ValueError):
        tc.sparse_conv(t_map(coords, keys, f, 2), torch.ones(27, 2, 3), 3,
                       bias=torch.zeros(3), epilogue=epi)


@pytest.mark.parametrize("name", ["fcaf3d_scannet", "fcaf3d_tiny",
                                  "fcaf3d_nano"])
def test_configs_match_jax(name):
    """The port's copies of the configs equal the JAX package's."""
    assert dataclasses.asdict(getattr(tconfigs, name)()) == \
        dataclasses.asdict(getattr(jconfigs, name)())
