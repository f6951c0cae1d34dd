"""The port's kernels K1-K4 (plain PyTorch versions, which the CPU runs)
held against the JAX package's Pallas kernels in interpret mode, on the
same numpy inputs; plus guards on the port's CUDA boundary.

The CUDA kernels themselves run only on a GPU: `chip_smoke.py` holds each
against its plain version there.
"""
import dataclasses
import os
import re
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


@pytest.mark.parametrize("threads", [1, 3, 8])
def test_elu_epilogue_matches_float64(threads):
    """The plain epilogue's ELU within 1e-7 of float64 at every element,
    with the tensor split over `threads` intra-op threads: the K2 flake
    (ROADMAP Queue 3) moved the negative outputs of one thread's share of
    `torch.exp` by up to 1e-4."""
    rng = np.random.default_rng(0)
    out = rng.normal(0, 1, (1, 640, 64)).astype(np.float32)
    out[0, 600:] = 0.0  # all-miss rows: act(shift), as in the flake
    scale = rng.uniform(0.5, 1.5, 64).astype(np.float32)
    shift = rng.normal(0, 0.1, 64).astype(np.float32)
    vmask = np.ones((1, 640), bool)
    was = torch.get_num_threads()
    torch.set_num_threads(threads)
    try:
        got = tg.apply_epilogue(torch.as_tensor(out), torch.as_tensor(scale),
                                torch.as_tensor(shift), "elu",
                                torch.as_tensor(vmask))
    finally:
        torch.set_num_threads(was)
    y = (out * scale + shift).astype(np.float64)  # the f32 pre-activation
    want = np.where(y > 0, y, np.expm1(np.minimum(y, 0.0)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-7)


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


def _gather_max_source():
    with open(os.path.join(REPO, "fcaf3d_tpu_torch", "csrc",
                           "gather_max.cu")) as f:
        return f.read()


def k3_vector_replay(feats, idx, chunk):
    """K3's vector kernel in torch: a row's offsets walked `chunk` at a
    time, misses (idx == N) skipped, the max taken in float, `lowest` for a
    row with no hit, the result cast back."""
    b, n, c = feats.shape
    f = feats.float()
    best = torch.full((b, idx.shape[1], c), -torch.inf)
    hit_any = torch.zeros(idx.shape[:2], dtype=torch.bool)
    for k0 in range(0, idx.shape[2], chunk):
        for r in idx[:, :, k0:k0 + chunk].unbind(-1):
            hit = r < n
            g = torch.take_along_dim(f, r.clamp(max=n - 1).long()[..., None],
                                     dim=1)
            best = torch.where(hit[..., None], torch.maximum(best, g), best)
            hit_any |= hit
    lowest = torch.finfo(feats.dtype).min
    return torch.where(hit_any[..., None], best, lowest).to(feats.dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k3_vector_plan_covers_every_channel_once(dtype):
    """For every C from 1 to 80 and K of 8, 12 and 27: the plan's vector is
    the widest of 16, 8, 4 and 2 bytes (never narrower than one element)
    that divides a row, so that a thread holds whole channels of one row;
    the threads of a row (thread i: row i // vecs, vector i % vecs) cover
    each channel exactly once; the map is read by int4 exactly where
    K % 4 == 0; and the kernel's walk over the offsets, kChunk at a time
    (read from `csrc/gather_max.cu`), gives exactly `fused_gather_max_plain`
    on maps with misses, all-miss rows and ties."""
    chunk = int(re.search(r"constexpr int kChunk = (\d+);",
                          _gather_max_source()).group(1))
    elt = torch.finfo(dtype).bits // 8
    rng = np.random.default_rng(7)
    b, n, m = 2, 11, 6
    for c in range(1, 81):
        for k in (8, 12, 27):
            plan = tg.k3_plan(c, k, dtype)
            vb = plan.vector_bytes
            assert plan.variant == f"vec{vb}" and plan.variant in tg.K3_VARIANTS
            assert vb in (16, 8, 4, 2) and vb >= elt and c * elt % vb == 0
            assert not any(c * elt % w == 0 for w in (16, 8, 4, 2) if w > vb)
            assert plan.map_vector == (4 if k % 4 == 0 else 1)
            per, vecs = vb // elt, c * elt // vb
            i = np.arange(m * vecs)
            cover = np.zeros((m, c), np.int64)
            np.add.at(cover, (i[:, None] // vecs,
                              (i % vecs)[:, None] * per + np.arange(per)), 1)
            assert (cover == 1).all()
            idx = rng.integers(0, n + 1, (b, m, k)).astype(np.int32)
            idx[:, 0] = n  # an all-miss row
            feats = torch.as_tensor(
                rng.integers(-3, 4, (b, n, c)).astype(np.float32)).to(dtype)
            want = tg.fused_gather_max_plain(feats, torch.as_tensor(idx))
            got = k3_vector_replay(feats, torch.as_tensor(idx), chunk)
            assert torch.equal(got, want), (c, k)


@pytest.mark.parametrize("c,k,dtype", [(64, 8, torch.bfloat16),
                                       (64, 8, torch.float32),
                                       (3, 27, torch.bfloat16),
                                       (6, 12, torch.float32)])
def test_k3_wrapper_hands_the_kernel_its_plan(monkeypatch, c, k, dtype):
    """On a CUDA tensor the wrapper hands `fcaf3d_gather_max_vec` the shapes,
    the dtype code, `k3_plan`'s vector bytes and map vector and finfo.min,
    counts the launch by variant, and reaches the first kernel only through
    `_variant="scalar"`; the C entry takes exactly the plan's vector widths,
    and `_native` binds both entries."""
    lib = _Recorder()
    monkeypatch.setattr(_native, "load", lambda: lib)
    monkeypatch.setattr(_native, "stream_ptr", lambda dev: 0)
    _native.reset_launches()
    b, n, m = 2, 50, 40
    feats = _cuda_looking(torch.zeros(b, n, c, dtype=dtype))
    idx = _cuda_looking(torch.full((b, m, k), n, dtype=torch.int32))
    out = tg.fused_gather_max(feats, idx)
    assert out.shape == (b, m, c) and out.dtype == dtype
    tg.fused_gather_max(feats, idx, _variant="scalar")
    (name, args), (old_name, old_args) = lib.calls
    plan = tg.k3_plan(c, k, dtype)
    code, lowest = int(dtype == torch.bfloat16), torch.finfo(dtype).min
    assert name == "fcaf3d_gather_max_vec" and old_name == "fcaf3d_gather_max"
    assert args[3:] == (b, n, m, k, c, code, plan.vector_bytes,
                        plan.map_vector, lowest, 0)
    assert old_args[3:] == (b, n, m, k, c, code, lowest, 0)
    dname = str(dtype).replace("torch.", "")
    assert _native.VARIANT_LAUNCHES == {("gather_max", plan.variant, dname): 1,
                                        ("gather_max", "scalar", dname): 1}
    with pytest.raises(ValueError, match="variant"):
        tg.fused_gather_max(feats, idx, _variant="vec16")
    _native.reset_launches()
    src = _gather_max_source()
    entry = src[src.index('extern "C" int fcaf3d_gather_max_vec('):]
    widths = re.search(r"\(vector_bytes != 16 && vector_bytes != 8 && "
                       r"vector_bytes != 4 &&\s*vector_bytes != 2\)", entry)
    assert widths and tuple(f"vec{w}" for w in (16, 8, 4, 2)) \
        == tg.K3_VARIANTS[:-1]
    bound = re.findall(r"lib\.(fcaf3d_gather_max\w*)\.argtypes",
                       open(_native.__file__).read())
    assert sorted(bound) == ["fcaf3d_gather_max", "fcaf3d_gather_max_vec"]


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


class _Recorder:
    """A kernel library that records the arguments of each C call."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if not name.startswith("fcaf3d_"):
            raise AttributeError(name)
        return lambda *args: self.calls.append((name, args)) or 0


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
                                  "fcaf3d_nano", "fcaf3d_scannet_3scales",
                                  "fcaf3d_scannet_2scales", "fcaf3d_sunrgbd",
                                  "fcaf3d_s3dis"])
def test_configs_match_jax(name):
    """The port's copies of the configs equal the JAX package's."""
    assert dataclasses.asdict(getattr(tconfigs, name)()) == \
        dataclasses.asdict(getattr(jconfigs, name)())
