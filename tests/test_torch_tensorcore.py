"""What surrounds the kernels of K2 and K4 (the kernels run only on a GPU,
where `chip_smoke.py` holds them against their plain versions): the variant
rules, the tile and slice choices and what the wrapper hands the kernel,
`chip_smoke`'s work counter that its bounds rest on, and the build's source
hash.
"""
import ast
import os
import re
import shutil

import numpy as np
import pytest
import torch

import chip_smoke
from fcaf3d_tpu_torch import _native
from fcaf3d_tpu_torch.ops.sparse import gather_kernel as tg
from tests.test_torch_kernels import real_map

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the dFeats products of the training path: (E of the conv -> its C), K
DFEATS_SHAPES = ((64, 64, 27), (128, 64, 27))


@pytest.mark.parametrize("c,e,k", list(chip_smoke.K2_SHAPES) + list(
    DFEATS_SHAPES))
def test_k2_variant_rules(c, e, k):
    """bf16 goes to the tensor cores (folded below 16 channels), f32 to the
    CUDA cores (narrow below 16 channels, else tiled), at every K2 shape of
    the path and both dFeats products; never to the first SIMT kernel."""
    want = "tc_folded" if c < 16 else "tc"
    assert tg.k2_variant(c, e, k, torch.bfloat16) == want
    want = "simt_narrow" if c < 16 else "simt_tiled"
    assert tg.k2_variant(c, e, k, torch.float32) == want


@pytest.mark.parametrize("shape", sorted({s for s, _ in chip_smoke.K4_SHAPES}))
def test_k4_variant_rules(shape):
    c, e, k = shape
    want = "tc_folded" if c < 16 else "tc"
    assert tg.k4_variant(c, e, k, torch.bfloat16) == want
    assert tg.k4_variant(c, e, k, torch.float32) == "simt"


@pytest.mark.parametrize("pick", [tg.k2_variant, tg.k4_variant])
def test_variants_off_the_granule_stay_simt(pick):
    """bf16 with E, or C >= 16, off the 8-channel (16-byte) granule of
    cp.async stays on the CUDA cores (K2 on its narrow or tiled kernel, K4
    on its SIMT one); C < 16 folds whatever C is."""
    bf = torch.bfloat16
    k2 = pick is tg.k2_variant
    assert pick(64, 18, 27, bf) == ("simt_tiled" if k2 else "simt")
    assert pick(20, 64, 27, bf) == ("simt_tiled" if k2 else "simt")
    assert pick(3, 64, 27, bf) == "tc_folded"
    assert pick(24, 64, 1, bf) == "tc"
    if k2:
        assert pick(3, 18, 27, bf) == "simt_narrow"


def test_fold_limits():
    """The folded variants take K * C up to what one block holds, else the
    SIMT kernel."""
    bf = torch.bfloat16
    assert tg.fold_depth(27, 3) == 96 and tg.fold_depth(27, 1) == 32
    assert tg.k2_variant(15, 64, 27, bf) == "tc_folded"  # depth 416
    assert tg.k2_variant(15, 64, 40, bf) == "simt_narrow"  # depth 608
    assert tg.k4_variant(4, 64, 27, bf) == "tc_folded"  # 108 rows
    assert tg.k4_variant(5, 64, 27, bf) == "simt"  # 135 rows


@pytest.mark.parametrize("b,m", [(1, 43520), (1, 1024), (8, 30720), (1, 5)])
@pytest.mark.parametrize("c,e,k", list(chip_smoke.K2_SHAPES) + list(
    DFEATS_SHAPES))
def test_k2_tiles_cover_every_output_once(b, m, c, e, k):
    """K2's tile is one the CUDA entry point takes, a function of the
    shapes alone, and its grid covers every (row, channel) exactly once;
    the offset split only where the tiles would not fill the SMs, into the
    plain version's chunks."""
    variant = tg.k2_variant(c, e, k, torch.bfloat16)
    tm, tn, split = tg.k2_tiles(variant, b, m, e, k)
    assert tg.k2_tiles(variant, b, m, e, k) == (tm, tn, split)
    allowed = {"tc": {(128, 128), (64, 64)},
               "tc_folded": {(64, 64), (128, 8)}}[variant]
    assert (tm, tn) in allowed
    gm, ge = -(-m // tm), -(-e // tn)
    assert (gm - 1) * tm < m <= gm * tm and (ge - 1) * tn < e <= ge * tn
    if (tm, tn) == (128, 128):  # only where the big tiles fill the SMs
        assert b * gm * ge >= tg.SMS
    if variant == "tc_folded":
        assert tg.fold_depth(k, c) <= tg.K2_FOLD_MAX_DEPTH
    assert split in (1, tg.N_CHUNKS)
    if split > 1:
        assert variant == "tc" and b * gm * ge < tg.SMS and k >= split
        bounds = tg.chunk_bounds(k)
        assert bounds[0][0] == 0 and bounds[-1][1] == k
        assert all(lo < hi for lo, hi in bounds)  # no empty chunk


def test_k2_split_at_the_stride64_convs():
    """The s64 C512 E512 conv (M = 1 024 at batch 1) splits its offsets;
    the s8 conv and the batch-8 s64 conv fill the SMs without."""
    assert tg.k2_tiles("tc", 1, 1024, 512, 27) == (64, 64, 3)
    assert tg.k2_tiles("tc", 1, 30720, 64, 27) == (64, 64, 1)
    assert tg.k2_tiles("tc", 8, 1024, 512, 27) == (128, 128, 1)
    assert tg.k2_tiles("tc", 1, 1024, 512, 1) == (64, 64, 1)


@pytest.mark.parametrize("b,m", [(1, 30720), (8, 43520), (8, 1024), (1, 7)])
@pytest.mark.parametrize("variant", ["simt", "tc", "tc_folded"])
def test_k4_slices_partition_the_rows(b, m, variant):
    """Every K4 slice choice cuts the B * M rows into slices that cover each
    row exactly once, none empty, within the grid's z limit."""
    for (c, e, k), _ in chip_smoke.K4_SHAPES:
        if variant == "tc_folded" and k * c > tg.K4_FOLD_ROWS:
            continue
        per, n = tg.dw_slices(b, m, k, c, e, variant)
        rows = b * m
        covered = np.zeros(rows, np.int64)
        for s in range(n):
            lo, hi = s * per, min(rows, (s + 1) * per)
            assert lo < hi
            covered[lo:hi] += 1
        assert (covered == 1).all()
        assert per % tg.DW_TILE_ROWS == 0
        blocks_z = n if variant == "tc_folded" else k * n
        assert blocks_z <= 65535
        assert tg.dw_slices(b, m, k, c, e, variant) == (per, n)


def test_k4_tiles():
    assert tg.k4_tiles("simt", 512, 512) == (64, 64)
    assert tg.k4_tiles("tc", 512, 512) == (128, 128)
    assert tg.k4_tiles("tc", 64, 128) == (64, 64)
    assert tg.k4_tiles("tc_folded", 3, 64) == (tg.K4_FOLD_ROWS, 64)


@pytest.mark.parametrize("c,e", [(3, 64), (64, 128)])
@pytest.mark.parametrize("epilogue,add", [(False, False), (True, False),
                                          (True, True)])
def test_work_counter_matches_a_brute_count(c, e, epilogue, add):
    """`chip_smoke.gemm_work` (the FLOPs and bytes behind every bound)
    against a loop over a real map's entries and the arrays' own sizes."""
    idx, n = real_map(3)
    idx = np.concatenate([idx, idx[:, ::-1]])  # B = 2
    b, m, k = idx.shape
    hits = [sum(int(idx[bi, mi, ki] < n) for bi in range(b)
                for mi in range(m)) for ki in range(k)]
    assert chip_smoke.count_hits(torch.as_tensor(idx), n) == hits
    assert 0 < sum(hits) < b * m * k  # misses and hits
    elt = 2
    feats = np.zeros((b, n, c), np.float16)
    w = np.zeros((k, c, e), np.float16)
    out = np.zeros((b, m, e), np.float16)
    flops, nbytes = chip_smoke.gemm_work(torch.as_tensor(idx), n, c, e, elt,
                                         epilogue=epilogue, add=add)
    assert flops == 2 * sum(hits) * c * e
    want = feats.nbytes + idx.nbytes + w.nbytes + out.nbytes
    if epilogue:  # scale, shift (f32) and vmask (one byte a row)
        want += 2 * 4 * e + b * m
    if add:
        want += out.nbytes
    assert nbytes == want
    dw = np.zeros((k, c, e), np.float32)
    flops, nbytes = chip_smoke.gemm_work(torch.as_tensor(idx), n, c, e, elt,
                                         weight_grad=True)
    assert flops == 2 * sum(hits) * c * e
    assert nbytes == feats.nbytes + idx.nbytes + out.nbytes + dw.nbytes


def test_bound_takes_the_larger_limit():
    ms, by = chip_smoke.bound(989e9, 1e3, chip_smoke.PEAK_OPS["bfloat16"])
    assert by == "operations" and ms == pytest.approx(1.0)
    ms, by = chip_smoke.bound(1.0, 3.35e9, chip_smoke.PEAK_OPS["bfloat16"])
    assert by == "bytes" and ms == pytest.approx(1.0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k4_replay_gate_holds_to_float64(monkeypatch, dtype):
    """`chip_smoke.hold_calls_to_plain` on recorded K4 calls: `k4_float64`
    equals a numpy float64 contraction, the plain version passes, and a dW
    off by 1e-3 of its largest value at one element fails (the limit of a
    tensor-core call, K4_ULP a step of its chain, is below that here)."""
    idx, n = real_map(5)
    idx = np.concatenate([idx, idx[:, ::-1]])  # B = 2
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((2, n, 8)).astype(np.float32)
    dout = rng.standard_normal(idx.shape[:2] + (16,)).astype(np.float32)
    args = (torch.as_tensor(feats).to(dtype), torch.as_tensor(idx),
            torch.as_tensor(dout).to(dtype))
    feats, dout = (a.float().numpy() for a in (args[0], args[2]))
    fpad = np.concatenate([feats, np.zeros((2, 1, 8), np.float32)], 1)
    g = np.stack([fpad[i][idx[i]] for i in range(2)]).astype(np.float64)
    want = np.einsum("bmkc,bme->kce", g, dout.astype(np.float64))
    ref = chip_smoke.k4_float64(torch, *args)
    assert ref.dtype == torch.float64
    np.testing.assert_allclose(ref.numpy(), want, rtol=1e-12, atol=1e-12)
    calls = {"fused_gather_dw": [(args, {})]}
    worst = chip_smoke.hold_calls_to_plain(torch, calls, "a recorded step")
    assert worst["K4"] <= chip_smoke.K4_RTOL
    steps = worst["its mma steps"]
    assert (steps > 0) == (dtype == torch.bfloat16)
    assert chip_smoke.K4_ULP * steps < 1e-3
    real = tg.fused_gather_dw

    def off(*a, **kw):
        out = real(*a, **kw).clone()
        out[0, 0, 0] += 1e-3 * float(out.abs().max())
        return out

    monkeypatch.setattr(tg, "fused_gather_dw", off)
    with pytest.raises(AssertionError, match="K4"):
        chip_smoke.hold_calls_to_plain(torch, calls, "a recorded step")


def test_ballq_scan_count():
    """Points a ball query scans: up to its nsample-th hit, else all."""
    pts = torch.tensor([[[0.0, 0, 0], [5, 0, 0], [0.1, 0, 0], [0.2, 0, 0],
                         [9, 9, 9]]])
    cent = torch.tensor([[[0.0, 0, 0], [9, 9, 9]]])
    # centre 0 hits points 0, 2, 3: its 2nd hit is point 2 (3 scanned);
    # centre 1 hits point 4 only: all 5 scanned
    assert chip_smoke.ballq_scanned(torch, cent, pts, 0.5, 2) == 3 + 5


def test_smoke_imports_nothing_of_the_jax_system():
    """chip_smoke.py imports neither the JAX package, jax, nor the JAX
    benchmark script `bench`."""
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append(node.module or "")
    roots = {n.split(".")[0] for n in names}
    assert not roots & {"bench", "fcaf3d_tpu", "jax", "jaxlib", "flax"}, roots
    assert "fcaf3d_tpu_torch" in roots


def test_build_hashes_every_source_and_header(tmp_path):
    """The library's name hashes exactly csrc/*.cu + csrc/*.cuh, the shared
    headers included: editing a header names another library."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_native.CSRC_DIR, csrc)
    files = sorted(os.listdir(csrc))
    want = sorted(f for f in files if f.endswith((".cu", ".cuh")))
    assert _native.hashed_files(str(csrc)) == want
    assert _native.sources(str(csrc)) == [f for f in want if f.endswith(".cu")]
    headers = [f for f in want if f.endswith(".cuh")]
    assert headers, "the tensor-core kernels share a header"
    before = _native.library_path(str(csrc), str(tmp_path))
    assert before == _native.library_path(str(csrc), str(tmp_path))
    with open(csrc / headers[0], "a") as f:
        f.write("\n// edited\n")
    assert _native.library_path(str(csrc), str(tmp_path)) != before
    (csrc / "notes.txt").write_text("not a source")
    assert "notes.txt" not in _native.hashed_files(str(csrc))


def test_variant_counts_reset_with_the_launches():
    _native.count_launch("gather_gemm", "tc", torch.bfloat16)
    _native.count_launch("gather_gemm", "tc", torch.bfloat16)
    assert _native.VARIANT_LAUNCHES[("gather_gemm", "tc", "bfloat16")] == 2
    assert _native.LAUNCHES["gather_gemm"] >= 2
    _native.reset_launches()
    assert _native.VARIANT_LAUNCHES == {}
    assert _native.LAUNCHES["gather_gemm"] == 0


def _simt_source():
    with open(os.path.join(REPO, "fcaf3d_tpu_torch", "csrc",
                           "gather_gemm_simt.cu")) as f:
        return f.read()


def _constant(src, name):
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


@pytest.mark.parametrize("b,m", [(1, 43520), (1, 1024), (8, 30720), (1, 5)])
@pytest.mark.parametrize("c,e,k", list(chip_smoke.K2_SHAPES) + list(
    DFEATS_SHAPES))
def test_k2_simt_grids_cover_every_output_once(b, m, c, e, k):
    """The f32 K2 grids, replayed with the kernel's own constants and index
    rules (read from `csrc/gather_gemm_simt.cu`), produce every (sample,
    row, channel) exactly once in each offset chunk they run: a narrow
    thread one row by its block's NE channels, a tiled thread kTM rows by
    kTN channels of its block's BM x kBN tile; the split runs each of the
    plain version's chunks once, and the chunks partition the offsets."""
    src = _simt_source()
    variant = tg.k2_variant(c, e, k, torch.float32)
    tm, tn, split = tg.k2_tiles(variant, b, m, e, k)
    assert tg.k2_tiles(variant, b, m, e, k) == (tm, tn, split)
    cover = np.zeros((b, m, e), np.int64)
    if variant == "simt_narrow":
        assert c < tg.NARROW_MAX_C and split == 1
        assert tm == _constant(src, "kNarrowThreads") == tg.NARROW_ROWS
        assert f"if (tile_n == {tn}) return launch_narrow_c<T, {tn}>(a);" in src
        # W's [K, C, NE] slice fits a block's shared memory
        assert k * c * tn * 4 <= 227 * 1024
        for bx in range(-(-m // tm)):
            rows = bx * tm + np.arange(tm)
            rows = rows[rows < m]
            for by in range(-(-e // tn)):
                cols = by * tn + np.arange(tn)
                cols = cols[cols < e]
                cover[:, rows[:, None], cols[None, :]] += 1
    else:
        assert variant == "simt_tiled" and c >= tg.NARROW_MAX_C
        tile_m, tile_n = _constant(src, "kTM"), _constant(src, "kTN")
        bn = _constant(src, "kBN")
        assert tn == bn and f"if (tile_m == {tm})" in src \
            and f"launch_tiled<T, {tm}, true>(a)" in src
        if tm == 128:
            assert b * -(-m // 128) * -(-e // bn) >= tg.SMS
        threads = (tm // tile_m) * (bn // tile_n)
        assert threads in (128, 256)
        # the (row, channel) pairs of one block tile that each thread
        # covers: rows ty + i * (BM / kTM), channels tx * kTN + j
        assert "const int m = m0 + ty + i * P::kRowStep;" in src
        assert "static constexpr int kRowStep = BM / kTM;" in src
        tile = np.zeros((tm, bn), np.int64)
        for t in range(threads):
            tx, ty = t % (bn // tile_n), t // (bn // tile_n)
            tile[ty + np.arange(tile_m) * (tm // tile_m),
                 tx * tile_n:(tx + 1) * tile_n] += 1
        for _ in range(split):  # blockIdx.z = sample x chunk
            for by in range(-(-m // tm)):
                for bx in range(-(-e // bn)):  # masked at M and E
                    r0, c0 = by * tm, bx * bn
                    rows, cols = min(tm, m - r0), min(bn, e - c0)
                    cover[:, r0:r0 + rows, c0:c0 + cols] += \
                        tile[:rows, :cols]
        if split > 1:
            assert b * -(-m // 64) * -(-e // 64) < tg.SMS and k >= split
            bounds = tg.chunk_bounds(k)
            assert bounds[0][0] == 0 and bounds[-1][1] == k
            assert all(lo < hi for lo, hi in bounds)
            assert all(a[1] == b_[0] for a, b_ in zip(bounds, bounds[1:]))
    assert (cover == split).all()


def test_k2_simt_split_at_the_stride64_convs():
    """f32 s64 C512 E512 at batch 1 splits its offsets in 64 x 64 tiles;
    the s8 conv and the batch-8 s64 conv fill the SMs without."""
    assert tg.k2_tiles("simt_tiled", 1, 1024, 512, 27) == (64, 64, 3)
    assert tg.k2_tiles("simt_tiled", 1, 30720, 64, 27) == (128, 64, 1)
    assert tg.k2_tiles("simt_tiled", 8, 1024, 512, 27) == (128, 64, 1)
    assert tg.k2_tiles("simt_tiled", 1, 1024, 512, 1) == (64, 64, 1)
    assert tg.k2_tiles("simt_narrow", 1, 20000, 8, 27) == (128, 8, 1)
    assert tg.k2_tiles("simt_narrow", 1, 43520, 64, 27) == (128, 16, 1)


class _FakeSimtLibrary:
    """Records the arguments of each C call instead of launching."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if not name.startswith("fcaf3d_"):
            raise AttributeError(name)
        return lambda *args: self.calls.append((name, args)) or 0


@pytest.mark.parametrize("c,e,k,b,m", [(1, 8, 27, 1, 300), (3, 64, 27, 2, 40),
                                       (512, 512, 27, 1, 1024),
                                       (64, 64, 27, 1, 30720),
                                       (256, 512, 1, 1, 70)])
def test_k2_simt_kernels_receive_the_plain_chunks(monkeypatch, c, e, k, b, m):
    """What the f32 wrapper hands `fcaf3d_gather_gemm_simt`: the chunk
    boundaries are `chunk_bounds(K)`'s (the plain version's summation
    chunks, where `gather_gemm.cu` closes them), the variant and tile are
    `k2_variant` / `k2_tiles`, the split gets its [3, B, M, E] f32
    partials; each launch is counted by variant. `_variant="simt"` reaches
    the first SIMT kernel with the same boundaries."""
    from tests.test_torch_kernels import _cuda_looking

    lib = _FakeSimtLibrary()
    monkeypatch.setattr(_native, "load", lambda: lib)
    monkeypatch.setattr(_native, "stream_ptr", lambda dev: 0)
    _native.reset_launches()
    n = 2 * m
    feats = _cuda_looking(torch.zeros(b, n, c))
    idx = _cuda_looking(torch.full((b, m, k), n, dtype=torch.int32))
    w = _cuda_looking(torch.zeros(k, c, e))
    with torch.no_grad():
        tg.fused_gather_gemm(feats, idx, w)
        tg.fused_gather_gemm(feats, idx, w, _variant="simt")
    (name, args), (old_name, old_args) = lib.calls
    (_, k1), (_, k2), (_, last) = tg.chunk_bounds(k)
    assert last == k
    variant = tg.k2_variant(c, e, k, torch.float32)
    tile_m, tile_n, split = tg.k2_tiles(variant, b, m, e, k)
    assert name == "fcaf3d_gather_gemm_simt"
    assert args[9:17] == (b, n, m, k, c, e, k1, k2)
    assert args[17:23] == (0, 0, {"simt_narrow": 1, "simt_tiled": 2}[variant],
                           tile_m, tile_n, split)
    assert (args[8] is None) == (split == 1)
    assert old_name == "fcaf3d_gather_gemm" and old_args[14:16] == (k1, k2)
    assert _native.VARIANT_LAUNCHES == {
        ("gather_gemm", variant, "float32"): 1,
        ("gather_gemm", "simt", "float32"): 1}
    _native.reset_launches()
