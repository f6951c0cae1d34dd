"""K1 on the CPU: a numpy replay of the gallop kernel (each thread walks
one segment over a run of rows, every search after its first starting
from the previous answer) against the port's plain version
and the JAX package's Pallas kernel in interpret mode, on the edge cases
`chip_smoke.py` runs on the card; the launch plan against `csrc/search.cu`;
and the wrapper's launches and refusals.

The CUDA kernel itself runs only on a GPU: `chip_smoke.py` holds it
against its plain version there.
"""
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fcaf3d_tpu.ops.sparse.search import searchsorted_segments as j_search
from fcaf3d_tpu_torch import _native
from fcaf3d_tpu_torch.ops.sparse import search as ts
from tests.test_torch_kernels import _cuda_looking, _Recorder
from tests.test_torch_ops import jax_without_persistent_cache  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SENT = 0xFFFFFFFF
L = 16  # the edge clouds' run length: N < L, N = 1 mod L, runs across L


def _lower_bound(kb, lo, hi, q):
    while lo < hi:
        mid = (lo + hi) >> 1
        if kb[mid] < q:
            lo = mid + 1
        else:
            hi = mid
    return lo


def _result(kb, pos, q, with_miss):
    n = len(kb)
    if not with_miss:
        return pos
    return pos if pos < n and kb[pos] == q and q != SENT else n


def gallop_search(keys, queries, per_run, with_miss):
    """The gallop kernel's loops in Python, for keys [B, N] and queries
    [B, M, S]: lane (b, run, s) walks rows [run * per_run, ...) of segment
    s; its first search spans all N keys, each later one brackets the
    answer by doubling steps from the previous answer (forward for a query
    >= the previous, else backward), then binary-searches the bracket."""
    b_, m_rows, n_segs = queries.shape
    out = np.empty(queries.shape, np.int64)
    for b in range(b_):
        kb = [int(v) for v in keys[b]]
        n = len(kb)
        for s in range(n_segs):
            for m0 in range(0, m_rows, per_run):
                pos, prev = -1, 0
                for m in range(m0, min(m0 + per_run, m_rows)):
                    q = int(queries[b, m, s])
                    if pos < 0:
                        lo, hi = 0, n
                    elif q >= prev:
                        lo = hi = pos
                        step = 1
                        while hi < n and kb[hi] < q:
                            lo = hi + 1
                            hi = lo + step
                            step <<= 1
                        hi = min(hi, n)
                    else:
                        lo = hi = pos
                        step = 1
                        while lo > 0 and kb[lo - 1] >= q:
                            hi = lo - 1
                            lo = max(hi - step, 0)
                            step <<= 1
                    pos = _lower_bound(kb, lo, hi, q)
                    prev = q
                    out[b, m, s] = _result(kb, pos, q, with_miss)
    return out


def _queries(keys, rng, m):
    """[B, m, 3] queries: keys themselves (hits, at run starts and inside
    runs), their neighbours, values below the first and above the last
    key, and SENTINEL; in random order."""
    b, n = keys.shape
    q = rng.integers(0, 2 ** 32 - 1, (b, m, 3)).astype(np.int64)
    pick = rng.integers(0, n, (b, m))
    q[:, :, 0] = np.take_along_axis(keys, pick, 1)
    q[:, :, 1] = q[:, :, 0] + rng.integers(-1, 2, (b, m))
    q[:, :3, 2] = [0, SENT - 1, SENT]
    q[:, -5:, :] = SENT
    return np.clip(q, 0, SENT)


def _case(name, line, rng):
    """Keys [2, N] ascending (int64 carrying uint32) for one edge case."""
    if name == "random, SENTINEL tail":
        keys = np.sort(rng.integers(1, 2 ** 31, (2, 300)), axis=1)
        keys[:, -40:] = SENT
    elif name == "N = 1":
        keys = np.array([[5], [SENT]])
    elif name == "N < L":
        keys = np.sort(rng.integers(1, 50, (2, line // 2 + 1)), axis=1)
    elif name == "N = 1 mod L":
        keys = np.sort(rng.integers(1, 2 ** 20, (2, 3 * line + 1)), axis=1)
    elif name == "runs across every L-th key":
        # runs of L equal keys, each starting mid-line; then runs of 3L
        n = 8 * line + 3
        keys = np.stack([(np.arange(n) + line // 2) // line + 1,
                         (np.arange(n) + 5) // (3 * line) * 7 + 2])
    elif name == "compaction cumsum":
        mask = rng.random((2, 10 * line + 7)) < 0.3
        mask[:, 4 * line:6 * line] = False  # a long flat run
        mask[:, -3 * line:] = False  # the flat tail
        keys = np.cumsum(mask, axis=1)
    else:
        raise ValueError(name)
    return keys.astype(np.int64)


CASES = ["random, SENTINEL tail", "N = 1", "N < L", "N = 1 mod L",
         "runs across every L-th key", "compaction cumsum"]


def _plain(keys, q, with_miss):
    return ts.searchsorted_segments_plain(torch.as_tensor(keys),
                                          torch.as_tensor(q), with_miss)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("order", ["random", "sorted"])
def test_gallop_replay_matches_plain(case, order):
    """The gallop replay equals `searchsorted_segments_plain` exactly,
    positions and hit-verified, on random-order queries (backward gallops)
    and on ascending segments (the kernel maps' order), at 1, 3 and 64
    rows a thread."""
    rng = np.random.default_rng(len(case))
    keys = _case(case, L, rng)
    q = _queries(keys, rng, 48)
    if order == "sorted":
        q = np.sort(q, axis=1)
    for with_miss in (False, True):
        want = _plain(keys, q, with_miss).numpy()
        for per_run in (1, 3, 64):
            got = gallop_search(keys, q, per_run, with_miss)
            np.testing.assert_array_equal(got, want,
                                          err_msg=f"{case} {per_run}")


@pytest.mark.parametrize("case", CASES)
def test_gallop_replay_matches_pallas(case):
    """The gallop replay at the path's plan for this shape equals the
    Pallas kernel in interpret mode, hit-verified and positions, on sorted
    segments (the TPU kernel's order), "ms" layout."""
    rng = np.random.default_rng(1)
    keys = _case(case, L, rng)
    q = np.sort(_queries(keys, rng, 96), axis=1)
    per_run = max(ts.k1_gallop_plan(*q.shape), 5)
    for with_miss in (False, True):
        want = j_search(jnp.asarray(keys.astype(np.uint32)),
                        jnp.asarray(q.astype(np.uint32)), interpret=True,
                        with_miss=with_miss, layout="ms")
        got = gallop_search(keys, q, per_run, with_miss)
        np.testing.assert_array_equal(got, np.asarray(want), err_msg=case)


@pytest.mark.parametrize("per_run", [1, 7, 64])
def test_all_sentinel_queries_miss(per_run):
    keys = _case("random, SENTINEL tail", L, np.random.default_rng(0))
    q = np.full((2, 20, 1), SENT, np.int64)
    assert (gallop_search(keys, q, per_run, True) == keys.shape[1]).all()
    np.testing.assert_array_equal(gallop_search(keys, q, per_run, False),
                                  _plain(keys, q, False).numpy())


def _search_source():
    with open(os.path.join(REPO, "fcaf3d_tpu_torch", "csrc",
                           "search.cu")) as f:
        return f.read()


def _constant(src, name):
    """The value of `constexpr int name = <integer expression>;`."""
    expr = re.search(rf"constexpr int {name} = ([\d */+-]+);", src).group(1)
    return eval(expr.replace("/", "//"), {"__builtins__": {}})


def test_k1_plans_match_the_kernel_source():
    """The wrapper's constants and bindings are the kernels': K1_THREADS is
    kThreads, the gallop entry launches its kernel with kThreads threads a
    CTA, the entry's key limit is the one `test_gallop_plan_covers_every_
    query_once` holds the path to, and `_native` binds exactly the K1 entry
    the source defines. A mismatch would show on the card only as a refused
    launch or a wrong result."""
    src = _search_source()
    assert _constant(src, "kThreads") == ts.K1_THREADS
    gallop = src[src.index('extern "C" int fcaf3d_searchsorted_gallop('):]
    assert re.search(r"searchsorted_gallop_kernel<<<[^,]+,\s*kThreads,",
                     gallop)
    assert "n_keys > kMax / 2" in gallop  # below 2^30 keys a sample
    entries = re.findall(r'extern "C" int (fcaf3d_searchsorted\w*)\(', src)
    assert entries == ["fcaf3d_searchsorted_gallop"]
    bound = re.findall(r"lib\.(fcaf3d_searchsorted\w*)\.argtypes",
                       open(_native.__file__).read())
    assert sorted(bound) == sorted(entries)


# (B, M, S) and N of the path's K1 calls (kernel maps at each stride, the
# compactions, the lateral lookups; batch 1 and 8) and of the edges
PATH_CALLS = [(1, 43520, 27, 45056), (1, 30720, 27, 39936),
              (1, 30720, 27, 30720), (1, 45056, 1, 100000),
              (1, 43520, 1, 45056), (1, 3584, 27, 13312),
              (1, 1024, 27, 1024), (8, 43520, 27, 45056),
              (8, 45056, 1, 100000), (8, 39936, 1, 43520 * 8), (1, 1, 1, 1),
              (2, 7, 3, 5)]


@pytest.mark.parametrize("b,m,s,n", PATH_CALLS)
def test_gallop_plan_covers_every_query_once(b, m, s, n):
    """The gallop plan is a function of (B, M, S): one row a thread while
    every query can have a resident thread, else the fewest rows a thread
    that keep the lanes within the card's resident threads; the runs cover
    each row of each segment exactly once, within the entry's 2^31 lanes."""
    per_run = ts.k1_gallop_plan(b, m, s)
    assert per_run == ts.k1_gallop_plan(b, m, s) >= 1
    runs = -(-m // per_run)
    lanes = b * runs * s
    assert lanes <= max(ts.K1_RESIDENT, b * s) and lanes < 2 ** 31
    if b * m * s <= ts.K1_RESIDENT:
        assert per_run == 1
    else:
        assert b * -(-m // (per_run - 1)) * s > ts.K1_RESIDENT
    covered = np.zeros(m, np.int64)
    for run in range(runs):
        covered[run * per_run:min((run + 1) * per_run, m)] += 1
    assert (covered == 1).all()
    assert n < 2 ** 30


@pytest.mark.parametrize("b,n,m,s", [(1, 300, 40, 27), (2, 1000, 45, 1),
                                     (1, 1, 1, 1)])
def test_k1_wrapper_launches_the_plan(monkeypatch, b, n, m, s):
    """On a CUDA tensor the wrapper hands `fcaf3d_searchsorted_gallop` the
    shapes [B, M, S] and the gallop plan (or `_plan=`) and counts each launch
    as "gallop"; it takes no keyword that picks another kernel."""
    lib = _Recorder()
    monkeypatch.setattr(_native, "load", lambda: lib)
    monkeypatch.setattr(_native, "stream_ptr", lambda dev: 0)
    _native.reset_launches()
    keys = _cuda_looking(torch.arange(n, dtype=torch.int64)[None]
                         .expand(b, n).contiguous())
    qs = _cuda_looking(torch.zeros(b, m, s, dtype=torch.int64))
    ts.searchsorted_segments(keys, qs, with_miss=True, layout="ms")
    ts.searchsorted_segments(keys, qs, layout="ms", _plan=7)
    names = [c[0] for c in lib.calls]
    assert names == ["fcaf3d_searchsorted_gallop"] * 2
    assert lib.calls[0][1][3:] == (b, n, m, s, ts.k1_gallop_plan(b, m, s),
                                   1, 0)
    assert lib.calls[1][1][3:] == (b, n, m, s, 7, 0, 0)
    assert _native.VARIANT_LAUNCHES == {("searchsorted", "gallop", "int64"): 2}
    with pytest.raises(TypeError, match="_variant"):
        ts.searchsorted_segments(keys, qs, layout="ms", _variant="binary")
    assert len(lib.calls) == 2
    _native.reset_launches()


@pytest.mark.parametrize("what", ["int32 keys", "batch mismatch",
                                  "strided queries", "keys on the CPU"])
def test_k1_wrapper_refuses_what_its_kernels_cannot_take(monkeypatch, what):
    """On a CUDA tensor the wrapper raises before any launch on inputs the
    kernels do not take, rather than running something else."""
    lib = _Recorder()
    monkeypatch.setattr(_native, "load", lambda: lib)
    monkeypatch.setattr(_native, "stream_ptr", lambda dev: 0)
    keys = torch.arange(8, dtype=torch.int64)[None].expand(2, 8).contiguous()
    qs = torch.zeros(2, 5, 3, dtype=torch.int64)
    if what == "int32 keys":
        keys = keys.int()
    elif what == "batch mismatch":
        qs = qs[:1]
    elif what == "strided queries":
        qs = qs.transpose(1, 2)
    qs = _cuda_looking(qs)
    if what == "keys on the CPU":  # the public entry would run plain here
        with pytest.raises(ValueError, match="one CUDA device"):
            ts._searchsorted_cuda(keys, qs, False)
    else:
        keys = _cuda_looking(keys)
        with pytest.raises((TypeError, ValueError), match="K1"):
            ts.searchsorted_segments(keys, qs, layout="ms")
    assert lib.calls == []
