"""Kernel K7 (`csrc/masked_norm.cu`): the masked norm with the residual add
and the activation after it, forward and backward.

On the CPU: a CPU tensor takes the plain path (the ops the JAX package's
tests hold elsewhere), a CUDA tensor the kernels or a refusal; what the
wrapper hands the kernels (a recording fake library); `norm_plan`'s grid;
and a replay of the kernels' arithmetic (their rounding points and their
closed-form backward) held to autograd through the plain path.

On the card (`card`: skips without one) the Function is held to the plain
path on the same CUDA tensors, at every training shape of
`fcaf3d_scannet`, at fills from none to full, with and without a residual,
for each activation; and two runs of a call are bitwise equal:

    python3 -m pytest tests/test_torch_masked_norm.py -q -m card --noconftest

(`--noconftest`: the suite's conftest imports JAX, which the card's machine
does not have; this file imports none of it.)
"""
import os
import re

import numpy as np
import pytest
import torch

from fcaf3d_tpu_torch import _native
from fcaf3d_tpu_torch.models import blocks as tb
from fcaf3d_tpu_torch.ops.sparse import masked_norm as mn
from fcaf3d_tpu_torch.ops.sparse.tensor import SENTINEL, SparseTensor
from fcaf3d_tpu_torch.utils import tracing

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (mode, act, residual) of every norm call of the FCAF3D models
CALLS = [("instance", "relu", False), ("batch", "relu", False),
         ("batch", "relu", True), ("batch", None, False),
         ("batch", "elu", False), ("running", "elu", False)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def prefix_keys(b, n, fills, rng, gaps=False):
    """int64 keys [B, N]: sample i holds round(fills[i] * N) valid rows
    (ascending keys, a prefix of its budget; with `gaps`, scattered over
    the budget instead), SENTINEL on the others."""
    keys = np.full((b, n), SENTINEL, np.int64)
    for i, f in enumerate(fills):
        k = int(round(f * n))
        rows = (np.sort(rng.choice(n, k, replace=False)) if gaps
                else np.arange(k))
        keys[i, rows] = np.sort(rng.choice(2 ** 31, k, replace=False))
    return torch.as_tensor(keys)


def inputs(b, n, c, fills, dtype, seed=0, residual=False, device="cpu",
           gaps=False):
    """feats, keys, scale, bias, (running mean, var), residual (or None),
    dy: padding rows of feats and of the residual are 0, as the model's
    are; dy is 0 on padding rows, as the consumers' gradients are."""
    rng = np.random.default_rng(seed)
    keys = prefix_keys(b, n, fills, rng, gaps)
    valid = (keys != SENTINEL)[..., None]

    def rows(scale, shift=0.0):
        x = torch.as_tensor(rng.normal(shift, scale, (b, n, c)),
                            dtype=torch.float32)
        return torch.where(valid, x, 0.0).to(dtype)

    feats = rows(1.5, 0.3)
    res = rows(1.0) if residual else None
    dy = rows(0.7)
    scale = torch.as_tensor(rng.uniform(0.5, 1.5, c), dtype=torch.float32)
    bias = torch.as_tensor(rng.normal(0, 0.3, c), dtype=torch.float32)
    running = (torch.as_tensor(rng.normal(0, 0.2, c), dtype=torch.float32),
               torch.as_tensor(rng.uniform(0.5, 2.0, c), dtype=torch.float32))
    out = [feats, keys, scale, bias, running, res, dy]
    return [tuple(t.to(device) for t in x) if isinstance(x, tuple)
            else None if x is None else x.to(device) for x in out]


def run(fn, feats, keys, scale, bias, running, res, dy, mode, act):
    """fn's output, moved running statistics and the gradients of feats,
    scale, bias and the residual under the upstream gradient dy."""
    feats = feats.clone().requires_grad_()
    scale = scale.clone().requires_grad_()
    bias = bias.clone().requires_grad_()
    res = None if res is None else res.clone().requires_grad_()
    running = None if mode == "instance" else tuple(t.clone()
                                                    for t in running)
    out = fn(feats, keys, scale, bias, mode, act, res, running)
    out.backward(dy)
    return {"out": out.detach(), "running": running, "dx": feats.grad,
            "dscale": scale.grad, "dbias": bias.grad,
            "dres": None if res is None else res.grad}


# ---- a replay of the kernels' arithmetic --------------------------------


def replay(feats, keys, scale, bias, mode, act, residual, running,
           eps=1e-5, momentum=0.1):
    """K7 as its kernels compute it, in the features' precision (f32 for
    bf16): the forward's rounding points, and the closed-form backward
    dx = inv (g - sum g / n - (x - mean) sum g (x - mean) / (n (var +
    eps))), dscale = sum g (x - mean) / sqrt(var + eps), dbias = sum g,
    dres = g. Returns run()'s record for the upstream gradient set by
    `replay.dy`."""
    acc = torch.promote_types(feats.dtype, torch.float32)

    def rnd(x):
        return x.to(feats.dtype).to(acc)

    valid = (keys != SENTINEL)[..., None]
    x = feats.to(acc)
    m = valid.to(acc)
    dims = (1,) if mode == "instance" else (0, 1)
    if mode == "running":
        mean, var = running
        n = None
    else:
        n = torch.clamp_min(m.sum(dim=dims, keepdim=True), 1.0)
        mean = (x * m).sum(dim=dims, keepdim=True) / n
        var = (((x - mean) ** 2) * m).sum(dim=dims, keepdim=True) / n
        if running is not None:
            running = tuple((1 - momentum) * r + momentum * s.reshape(-1)
                            for r, s in zip(running, (mean, var)))
    std = torch.sqrt(var + eps)
    inv = scale / std
    r = rnd((x - mean) / std * scale + bias if mode == "instance"
            else (x - mean) * inv + bias)
    if residual is not None:
        r = rnd(r + residual.to(acc))
    if act == "relu":
        y = torch.where(r > 0, r, 0.0)
    elif act == "elu":
        y = torch.where(r > 0, r, rnd(torch.expm1(r)))
    else:
        y = r
    y = torch.where(valid, y, 0.0)
    dy = replay.dy.to(acc)
    if act == "relu":
        g = torch.where(r > 0, dy, torch.where(r == 0, rnd(dy * 0.5), 0.0))
    elif act == "elu":
        g = torch.where(r > 0, dy, rnd(dy * rnd(rnd(torch.expm1(r)) + 1)))
    else:
        g = dy
    g = torch.where(valid, g, 0.0)
    xc = x - mean
    g1 = g.sum(dim=dims, keepdim=True)
    g2 = (g * xc).sum(dim=dims, keepdim=True)
    if n is None:
        dx = inv * g
    else:
        dx = inv * (g - g1 / n - xc * g2 / (n * (var + eps)))
    dx = torch.where(valid, dx, 0.0)
    return {"out": y.to(feats.dtype), "running": running,
            "dx": dx.to(feats.dtype),
            "dscale": (g2 / std).reshape(-1, feats.shape[2]).sum(0),
            "dbias": g1.reshape(-1, feats.shape[2]).sum(0),
            "dres": None if residual is None else g.to(feats.dtype)}


def rel(got, want):
    """Largest |got - want| over the largest |want|."""
    return float((got.double() - want.double()).abs().max()
                 / max(float(want.double().abs().max()), 1e-30))


@pytest.mark.parametrize("mode,act,residual", CALLS + [
    ("batch", "elu", True), ("instance", None, False),
    ("running", "relu", True), ("running", None, False)])
def test_replay_matches_autograd_in_float64(mode, act, residual):
    """In float64 the replay's forward and closed-form backward equal
    autograd through the plain path to rounding (1e-10 of the largest
    value): the backward formula is the plain path's gradient, samples
    without a valid row and ReLU's tie at 0 included (rows whose features
    equal the batch mean, with a zero bias and residual, land on 0)."""
    b, n, c = 3, 40, 6
    feats, keys, scale, bias, running, res, dy = inputs(
        b, n, c, (0.5, 0.0, 0.3), torch.float64, seed=3, residual=residual)
    scale, bias = scale.double(), bias.double()
    running = tuple(t.double() for t in running)
    if act == "relu" and mode != "running":
        # the second half of each sample's valid rows mirrors the first, so
        # every mean is exactly 0 and the zero entries tie under the ReLU
        rng = np.random.default_rng(4)
        vals = np.zeros((b, n, c))
        for i in range(b):
            k = int((keys[i] != SENTINEL).sum())
            half = rng.choice([-2.0, -1.0, 0.0, 1.0, 2.0], (k // 2, c))
            vals[i, :k // 2], vals[i, k // 2:k] = half, -half
        feats = torch.as_tensor(vals)
        bias = torch.zeros_like(bias)
        if res is not None:
            res = torch.where(feats == 0, 0.0, res)
        assert ((feats == 0) & (keys != SENTINEL)[..., None]).any()
    replay.dy = dy
    want = run(mn.masked_norm_plain, feats, keys, scale, bias, running, res,
               dy, mode, act)
    got = replay(feats, keys, scale, bias, mode, act, res,
                 None if mode == "instance" else running)
    for k in ("out", "dx", "dscale", "dbias", "dres"):
        if want[k] is not None:
            assert rel(got[k], want[k]) < 1e-10, k
    if mode == "batch":
        for g, w in zip(got["running"], want["running"]):
            assert rel(g, w) < 1e-12


@pytest.mark.parametrize("mode,act,residual", CALLS)
def test_replay_rounds_where_the_plain_path_does(mode, act, residual):
    """In bf16 the replay's output, residual gradient and running
    statistics equal the plain path's bitwise (from the same sums), its dx
    is within a bf16 step of the largest value and its scale and bias
    gradients within 1e-5: the kernels round where autograd does, and
    InstanceNorm divides by the deviation as the plain path does."""
    feats, keys, scale, bias, running, res, dy = inputs(
        4, 64, 16, (0.19, 0.07, 0.0, 1.0), torch.bfloat16, seed=5,
        residual=residual)
    replay.dy = dy
    want = run(mn.masked_norm_plain, feats, keys, scale, bias, running, res,
               dy, mode, act)
    got = replay(feats, keys, scale, bias, mode, act, res,
                 None if mode == "instance" else running)
    assert torch.equal(got["out"], want["out"])
    if mode == "batch":
        assert all(torch.equal(g, w) for g, w in zip(got["running"],
                                                     want["running"]))
    if res is not None:
        assert torch.equal(got["dres"], want["dres"])
    assert rel(got["dx"], want["dx"]) <= 2 ** -7
    assert rel(got["dscale"], want["dscale"]) < 1e-5
    assert rel(got["dbias"], want["dbias"]) < 1e-5


# ---- the CPU / CUDA boundary ---------------------------------------------


class _CudaLooking(torch.Tensor):
    """A CPU tensor that reports a CUDA device, to reach the kernel path of
    a wrapper on a machine without a GPU."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def _cuda_looking(t):
    return None if t is None else torch.Tensor._make_subclass(_CudaLooking, t)


class _Recorder:
    """A kernel library that records the arguments of each C call."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if not name.startswith("fcaf3d_"):
            raise AttributeError(name)
        return lambda *args: self.calls.append((name, args)) or 0


@pytest.mark.parametrize("mode,act,residual", CALLS)
def test_cpu_tensors_take_the_plain_path(monkeypatch, mode, act, residual):
    """On CPU tensors `masked_norm` is `masked_norm_plain` and never
    reaches the kernel library; the modules' fused calls give what the
    separate norm, add and activation gave."""
    def no_library():
        raise AssertionError("the kernel library was reached")

    monkeypatch.setattr(_native, "load", no_library)
    feats, keys, scale, bias, running, res, dy = inputs(
        2, 30, 8, (0.6, 0.2), torch.bfloat16, seed=1, residual=residual)
    plain = run(mn.masked_norm_plain, feats, keys, scale, bias, running, res,
                dy, mode, act)
    got = run(mn.masked_norm, feats, keys, scale, bias, running, res, dy,
              mode, act)
    for k, v in plain.items():
        if isinstance(v, tuple):
            assert all(torch.equal(a, b) for a, b in zip(got[k], v))
        elif v is not None:
            assert torch.equal(got[k], v), k

    norm = (tb.SparseInstanceNorm(8) if mode == "instance"
            else tb.SparseBatchNorm(8))
    norm.train(mode != "running")
    with torch.no_grad():
        norm.scale.copy_(scale)
        norm.bias.copy_(bias)
    st = SparseTensor(coords=torch.zeros(2, 30, 3, dtype=torch.int32),
                      feats=feats, keys=keys,
                      shift=torch.zeros(2, 3, dtype=torch.int32))
    rst = None if res is None else st.with_feats(res)
    fused = (norm(st, act=act) if mode == "instance"
             else norm(st, act=act, residual=rst)).feats
    if mode != "instance":  # as the fused call found them
        norm.mean.zero_()
        norm.var.fill_(1.0)
    sep = norm(st)
    if rst is not None:
        sep = sep.with_feats(sep.feats + rst.feats)
    if act == "relu":
        sep = sep.with_feats(mn.relu_half_tie(sep.feats))
    elif act == "elu":
        sep = sep.with_feats(mn.elu_masked(sep.feats, sep.valid))
    assert torch.equal(fused, sep.feats)


def test_cuda_tensors_take_the_kernels_or_raise(monkeypatch):
    """On a CUDA tensor the wrapper launches K7 or raises: with no kernel
    library it does not fall back to the plain version, and a dtype,
    layout or width the kernels do not take is refused before any launch."""
    def no_library():
        raise RuntimeError("kernel library not built")

    monkeypatch.setattr(_native, "load", no_library)
    feats, keys, scale, bias, running, _, _ = inputs(
        2, 16, 8, (0.5, 0.5), torch.bfloat16)
    f, k, s, b = (_cuda_looking(t) for t in (feats, keys, scale, bias))
    run_ = tuple(_cuda_looking(t) for t in running)
    before = dict(_native.LAUNCHES)
    with pytest.raises(RuntimeError, match="not built"):
        mn.masked_norm(f, k, s, b, "batch", "relu", running=run_)
    for dtype in (torch.float16, torch.float64):
        with pytest.raises(TypeError, match="float32 or bfloat16"):
            mn.masked_norm(_cuda_looking(feats.to(dtype)), k, s, b, "batch",
                           running=run_)
    with pytest.raises(ValueError, match="int64 keys"):
        mn.masked_norm(f, _cuda_looking(keys.int()), s, b, "batch",
                       running=run_)
    with pytest.raises(ValueError, match="float32 scale"):
        mn.masked_norm(f, k, _cuda_looking(scale.double()), b, "batch",
                       running=run_)
    with pytest.raises(ValueError, match="residual"):
        mn.masked_norm(f, k, s, b, "batch", residual=f.float(),
                       running=run_)
    with pytest.raises(ValueError, match="'running' takes"):
        mn.masked_norm(f, k, s, b, "running")
    with pytest.raises(ValueError, match="act"):
        mn.masked_norm(f, k, s, b, "batch", act="gelu", running=run_)
    with pytest.raises(ValueError, match="threads a row"):
        mn.norm_plan(1, 64, 8 * 513, torch.bfloat16)
    assert _native.LAUNCHES == before


@pytest.mark.parametrize("mode,act,residual", CALLS)
def test_wrapper_hands_the_kernels_their_plan(monkeypatch, mode, act,
                                              residual):
    """On a CUDA tensor the forward launches stats, dev and apply ("running":
    apply alone) and the backward bwd_reduce and bwd_apply, each with
    `norm_plan`'s grid, the dtype code, the statistics' source, the
    activation code, eps and the momentum; each launch is counted by kernel
    and dtype; under tracing the call adds `norm_rows` and
    `norm_budget_rows` to the open span; and `_native` binds the five
    entries of `csrc/masked_norm.cu`."""
    lib = _Recorder()
    monkeypatch.setattr(_native, "load", lambda: lib)
    monkeypatch.setattr(_native, "stream_ptr", lambda dev: 0)
    monkeypatch.setattr(mn, "_TICKETS", {})
    _native.reset_launches()
    b, n, c = 2, 48, 64
    feats, keys, scale, bias, running, res, dy = inputs(
        b, n, c, (0.25, 0.5), torch.bfloat16, residual=residual)
    f = _cuda_looking(feats).requires_grad_()
    s = _cuda_looking(scale).requires_grad_()
    bb = _cuda_looking(bias).requires_grad_()
    r = None if res is None else _cuda_looking(res).requires_grad_()
    run_ = (None if mode == "instance"
            else tuple(_cuda_looking(t) for t in running))
    tracing.enable()
    try:
        with tracing.span("backbone"):
            out = mn.masked_norm(f, _cuda_looking(keys), s, bb, mode, act, r,
                                 run_)
    finally:
        tracing.disable()
    spans = tracing.drain()
    out.backward(dy)
    groups, rows = (b, n) if mode == "instance" else (1, b * n)
    plan = mn.norm_plan(groups, rows, c, torch.bfloat16)
    geo = (groups, rows, c, plan.rows_per_cta, plan.blocks)
    tail = (1, plan.vec, plan.threads, 0)
    names = [name.replace("fcaf3d_masked_norm_", "") for name, _ in lib.calls]
    fwd = ["apply"] if mode == "running" else ["stats", "dev", "apply"]
    assert names == fwd + ["bwd_reduce", "bwd_apply"]
    act_code = mn._ACTS[act]
    for name, args in lib.calls:
        kernel = name.replace("fcaf3d_masked_norm_", "")
        if kernel == "stats":
            assert args[5:] == geo + tail
        elif kernel == "dev":
            assert args[6:] == geo + tail
        elif kernel == "apply":
            assert (args[2] is None) == (r is None)
            assert args[5] == mn.MODES[mode]
            update = mode == "batch"
            assert (args[8] is None) == (not update)
            assert args[10:12] == pytest.approx((0.9, 0.1))
            assert args[13:] == geo + (act_code, 1e-5) + tail
        elif kernel == "bwd_reduce":
            assert args[6] == mn.MODES[mode]
            assert args[14:] == geo + (act_code, 1e-5) + tail
        else:
            assert (args[11] is None) == (r is None)
            assert args[12:] == geo + (act_code, 1e-5) + tail
    assert _native.LAUNCHES["masked_norm"] == len(names)
    assert _native.VARIANT_LAUNCHES == {
        ("masked_norm", k, "bfloat16"): 1 for k in names}
    _native.reset_launches()
    (span,) = spans
    assert span.counters["norm_budget_rows"] == b * n
    assert "norm_rows" in span.counters
    if mode == "running":
        assert span.counters["norm_rows"] == int((keys != SENTINEL).sum())
    src = open(os.path.join(REPO, "fcaf3d_tpu_torch", "csrc",
                            "masked_norm.cu")).read()
    entries = re.findall(r'extern "C" int (fcaf3d_masked_norm_\w+)\(', src)
    assert entries == [f"fcaf3d_masked_norm_{k}" for k in
                       ("stats", "dev", "apply", "bwd_reduce", "bwd_apply")]
    bound = re.findall(r"lib\.(fcaf3d_masked_norm_\w+)\.argtypes",
                       open(_native.__file__).read())
    assert sorted(bound) == sorted(entries)
    assert int(re.search(r"constexpr int kMaxThreads = (\d+);",
                         src).group(1)) == mn.MAX_THREADS


def test_norm_counters_read_through_program_trace(monkeypatch):
    """The counters of two norm calls in `backbone` (here "running" mode,
    whose valid rows the wrapper counts from the keys) come out of
    `cardbench.program_trace.read` summed, beside `budget_rows`."""
    from cardbench import program_trace

    monkeypatch.setattr(_native, "load", lambda: _Recorder())
    monkeypatch.setattr(_native, "stream_ptr", lambda dev: 0)
    feats, keys, scale, bias, running, _, _ = inputs(
        2, 40, 16, (0.25, 0.5), torch.float32)
    args = [_cuda_looking(t) for t in (feats, keys, scale, bias)]
    run_ = tuple(_cuda_looking(t) for t in running)
    tracing.drain()
    tracing.enable()
    try:
        with tracing.item(), tracing.span("backbone"):
            tracing.count("budget_rows", [80])
            for _ in range(2):
                mn.masked_norm(*args, "running", "elu", running=run_)
    finally:
        tracing.disable()
    _native.reset_launches()
    seg = {"n": 1, "events": {"kernels": [], "copies": [], "runtime": [],
                              "lo": 0, "hi": 1},
           "spans": [s._asdict() for s in tracing.drain()]}
    counters = program_trace.read(seg)["spans"]["backbone"]["counters"]
    assert counters["norm_budget_rows"] == 2 * 80
    assert counters["norm_rows"] == 2 * (10 + 20)
    assert counters["budget_rows"] == [80]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_norm_plan_covers_every_row(dtype):
    """At every norm shape of the FCAF3D configs and at odd ones: a thread
    holds 16 bytes of channels where C fills them, else one; a CTA holds
    whole rows side by side, at most MAX_THREADS threads; the CTAs cover a
    group's rows, none empty; each thread takes at least MIN_PASSES rows;
    the reducing kernels' partials fit MAX_PARTIAL unless MIN_PASSES
    forbids fewer CTAs."""
    elt = 2 if dtype == torch.bfloat16 else 4
    shapes = [(16, 43520, 64), (1, 16 * 30720, 64), (1, 16 * 13312, 128),
              (1, 16 * 3584, 256), (1, 16 * 1024, 512), (1, 8 * 6144, 1024),
              (1, 8 * 1024, 2048), (2, 96, 64), (1, 7, 3), (1, 1, 12),
              (5, 333, 40), (1, 100, 6), (1, 24, 2048)]
    for groups, rows, c in shapes:
        p = mn.norm_plan(groups, rows, c, dtype)
        assert p.vec in (1, 16 // elt) and c % p.vec == 0
        assert p.vec == (16 // elt if c * elt % 16 == 0 else 1)
        tpr = c // p.vec
        assert p.threads % tpr == 0 and p.threads <= mn.MAX_THREADS
        rp = p.threads // tpr
        assert p.rows_per_cta % rp == 0
        assert p.rows_per_cta // rp >= mn.MIN_PASSES
        assert p.blocks * p.rows_per_cta >= rows
        assert (p.blocks - 1) * p.rows_per_cta < rows
        assert (groups * p.blocks * c <= mn.MAX_PARTIAL
                or p.rows_per_cta // rp == mn.MIN_PASSES)


def test_tickets_grow_with_the_groups(monkeypatch):
    """One zeroed ticket buffer a device and stream, with a count for each
    group of the widest launch on it so far; another stream gets its own."""
    monkeypatch.setattr(mn, "_TICKETS", {})
    x = torch.zeros(2, 3)
    a = mn._tickets(x, 4, 0)
    assert a.dtype == torch.int32 and a.numel() == 5 and not a.any()
    assert mn._tickets(x, 2, 0) is a
    other = mn._tickets(x, 2, 7)
    assert other is not a and other.data_ptr() != a.data_ptr()
    assert mn._tickets(x, 16, 0).numel() == 17
    assert mn._tickets(x, 2, 7) is other


def test_tiny_gate_replays_the_other_devices_relu_ties():
    """`chip_smoke.relu_ties`, which lets the tight card-vs-CPU train gate
    take the card's side of a ReLU whose input changes sign at a rounding
    from 0: replaying a step's own inputs changes nothing; an input within
    RELU_TIE_ATOL of 0 recorded on the other side is taken (one flip
    logged, the gradients move); one away from 0 raises."""
    import chip_smoke as cs
    from fcaf3d_tpu_torch.configs import fcaf3d_tiny

    cfg = fcaf3d_tiny()
    batch = cs.head_batch(torch, cfg, cs.TINY_EXTENT)
    rec = {}
    base = cs.step_grads(torch, cfg, batch, "cpu", 0, cs.relu_ties(torch, rec))
    assert rec and all(v.dim() == 3 for v in rec.values())
    flips = []
    same = cs.step_grads(torch, cfg, batch, "cpu", 0,
                         cs.relu_ties(torch, {}, replay=rec, flips=flips))
    assert flips == []
    assert all(torch.equal(same[3][n], g) for n, g in base[3].items())
    name, i, v = min(((n, int(x.abs().where(x != 0, np.inf).argmin()), x)
                      for n, x in rec.items()),
                     key=lambda t: float(t[2].flatten()[t[1]].abs()))
    at = float(v.flatten()[i])
    assert 0 < abs(at) <= cs.RELU_TIE_ATOL
    tie = {**rec, name: v.clone()}
    tie[name].view(-1)[i] = -at
    got = cs.step_grads(torch, cfg, batch, "cpu", 0,
                        cs.relu_ties(torch, {}, replay=tie, flips=flips))
    assert flips == [(name, 1, abs(at))]
    assert any(not torch.equal(got[3][n], g) for n, g in base[3].items())
    far = {**rec, name: v.clone()}
    far[name].view(-1)[int(v.abs().argmax())] *= -1
    with pytest.raises(AssertionError, match="away from 0"):
        cs.step_grads(torch, cfg, batch, "cpu", 0,
                      cs.relu_ties(torch, {}, replay=far, flips=[]))


# ---- on the card -----------------------------------------------------------

# (name, mode, act, residual, B, N, C, fill of each sample): the norm calls
# of a batch-16 fcaf3d_scannet train step at their budgets and channels
SCANNET_SHAPES = [
    ("stem", "instance", "relu", False, 16, 43520, 64, 0.6),
    ("s8", "batch", "relu", True, 16, 30720, 64, 0.193),
    ("s8_ds", "batch", None, False, 16, 30720, 64, 0.193),
    ("s16", "batch", "relu", True, 16, 13312, 128, 0.128),
    ("s32", "batch", "relu", False, 16, 3584, 256, 0.11),
    ("s64", "batch", "relu", True, 16, 1024, 512, 0.072),
    ("neck_up0", "batch", "elu", False, 16, 32768, 64, 0.2),
    ("neck_up1", "batch", "elu", False, 16, 16384, 128, 0.2),
    ("neck_up2", "batch", "elu", False, 16, 6144, 256, 0.2),
    ("out0", "batch", "elu", False, 16, 32768, 128, 0.2),
    ("out3", "batch", "elu", False, 16, 1024, 128, 0.072),
    ("up_eval", "running", "elu", False, 16, 16384, 128, 0.2),
]


def hold_to_plain(device, mode, act, residual, b, n, c, fills, dtype,
                  seed=0, gaps=False):
    """The Function against the plain path on the same CUDA tensors:
    output and residual gradient within a step of the dtype of the largest
    value, running statistics within 1e-5, dx within two steps, the scale
    and bias gradients within 1e-4 in f32 (sums in another order) and 1e-3
    in bf16; then the same call again, bitwise equal."""
    args = inputs(b, n, c, fills, dtype, seed=seed, residual=residual,
                  device=device, gaps=gaps)
    want = run(mn.masked_norm_plain, *args, mode, act)
    got = run(mn.masked_norm, *args, mode, act)
    again = run(mn.masked_norm, *args, mode, act)
    step = 2 ** -7 if dtype == torch.bfloat16 else 1e-5
    # in bf16 an activation whose rounding flips with the statistics' last
    # bit moves its term of the scale's and bias's sums by a bf16 step of
    # that term: the sums read up to 2.2e-4 of their largest on an H100
    sums = 1e-3 if dtype == torch.bfloat16 else 1e-4
    tols = {"out": step, "dres": step, "dx": 2 * step, "dscale": sums,
            "dbias": sums}
    for k, tol in tols.items():
        if want[k] is None:
            continue
        assert torch.isfinite(got[k]).all(), k
        assert rel(got[k], want[k]) <= tol, (k, rel(got[k], want[k]))
        assert torch.equal(got[k], again[k]), k
    valid = (args[1] != SENTINEL)[..., None]
    assert not got["out"].masked_select(~valid).any()
    assert not got["dx"].masked_select(~valid).any()
    if mode == "batch":
        for g, w in zip(got["running"], want["running"]):
            assert rel(g, w) <= 1e-5


@pytest.mark.card
@pytest.mark.parametrize("shape", SCANNET_SHAPES, ids=lambda s: s[0])
def test_card_scannet_training_shapes(card, shape):
    _, mode, act, residual, b, n, c, fill = shape
    fills = [fill] * (b - 1) + [0.0]  # the last sample holds no voxel
    hold_to_plain(card, mode, act, residual, b, n, c, fills, torch.bfloat16)


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("fill", [0.0, "one", 0.07, 0.19, 1.0])
@pytest.mark.parametrize("mode,act,residual", CALLS + [
    ("batch", "elu", True), ("batch", None, True)])
def test_card_fills(card, dtype, fill, mode, act, residual):
    b, n, c = 4, 4096, 64
    f = 1 / n if fill == "one" else fill
    fills = [f, f / 2, 0.0, f]
    hold_to_plain(card, mode, act, residual, b, n, c, fills, dtype,
                  gaps=fill == 0.19)


@pytest.mark.card
@pytest.mark.parametrize("c", [3, 12, 40, 1024])
def test_card_odd_widths(card, c):
    """Widths that do not fill 16 bytes (one channel a thread) and a wide
    one (a row across several warps)."""
    for dtype in (torch.bfloat16, torch.float32):
        hold_to_plain(card, "batch", "relu", True, 2, 512, c, (0.4, 0.9),
                      dtype)
        hold_to_plain(card, "instance", "elu", False, 2, 512, c, (0.4, 0.9),
                      dtype)


@pytest.mark.card
@pytest.mark.parametrize("residual", [False, True])
def test_card_relu_tie_passes_half(card, residual):
    """Rows whose norm lands on exactly 0 under the ReLU (features at the
    batch mean, zero bias, zero residual) pass dy / 2, as the plain path's
    `torch.maximum` does."""
    b, n, c = 2, 256, 16
    rng = np.random.default_rng(9)
    keys = prefix_keys(b, n, (0.5, 0.5), rng).to(card)
    vals = rng.choice([-1.0, 1.0], (b, n, c))
    vals[:, : n // 4] = 0.0  # mean 0 over the valid rows of +-1 pairs
    vals[:, n // 4: n // 2: 2] = 1.0
    vals[:, n // 4 + 1: n // 2: 2] = -1.0
    valid = (keys != SENTINEL)[..., None]
    feats = torch.where(valid, torch.as_tensor(vals, dtype=torch.float32,
                                               device=card), 0.0)
    feats = feats.to(torch.bfloat16)
    scale = torch.ones(c, device=card)
    bias = torch.zeros(c, device=card)
    running = (torch.zeros(c, device=card), torch.ones(c, device=card))
    res = torch.zeros_like(feats) if residual else None
    dy = torch.where(valid, torch.ones_like(feats), 0.0)
    args = (feats, keys, scale, bias, running, res, dy)
    want = run(mn.masked_norm_plain, *args, "batch", "relu")
    got = run(mn.masked_norm, *args, "batch", "relu")
    tie = valid[..., 0].clone()
    tie[:, n // 4:] = False
    assert (got["out"][tie] == 0).all()
    if residual:
        assert (got["dres"][tie] == 0.5).all()
        assert torch.equal(got["dres"], want["dres"])
    assert rel(got["dx"], want["dx"]) <= 2 ** -6


@pytest.mark.card
def test_card_counts_its_launches(card):
    """A batch-mode call with a residual is five launches, forward and
    backward, counted by kernel."""
    _native.reset_launches()
    run(mn.masked_norm, *inputs(2, 256, 64, (0.3, 0.6), torch.bfloat16,
                                residual=True, device=card), "batch", "relu")
    assert _native.VARIANT_LAUNCHES == {
        ("masked_norm", k, "bfloat16"): 1
        for k in ("stats", "dev", "apply", "bwd_reduce", "bwd_apply")}
    _native.reset_launches()


@pytest.mark.card
def test_card_modules_take_the_kernels(card):
    """A train-mode `fcaf3d_tiny` forward and backward on the card runs
    every norm of the model through K7: one stats and one bwd_apply launch
    a norm module."""
    from fcaf3d_tpu_torch.configs import fcaf3d_tiny
    from fcaf3d_tpu_torch.models.detector import FCAF3D

    cfg = fcaf3d_tiny()
    model = FCAF3D(cfg, device=card).train()
    norms = sum(isinstance(m, (tb.SparseBatchNorm, tb.SparseInstanceNorm))
                for m in model.modules())
    rng = np.random.default_rng(0)
    b = 2
    points = torch.as_tensor(rng.uniform(0, 0.3, (b, cfg.num_points, 3)),
                             dtype=torch.float32, device=card)
    colors = torch.as_tensor(rng.uniform(0, 255, (b, cfg.num_points, 3)),
                             dtype=torch.float32, device=card)
    valid = torch.ones(b, cfg.num_points, dtype=torch.bool, device=card)
    _native.reset_launches()
    outs, _ = model(points, colors, valid)
    assert _native.VARIANT_LAUNCHES[("masked_norm", "stats", "float32")] \
        == norms
    sum(o.cls_scores.sum() + o.bbox_pred.sum() for o in outs).backward()
    assert _native.VARIANT_LAUNCHES[("masked_norm", "bwd_apply",
                                     "float32")] == norms
    _native.reset_launches()
