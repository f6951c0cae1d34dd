"""Kernel K8 (`csrc/clip_adamw.cu`): `ClipAdamW.step` on the card, the
global-norm clip and AdamW over every leaf in two launches.

On the CPU: CPU leaves take the plain loop and never the kernel library;
CUDA leaves take K8 or a refusal; what the wrapper hands the kernels (a
recording fake library: the table of leaves, its uploads, the gradients'
addresses, the f32 scalars); the chunks' cover of every leaf; and numpy replays of the
kernels' arithmetic (the update op for op, the norm in its order of
summation) held to float64 and to the plain norm.

On the card (`card`: skips without one) K8 is held to the plain loop on
the card (bit for bit below the clip) and to the numpy replay (bit for
bit) at `fcaf3d_scannet`'s 149 leaf shapes cut to a quarter a dimension,
plus leaves of 1, 3 and 4 097 elements and leaves without a gradient,
over 3 steps below and above the clip, two runs bitwise equal, and
through a checkpoint restore:

    python3 -m pytest tests/test_torch_clip_adamw.py -q -m card --noconftest

(`--noconftest`: the suite's conftest imports JAX, which the card's machine
does not have; this file imports none of it.)
"""
import os
import re

import numpy as np
import pytest
import torch

from fcaf3d_tpu_torch import _native
from fcaf3d_tpu_torch.ops.optim import clip_adamw as k8
from fcaf3d_tpu_torch.train.optim import ClipAdamW, constant_schedule
from fcaf3d_tpu_torch.utils import tracing

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "fcaf3d_tpu_torch", "csrc", "clip_adamw.cu")
GRAD_CLIP, LR, WD = 10.0, 1e-3, 1e-4
ODD = [(1,), (3,), (4097,)]  # lengths off the 16-byte vector and the chunk


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def fcaf3d_shapes(div=4):
    """`fcaf3d_scannet`'s 149 leaf shapes, each dimension divided by `div`
    (at least 1), then ODD."""
    from fcaf3d_tpu_torch.configs import fcaf3d_scannet
    from fcaf3d_tpu_torch.models.detector import FCAF3D

    model = FCAF3D(fcaf3d_scannet(), device="cpu")
    return [tuple(max(1, d // div) for d in p.shape)
            for p in model.parameters()] + ODD


def draw(shapes, seed, scale, missing=()):
    """Parameters and gradients of `shapes` from `seed`: gradients of
    typical size `scale` (the norm lands below or above the clip), None
    at the indices in `missing`."""
    rng = np.random.default_rng(seed)
    params = [torch.as_tensor(rng.normal(0, 0.05, s), dtype=torch.float32)
              for s in shapes]
    grads = [None if i in missing else torch.as_tensor(
        rng.normal(0, scale, s) * rng.uniform(0.1, 2.0), dtype=torch.float32)
        for i, s in enumerate(shapes)]
    return params, grads


def make_opt(params):
    return ClipAdamW([torch.nn.Parameter(p) for p in params],
                     constant_schedule(LR), weight_decay=WD,
                     grad_clip=GRAD_CLIP)


def leaves_of(opt):
    return [p for g in opt.param_groups for p in g["params"]]


# ---- the CPU / CUDA boundary ---------------------------------------------


class _CudaLooking(torch.Tensor):
    """A CPU tensor that reports a CUDA device, to reach the kernel path of
    a wrapper on a machine without a GPU."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def _cuda_looking(t, grad=False):
    if t is None:
        return None
    return torch.Tensor._make_subclass(_CudaLooking, t, grad)


class _Recorder:
    """A kernel library that records the arguments of each C call."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if not name.startswith("fcaf3d_"):
            raise AttributeError(name)
        return lambda *args: self.calls.append((name, args)) or 0


def cuda_looking_opt(shapes, seed=0, scale=0.1, missing=(),
                     dtype=torch.float32):
    params, grads = draw(shapes, seed, scale, missing)
    ps = [_cuda_looking(p.to(dtype), grad=True) for p in params]
    for p, g in zip(ps, grads):
        p.grad = _cuda_looking(None if g is None else g.to(dtype))
    return ClipAdamW(ps, constant_schedule(LR), weight_decay=WD,
                     grad_clip=GRAD_CLIP)


def traced_step(opt):
    tracing.enable()
    try:
        with tracing.span("optimizer"):
            out = opt.step()
    finally:
        tracing.disable()
    (span,) = tracing.drain()
    return out, span.counters


def test_cpu_leaves_take_the_plain_loop(monkeypatch):
    """CPU leaves run the plain loop: no kernel library, no launch; the
    counters read every leaf and none fused."""
    def no_library():
        raise AssertionError("the plain loop loaded the kernel library")

    monkeypatch.setattr(_native, "load", no_library)
    _native.reset_launches()
    params, grads = draw([(5, 3), (7,), (4097,)], 0, 0.1, missing=(1,))
    opt = make_opt(params)
    for p, g in zip(leaves_of(opt), grads):
        p.grad = g
    norm, counters = traced_step(opt)
    assert norm.device.type == "cpu" and torch.isfinite(norm)
    assert counters == {"adamw_leaves": 3, "adamw_fused_leaves": 0}
    assert _native.LAUNCHES["clip_adamw"] == 0
    assert _native.VARIANT_LAUNCHES == {}


def test_cuda_leaves_take_the_kernels_or_raise(monkeypatch):
    """CUDA leaves launch K8 or raise: with no kernel library the step does
    not fall back to the plain loop, and f16, f64, non-contiguous, mixed
    device or mis-shaped leaves are refused before any launch."""
    def no_library():
        raise RuntimeError("kernel library not built")

    monkeypatch.setattr(_native, "load", no_library)
    _native.reset_launches()
    shapes = [(4, 6), (9,)]
    with pytest.raises(RuntimeError, match="not built"):
        cuda_looking_opt(shapes).step()
    for dtype in (torch.float16, torch.float64):
        with pytest.raises(TypeError, match="float32"):
            cuda_looking_opt(shapes, dtype=dtype).step()
    for first in (True, False):  # the first step's check, a later one's
        opt = cuda_looking_opt(shapes)
        if not first:
            with pytest.raises(RuntimeError, match="not built"):
                opt.step()
        p = leaves_of(opt)[0]
        p.grad = _cuda_looking(torch.zeros(6, 4).t())
        with pytest.raises(ValueError, match="contiguous"):
            opt.step()
    opt = cuda_looking_opt(shapes)
    opt.state[leaves_of(opt)[0]] = {"mu": _cuda_looking(torch.zeros(24)),
                                    "nu": _cuda_looking(torch.zeros(4, 6))}
    with pytest.raises(ValueError, match="one shape"):
        opt.step()
    opt = cuda_looking_opt(shapes)
    opt.state[leaves_of(opt)[1]] = {"mu": _cuda_looking(torch.zeros(9)),
                                    "nu": torch.zeros(9)}  # on the CPU
    with pytest.raises(ValueError, match="one CUDA device"):
        opt.step()
    with pytest.raises(ValueError, match=f"at most {k8.MAX_LEAVES} leaves"):
        cuda_looking_opt([(2,)] * (k8.MAX_LEAVES + 1)).step()
    assert _native.LAUNCHES["clip_adamw"] == 0


def test_wrapper_hands_the_kernels_their_table(monkeypatch):
    """On CUDA leaves a step is two launches, `fcaf3d_clip_adamw_norm` then
    `_update`, over `work_rows`' table (no row for an empty leaf), the
    step's gradient addresses (0 for a missing gradient) and the plain
    loop's scalars rounded to f32; the table is uploaded at the first step
    and again only when a parameter's or moment's address changes (a
    checkpoint's new moments), not for a new gradient; the counters read
    every leaf fused; and `_native` binds the two entries of
    `csrc/clip_adamw.cu`."""
    lib = _Recorder()
    monkeypatch.setattr(_native, "load", lambda: lib)
    monkeypatch.setattr(_native, "stream_ptr", lambda dev: 0)
    _native.reset_launches()
    shapes = [(3, 5), (0,), (k8.CHUNK + 3,), (2,), (2 * k8.CHUNK,)]
    opt = cuda_looking_opt(shapes, missing=(3,))
    ps = leaves_of(opt)
    uploads = []
    for i in range(4):
        if i == 2:
            ps[0].grad = _cuda_looking(ps[0].grad.clone())
        if i == 3:  # as `train/checkpoint.py` restores the moments
            opt.state[ps[4]] = {"mu": _cuda_looking(torch.zeros(shapes[4])),
                                "nu": _cuda_looking(torch.zeros(shapes[4]))}
        _, counters = traced_step(opt)
        assert counters["adamw_leaves"] == counters["adamw_fused_leaves"] == 5
        uploads.append(counters["adamw_table_uploads"])
    assert uploads == [1, 0, 0, 1]
    assert opt.kernel.uploads == 2
    first = [0, 2, 3, 4]  # the empty leaf 1 has no row
    starts = [0, 1, 3, 4]
    want = [(ps[i].data_ptr(), opt.state[ps[i]]["mu"].data_ptr(),
             opt.state[ps[i]]["nu"].data_ptr(), ps[i].numel(), s)
            for i, s in zip(first, starts)]
    assert opt.kernel.table.tolist() == [list(r) for r in want]
    assert opt.kernel.grads.tolist() == [
        0 if ps[i].grad is None else ps[i].grad.data_ptr() for i in first]
    chunks = 6
    names = [name for name, _ in lib.calls]
    assert names == ["fcaf3d_clip_adamw_norm",
                     "fcaf3d_clip_adamw_update"] * 4
    f32 = lambda x: torch.tensor(x, dtype=torch.float32).item()  # noqa: E731
    for _, args in lib.calls[-2:]:
        assert args[0] == opt.kernel.table.data_ptr()
        assert args[1:4] == (4, chunks, opt.kernel.grads.ctypes.data)
        assert args[-1] == 0  # the stream
    norm_args, upd_args = lib.calls[-2][1], lib.calls[-1][1]
    assert norm_args[4] == opt.kernel.slots.data_ptr()
    assert opt.kernel.slots.numel() >= chunks
    assert norm_args[5] == opt.kernel.ticket.data_ptr()
    assert upd_args[4] == norm_args[6]  # the update reads the norm written
    # 1 / c in f32, as ATen's CUDA division by a host scalar takes it
    inv = [(torch.ones((), dtype=torch.float32)
            / torch.tensor(c, dtype=torch.float32)).item()
           for c in opt_c(4)]
    assert upd_args[5:15] == (f32(GRAD_CLIP), f32(0.9), f32(1 - 0.9),
                              f32(0.999), f32(1 - 0.999), *inv, f32(1e-8),
                              f32(WD), f32(-LR))
    assert _native.LAUNCHES["clip_adamw"] == 8
    assert _native.VARIANT_LAUNCHES == {
        ("clip_adamw", "norm", "float32"): 4,
        ("clip_adamw", "update", "float32"): 4}
    _native.reset_launches()
    src = open(SRC).read()
    entries = re.findall(r'extern "C" int (fcaf3d_clip_adamw_\w+)\(', src)
    assert entries == ["fcaf3d_clip_adamw_norm", "fcaf3d_clip_adamw_update"]
    bound = re.findall(r"lib\.(fcaf3d_clip_adamw_\w+)\.argtypes",
                       open(_native.__file__).read())
    assert sorted(bound) == sorted(entries)
    assert int(re.search(r"constexpr int64_t kChunk = (\d+);",
                         src).group(1)) == k8.CHUNK
    assert int(re.search(r"constexpr int kFields = (\d+);",
                         src).group(1)) == k8.FIELDS
    assert int(re.search(r"constexpr int kMaxLeaves = (\d+);",
                         src).group(1)) == k8.MAX_LEAVES
    assert "clip_adamw" in _native.LAUNCHES


def find_chunk(rows, b):
    """The kernels' CTA b: (row index, first element, end), as
    `find_chunk` searches the table."""
    lo, hi = 0, len(rows) - 1
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if rows[mid][4] <= b:
            lo = mid
        else:
            hi = mid - 1
    begin = (b - rows[lo][4]) * k8.CHUNK
    return lo, begin, min(rows[lo][3], begin + k8.CHUNK)


@pytest.mark.parametrize("seed", range(3))
def test_chunks_cover_every_element_once(seed):
    """The launches' CTAs, each finding its chunk in the table, cover every
    element of every leaf once, none beyond a leaf's end."""
    rng = np.random.default_rng(seed)
    sizes = list(rng.choice([0, 1, 3, 64, k8.CHUNK - 1, k8.CHUNK,
                             k8.CHUNK + 1, 3 * k8.CHUNK + 5], 40))
    ts = [torch.empty(int(n)) for n in sizes]
    rows, chunks = k8.work_rows([(t, None, t, t) for t in ts])
    assert len(rows) == sum(n > 0 for n in sizes)
    seen = [np.zeros(r[3], np.int64) for r in rows]
    for b in range(chunks):
        i, begin, end = find_chunk(rows, b)
        assert 0 <= begin < end <= rows[i][3]
        seen[i][begin:end] += 1
    assert all((s == 1).all() for s in seen)
    assert chunks == sum(-(-int(n) // k8.CHUNK) for n in sizes)


# ---- the kernels' arithmetic, replayed in numpy --------------------------


def replay_update(p, mu, nu, g, norm, count):
    """`adamw()` of csrc/clip_adamw.cu in numpy f32 (each op rounded once,
    as the `_rn` intrinsics round; numpy's f32 division and square root
    are IEEE), on copies."""
    f = np.float32
    h = dict(zip(("clip", "b1", "omb1", "b2", "omb2", "inv_c1", "inv_c2",
                  "eps", "wd", "neg_lr"),
                 (f(v) for v in k8.hyper(LR, *opt_c(count), 0.9, 0.999, 1e-8,
                                         WD, GRAD_CLIP))))
    norm = f(norm)
    if norm >= h["clip"]:
        g = (g / norm) * h["clip"]
    mu = h["omb1"] * g + h["b1"] * mu
    nu = h["omb2"] * (g * g) + h["b2"] * nu
    u = (mu * h["inv_c1"]) / (np.sqrt(nu * h["inv_c2"]) + h["eps"])
    u = u + h["wd"] * p
    return p + h["neg_lr"] * u, mu, nu


def float64_update(p, mu, nu, g, norm, count):
    """optax's clip + adamw step in float64 (the bias corrections as f32
    values, as optax takes them): (p, mu, nu), and the size of the terms
    each was summed from, for a tolerance in ulps that a cancelling sum
    does not defeat."""
    c1, c2 = opt_c(count)
    p, mu, nu, g = (np.asarray(x, np.float64) for x in (p, mu, nu, g))
    if norm >= GRAD_CLIP:
        g = g / norm * GRAD_CLIP
    mu_scale = 0.9 * np.abs(mu) + 0.1 * np.abs(g)
    mu = 0.1 * g + 0.9 * mu
    nu = 0.001 * g * g + 0.999 * nu
    den = np.sqrt(nu / c2) + 1e-8
    p_scale = np.abs(p) + LR * (mu_scale / c1 / den + WD * np.abs(p))
    p = p - LR * ((mu / c1) / den + WD * p)
    return (p, mu, nu), (p_scale, mu_scale, nu)


def opt_c(count):
    """The bias corrections at step `count`, as `ClipAdamW.step` takes
    them."""
    f = np.float32
    return (float(1 - f(0.9) ** f(count)), float(1 - f(0.999) ** f(count)))


@pytest.mark.parametrize("scale", [0.002, 0.2])  # below / above the clip
def test_update_replay_holds_to_float64(scale):
    """The kernels' update, op for op in f32, stays within 8 ulps of its
    terms of optax's step in float64 over 3 steps below and above the clip,
    given the plain loop's norm; and the plain loop on the CPU stays as
    close (its vectorised square root is not IEEE: no bitwise premise
    there)."""
    shapes = [(27, 16, 8), (64,), (4097,), (3,), ()]
    params, _ = draw(shapes, 1, scale)
    opt = make_opt(params)
    ps = leaves_of(opt)
    ref = [(p.detach().numpy().copy(), np.zeros(p.shape, np.float32),
            np.zeros(p.shape, np.float32)) for p in ps]
    for step in range(1, 4):
        _, grads = draw(shapes, 10 + step, scale, missing=(3,))
        for p, g in zip(ps, grads):
            p.grad = g
        norm = opt.step().item()
        assert (norm >= GRAD_CLIP) == (scale > 0.1)
        full = [np.zeros(p.shape, np.float32) if g is None else g.numpy()
                for p, g in zip(ps, grads)]
        exact = [float64_update(*r, g, norm, step) for r, g in zip(ref, full)]
        ref = [replay_update(*r, g, norm, step) for r, g in zip(ref, full)]
        for p, got, (want, scales) in zip(ps, ref, exact):
            plain = (p.detach().numpy(), opt.state[p]["mu"].numpy(),
                     opt.state[p]["nu"].numpy())
            for side in (got, plain):
                for x, w, sc in zip(side, want, scales):
                    assert np.all(np.abs(np.float64(x) - w)
                                  <= 8 * 2.0 ** -23 * sc)


def block_sum(v):
    """`block_sum` of csrc/clip_adamw.cu over a CTA's 256 per-thread values
    (f32): a shuffle-down tree in each warp, then over the warps' sums."""
    def warp(x):
        x = x.copy()
        for o in (16, 8, 4, 2, 1):
            x[:32 - o] = x[:32 - o] + x[o:]
        return x[0]

    sums = np.array([warp(v[w * 32:(w + 1) * 32]) for w in range(8)],
                    np.float32)
    return warp(np.concatenate([sums, np.zeros(24, np.float32)]))


def replay_norm(grads):
    """`clip_adamw_norm` in numpy f32, in its order of summation: each
    thread's four lane sums over its vectors of a chunk, its tail elements
    into the first lane, the CTA's tree, then the slots by thread and the
    tree again."""
    slots = []
    for g in grads:
        g = g.reshape(-1)
        for begin in range(0, g.size, k8.CHUNK):
            c = g[begin:begin + k8.CHUNK]
            nv = c.size // 4
            vec = c[:nv * 4].reshape(nv, 4)
            acc = np.zeros((256, 4), np.float32)
            for v in range(0, nv, 256):  # thread t takes vector v + t
                blk = vec[v:v + 256]
                acc[:len(blk)] = acc[:len(blk)] + blk * blk
            for k, x in enumerate(c[nv * 4:]):
                acc[k, 0] = acc[k, 0] + x * x
            per = (acc[:, 0] + acc[:, 1]) + (acc[:, 2] + acc[:, 3])
            slots.append(block_sum(per))
    slots = np.array(slots, np.float32)
    t = np.zeros(256, np.float32)
    for k in range(0, slots.size, 256):
        blk = slots[k:k + 256]
        t[:len(blk)] = t[:len(blk)] + blk
    return np.sqrt(block_sum(t))


def test_norm_replay_matches_the_plain_norm():
    """The kernels' norm, in its order of summation, is within 1e-6 of the
    plain loop's (per-leaf sums, then their sum) and of float64, at
    `fcaf3d_scannet`'s leaf shapes cut to an eighth a dimension."""
    shapes = fcaf3d_shapes(8)
    _, grads = draw(shapes, 3, 0.05)
    got = float(replay_norm([g.numpy() for g in grads]))
    plain = float(torch.sqrt(sum(torch.sum(g * g) for g in grads)))
    exact = float(np.sqrt(sum(np.sum(g.double().numpy() ** 2)
                              for g in grads)))
    assert abs(got - plain) <= 1e-6 * plain
    assert abs(got - exact) <= 1e-6 * exact


# ---- on the card -----------------------------------------------------------


def over_tolerance(got, want, scale, gap):
    """The largest |got - want| over the tolerance: 8 f32 ulps of `scale`
    (the size of the terms the result was summed from, so that a result
    that cancels is not held to its own ulps) plus twice the norm's
    relative gap `gap` of it (the one difference permitted above the
    clip)."""
    tol = scale.double() * (8 * 2.0 ** -23 + 2 * gap)
    diff = (got.double() - want.double()).abs()
    return float((diff / tol.clamp_min(2.0 ** -149)).max())


def card_run(card, shapes, scale, steps=3, restore_at=None):
    """K8 on the card over `steps` steps of drawn gradients (every fifth
    leaf, from the second step on, without one), held at each step to the
    numpy replay given K8's norm and to the plain loop on the card from the
    same state with its own norm. The gradients are copied into the same
    tensors step after step, as the caching allocator hands a train step's
    back. Returns the readings and the final card tensors."""
    params, _ = draw(shapes, 0, scale)
    opt = make_opt([p.to(card) for p in params])
    ps = leaves_of(opt)
    bufs = [torch.empty_like(p) for p in ps]
    rd = {"norm_gap": 0.0, "card_over": 0.0, "replay_equal": True,
          "plain_equal": True, "uploads": [], "norms": []}
    for step in range(1, steps + 1):
        missing = () if step == 1 else tuple(range(0, len(shapes), 5))
        _, grads = draw(shapes, 100 + step, scale, missing)
        for p, g, buf in zip(ps, grads, bufs):
            p.grad = None if g is None else buf.copy_(g)
        if step == restore_at:
            for p in ps:  # as `train/checkpoint.py` restores the moments
                st = opt.state[p]
                opt.state[p] = {"mu": st["mu"].cpu().to(card),
                                "nu": st["nu"].cpu().to(card)}
        before = [(p.detach().clone(),
                   *(opt.state[p].get(k, torch.zeros_like(p)).clone()
                     for k in ("mu", "nu"))) for p in ps]
        norm, counters = traced_step(opt)
        norm = norm.item()
        rd["norms"].append(norm)
        rd["uploads"].append(counters["adamw_table_uploads"])
        assert counters["adamw_fused_leaves"] == len(ps)
        full = [torch.zeros_like(p) if p.grad is None else p.grad
                for p in ps]
        for p, b, g in zip(ps, before, full):
            want = replay_update(*(x.cpu().numpy() for x in b),
                                 g.cpu().numpy(), norm, step)
            got = (p.detach(), opt.state[p]["mu"], opt.state[p]["nu"])
            rd["replay_equal"] &= all(np.array_equal(x.cpu().numpy(), w)
                                      for x, w in zip(got, want))
        plain_norm = torch.sqrt(sum(torch.sum(g * g) for g in full))
        gap = abs(norm - plain_norm.item()) / plain_norm.item()
        rd["norm_gap"] = max(rd["norm_gap"], gap)
        states = [{"mu": m.clone(), "nu": n.clone()} for _, m, n in before]
        plain_p = [b[0].clone() for b in before]
        opt._plain_update(plain_p, full, states, plain_norm, LR,
                          *opt_c(step))
        for p, pp, st, b, g in zip(ps, plain_p, states, before, full):
            _, scales = float64_update(*(x.cpu().numpy() for x in b),
                                       g.cpu().numpy(), plain_norm.item(),
                                       step)
            for got, want, sc in zip(
                    (p.detach(), opt.state[p]["mu"], opt.state[p]["nu"]),
                    (pp, st["mu"], st["nu"]), scales):
                rd["plain_equal"] &= torch.equal(got, want)
                rd["card_over"] = max(rd["card_over"], over_tolerance(
                    got.cpu(), want.cpu(), torch.as_tensor(sc), gap))
    return rd, [(p.detach().clone(), opt.state[p]["mu"].clone(),
                 opt.state[p]["nu"].clone()) for p in ps]


@pytest.mark.card
@pytest.mark.parametrize("scale,above", [(2e-4, False), (0.05, True)])
def test_card_matches_the_plain_loop(card, scale, above):
    """K8 against the plain loop on the card: parameters and moments bit
    for bit below the clip, and above it within 8 ulps of their terms plus
    twice the norm's gap (its order of summation is the one difference);
    the norm within 1e-6 of the plain loop's; every leaf bit for bit the
    numpy replay of the kernels' arithmetic given K8's norm; two runs
    bitwise equal; the table uploaded at the first step only (the
    gradients' addresses go with each launch)."""
    shapes = fcaf3d_shapes(4)
    rd, final = card_run(card, shapes, scale)
    assert all((n >= GRAD_CLIP) == above for n in rd["norms"])
    assert rd["replay_equal"]
    assert rd["norm_gap"] <= 1e-6
    assert rd["card_over"] <= 1
    assert rd["plain_equal"] or above
    assert rd["uploads"] == [1, 0, 0]
    again, final2 = card_run(card, shapes, scale)
    assert again["norms"] == rd["norms"]
    assert all(torch.equal(a, b) for x, y in zip(final, final2)
               for a, b in zip(x, y))


@pytest.mark.card
def test_card_step_after_a_checkpoint_restore(card):
    """A restore replaces every leaf's moments with new tensors: the next
    step uploads the table again and still matches the plain loop, and the
    run ends bitwise where a run without the restore ends."""
    shapes = fcaf3d_shapes(8)
    rd, final = card_run(card, shapes, 0.05, restore_at=3)
    assert rd["uploads"] == [1, 0, 1]
    assert rd["replay_equal"] and rd["norm_gap"] <= 1e-6
    assert rd["card_over"] <= 1
    _, plain = card_run(card, shapes, 0.05)
    assert all(torch.equal(a, b) for x, y in zip(final, plain)
               for a, b in zip(x, y))


@pytest.mark.card
def test_card_counts_its_launches(card):
    """A step on the card is K8's two launches, counted by kernel."""
    opt = make_opt([torch.ones(5, device=card), torch.ones(4097, device=card)])
    for p in leaves_of(opt):
        p.grad = torch.full_like(p, 0.5)
    _native.reset_launches()
    norm = opt.step()
    assert _native.VARIANT_LAUNCHES == {
        ("clip_adamw", "norm", "float32"): 1,
        ("clip_adamw", "update", "float32"): 1}
    _native.reset_launches()
    assert norm.item() == pytest.approx(0.5 * np.sqrt(4102), rel=1e-6)
