"""The sparse ops' constant tables (`ops/sparse/tables.py::const_table`):
made once a device and reused, so a warmed forward copies no table to the
card and never waits on one.

On the CPU: every table the FCAF3D forward asks for equals its build's
array in value, dtype and shape, and a second request returns the same
tensor and counts no build; devices and dtypes get entries of their own;
an FCAF3D forward gives bitwise the same outputs with a cold cache and a
warm one, counts `const_table_builds` in `voxelize`, `backbone` and
`neck_head` on the cold forward and 0 on the warm one, and asks only for
the tables checked here.

On the card (`card`: skips without one) a warmed `fcaf3d_scannet`
forward at batch 8 runs under `torch.cuda.set_sync_debug_mode("error")`,
which raises at any call that waits on the device:

    python3 -m pytest tests/test_torch_const_tables.py -q -m card --noconftest

(`--noconftest`: the suite's conftest imports JAX, which the card's machine
does not have; this file imports none of it.)
"""
import dataclasses

import numpy as np
import pytest
import torch

from fcaf3d_tpu_torch import configs
from fcaf3d_tpu_torch.apis import init_detector
from fcaf3d_tpu_torch.data.synth import synth_scene
from fcaf3d_tpu_torch.ops.sparse import conv, neck_ops, tables, tensor
from fcaf3d_tpu_torch.utils import tracing

CPU = torch.device("cpu")
# the lattice strides of a 4-scale FCAF3D map, stem to the coarsest level
STRIDES = (1, 2, 4, 8, 16, 32, 64)


def _offsets(k, s):
    return (f"offsets_k{k}_s{s}", lambda dev: conv.offsets_table(k, s, dev),
            conv.kernel_offsets(k, s))


def _trilinear(dtype):
    return (f"trilinear_{dtype}".replace("torch.", ""),
            lambda dev: tables.const_table(neck_ops.trilinear_slot_weights,
                                           device=dev, dtype=dtype),
            torch.as_tensor(neck_ops.trilinear_slot_weights()).to(dtype))


# (id, the request as its call site makes it, the array its build gives)
TABLES = [_offsets(k, s) for k in (1, 2, 3) for s in STRIDES] + [
    ("route", lambda dev: tables.const_table(conv.gen_route_tables,
                                             device=dev),
     conv.gen_route_tables()),
    _trilinear(torch.float32),
    _trilinear(torch.bfloat16),
    ("extent", lambda dev: tensor._extent(torch.zeros((), device=dev)),
     torch.tensor(tensor.EXTENT, dtype=torch.int32)),
]


@pytest.fixture
def cold(monkeypatch):
    """An empty table cache for the test; the process's own comes back
    after it."""
    monkeypatch.setattr(tables, "_TABLES", {})
    return tables


@pytest.fixture
def traced():
    """Tracing on for the test, its records dropped after it."""
    tracing.drain()
    tracing.enable()
    try:
        yield
    finally:
        tracing.disable()
        tracing.drain()


def _builds(spans):
    """`const_table_builds` summed by span name."""
    out = {}
    for s in spans:
        if "const_table_builds" in s.counters:
            out[s.name] = out.get(s.name, 0) + s.counters["const_table_builds"]
    return out


@pytest.mark.parametrize("name,make,want", TABLES, ids=[t[0] for t in TABLES])
def test_table_is_the_built_array_made_once(cold, traced, name, make, want):
    with tracing.span("first"):
        got = make(CPU)
    want = torch.as_tensor(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want)
    with tracing.span("again"):
        again = make(CPU)
    assert again is got
    assert _builds(tracing.drain()) == {"first": 1, "again": 0}
    assert len(cold._TABLES) == 1


def test_devices_and_dtypes_get_entries_of_their_own(cold):
    meta = torch.device("meta")
    off_cpu = conv.offsets_table(3, 8, CPU)
    off_meta = conv.offsets_table(3, 8, meta)
    assert off_meta is not off_cpu and off_meta.device == meta
    assert conv.offsets_table(3, 8, CPU) is off_cpu
    assert conv.offsets_table(3, 8, meta) is off_meta
    w32, w16 = (tables.const_table(neck_ops.trilinear_slot_weights,
                                   device=CPU, dtype=dt)
                for dt in (torch.float32, torch.bfloat16))
    assert w32 is not w16
    assert (w32.dtype, w16.dtype) == (torch.float32, torch.bfloat16)
    assert torch.equal(w16.float(), w32)
    # kernel size, stride: separate entries for every pair
    assert conv.offsets_table(3, 4, CPU) is not off_cpu
    assert conv.offsets_table(2, 8, CPU) is not off_cpu
    assert len(cold._TABLES) == 6


def _scan_batch(cfg, b, seed):
    """`b` synthetic scans of `cfg.num_points` points: (points, colors,
    valid) tensors."""
    rng = np.random.RandomState(seed)
    xyz, rgb = zip(*(synth_scene(rng, cfg.num_points, extent=(0.6, 0.6, 0.3))
                     for _ in range(b)))
    valid = np.ones((b, cfg.num_points), bool)
    valid[-1, cfg.num_points // 2:] = False  # one sample half padding
    return (torch.as_tensor(np.stack(xyz)), torch.as_tensor(np.stack(rgb)),
            torch.as_tensor(valid))


def _flat(outs):
    return [t for level in outs[0] for t in level] + list(outs[1].values())


FORWARDS = {
    "tiny": configs.fcaf3d_tiny(),
    "nano": configs.fcaf3d_nano(),
    "tiny_bf16": dataclasses.replace(configs.fcaf3d_tiny(),
                                     compute_dtype="bfloat16"),
    "tiny_reference": dataclasses.replace(configs.fcaf3d_tiny(),
                                          neck_mode="reference"),
}


@pytest.mark.parametrize("name", list(FORWARDS))
def test_forward_is_bitwise_the_same_cold_and_warm(cold, traced, name):
    cfg = FORWARDS[name]
    model = init_detector(cfg, seed=0, device="cpu")
    batch = _scan_batch(cfg, 2, seed=3)
    with torch.no_grad():
        with tracing.item():
            first = _flat(model(*batch))
        cold_builds = _builds(tracing.drain())
        made = list(cold._TABLES.values())
        with tracing.item():
            second = _flat(model(*batch))
        warm_builds = _builds(tracing.drain())
    assert len(first) == len(second)
    for a, b in zip(first, second):
        assert a.dtype == b.dtype and torch.equal(a, b)
    # each forward span asks for tables; the cold forward makes each once
    assert set(cold_builds) == {"voxelize", "backbone", "neck_head"}
    assert all(n > 0 for n in cold_builds.values())
    assert sum(cold_builds.values()) == len(made)
    assert warm_builds == dict.fromkeys(cold_builds, 0)
    assert len(cold._TABLES) == len(made)
    # the forward asks for no table that the test above does not check
    checked = {id(make(CPU)) for _, make, _ in TABLES}
    assert {id(t) for t in made} <= checked


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")
    return torch.device("cuda")


@pytest.mark.card
def test_card_warm_forward_never_waits(card):
    """`fcaf3d_scannet`'s bf16 eval forward on 8 synthetic 100k-point
    scans: after two warm-up forwards, a third makes no call that waits on
    the device (any would raise under the "error" sync debug mode)."""
    cfg = configs.fcaf3d_scannet()
    model = init_detector(cfg, seed=0, device=card)
    rng = np.random.RandomState(0)
    xyz, rgb = zip(*(synth_scene(rng, cfg.num_points) for _ in range(8)))
    batch = (torch.as_tensor(np.stack(xyz), device=card),
             torch.as_tensor(np.stack(rgb), device=card),
             torch.ones((8, cfg.num_points), dtype=torch.bool, device=card))
    with torch.no_grad():
        for _ in range(2):
            model(*batch)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            outs = model(*batch)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert all(torch.isfinite(t).all() for t in _flat(outs)
               if t.is_floating_point())
