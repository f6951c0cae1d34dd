"""The port's parity-on-arrival harness (`fcaf3d_tpu_torch.tools.
parity_check`, the counterpart of `tools/parity_check.py`) on the CPU.

- The JAX harness's unit tests (`tests/test_parity_harness.py`), on the
  port's `SparseTensor`, and the copied `tensor_stats`, `collect_stats` and
  `run_diff` against the JAX tool's on the same inputs.
- The dump at `fcaf3d_tiny(neck_mode="reference")` on one `.bin` written
  from `data.synth` (a scene the tiny budgets hold, its coarsest level half
  padding) and one `--params` pickle of `init_variables(cfg, 0)`, against
  the JAX tool's dump of the same files (a subprocess under
  `JAX_PLATFORMS=cpu`, as the JAX test runs it): the same keys both ways,
  every `.n_valid` equal, every mean / std / absmax within STAT_RTOL
  relative (the head outputs' statistics include their padding rows), the
  same detections (labels exactly, boxes and scores within phase 5's
  `BOX_ATOL` / `SCORE_ATOL` of `chip_smoke.py`), and `--diff` of the two
  dumps passing through both tools.
"""
import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

import chip_smoke
from fcaf3d_tpu_torch.configs import fcaf3d_tiny
from fcaf3d_tpu_torch.data.synth import synth_scene
from fcaf3d_tpu_torch.ops.sparse.tensor import SENTINEL, SparseTensor
from fcaf3d_tpu_torch.params import init_variables
from fcaf3d_tpu_torch.tools import parity_check as tpc

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

import parity_check as jpc  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STAT_RTOL = 1e-4


def test_tensor_stats_masked():
    x = np.array([[1.0, 2.0], [100.0, 200.0]])
    mask = np.array([True, False])
    s = tpc.tensor_stats(x, mask)
    assert s["n"] == 2 and s["mean"] == 1.5 and s["absmax"] == 2.0


def port_sparse_tensor():
    return SparseTensor(
        coords=torch.zeros((1, 3, 3), dtype=torch.int32),
        feats=torch.tensor([[[1.0], [3.0], [999.0]]]),
        keys=torch.tensor([[0, 5, SENTINEL]]),
        shift=torch.zeros((1, 3), dtype=torch.int32), stride=1)


def test_collect_stats_walks_sparse_tensors():
    out = {}
    tpc.collect_stats({"backbone": {"__call__": (port_sparse_tensor(),)}},
                      "", out)
    rec = out["backbone/__call__[0]"]
    assert rec["n"] == 2 and rec["mean"] == 2.0  # padding row excluded
    assert out["backbone/__call__[0].n_valid"] == {"n": 2}


def test_diff_detects_deviation(tmp_path):
    a = {"layer_stats": {"l1": {"mean": 1.0, "std": 2.0, "absmax": 3.0}},
         "detections": {"scores": [0.9], "boxes": [[0] * 7], "labels": [0]}}
    b = json.loads(json.dumps(a))
    pa, pb = tmp_path / "a.json", tmp_path / "b.json"
    pa.write_text(json.dumps(a))
    pb.write_text(json.dumps(b))
    assert tpc.run_diff(str(pa), str(pb), rtol=1e-3) == 0
    b["layer_stats"]["l1"]["mean"] = 1.5
    pb.write_text(json.dumps(b))
    assert tpc.run_diff(str(pa), str(pb), rtol=1e-3) == 1


@pytest.mark.parametrize("masked", [False, True])
def test_tensor_stats_equals_jax(masked):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 7, 5)).astype(np.float32)
    x[0, 2, 1] = np.inf
    mask = rng.uniform(size=(2, 7)) < 0.6 if masked else None
    # as the dumps hold them (NaN written as NaN)
    assert json.dumps(tpc.tensor_stats(x, mask)) == json.dumps(
        jpc.tensor_stats(x, mask))
    assert tpc.tensor_stats(x[:0]) == jpc.tensor_stats(x[:0]) == {"n": 0}


def test_collect_stats_equals_jax():
    """A tree of the port's SparseTensor, tensors, a dict and nested
    tuples walks to the JAX tool's records of the same tree of the JAX
    package's SparseTensor and arrays."""
    import jax.numpy as jnp

    from fcaf3d_tpu.ops.sparse.tensor import SENTINEL as JSENTINEL
    from fcaf3d_tpu.ops.sparse.tensor import SparseTensor as JSparseTensor

    rng = np.random.default_rng(0)
    feats = rng.normal(size=(2, 4, 3)).astype(np.float32)
    keys = np.array([[1, 4, 9, -1], [2, 3, -1, -1]])
    inv = rng.uniform(size=8).astype(np.float32)
    plain = rng.normal(size=(1, 4, 6)).astype(np.float32)
    port = SparseTensor(
        coords=torch.zeros((2, 4, 3), dtype=torch.int32),
        feats=torch.from_numpy(feats),
        keys=torch.from_numpy(np.where(keys < 0, SENTINEL, keys)),
        shift=torch.zeros((2, 3), dtype=torch.int32))
    jst = JSparseTensor(
        coords=jnp.zeros((2, 4, 3), jnp.int32), feats=jnp.asarray(feats),
        keys=jnp.asarray(np.where(keys < 0, int(JSENTINEL), keys),
                         jnp.uint32),
        shift=jnp.zeros((2, 3), jnp.int32), stride=1)
    got, want = {}, {}
    tpc.collect_stats({"m": {"__call__": (port, (torch.from_numpy(inv),
                                                 torch.from_numpy(plain)))}},
                      "", got)
    jpc.collect_stats({"m": {"__call__": (jst, (jnp.asarray(inv),
                                                jnp.asarray(plain)))}},
                      "", want)
    assert got == want
    assert got["m/__call__[0].n_valid"] == {"n": 5}


def test_run_diff_equals_jax(tmp_path, capsys):
    """The same return code and printout as the JAX tool's `run_diff`, on
    equal dumps, a deviation, a missing key and unequal detections."""
    a = {"layer_stats": {"l1": {"mean": 1.0, "std": 2.0, "absmax": 3.0},
                         "l2": {"n": 0}, "l3": {"mean": 0.0, "std": 1e-7,
                                               "absmax": 1e-7}},
         "detections": {"scores": [0.9], "boxes": [[0] * 7], "labels": [0]}}
    cases = [{}, {"l1": ("std", 2.01)}, {"l3": ("absmax", 5e-7)},
             {"missing": "l1"}, {"scores": [0.9, 0.5]}]
    pa = tmp_path / "a.json"
    pa.write_text(json.dumps(a))
    for case in cases:
        b = json.loads(json.dumps(a))
        for key, change in case.items():
            if key == "missing":
                del b["layer_stats"][change]
            elif key == "scores":
                b["detections"]["scores"] = change
            else:
                b["layer_stats"][key][change[0]] = change[1]
        pb = tmp_path / "b.json"
        pb.write_text(json.dumps(b))
        for rtol in (1e-3, 1.0):
            rc = tpc.run_diff(str(pa), str(pb), rtol)
            got = capsys.readouterr().out
            assert jpc.run_diff(str(pa), str(pb), rtol) == rc, case
            assert capsys.readouterr().out == got, case


def test_missing_fixture_names_its_directory(tmp_path, monkeypatch):
    """Without `--points` the dump reads the reference's fixture scene;
    where it is missing the error names the directory (as does
    `--export-points`)."""
    monkeypatch.setattr(tpc, "REF_FIXTURES", str(tmp_path / "absent"))
    want = str(tmp_path / "absent" / "scannet")
    with pytest.raises(FileNotFoundError, match=want):
        tpc.main(["--config", "fcaf3d_tiny", "--device", "cpu"])
    with pytest.raises(FileNotFoundError, match=want):
        tpc.main(["--export-points", str(tmp_path / "x.bin")])


@pytest.fixture(scope="module")
def dumps(tmp_path_factory):
    """(the port's dump, the JAX tool's dump, their paths, the files):
    one `data.synth` scene and the pickled seeded tree at fcaf3d_tiny."""
    tmp = tmp_path_factory.mktemp("parity")
    xyz, rgb = synth_scene(np.random.RandomState(0), 2048,
                           extent=chip_smoke.TINY_EXTENT)
    bin_path, params = str(tmp / "scene.bin"), str(tmp / "params.pkl")
    np.concatenate([xyz, rgb], 1).astype(np.float32).tofile(bin_path)
    with open(params, "wb") as f:
        pickle.dump(init_variables(fcaf3d_tiny(), 0), f)
    port, jax_path = str(tmp / "port.json"), str(tmp / "jax.json")
    args = ["--config", "fcaf3d_tiny", "--points", bin_path, "--params",
            params]
    r = subprocess.run(
        [sys.executable, "tools/parity_check.py", *args, "--dump", jax_path],
        capture_output=True, text=True, cwd=REPO, timeout=900,
        env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert r.returncode == 0, r.stderr[-2000:]
    tpc.main([*args, "--dump", port, "--device", "cpu"])
    with open(port) as f, open(jax_path) as g:
        return (json.load(f), json.load(g), port, jax_path, bin_path)


def test_dump_keys_equal_jax(dumps):
    got, want = dumps[0]["layer_stats"], dumps[1]["layer_stats"]
    assert sorted(set(want) - set(got)) == []
    assert sorted(set(got) - set(want)) == []
    assert len(got) == 292
    assert dumps[0]["config"] == dumps[1]["config"] == "fcaf3d_scannet"


def test_dump_stats_equal_jax(dumps):
    """Every `.n_valid` and every record's element count equal; every mean,
    std and absmax within STAT_RTOL relative (of the larger magnitude, at
    least 1e-6, as `run_diff` measures it). Some level holds padding rows,
    and the plain head outputs count them."""
    got, want = dumps[0]["layer_stats"], dumps[1]["layer_stats"]
    worst = (0.0, "")
    for k, w in want.items():
        g = got[k]
        if k.endswith(".n_valid"):
            assert g == w, k
            continue
        assert g["n"] == w["n"] and g["finite_frac"] == w["finite_frac"], k
        for field in ("mean", "std", "absmax"):
            rel = abs(g[field] - w[field]) / max(abs(g[field]),
                                                 abs(w[field]), 1e-6)
            worst = max(worst, (rel, f"{k}.{field}"))
    print(f"worst relative deviation {worst[0]:.3e} at {worst[1]}")
    assert worst[0] <= STAT_RTOL, worst
    n_valid = want["backbone/__call__[0][3].n_valid"]["n"]
    assert want["__call__[0][3][4]"]["n"] > n_valid > 0


def test_dump_detections_equal_jax(dumps):
    got, want = dumps[0]["detections"], dumps[1]["detections"]
    assert len(got["scores"]) == len(want["scores"]) > 0
    assert got["labels"] == want["labels"]
    np.testing.assert_allclose(got["boxes"], want["boxes"], rtol=0,
                               atol=chip_smoke.BOX_ATOL)
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=0,
                               atol=chip_smoke.SCORE_ATOL)


@pytest.mark.parametrize("tool", ["fcaf3d_tpu_torch.tools.parity_check",
                                  "tools/parity_check.py"])
def test_diff_passes_through_both_tools(dumps, tool):
    cmd = ([sys.executable, "-m", tool] if tool.startswith("fcaf3d")
           else [sys.executable, tool])
    for a, b in ((dumps[3], dumps[2]), (dumps[2], dumps[3])):
        r = subprocess.run([*cmd, "--diff", a, b, "--rtol", "1e-3"],
                           capture_output=True, text=True, cwd=REPO,
                           timeout=300)
        assert r.returncode == 0, r.stdout + r.stderr[-500:]
        assert "PARITY OK" in r.stdout and "missing in b: 0" in r.stdout


def test_dump_without_params_is_the_seeded_draw(dumps, tmp_path, capsys):
    """Without `--params` the dump runs the seeded `init_variables(cfg, 0)`
    draw: the pickle's dump exactly."""
    out = str(tmp_path / "smoke.json")
    tpc.main(["--config", "fcaf3d_tiny", "--points", dumps[4], "--dump",
              out, "--device", "cpu"])
    assert "harness smoke mode" in capsys.readouterr().out
    with open(out) as f:
        assert json.load(f) == dumps[0]
