"""What a run loads: a cell's run, in a fresh process, imports no module
whose top-level name (the part before the first dot, compared whole) is
`jax`, `jaxlib`, `flax` or the JAX package `fcaf3d_tpu`; the reference
imports nothing of the port (`fcaf3d_tpu_torch`) either."""
import json
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
JAX_SIDE = {"jax", "jaxlib", "flax", "fcaf3d_tpu"}

RUN_TINY = """
import json, sys
import torch
torch.set_num_threads(1)
from cardbench import run
from cardbench.tests import tiny
r = run.run_cell(tiny.cell(sys.argv[1]), 7, 0.2, False, device="cpu")
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""

IMPORT_REF = """
import json, pkgutil, importlib, sys
import cardbench.ref as ref
for m in pkgutil.walk_packages(ref.__path__, "cardbench.ref."):
    importlib.import_module(m.name)
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def top_level_modules(code, *args):
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    out = subprocess.run([sys.executable, "-c", code, *args], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


@pytest.mark.parametrize("kind", ["fcaf3d_train", "fcaf3d_eval",
                                  "votenet_train"])
def test_a_cells_run_imports_nothing_of_jax(kind):
    mods = top_level_modules(RUN_TINY, kind)
    assert "fcaf3d_tpu_torch" in mods  # the run did drive the port
    assert not mods & JAX_SIDE, sorted(mods & JAX_SIDE)


def test_the_reference_imports_nothing_of_the_port():
    mods = top_level_modules(IMPORT_REF)
    assert "cardbench" in mods
    assert not mods & (JAX_SIDE | {"fcaf3d_tpu_torch"}), sorted(
        mods & (JAX_SIDE | {"fcaf3d_tpu_torch"}))


def test_the_run_refuses_a_jax_module():
    from cardbench import run
    sys.modules.setdefault("fcaf3d_tpu_fake_check", object())
    try:
        assert "fcaf3d_tpu" not in run.forbidden_modules()
        sys.modules["jaxlib.fake_check"] = object()
        assert run.forbidden_modules() == ["jaxlib"]
    finally:
        sys.modules.pop("jaxlib.fake_check", None)
        sys.modules.pop("fcaf3d_tpu_fake_check", None)
