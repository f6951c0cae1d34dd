"""The port's native evaluation IoU (`fcaf3d_tpu_torch/native/`) against the
JAX package's (`fcaf3d_tpu/native/`), on the CPU.

Both libraries are built from the same C++ with the same g++ flags, so the
port's float32 IoU is held bitwise to the JAX package's; against the numpy
IoU (the plain version, `FCAF3D_NATIVE=0`) within 1e-6 (float32 C++
against float64 numpy). The port's `indoor_eval` on its default (native)
path gives the JAX package's metric dict on its default (native) path. A
failed build raises with the compiler's output.
"""
import numpy as np
import pytest

from fcaf3d_tpu import native as jnative
from fcaf3d_tpu.core import eval as jeval
from fcaf3d_tpu_torch import native as tnative
from fcaf3d_tpu_torch.core import eval as teval
from tests.test_torch_platform import CLASSES, _rand_boxes

NUMPY_ATOL = 1e-6


def _pairs(rotated, seed, n=60, m=50):
    rng = np.random.default_rng(seed)
    a, b = _rand_boxes(rng, n, rotated), _rand_boxes(rng, m, rotated)
    b[:5] = a[:5]  # identical pairs: IoU 1
    b[5:8] = a[5:8] * np.float32(1.0001)  # near-identical pairs
    return a, b


@pytest.mark.parametrize("rotated", [False, True])
def test_native_iou_bitwise_jax_native(rotated):
    """The port's library gives bitwise the JAX package's float32 IoU; the
    port's `pairwise_iou_3d_np` returns it as float64 and lies within
    NUMPY_ATOL of the numpy IoU."""
    a, b = _pairs(rotated, 20 + int(rotated))
    want = jnative.pairwise_iou_3d(a, b)
    assert want is not None, "the JAX package's native IoU did not build"
    got = tnative.pairwise_iou_3d(a, b)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    dispatched = teval.pairwise_iou_3d_np(a, b)
    assert dispatched.dtype == np.float64
    np.testing.assert_array_equal(dispatched, want.astype(np.float64))
    np.testing.assert_allclose(dispatched, teval._pairwise_iou_3d_numpy(a, b),
                               rtol=0, atol=NUMPY_ATOL)
    assert (np.diag(dispatched[:5, :5]) > 1 - 1e-6).all()
    assert teval.pairwise_iou_3d_np(a[:0], b).shape == (0, len(b))
    assert teval.pairwise_iou_3d_np(a, b[:0]).shape == (len(a), 0)


def test_native_switch_selects_numpy(monkeypatch):
    """`FCAF3D_NATIVE=0` (read at each call) runs the numpy IoU and never
    touches the library."""
    a, b = _pairs(True, 3)

    def refuse():
        raise AssertionError("the library was loaded")

    monkeypatch.setenv("FCAF3D_NATIVE", "0")
    monkeypatch.setattr(tnative, "load", refuse)
    np.testing.assert_array_equal(teval.pairwise_iou_3d_np(a, b),
                                  jeval._pairwise_iou_3d_numpy(a, b))


@pytest.mark.parametrize("fault", ["compile_error", "no_compiler"])
def test_failed_build_raises(fault, monkeypatch, tmp_path):
    """A source that does not compile, or no g++, raises RuntimeError (with
    the compiler's output); the IoU does not degrade to numpy."""
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "BUILD_DIR", str(tmp_path / "build"))
    if fault == "compile_error":
        src = tmp_path / "iou3d.cc"
        src.write_text("int broken( {\n")
        monkeypatch.setattr(tnative, "SOURCE", str(src))
        match = "g\\+\\+ failed(.|\n)*error"
    else:
        monkeypatch.setattr(tnative.shutil, "which", lambda name: None)
        match = "no g\\+\\+"
    a, b = _pairs(False, 4)
    with pytest.raises(RuntimeError, match=match):
        teval.pairwise_iou_3d_np(a, b)
    assert not (tmp_path / "build").exists() or not any(
        p.suffix == ".so" for p in (tmp_path / "build").iterdir())


@pytest.mark.parametrize("rotated", [False, True])
def test_indoor_eval_native_equals_jax_default(rotated):
    """The scenes of `test_torch_platform.py::test_indoor_eval_equals_jax`:
    the port's `indoor_eval` on its default (native) IoU gives the JAX
    package's metric dict on its default (native) IoU."""
    assert jnative.load() is not None
    rng = np.random.default_rng(10 + int(rotated))
    gts, dts = [], []
    for _ in range(6):
        g = _rand_boxes(rng, 5, rotated)
        gl = rng.integers(0, 4, 5)
        d = np.concatenate([g + rng.normal(0, 0.1, g.shape).astype(
            np.float32), _rand_boxes(rng, 4, rotated)])
        gts.append({"gt_boxes_3d": g, "gt_labels_3d": gl})
        dts.append({"boxes_3d": d, "scores_3d": rng.uniform(0, 1, len(d)),
                    "labels_3d": np.concatenate([gl, rng.integers(0, 5, 4)])})
    label2cat = dict(enumerate(CLASSES))
    got = teval.indoor_eval(gts, dts, (0.25, 0.5), label2cat)
    want = jeval.indoor_eval(gts, dts, (0.25, 0.5), label2cat)
    assert got == want and got["mAP_0.25"] > 0
