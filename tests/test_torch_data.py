"""The port's copy of the JAX benchmark's scene generator
(`data.synth.synth_scene`, which `chip_smoke.py` uses) equals
`bench.synth_scene` exactly."""
import numpy as np
import pytest

import bench
from fcaf3d_tpu_torch.data.synth import synth_scene

# (points, extent): the smoke's ScanNet and SUN RGB-D scans at the default
# room, and the extents of the CPU tests and the smoke's tiny train step
CASES = [(50000, None), (20000, None), (4000, (0.6, 0.6, 0.3)),
         (2000, (0.3, 0.3, 0.15)), (1000, (0.4, 0.4, 0.2)),
         (3000, (2.0, 2.0, 1.4))]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("n,extent", CASES)
def test_synth_scene_equals_bench(seed, n, extent):
    kw = {} if extent is None else {"extent": extent}
    got = synth_scene(np.random.RandomState(seed), n, **kw)
    want = bench.synth_scene(np.random.RandomState(seed), n, **kw)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("sx,sy", [(1.0, 1.0), (640 / 730, 480 / 530)])
def test_sunrgbd_depth2img_equals_jax(seed, sx, sy):
    """The port's copy of `sunrgbd_depth2img` equals the JAX package's
    exactly, on random transposed intrinsics and rotations."""
    from fcaf3d_tpu.data.datasets import sunrgbd_depth2img as want_fn
    from fcaf3d_tpu_torch.data.calib import sunrgbd_depth2img

    rng = np.random.default_rng(seed)
    k = np.array([[rng.uniform(500, 600), 0, 0], [0, rng.uniform(500, 600), 0],
                  [rng.uniform(300, 360), rng.uniform(220, 260), 1]])
    q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
    calib = {"K": k.reshape(-1).tolist(), "Rt": q.astype(np.float32)}
    got = sunrgbd_depth2img(calib, sx, sy)
    want = want_fn(calib, sx, sy)
    assert got.dtype == want.dtype and got.shape == (3, 3)
    np.testing.assert_array_equal(got, want)
