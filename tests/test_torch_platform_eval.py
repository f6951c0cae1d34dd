"""`evaluate_dataset` of the port (CPU, f32) against the JAX package's on
the same numpy variables (`fcaf3d_tiny`), with and without the 4-way flip
TTA, at batch 1 and batch 3 over 4 val scenes (a ragged last batch).

Tolerances: per-scene detections as `tests/test_torch_model.py` holds them
(labels exact, boxes and scores within atol 1e-4); metric dicts equal,
with the JAX side's IoU on its numpy path, as the port's.
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke
from fcaf3d_tpu import configs as jconfigs
from fcaf3d_tpu import data as jdata
from fcaf3d_tpu.apis import test as jtest
from fcaf3d_tpu.models.detector import FCAF3D as JFCAF3D
from fcaf3d_tpu_torch import configs as tconfigs
from fcaf3d_tpu_torch.apis import init_detector
from fcaf3d_tpu_torch.apis.test import evaluate_dataset
from fcaf3d_tpu_torch.params import init_variables
from tests.test_torch_ops import jax_without_persistent_cache  # noqa: F401
from tests.test_torch_platform import write_mini_root
from tests.test_torch_platform_train import (  # noqa: F401
    one_intra_op_thread, val_set)

ATOL = 1e-4


@pytest.fixture(scope="module")
def eval_pair(tmp_path_factory):
    """fcaf3d_tiny on both sides from the same numpy variables, and a val
    split whose GT comes from the port's detections."""
    root = write_mini_root(tmp_path_factory.mktemp("val"), n_train=1,
                           n_val=4)
    cfg, jcfg = tconfigs.fcaf3d_tiny(), jconfigs.fcaf3d_tiny()
    model = init_detector(cfg, device="cpu")
    ann = os.path.join(root, "scannet_infos_val.pkl")
    chip_smoke.gt_from_detections(root, ann, ann, cfg, model)
    jvars = jax.tree_util.tree_map(jnp.asarray, init_variables(cfg, seed=0))
    return root, cfg, jcfg, model, jvars


@pytest.mark.parametrize("tta,batch_size", [(False, 1), (True, 3)])
def test_evaluate_dataset_matches_jax(eval_pair, tta, batch_size,
                                      monkeypatch, tmp_path):
    """Per-scene detections within atol 1e-4 (labels exact) and equal
    metric dicts; the JAX side's IoU on its numpy path, as the port's."""
    import fcaf3d_tpu.native

    monkeypatch.setattr(fcaf3d_tpu.native, "pairwise_iou_3d",
                        lambda a, b: None)
    root, cfg, jcfg, model, jvars = eval_pair
    got_dets, want_dets = [], []

    def recording(module, into):
        real = module.indoor_eval

        def record(gt, dt, *a):
            into.extend(dt)
            return real(gt, dt, *a)
        monkeypatch.setattr(module, "indoor_eval", record)

    recording(sys.modules["fcaf3d_tpu_torch.apis.test"], got_dets)
    recording(jtest, want_dets)
    show = str(tmp_path / "show")
    got = evaluate_dataset(model, val_set(root, cfg), cfg,
                           batch_size=batch_size, tta=tta, show_dir=show)
    jval = val_set(root, jcfg, jdata, jtest.make_test_pipeline)
    want = jtest.evaluate_dataset(JFCAF3D(jcfg), jvars, jval, jcfg,
                                  batch_size=batch_size, tta=tta)
    assert got == want
    assert 0 < got["mAP_0.25"] and got["mAR_0.50"] < 1
    assert len(got_dets) == len(want_dets) == 4
    for g, w in zip(got_dets, want_dets):
        assert len(g["scores_3d"]) == len(w["scores_3d"]) > 0
        np.testing.assert_array_equal(g["labels_3d"], w["labels_3d"])
        for k in ("boxes_3d", "scores_3d"):
            np.testing.assert_allclose(g[k], w[k], rtol=0, atol=ATOL)
    assert len(os.listdir(show)) == 3 * 4
