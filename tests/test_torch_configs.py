"""The port's other FCAF3D configurations held against the JAX package:
the configs themselves, the acquisition models that set their budgets
(copies of `tools/calibrate_budgets.py`'s generators), and the slice end
to end at miniature sizes with the features each config brings: rotated
boxes (`fcaf3d_tiny(with_yaw=True)` inference, a with-yaw nano train
step), three output scales and 2 cm voxels (`fcaf3d_nano` variants).
"""
import dataclasses
import importlib.util
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import head_batch
from fcaf3d_tpu import configs as jconfigs
from fcaf3d_tpu.apis.inference import inference_detector as j_inference
from fcaf3d_tpu.models.detector import FCAF3D as JFCAF3D
from fcaf3d_tpu_torch import configs as tconfigs
from fcaf3d_tpu_torch.apis import inference_detector, init_detector
from fcaf3d_tpu_torch.data import synth
from fcaf3d_tpu_torch.params import init_variables
from tests.test_torch_model import ATOL, EXTENT
from tests.test_torch_ops import jax_without_persistent_cache  # noqa: F401
from tests.test_torch_train import assert_step_matches, step_on_both_sides

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NEW_CONFIGS = ("fcaf3d_scannet_3scales", "fcaf3d_scannet_2scales",
               "fcaf3d_sunrgbd", "fcaf3d_s3dis")


def calibrate_budgets():
    """`tools/calibrate_budgets.py` as a module."""
    spec = importlib.util.spec_from_file_location(
        "calibrate_budgets", os.path.join(REPO, "tools",
                                          "calibrate_budgets.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_config_from_dict_matches_jax():
    """A JSON round-trip of each new config rebuilds it on both sides,
    unknown keys dropped and lists back to tuples."""
    for name in NEW_CONFIGS:
        d = dataclasses.asdict(getattr(tconfigs, name)())
        d = {k: list(v) if isinstance(v, tuple) else v for k, v in d.items()}
        d["not_a_field"] = 1
        got = tconfigs.config_from_dict(d)
        assert got == getattr(tconfigs, name)()
        assert dataclasses.asdict(got) == dataclasses.asdict(
            jconfigs.config_from_dict(d))


@pytest.mark.parametrize("seed", [0, 1])
def test_synth_room_and_sunrgbd_equal_the_tool(seed):
    """Same RandomState seed, same clouds, exactly: a room (default and
    given size) and a Kinect frame."""
    tool = calibrate_budgets()
    for fn, kw in [("synth_room", {"n_points": 5000}),
                   ("synth_room", {"n_points": 3000,
                                   "size": np.array([5.0, 6.0, 2.8])}),
                   ("synth_sunrgbd", {"n_points": 20000})]:
        got = getattr(synth, fn)(np.random.RandomState(seed), **kw)
        want = getattr(tool, fn)(np.random.RandomState(seed), **kw)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want, err_msg=fn)


def test_synth_s3dis_equals_the_tool(monkeypatch):
    """`synth_s3dis` equals the S3DIS cloud of the tool's `main()` (1M raw
    points sampled to 100k) for its seed: the tool runs one scene with its
    cascade replaced by a recorder."""
    tool = calibrate_budgets()
    clouds = []
    monkeypatch.setattr(tool, "cascade_counts",
                        lambda pts, voxel_size: clouds.append(pts) or {})
    monkeypatch.setattr(sys, "argv", ["calibrate_budgets.py", "--dataset",
                                      "s3dis", "--scenes", "1"])
    tool.main()
    assert len(clouds) == 1 and clouds[0].shape == (100000, 3)
    np.testing.assert_array_equal(
        synth.synth_s3dis(np.random.RandomState(0)), clouds[0])


def miniature(name):
    """(port config, JAX config) of a miniature with a new config's
    feature, and its scene extent."""
    if name == "tiny_with_yaw":
        return (tconfigs.fcaf3d_tiny(with_yaw=True),
                jconfigs.fcaf3d_tiny(with_yaw=True), EXTENT["fcaf3d_tiny"])
    change = {"nano_3scales": {"n_outs": 3},
              "nano_2cm": {"voxel_size": 0.02}}[name]
    return (dataclasses.replace(tconfigs.fcaf3d_nano(), **change),
            dataclasses.replace(jconfigs.fcaf3d_nano(), **change),
            EXTENT["fcaf3d_nano"])


@pytest.mark.parametrize("name", ["tiny_with_yaw", "nano_3scales",
                                  "nano_2cm"])
def test_inference_detector_matches_jax(name):
    """`init_detector` + `inference_detector` against the JAX package's
    `inference_detector` on one scan: the same non-empty detections, labels
    exact, boxes (yaw included) and scores within ATOL (1e-4); with
    rotated boxes, some yaws non-zero."""
    cfg, jcfg, extent = miniature(name)
    xyz, rgb = synth.synth_scene(np.random.RandomState(0), cfg.num_points,
                                 extent=extent)
    points = np.concatenate([xyz, rgb], axis=1)
    got, overflow = inference_detector(init_detector(cfg, device="cpu"),
                                       points)
    jvars = jax.tree_util.tree_map(jnp.asarray, init_variables(cfg, seed=0))
    want = j_inference(JFCAF3D(jcfg), jvars, points, jcfg, seed=0)
    assert len(got["scores_3d"]) == len(want["scores_3d"]) > 0
    np.testing.assert_array_equal(got["labels_3d"], want["labels_3d"])
    np.testing.assert_allclose(got["boxes_3d"], want["boxes_3d"], rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(got["scores_3d"], want["scores_3d"], rtol=0,
                               atol=ATOL)
    assert (np.abs(got["boxes_3d"][:, 6]) > 1e-3).any() == cfg.with_yaw


def test_with_yaw_train_step_matches_jax():
    """One training step at fcaf3d_nano with rotated boxes (8 regression
    outputs, Mobius yaw, yawed GT boxes), batch 2: as
    `test_train_step_losses_and_grads_match_jax` holds the axis-aligned
    step."""
    change = {"n_reg_outs": 8, "with_yaw": True}
    cfg = dataclasses.replace(tconfigs.fcaf3d_nano(), **change)
    jcfg = dataclasses.replace(jconfigs.fcaf3d_nano(), **change)
    batch = head_batch(torch, cfg, EXTENT["fcaf3d_nano"])
    assert (batch["gt_boxes"][batch["gt_valid"]][:, 6] != 0).all()
    assert_step_matches(*step_on_both_sides(cfg, jcfg, batch))
