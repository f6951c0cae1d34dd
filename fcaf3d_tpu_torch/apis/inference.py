"""Single-cloud inference API (port of `fcaf3d_tpu/apis/inference.py`):
FCAF3D, VoteNet-v2 and the bin-based VoteNet-v1."""
from __future__ import annotations

import pickle
from typing import Optional

import numpy as np
import torch

from ..configs.fcaf3d import FCAF3DConfig
from ..configs.votenet import VoteNetConfig
from ..data.points import add_height
from ..models.detector import FCAF3D, infer_config
from ..models.fcaf3d_head import fcaf3d_get_bboxes
from ..models.votenet import VoteNet, votenet_get_bboxes
from ..models.votenet_v1 import build_votenet
from ..params import init_variables, init_votenet_variables, load_variables
from .test import detections_to_numpy


def init_detector(cfg: FCAF3DConfig, seed: int = 0,
                  params_file: Optional[str] = None,
                  device="cuda") -> FCAF3D:
    """Build a detector in eval mode on `device`, with the weights of a
    converted-checkpoint pickle (`{"params", "batch_stats"}` numpy tree in
    the flax layout, `tools/convert_checkpoint.py`) or, without one, the
    seeded numpy draw of `params.init_variables`."""
    model = FCAF3D(cfg, device=device)
    load_variables(model, _variables(params_file,
                                     lambda: init_variables(cfg, seed)))
    return model.eval()


def _variables(params_file, draw):
    if params_file is None:
        return draw()
    with open(params_file, "rb") as f:
        return pickle.load(f)  # a file this project's tools wrote


@torch.inference_mode()
def inference_detector(model: FCAF3D, points: np.ndarray, seed: int = 0):
    """Detect objects in one point cloud [N, >=6] (xyz + rgb).

    Samples `cfg.num_points` points (with replacement when the cloud is
    smaller), runs the forward + NMS on the model's device, and returns
    ({boxes_3d, scores_3d, labels_3d} numpy arrays with bottom-centred
    box7, overflow {name: int} of voxels the static budgets dropped)."""
    cfg = model.cfg
    device = next(model.parameters()).device
    rng = np.random.default_rng(seed)
    n = len(points)
    idx = rng.choice(n, cfg.num_points, replace=n < cfg.num_points)
    pts = points[idx]
    batch_pts = torch.as_tensor(pts[None, :, :3].astype(np.float32),
                                device=device)
    batch_col = torch.as_tensor(pts[None, :, 3:6].astype(np.float32),
                                device=device)
    valid = torch.ones((1, cfg.num_points), dtype=torch.bool, device=device)
    outs, overflow = model(batch_pts, batch_col, valid)
    dets = fcaf3d_get_bboxes(outs, infer_config(cfg))
    return (detections_to_numpy(dets, 0),
            {k: int(v[0]) for k, v in overflow.items()})


def init_votenet(cfg: VoteNetConfig, seed: int = 0,
                 params_file: Optional[str] = None,
                 device="cuda", coder=None) -> VoteNet:
    """Build a VoteNet in eval mode on `device`: `VoteNet(cfg)` for a v2
    config, `VoteNetV1(cfg, coder)` for a v1 config (whose box coder,
    `sunrgbd_coder()` or `scannet_coder()`, is required), with the weights
    of a converted-checkpoint pickle (flax layout) or, without one, the
    seeded numpy draw of `params.init_votenet_variables`."""
    model = build_votenet(cfg, coder, device=device)
    load_variables(model, _variables(
        params_file, lambda: init_votenet_variables(cfg, seed, coder)))
    return model.eval()


def votenet_inputs(points: np.ndarray, num_points: int,
                   seed: int = 0) -> np.ndarray:
    """The VoteNet input of one point cloud [N, >=3] (xyz first): the height
    column appended (`add_height`), then `num_points` points sampled (with
    replacement when the cloud is smaller) -> [num_points, 4] f32."""
    rng = np.random.default_rng(seed)
    pts = add_height(np.asarray(points, np.float32)[:, :3])
    return pts[rng.choice(len(pts), num_points,
                          replace=len(pts) < num_points)]


@torch.inference_mode()
def inference_votenet(model: VoteNet, points: np.ndarray, seed: int = 0,
                      sample_mod: Optional[str] = None):
    """Detect objects in one point cloud [N, >=3] (xyz first) with
    VoteNet-v2 or v1, as the JAX package's VoteNet path does:
    `votenet_inputs`,
    forward, `votenet_get_bboxes` with the config's thresholds.

    `sample_mod` defaults to the test config's `cfg.sample_mod_test`
    ("seed"); "vote" is the module default.

    Returns {boxes_3d, scores_3d, labels_3d} numpy arrays (bottom-centred
    box7) with padding stripped."""
    cfg = model.cfg
    device = next(model.parameters()).device
    x = torch.as_tensor(votenet_inputs(points, cfg.num_points, seed)[None],
                        device=device)
    preds = model(x, sample_mod=sample_mod or cfg.sample_mod_test)
    dets = votenet_get_bboxes(preds, x, cfg.n_classes, nms_thr=cfg.nms_thr,
                              score_thr=cfg.score_thr,
                              per_class_proposal=cfg.per_class_proposal)
    return detections_to_numpy(dets, 0)
