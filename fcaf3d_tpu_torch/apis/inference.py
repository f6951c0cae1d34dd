"""Single-cloud inference API (port of `fcaf3d_tpu/apis/inference.py`)."""
from __future__ import annotations

import pickle
from typing import Optional

import numpy as np
import torch

from ..configs.fcaf3d import FCAF3DConfig
from ..models.detector import FCAF3D, infer_config
from ..models.fcaf3d_head import fcaf3d_get_bboxes
from ..params import init_variables, load_variables
from .test import detections_to_numpy


def init_detector(cfg: FCAF3DConfig, seed: int = 0,
                  params_file: Optional[str] = None,
                  device="cpu") -> FCAF3D:
    """Build a detector in eval mode on `device`, with the weights of a
    converted-checkpoint pickle (`{"params", "batch_stats"}` numpy tree in
    the flax layout, `tools/convert_checkpoint.py`) or, without one, the
    seeded numpy draw of `params.init_variables`."""
    model = FCAF3D(cfg, device=device)
    if params_file is not None:
        with open(params_file, "rb") as f:
            variables = pickle.load(f)  # a file this project's tools wrote
    else:
        variables = init_variables(cfg, seed)
    load_variables(model, variables)
    return model.eval()


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
