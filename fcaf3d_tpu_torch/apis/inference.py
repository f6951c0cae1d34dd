"""Single-cloud inference API (port of `fcaf3d_tpu/apis/inference.py`):
FCAF3D, VoteNet-v2, the bin-based VoteNet-v1, and ImVoteNet with its 2D
detector."""
from __future__ import annotations

import pickle
from typing import Optional

import numpy as np
import torch

from ..configs.fcaf3d import FCAF3DConfig
from ..configs.votenet import VoteNetConfig
from ..data.points import add_height
from ..models.detector import FCAF3D, infer_config
from ..models.detector2d import Detector2D
from ..models.fcaf3d_head import fcaf3d_get_bboxes
from ..models.imvotenet import ImVoteNet
from ..models.votenet import VoteNet, votenet_get_bboxes
from ..models.votenet_v1 import build_votenet
from ..params import (
    init_detector2d_variables,
    init_imvotenet_variables,
    init_variables,
    init_votenet_variables,
    load_variables,
)
from ..train.checkpoint import restore_checkpoint
from .test import detections_to_numpy


def init_detector(cfg: FCAF3DConfig, seed: int = 0,
                  params_file: Optional[str] = None,
                  device="cuda", work_dir: Optional[str] = None) -> FCAF3D:
    """Build a detector in eval mode on `device`, with the weights of a
    converted-checkpoint pickle (`{"params", "batch_stats"}` numpy tree in
    the flax layout, `tools/convert_checkpoint.py`), of the latest
    checkpoint of a training run's `work_dir`, or, with neither, the
    seeded numpy draw of `params.init_variables`."""
    if params_file is not None and work_dir is not None:
        raise ValueError("init_detector takes params_file or work_dir, "
                         "not both")
    model = FCAF3D(cfg, device=device)
    if work_dir is not None:
        restore_checkpoint(work_dir, model)
    else:
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


def init_detector2d(n_classes: int = 10, width: int = 64, fpn_ch: int = 128,
                    seed: int = 0, params_file: Optional[str] = None,
                    device="cuda") -> Detector2D:
    """Build ImVoteNet's 2D detector in eval mode on `device`, with the
    weights of a pickle (`{"params"}` in the flax layout, as
    `tools/train_detector2d.py` writes) or, without one, the seeded draw of
    `params.init_detector2d_variables`."""
    model = Detector2D(n_classes, width, fpn_ch, device=device)
    load_variables(model, _variables(params_file, lambda: (
        init_detector2d_variables(n_classes, width, fpn_ch, seed))))
    return model.eval()


def init_imvotenet(cfg: VoteNetConfig, seed: int = 0,
                   params_file: Optional[str] = None, device="cuda",
                   num_sampled_seed: int = 1024,
                   max_imvote: int = 3) -> ImVoteNet:
    """Build ImVoteNet stage 2 at a VoteNet-v2 config in eval mode on
    `device`, with the weights of a pickle (flax layout, as
    `tools/train_imvotenet.py` writes) or, without one, the seeded draw of
    `params.init_imvotenet_variables`."""
    model = ImVoteNet(cfg, num_sampled_seed, max_imvote, device=device)
    load_variables(model, _variables(params_file, lambda: (
        init_imvotenet_variables(cfg, seed, num_sampled_seed, max_imvote))))
    return model.eval()


def imvotenet_inputs(points: np.ndarray, image: np.ndarray,
                     boxes_2d: np.ndarray, depth2img: np.ndarray,
                     num_points: int, seed: int, device):
    """The ImVoteNet inputs of one frame as batches of one on `device`:
    (points [1, num_points, 4] from `votenet_inputs`, image [1, H, W, 3],
    boxes2d [1, D, 6] with D >= 1, their valid mask [1, D], depth2img [1,
    3, 3]). `boxes_2d` may be empty, as an array or a list."""
    d = max(len(boxes_2d), 1)
    b2 = np.zeros((d, 6), np.float32)
    bv = np.zeros((d,), bool)
    if len(boxes_2d):
        b2[:len(boxes_2d)] = np.asarray(boxes_2d, np.float32)
        bv[:len(boxes_2d)] = True

    def dev(a, dtype=np.float32):
        return torch.as_tensor(np.asarray(a, dtype)[None], device=device)

    return (dev(votenet_inputs(points, num_points, seed)), dev(image),
            dev(b2), dev(bv, bool), dev(depth2img))


@torch.inference_mode()
def inference_imvotenet(model: ImVoteNet, points: np.ndarray,
                        image: np.ndarray, boxes_2d: np.ndarray,
                        depth2img: np.ndarray, num_points: int = 20000,
                        n_classes: int = 10, nms_thr: float = 0.25,
                        score_thr: float = 0.05, seed: int = 0):
    """Multi-modality (points + image) single-sample inference, as the JAX
    package's `inference_imvotenet`: the cloud [N, >=3] (xyz first) gets
    its height column, then `num_points` seeded samples; the 2D boxes [D,
    6] (x1, y1, x2, y2, conf, cls), from `extract_bboxes_2d` or GT, are
    padded to at least one row; the image [H, W, 3] is float RGB at the
    net's input size and depth2img the [3, 3] projection
    (`data.calib.sunrgbd_depth2img`) (`imvotenet_inputs`). Runs the joint
    tower alone, proposals sampled over the votes, then
    `votenet_get_bboxes` at its defaults.

    Returns {boxes_3d, scores_3d, labels_3d} numpy arrays (bottom-centred
    box7) with padding stripped."""
    x, images, b2, bv, d2i = imvotenet_inputs(
        points, image, boxes_2d, depth2img, num_points, seed,
        next(model.parameters()).device)
    preds = model(x, images, b2, bv, depth2img=d2i, towers=("joint",))
    dets = votenet_get_bboxes(preds["joint"], x, n_classes, nms_thr=nms_thr,
                              score_thr=score_thr)
    return detections_to_numpy(dets, 0)
