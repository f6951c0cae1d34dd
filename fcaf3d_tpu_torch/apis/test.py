"""Evaluation API (port of `fcaf3d_tpu/apis/test.py`): run the detector over
a dataset, with or without flip test-time augmentation, and compute indoor
mAP (the reference's `single_gpu_test` + `dataset.evaluate`; sharded over
a data-parallel group, its `multi_gpu_test`)."""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from ..configs.fcaf3d import FCAF3DConfig
from ..core.eval import indoor_eval
from ..core.merge_augs import merge_aug_detections
from ..core.visualizer import show_result
from ..data.loader import collate
from ..data.pipelines import Compose, GlobalAlignment, PointSample
from ..models.detector import FCAF3D, infer_config
from ..models.fcaf3d_head import Detections, fcaf3d_get_bboxes
from ..models.votenet import VoteDetections
from ..parallel.comm import Group, all_gather_object, rank, world
from ..utils import tracing


@tracing.spanned("to_numpy")
def detections_to_numpy(dets: Union[Detections, VoteDetections],
                        sample_idx: int) -> Dict[str, np.ndarray]:
    """Strip padding from one sample of a batched `Detections` or
    `VoteDetections`."""
    keep = dets.valid[sample_idx].cpu().numpy()
    return {
        "boxes_3d": dets.boxes[sample_idx].cpu().numpy()[keep],
        "scores_3d": dets.scores[sample_idx].cpu().numpy()[keep],
        "labels_3d": dets.labels[sample_idx].cpu().numpy()[keep],
    }


FLIP_TTA = (
    {},
    {"flip_horizontal": True},
    {"flip_vertical": True},
    {"flip_horizontal": True, "flip_vertical": True},
)


def detect_batch(model: FCAF3D, cfg: FCAF3DConfig, points: np.ndarray,
                 batch: dict) -> Detections:
    """The forward and `fcaf3d_get_bboxes` (at `cfg`'s test settings) of a
    collated batch on the model's device, with `points` in place of the
    batch's."""
    device = next(model.parameters()).device
    outs, _ = model(torch.as_tensor(points, device=device),
                    torch.as_tensor(batch["colors"], device=device),
                    torch.as_tensor(batch["valid"], device=device))
    return fcaf3d_get_bboxes(outs, infer_config(cfg))


def aug_test_batch(model: FCAF3D, batch: dict, cfg: FCAF3DConfig,
                   augs: Sequence[dict], rotated: bool) -> List[dict]:
    """Run one forward per flip augmentation on a collated batch and merge
    each sample's detections (the reference's `aug_test` +
    `merge_aug_bboxes_3d`). Returns a list of per-sample numpy detection
    dicts."""
    per_aug = []
    for aug in augs:
        pts = np.array(batch["points"])
        if aug.get("flip_horizontal"):
            pts[..., 0] = -pts[..., 0]
        if aug.get("flip_vertical"):
            pts[..., 1] = -pts[..., 1]
        per_aug.append(detect_batch(model, cfg, pts, batch))

    out = []
    for j in range(batch["points"].shape[0]):
        boxes, scores, labels, keep = merge_aug_detections(
            [d.boxes[j] for d in per_aug], [d.scores[j] for d in per_aug],
            [d.labels[j] for d in per_aug], [d.valid[j] for d in per_aug],
            list(augs), iou_thr=cfg.iou_thr, rotated=rotated)
        k = keep.cpu().numpy()
        out.append({"boxes_3d": boxes.cpu().numpy()[k],
                    "scores_3d": scores.cpu().numpy()[k],
                    "labels_3d": labels.cpu().numpy()[k]})
    return out


@torch.inference_mode()
def evaluate_dataset(model: FCAF3D, dataset, cfg: FCAF3DConfig,
                     batch_size: int = 1, seed: int = 0,
                     iou_thresholds=(0.25, 0.5),
                     max_scenes: Optional[int] = None, tta: bool = False,
                     show_dir: Optional[str] = None,
                     group: Optional[Group] = None) -> Dict[str, float]:
    """Run inference over `dataset` (test-mode pipeline; scene i drawn with
    `default_rng([seed, i])`) in batches on the model's device and compute
    mAP/mAR with `indoor_eval`.

    The forward runs in eval mode (the folded BN); the model's mode is
    restored afterwards. tta=True runs the 4 BEV flip combinations per
    scene and merges the inverted detections with class-wise NMS
    (`MultiScaleFlipAug3D` + `aug_test`). show_dir: dump each scene's
    points and pred / GT wireframes as .obj files.

    With a data-parallel `group` (the JAX function's `mesh=`) every rank
    calls this; `batch_size` is the global batch, a multiple of the world
    size W. Rank r runs rows [r B / W, (r + 1) B / W) of each global batch
    (the last one padded with copies of its last scene, whose detections
    are dropped); the scenes' records are gathered to every rank in scene
    order and every rank returns the single process's metrics."""
    w, r = world(group), rank(group)
    if batch_size % w:
        raise ValueError(f"batch_size {batch_size} must be a multiple of "
                         f"the {w} ranks")
    local = batch_size // w
    records = []  # (scene, detections, GT) of this rank's scenes
    was_training = model.training
    model.eval()
    try:
        n = len(dataset) if max_scenes is None else min(max_scenes,
                                                         len(dataset))
        for lo in range(0, n, batch_size):
            idxs = list(range(lo, min(lo + batch_size, n)))
            if group is not None:
                idxs += idxs[-1:] * (batch_size - len(idxs))
                idxs = idxs[r * local:(r + 1) * local]
            real = [lo + r * local + j < n for j in range(len(idxs))]
            samples = [dataset(i, np.random.default_rng([seed, i]))
                       for i in idxs]
            batch = collate(samples, cfg.num_points, cfg.max_gt_boxes)
            with tracing.item():
                if tta:
                    dts = aug_test_batch(model, batch, cfg, FLIP_TTA,
                                         rotated=cfg.with_yaw)
                else:
                    dets = detect_batch(model, cfg, batch["points"], batch)
                    dts = [detections_to_numpy(dets, j)
                           for j in range(len(samples))]
            for i, s, dt, keep in zip(idxs, samples, dts, real):
                if not keep:
                    continue
                records.append((i, dt, {"gt_boxes_3d": s["gt_boxes"],
                                        "gt_labels_3d": s["gt_labels"]}))
                if show_dir is not None:
                    show_result(s["points"][:, :3], dt["boxes_3d"],
                                np.asarray(s["gt_boxes"]).reshape(-1, 7),
                                show_dir, f"scene_{i:05d}")
    finally:
        model.train(was_training)
    records = sorted((rec for part in all_gather_object(records, group)
                      for rec in part), key=lambda rec: rec[0])
    label2cat = ({i: c for i, c in enumerate(dataset.classes)}
                 if hasattr(dataset, "classes") else {})
    return indoor_eval([gt for _, _, gt in records],
                       [dt for _, dt, _ in records], iou_thresholds,
                       label2cat)


def make_test_pipeline(cfg: FCAF3DConfig, align: bool = True) -> Compose:
    """Deterministic test pipeline: align (ScanNet) + point sample. The
    reference's TTA wrapper keeps random flip/sample at test time for the
    5x5 protocol; a fixed seed per scene makes the runs reproducible."""
    ts = [GlobalAlignment()] if align else []
    ts.append(PointSample(cfg.num_points))
    return Compose(ts)
