"""VOC-style 2D detection mAP (xyxy boxes): a copy of
`fcaf3d_tpu/core/eval2d.py`, held equal to it by a test.

Small evaluator for the ImVoteNet stage-1 image branch: the reference
relies on a COCO-pretrained Faster R-CNN and never evaluates it in-repo;
this framework trains its own 2D detector (`models/detector2d.py`), so it
needs a measured accuracy number. Same greedy-matching/area-AP semantics
as `core/eval.py`'s indoor_eval, in 2D.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np


def iou_xyxy(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """[N, 4] x [M, 4] -> [N, M] IoU."""
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a = np.prod(np.clip(a[:, 2:] - a[:, :2], 0, None), axis=1)
    area_b = np.prod(np.clip(b[:, 2:] - b[:, :2], 0, None), axis=1)
    union = area_a[:, None] + area_b[None, :] - inter
    return inter / np.maximum(union, 1e-9)


def _average_precision(recall: np.ndarray, precision: np.ndarray) -> float:
    """Area-mode AP (matches indoor_eval's `average_precision`)."""
    mrec = np.concatenate([[0.0], recall, [1.0]])
    mpre = np.concatenate([[0.0], precision, [0.0]])
    for i in range(len(mpre) - 1, 0, -1):
        mpre[i - 1] = max(mpre[i - 1], mpre[i])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


def eval_det_2d(
    gt_annos: Sequence[dict],
    dt_annos: Sequence[dict],
    iou_thr: float = 0.5,
    n_classes: int = None,
) -> Dict[str, float]:
    """Per-class greedy-matched AP at `iou_thr`.

    Args:
        gt_annos: per image {"boxes": [G, 4] xyxy, "labels": [G]}.
        dt_annos: per image {"boxes": [D, 4], "scores": [D], "labels": [D]}.

    Returns:
        {"mAP": float, "AP_<c>": float per class with GT}.
    """
    labels = sorted({int(l) for g in gt_annos for l in np.asarray(g["labels"])})
    if n_classes is not None:
        labels = list(range(n_classes))
    aps = {}
    for c in labels:
        scores: List[float] = []
        tp: List[int] = []
        n_gt = 0
        for g, d in zip(gt_annos, dt_annos):
            gmask = np.asarray(g["labels"]) == c
            gboxes = np.asarray(g["boxes"], np.float32)[gmask]
            n_gt += len(gboxes)
            dmask = np.asarray(d["labels"]) == c
            dboxes = np.asarray(d["boxes"], np.float32)[dmask]
            dscores = np.asarray(d["scores"], np.float32)[dmask]
            order = np.argsort(-dscores)
            dboxes, dscores = dboxes[order], dscores[order]
            matched = np.zeros(len(gboxes), bool)
            ious = iou_xyxy(dboxes, gboxes) if len(gboxes) and len(dboxes) \
                else np.zeros((len(dboxes), 0))
            for i in range(len(dboxes)):
                scores.append(float(dscores[i]))
                j = int(np.argmax(ious[i])) if ious.shape[1] else -1
                if j >= 0 and ious[i, j] >= iou_thr and not matched[j]:
                    matched[j] = True
                    tp.append(1)
                else:
                    tp.append(0)
        if n_gt == 0:
            continue
        if not scores:
            aps[c] = 0.0
            continue
        order = np.argsort(-np.asarray(scores))
        tp_arr = np.asarray(tp)[order]
        ctp = np.cumsum(tp_arr)
        recall = ctp / n_gt
        precision = ctp / np.arange(1, len(tp_arr) + 1)
        aps[c] = _average_precision(recall, precision)
    out = {f"AP_{c}": v for c, v in aps.items()}
    out["mAP"] = float(np.mean(list(aps.values()))) if aps else 0.0
    return out
