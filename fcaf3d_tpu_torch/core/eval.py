"""Indoor detection evaluation (VOC-style mAP/mAR), host-side numpy: a copy
of `fcaf3d_tpu/core/eval.py`, held equal to it by a test.

The reference's `indoor_eval` (mmdet3d `core/evaluation/indoor_eval.py`):
per-class, per-scene greedy matching at multiple IoU thresholds with
area-mode AP. IoU between detections and GT is full 3D IoU of (possibly
rotated) boxes, vectorized numpy polygon clipping (the candidate-vertex
construction of `core.rotated_iou`, the tensor twin). The JAX package
dispatches the IoU to a host C++ op when one builds; the port computes it
in numpy only (the JAX package's numpy path, `_pairwise_iou_3d_numpy`).

Box convention: bottom-centered box7 (cx, cy, cz_bottom, dx, dy, dz, yaw),
the framework canonical layout.
"""
from __future__ import annotations

from collections import defaultdict

import numpy as np


# ---------------------------------------------------------------------------
# numpy rotated 3D IoU (eval only; the tensor twin is core.rotated_iou)
# ---------------------------------------------------------------------------

def _bev_corners_np(boxes5):
    x, y, dx, dy, a = (boxes5[..., i] for i in range(5))
    sx = np.array([0.5, -0.5, -0.5, 0.5])
    sy = np.array([0.5, 0.5, -0.5, -0.5])
    cx = sx * dx[..., None]
    cy = sy * dy[..., None]
    c, s = np.cos(a)[..., None], np.sin(a)[..., None]
    # clockwise-for-positive convention, matching core.geometry.bev_corners
    rx = cx * c + cy * s + x[..., None]
    ry = -cx * s + cy * c + y[..., None]
    return np.stack([rx, ry], axis=-1)


def _quad_inter_area_np(c1, c2):
    """Intersection area of convex quads c1, c2: [..., 4, 2] -> [...]."""
    eps = 1e-8
    p1, q1 = c1, np.roll(c1, -1, axis=-2)
    p2, q2 = c2, np.roll(c2, -1, axis=-2)
    a = p1[..., :, None, :]
    b = q1[..., :, None, :]
    c = p2[..., None, :, :]
    d = q2[..., None, :, :]
    r, s = b - a, d - c
    denom = r[..., 0] * s[..., 1] - r[..., 1] * s[..., 0]
    ok = np.abs(denom) > eps
    denom = np.where(ok, denom, 1.0)
    qp = c - a
    t = (qp[..., 0] * s[..., 1] - qp[..., 1] * s[..., 0]) / denom
    u = (qp[..., 0] * r[..., 1] - qp[..., 1] * r[..., 0]) / denom
    valid = ok & (t >= 0) & (t <= 1) & (u >= 0) & (u <= 1)
    inter = a + t[..., None] * r
    lead = c1.shape[:-2]
    inter = inter.reshape(lead + (16, 2))
    valid = valid.reshape(lead + (16,))

    def corners_in(pts, quad):
        o = quad[..., None, :, :]
        nx = np.roll(quad, -1, axis=-2)[..., None, :, :]
        p = pts[..., :, None, :]
        cr = (nx[..., 0] - o[..., 0]) * (p[..., 1] - o[..., 1]) - (
            nx[..., 1] - o[..., 1]
        ) * (p[..., 0] - o[..., 0])
        return np.all(cr >= -eps, axis=-1) | np.all(cr <= eps, axis=-1)

    pts = np.concatenate([inter, c1, c2], axis=-2)
    val = np.concatenate([valid, corners_in(c1, c2), corners_in(c2, c1)], axis=-1)

    num = val.sum(axis=-1)
    center = (pts * val[..., None]).sum(axis=-2) / np.maximum(num, 1)[..., None]
    rel = pts - center[..., None, :]
    ang = np.where(val, np.arctan2(rel[..., 1], rel[..., 0]), 1e9)
    order = np.argsort(ang, axis=-1)
    spts = np.take_along_axis(pts, order[..., None], axis=-2)
    idx = np.arange(24)
    nxt = np.where(idx + 1 >= num[..., None], 0, idx + 1)
    npts = np.take_along_axis(spts, nxt[..., None], axis=-2)
    cross = spts[..., 0] * npts[..., 1] - spts[..., 1] * npts[..., 0]
    area = 0.5 * np.abs(np.where(idx < num[..., None], cross, 0.0).sum(axis=-1))
    return np.where(num >= 3, area, 0.0)


def pairwise_iou_3d_np(boxes1, boxes2):
    """[N, M] 3D IoU of bottom-centered box7 arrays (float64)."""
    n, m = len(boxes1), len(boxes2)
    if n == 0 or m == 0:
        return np.zeros((n, m))
    boxes1, boxes2 = np.asarray(boxes1), np.asarray(boxes2)
    b1 = np.broadcast_to(boxes1[:, None, :], (n, m, 7)).copy()
    b2 = np.broadcast_to(boxes2[None, :, :], (n, m, 7)).copy()
    inter2d = _quad_inter_area_np(
        _bev_corners_np(b1[..., [0, 1, 3, 4, 6]]),
        _bev_corners_np(b2[..., [0, 1, 3, 4, 6]]),
    )
    zmin1, zmax1 = b1[..., 2], b1[..., 2] + b1[..., 5]
    zmin2, zmax2 = b2[..., 2], b2[..., 2] + b2[..., 5]
    zo = np.clip(np.minimum(zmax1, zmax2) - np.maximum(zmin1, zmin2), 0, None)
    inter = inter2d * zo
    v1 = b1[..., 3] * b1[..., 4] * b1[..., 5]
    v2 = b2[..., 3] * b2[..., 4] * b2[..., 5]
    return inter / np.maximum(v1 + v2 - inter, 1e-8)


# ---------------------------------------------------------------------------
# VOC-style AP
# ---------------------------------------------------------------------------

def average_precision(recalls, precisions, mode="area"):
    """Area/11-point AP, mirroring `indoor_eval.py:7-52` exactly."""
    recalls = recalls[np.newaxis, :] if recalls.ndim == 1 else recalls
    precisions = precisions[np.newaxis, :] if precisions.ndim == 1 else precisions
    num_scales = recalls.shape[0]
    ap = np.zeros(num_scales, dtype=np.float32)
    if mode == "area":
        zeros = np.zeros((num_scales, 1), dtype=recalls.dtype)
        ones = np.ones((num_scales, 1), dtype=recalls.dtype)
        mrec = np.hstack((zeros, recalls, ones))
        mpre = np.hstack((zeros, precisions, zeros))
        for i in range(mpre.shape[1] - 1, 0, -1):
            mpre[:, i - 1] = np.maximum(mpre[:, i - 1], mpre[:, i])
        for i in range(num_scales):
            ind = np.where(mrec[i, 1:] != mrec[i, :-1])[0]
            ap[i] = np.sum((mrec[i, ind + 1] - mrec[i, ind]) * mpre[i, ind + 1])
    elif mode == "11points":
        for i in range(num_scales):
            for thr in np.arange(0, 1 + 1e-3, 0.1):
                precs = precisions[i, recalls[i, :] >= thr]
                ap[i] += precs.max() if precs.size > 0 else 0
        ap /= 11
    else:
        raise ValueError(mode)
    return ap


def _eval_det_cls(pred, gt, iou_thresholds):
    """Greedy matching for one class (mirrors `eval_det_cls`, `indoor_eval.py:55-160`).

    Args:
        pred: {scene_id: [(box7, score)]}
        gt: {scene_id: [box7]}
        iou_thresholds: list of floats.

    Returns:
        list of (recall_curve, precision_curve, ap) per threshold.
    """
    class_recs = {}
    npos = 0
    for scene_id in gt:
        boxes = np.asarray(gt[scene_id]).reshape(-1, 7)
        det = [[False] * len(boxes) for _ in iou_thresholds]
        npos += len(boxes)
        class_recs[scene_id] = {"bbox": boxes, "det": det}
    for scene_id in pred:
        if scene_id not in class_recs:
            class_recs[scene_id] = {
                "bbox": np.zeros((0, 7)),
                "det": [[] for _ in iou_thresholds],
            }

    image_ids, confidence, all_boxes = [], [], []
    for scene_id in pred:
        for box, score in pred[scene_id]:
            image_ids.append(scene_id)
            confidence.append(score)
            all_boxes.append(box)
    confidence = np.asarray(confidence)
    sorted_ind = np.argsort(-confidence)
    image_ids = [image_ids[i] for i in sorted_ind]
    all_boxes = [all_boxes[i] for i in sorted_ind]

    nd = len(image_ids)
    # one det-x-gt IoU matrix per scene (instead of a per-detection call:
    # the matrix is where the time goes, and batching it per scene lets
    # the vectorized numpy amortize)
    iou_rows = [None] * nd
    scene_det_idx = {}
    for d in range(nd):
        scene_det_idx.setdefault(image_ids[d], []).append(d)
    for sid, dlist in scene_det_idx.items():
        gt_boxes = class_recs[sid]["bbox"]
        if len(gt_boxes) == 0:
            continue
        det_boxes = np.asarray([all_boxes[d] for d in dlist]).reshape(-1, 7)
        mat = pairwise_iou_3d_np(det_boxes, gt_boxes)
        for r, d in enumerate(dlist):
            iou_rows[d] = mat[r]

    tp = np.zeros((len(iou_thresholds), nd))
    fp = np.zeros((len(iou_thresholds), nd))
    for d in range(nd):
        rec = class_recs[image_ids[d]]
        if iou_rows[d] is not None:
            ious = iou_rows[d]
            jmax = int(np.argmax(ious))
            iou_max = float(ious[jmax])
        else:
            iou_max, jmax = -np.inf, -1
        for t, thr in enumerate(iou_thresholds):
            if iou_max > thr and not rec["det"][t][jmax]:
                tp[t, d] = 1.0
                rec["det"][t][jmax] = True
            else:
                fp[t, d] = 1.0

    out = []
    for t in range(len(iou_thresholds)):
        fp_c = np.cumsum(fp[t])
        tp_c = np.cumsum(tp[t])
        recall = tp_c / float(max(npos, 1))
        precision = tp_c / np.maximum(tp_c + fp_c, np.finfo(np.float64).eps)
        ap = average_precision(recall, precision)[0]
        out.append((recall, precision, ap))
    return out


def indoor_eval(gt_annos, dt_annos, iou_thresholds, label2cat):
    """Indoor mAP/mAR (mirrors `indoor_eval`, `indoor_eval.py:203-309`).

    Args:
        gt_annos: list per scene: {"gt_boxes_3d": [G, 7] np, "gt_labels_3d": [G] np}.
        dt_annos: list per scene: {"boxes_3d": [D, 7] np, "scores_3d": [D] np,
            "labels_3d": [D] np}.
        iou_thresholds: e.g. (0.25, 0.5).
        label2cat: {label_int: class_name}.

    Returns:
        flat dict: {f"{cat}_AP_{thr}": v, f"mAP_{thr}": v, f"{cat}_rec_{thr}": v,
        f"mAR_{thr}": v}.
    """
    pred = defaultdict(lambda: defaultdict(list))
    gt = defaultdict(lambda: defaultdict(list))
    for img_id, det in enumerate(dt_annos):
        boxes = np.asarray(det["boxes_3d"]).reshape(-1, 7)
        labels = np.asarray(det["labels_3d"]).reshape(-1).astype(int)
        scores = np.asarray(det["scores_3d"]).reshape(-1)
        for box, score, label in zip(boxes, scores, labels):
            pred[label][img_id].append((box, float(score)))
    for img_id, anno in enumerate(gt_annos):
        boxes = np.asarray(anno["gt_boxes_3d"]).reshape(-1, 7)
        labels = np.asarray(anno["gt_labels_3d"]).reshape(-1).astype(int)
        for box, label in zip(boxes, labels):
            gt[label][img_id].append(box)
        # ensure every scene exists in gt maps of predicted classes
        for label in pred:
            _ = gt[label]

    ret = {}
    aps = defaultdict(list)
    recs = defaultdict(list)
    for label in sorted(gt.keys()):
        if len(gt[label]) == 0:
            continue
        results = _eval_det_cls(pred.get(label, {}), gt[label], iou_thresholds)
        cat = label2cat.get(label, str(label))
        for t, thr in enumerate(iou_thresholds):
            recall, _, ap = results[t]
            ret[f"{cat}_AP_{thr:.2f}"] = float(ap)
            rec_val = float(recall[-1]) if len(recall) else 0.0
            ret[f"{cat}_rec_{thr:.2f}"] = rec_val
            aps[thr].append(float(ap))
            recs[thr].append(rec_val)
    for thr in iou_thresholds:
        ret[f"mAP_{thr:.2f}"] = float(np.mean(aps[thr])) if aps[thr] else 0.0
        ret[f"mAR_{thr:.2f}"] = float(np.mean(recs[thr])) if recs[thr] else 0.0
    return ret
