"""The numbers that decide `correct`: the port's readings against the
reference's, each held to its limit (`limits/<cell>.json`).

Training (the first steps of the timed step object, replayed by the
reference from the same weights and batches):
- `loss1_gap`: the first step's relative loss gap, |L - L_ref| / |L_ref|
  (the forward and the loss alone);
- `loss_gap`: the largest relative loss gap over the checked steps;
- `grad_gap`: the worst leaf's gap between the norms of the first
  gradient the optimizer took, |n - n_ref| / max(n_ref, the median
  leaf's n_ref), and `grad_gap_med` the median leaf's (steady where
  single leaves flip with ReLUs at random init);
- `change_gap`: the worst leaf's gap of the leaves' change over the
  checked steps. Leaves whose reference gradient is under a
  thousandth of the median leaf's (a Dense bias ahead of a train-mode
  BatchNorm has a zero gradient and moves under Adam by round-off alone)
  are left out of the change.

Detection (sampled requests of the window, against the reference on the
same batches): the gap of a detection from another is max(|score gap|,
1 - IoU), IoU of the axis-aligned 3D boxes.
- `det_gap_p99`: the 99th percentile of each of the port's detections'
  gap from the reference's nearest valid row of its class, over every
  row of every level (so before the top-k cuts, across which rounding
  may move a row): a wrong box or score in one detection a hundred;
- `det_lost_p90`: the 90th percentile of each of the reference's kept
  detections' gap from the port's nearest kept detection of its class
  (1 where there is none): scans or detections lost. An NMS decision
  that rounding tips leaves a detection's nearest partner at IoU ~0.5;
  such flips touch a few in a hundred of the port's detections and pass
  under the 90th percentile;
- `det_extra_p90`: the 90th percentile of each of the port's kept
  detections' gap from the reference's nearest kept detection of its
  class (1 where there is none): detections kept that the reference
  drops, as an NMS skipped, a score threshold ignored or a candidate cap
  cut too late keep them. `det_gap_p99` cannot see these, since each is
  still a valid row.
"""
from __future__ import annotations

from typing import Dict, List, Mapping

import numpy as np
import torch

GRAD_FLOOR = 1e-3  # of the median leaf's reference gradient norm


def train_readings(prog: dict, ref: dict) -> Dict[str, float]:
    losses = np.asarray(prog["losses"], np.float64)
    ref_losses = np.asarray(ref["losses"], np.float64)
    gaps = np.abs(losses - ref_losses) / np.abs(ref_losses)
    loss1_gap, loss_gap = float(gaps[0]), float(np.max(gaps))
    names = sorted(ref["grad"])
    g_ref = np.array([ref["grad"][n] for n in names])
    g = np.array([prog["grad"].get(n, 0.0) for n in names])
    g_med = float(np.median(g_ref))
    g_gaps = np.abs(g - g_ref) / np.maximum(g_ref, g_med)
    grad_gap, grad_gap_med = float(np.max(g_gaps)), float(np.median(g_gaps))
    moving = [n for n, v in zip(names, g_ref) if v >= GRAD_FLOOR * g_med]
    c_ref = np.array([ref["change"][n] for n in moving])
    c = np.array([prog["change"][n] for n in moving])
    c_med = float(np.median(c_ref))
    change_gap = float(np.max(np.abs(c - c_ref) / np.maximum(c_ref, c_med)))
    return {"loss1_gap": loss1_gap, "loss_gap": loss_gap,
            "grad_gap": grad_gap, "grad_gap_med": grad_gap_med,
            "change_gap": change_gap}


def detection_readings(prog: List[Mapping[str, np.ndarray]],
                       ref: List[Mapping]) -> Dict[str, float]:
    """`prog`: a scan's kept detections ({"boxes_3d", "scores_3d",
    "labels_3d"} numpy), `ref`: the same scan's kept detections ({"boxes",
    "scores", "labels", "keep"} numpy, over the post-processing's
    candidates) and its valid rows ({"rows_boxes" [R, 7], "rows_scores"
    [R, C]}, tensors on the reference's device), scan by scan."""
    fwd, back, extra = [torch.zeros(0)], [torch.zeros(0)], [torch.zeros(0)]
    for p, r in zip(prog, ref):
        dev = r["rows_boxes"].device
        pb, ps, pl = (torch.as_tensor(np.asarray(p[k]), device=dev)
                      for k in ("boxes_3d", "scores_3d", "labels_3d"))
        keep = torch.as_tensor(np.asarray(r["keep"], bool), device=dev)
        kb, ks, kl = (torch.as_tensor(np.asarray(r[k]), device=dev)[keep]
                      for k in ("boxes", "scores", "labels"))
        # the port's detections against every row of their class
        rows_s = r["rows_scores"].float().t()[pl.long()]  # [P, R]
        fwd.append(_nearest(pb, ps, r["rows_boxes"], rows_s).cpu())
        # the reference's kept detections against the port's of their class
        same = kl.long()[:, None] == pl.long()[None, :]
        back.append(_nearest(kb, ks, pb, ps[None, :].expand(len(ks), -1),
                             same).cpu())
        # the port's kept detections against the reference's kept ones
        extra.append(_nearest(pb, ps, kb, ks[None, :].expand(len(ps), -1),
                              same.t()).cpu())
    return {"det_gap_p99": _quantile(fwd, 0.99),
            "det_lost_p90": _quantile(back, 0.90),
            "det_extra_p90": _quantile(extra, 0.90)}


def _quantile(parts, q: float) -> float:
    g = torch.cat(parts).double()
    return float(torch.quantile(g, q)) if len(g) else 0.0


def _nearest(qb, qs, tb, ts, allowed=None):
    """[Q] gap of each query box (qb [Q, 7], score qs [Q]) from its
    nearest target (tb [T, 7], its score for the query ts [Q, T]), where
    `allowed` [Q, T]: max(|score gap|, 1 - IoU); 1 with no target."""
    if not len(qb):
        return torch.zeros(0, device=qb.device)
    if not len(tb):
        return torch.ones(len(qb), device=qb.device)
    gap = torch.maximum((qs.float()[:, None] - ts.float()).abs(),
                        1.0 - _iou3d(qb.float(), tb.float()))
    if allowed is not None:
        gap = torch.where(allowed, gap, torch.ones_like(gap))
    return gap.amin(dim=1).clamp_max(1.0)


def _iou3d(a, b):
    """[n, m] IoU of bottom-centred box7s [n, 7], [m, 7], yaw ignored."""
    def corners(x):
        half = torch.cat([x[:, 3:5] / 2, torch.zeros_like(x[:, 5:6])], -1)
        lo = x[:, :3] - half
        return lo, lo + x[:, 3:6]

    lo_a, hi_a = corners(a)
    lo_b, hi_b = corners(b)
    inter = (torch.minimum(hi_a[:, None], hi_b[None])
             - torch.maximum(lo_a[:, None], lo_b[None])).clamp_min(0).prod(-1)
    vol_a = a[:, 3:6].prod(-1)[:, None]
    vol_b = b[:, 3:6].prod(-1)[None, :]
    return inter / (vol_a + vol_b - inter).clamp_min(1e-12)


def judge(readings: Mapping[str, float], limits: Mapping[str, dict]
          ) -> List[dict]:
    """[{"name", "value", "limit", "ok"}] of every number the limits
    name; a number with no reading fails."""
    out = []
    for name, lim in limits.items():
        value = readings.get(name)
        ok = value is not None and np.isfinite(value) \
            and value <= lim["limit"]
        out.append({"name": name, "value": value, "limit": lim["limit"],
                    "ok": bool(ok)})
    return out
