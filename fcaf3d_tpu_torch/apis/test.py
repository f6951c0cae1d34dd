"""Evaluation helpers (port of the inference part of `fcaf3d_tpu/apis/test.py`)."""
from __future__ import annotations

from typing import Dict

import numpy as np

from ..models.fcaf3d_head import Detections


def detections_to_numpy(dets: Detections,
                        sample_idx: int) -> Dict[str, np.ndarray]:
    """Strip padding from one sample of a batched `Detections`."""
    keep = dets.valid[sample_idx].cpu().numpy()
    return {
        "boxes_3d": dets.boxes[sample_idx].cpu().numpy()[keep],
        "scores_3d": dets.scores[sample_idx].cpu().numpy()[keep],
        "labels_3d": dets.labels[sample_idx].cpu().numpy()[keep],
    }
