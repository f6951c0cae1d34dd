"""Evaluation helpers (port of the inference part of `fcaf3d_tpu/apis/test.py`)."""
from __future__ import annotations

from typing import Dict, Union

import numpy as np

from ..models.fcaf3d_head import Detections
from ..models.votenet import VoteDetections


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
