"""Host-side point preprocessing of the VoteNet path: a copy of
`fcaf3d_tpu/core/points.py::Points3D.add_height` (the JAX package's
`data/pipelines.py::ShiftHeight`), held equal to it by a test."""
from __future__ import annotations

import numpy as np


def add_height(points: np.ndarray, floor_percentile: float = 0.99
               ) -> np.ndarray:
    """[N, 3+C] -> [N, 4+C] f32: xyz, then the height above the floor (z
    minus its `floor_percentile` percentile), then the other columns."""
    arr = np.asarray(points, np.float32)
    z = arr[:, 2]
    floor = np.percentile(z, floor_percentile)
    height = (z - floor).astype(np.float32)[:, None]
    return np.concatenate([arr[:, :3], height, arr[:, 3:]], axis=1)
