"""Host-side camera calibration of the ImVoteNet path: a copy of
`fcaf3d_tpu/data/datasets.py::sunrgbd_depth2img`, held equal to it by a
test."""
from __future__ import annotations

import numpy as np


def sunrgbd_depth2img(calib: dict, sx: float = 1.0,
                      sy: float = 1.0) -> np.ndarray:
    """[3, 3] depth->image projection for `project_to_image` (left-multiply:
    `uv3 = xyz @ depth2img.T`).

    SUN RGB-D calib convention (reference `sunrgbd_data_utils.py` /
    `vote_fusion.py`): `K` is stored TRANSPOSED ([fx 0 0; 0 fy 0; cx cy 1],
    right-multiplied), `Rt` rotates depth-frame points first, and the
    camera frame is (x, -z, y) of the depth frame (y = forward). sx/sy
    scale the intrinsics for resized images.
    """
    k = np.asarray(calib["K"], np.float32).reshape(3, 3)
    rt = np.asarray(calib["Rt"], np.float32).reshape(3, 3)
    flip = np.array([[1, 0, 0], [0, 0, -1], [0, 1, 0]], np.float32).T
    k = k @ np.diag([sx, sy, 1.0]).astype(np.float32)
    return (rt @ flip @ k).T
