"""Host-side point columns of the pipelines: copies of the parts of
`fcaf3d_tpu/core/points.py` that the data pipelines use
(`default_attribute_dims` and `Points3D.add_height`, which the JAX
package's `data/pipelines.py::ShiftHeight` calls), held equal to them by a
test. `add_height` is also the VoteNet path's height column."""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np


def default_attribute_dims(n_cols: int, shift_height: bool = False,
                           use_color: bool = True) -> Dict[str, object]:
    """Column map for the standard load layouts (the reference's
    `LoadPointsFromFile`): xyz [+height] [+rgb].

    Height (when present) sits right after xyz, the layout `ShiftHeight`
    produces, and color takes the next three columns.
    """
    dims: Dict[str, object] = {}
    col = 3
    if shift_height and n_cols > col:
        dims["height"] = col
        col += 1
    if use_color and n_cols >= col + 3:
        dims["color"] = [col, col + 1, col + 2]
        col += 3
    return dims


def add_height(points: np.ndarray, floor_percentile: float = 0.99
               ) -> np.ndarray:
    """[N, 3+C] -> [N, 4+C] f32: xyz, then the height above the floor (z
    minus its `floor_percentile` percentile), then the other columns."""
    arr = np.asarray(points, np.float32)
    z = arr[:, 2]
    floor = np.percentile(z, floor_percentile)
    height = (z - floor).astype(np.float32)[:, None]
    return np.concatenate([arr[:, :3], height, arr[:, 3:]], axis=1)


def height_attribute_dims(attribute_dims: Optional[Dict[str, object]]
                          ) -> Dict[str, object]:
    """The column map after `add_height`: "height" at column 3, every other
    attribute one column further right."""
    dims: Dict[str, object] = {"height": 3}
    for k, v in (attribute_dims or {}).items():
        if k == "height":
            continue
        dims[k] = v + 1 if isinstance(v, int) else [c + 1 for c in v]
    return dims
