"""Cells at the CPU tests' size: the port's `fcaf3d_tiny` and
`votenet_tiny` configurations on small crowded rooms, shaped as
`spec.cell` shapes a cell."""
from __future__ import annotations

import dataclasses
import json

from cardbench import spec

SCENE = {"n_boxes": 4, "extent": 0.6, "box_points": 100, "floor_points": 100}
VOTE_SCENE = {"n_boxes": 4, "extent": 2.0, "box_points": 100,
              "floor_points": 100}


def _fields(cfg) -> dict:
    return json.loads(json.dumps(dataclasses.asdict(cfg)))


def fcaf3d_config() -> dict:
    from fcaf3d_tpu_torch.configs import fcaf3d_tiny
    return {"family": "fcaf3d", "steps_per_epoch": 75,
            "config": _fields(fcaf3d_tiny())}


def votenet_config() -> dict:
    from fcaf3d_tpu_torch.configs import votenet_tiny
    return {"family": "votenet", "steps_per_epoch": 41,
            "config": _fields(votenet_tiny())}


def cell(kind: str) -> dict:
    """"fcaf3d_train", "fcaf3d_eval" or "votenet_train", with the metrics
    and the limits of the full-size cell of that kind."""
    full = {"fcaf3d_train": "fcaf3d_scannet.train_b16",
            "fcaf3d_eval": "fcaf3d_scannet.eval_b8",
            "votenet_train": "votenet_sunrgbd.train_b16"}[kind]
    bench = spec.cell(full, spec.benchmark())
    config = votenet_config() if kind.startswith("votenet") \
        else fcaf3d_config()
    if kind.endswith("train"):
        traffic = {"mode": "train", "batch": 2, "pool": 3,
                   "scene": "crowded",
                   "scene_args": VOTE_SCENE if kind.startswith("votenet")
                   else SCENE,
                   "checked_steps": 3, "profiled_steps": 1}
    else:
        traffic = {"mode": "infer", "batch": 2, "pool": 2,
                   "scene": "crowded", "scene_args": SCENE,
                   "warm_requests": 1, "checked_requests": 2,
                   "profiled_requests": 1}
    return {"name": full, "chips": 1, "config": config, "traffic": traffic,
            "limits": bench["limits"], "end_to_end": bench["end_to_end"],
            "per_layer": bench["per_layer"]}
