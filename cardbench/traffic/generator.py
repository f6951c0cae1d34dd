"""The one traffic generator: scenes and batches from a traffic mix's
parameters (`traffic/<name>.json`) and the run's seed, on the host.

`sample_box_surface`, `densify`, `crowded_scene` and `synth_scene` are
frozen copies of the port's scene generators (`data/synth.py`): crowded
rooms of boxes whose surface points and labels are exact, for training,
and room-like clouds (walls, floor, furniture blobs) of a ScanNet scan's
raw size, for detection. A scan is sampled to the configuration's
`num_points` as the port's `inference_detector` samples it.

A mix's "scene" names the generator ("crowded" or "room") and
"scene_args" its sizes; "batch" is the scans a request or a step takes
and "pool" the number of distinct batches a run builds and cycles. Every
seed gets the same sizes: only the random draws differ.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np


def sample_box_surface(box, n, rng):
    """n points on the surfaces of a (possibly yawed) box7 (bottom-center)."""
    cx, cy, cz, dx, dy, dz, yaw = box
    areas = np.array([dy * dz, dy * dz, dx * dz, dx * dz, dx * dy, dx * dy])
    face = rng.choice(6, size=n, p=areas / areas.sum())
    u = rng.uniform(-0.5, 0.5, (n, 2))
    local = np.zeros((n, 3), np.float32)
    for f, (fix_axis, sign) in enumerate(
        [(0, -1), (0, 1), (1, -1), (1, 1), (2, -1), (2, 1)]
    ):
        m = face == f
        other = [a for a in range(3) if a != fix_axis]
        local[m, fix_axis] = 0.5 * sign
        local[m, other[0]] = u[m, 0]
        local[m, other[1]] = u[m, 1]
    local *= np.array([dx, dy, dz], np.float32)
    c, s = np.cos(yaw), np.sin(yaw)
    rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    pts = local @ rot.T
    pts += np.array([cx, cy, cz + dz / 2], np.float32)
    return pts


def densify(sample, pts_per_box, n_floor, rng):
    """Replace a sample's cloud with surface samples of its GT boxes plus a
    floor sheet spanning the scene. Keeps boxes/labels untouched."""
    boxes = sample["gt_boxes"]
    clouds = [sample_box_surface(b, pts_per_box, rng) for b in boxes]
    lo = boxes[:, :3].min(axis=0) - 0.5
    hi = (boxes[:, :3] + boxes[:, 3:6] * 0.5).max(axis=0) + 0.5
    floor_z = boxes[:, 2].min()
    floor = np.stack(
        [
            rng.uniform(lo[0], hi[0], n_floor),
            rng.uniform(lo[1], hi[1], n_floor),
            np.full(n_floor, floor_z, np.float32),
        ],
        axis=1,
    ).astype(np.float32)
    pts = np.concatenate(clouds + [floor]).astype(np.float32)
    colors = rng.uniform(0, 255, (len(pts), 3)).astype(np.float32)
    return {
        "points": np.concatenate([pts, colors], axis=1),
        "gt_boxes": boxes,
        "gt_labels": sample["gt_labels"],
    }


def crowded_scene(n_boxes, n_classes, rng, extent=8.0, with_yaw=False):
    """Dense synthetic room: many small boxes on a grid with jitter —
    stresses per-class NMS candidate counts (nms_cap experiments)."""
    side = int(np.ceil(np.sqrt(n_boxes)))
    cell = extent / side
    boxes = []
    for i in range(n_boxes):
        gx, gy = i % side, i // side
        cxy = (np.array([gx, gy]) + 0.5) * cell + rng.uniform(-0.1, 0.1, 2)
        dims = rng.uniform(0.35, 0.7, 3) * min(cell, 1.0)
        yaw = rng.uniform(-np.pi, np.pi) if with_yaw else 0.0
        boxes.append([cxy[0], cxy[1], 0.0, dims[0], dims[1], dims[2], yaw])
    boxes = np.asarray(boxes, np.float32)
    labels = rng.integers(0, n_classes, n_boxes).astype(np.int64)
    return {"gt_boxes": boxes, "gt_labels": labels}


def synth_scene(rng, n_points, extent=(6.0, 6.0, 2.8)):
    """Room-like synthetic scene: points concentrated on walls/floor planes
    plus furniture blobs, so voxel occupancy resembles real scans. `rng` is
    a `np.random.RandomState`; returns (xyz [n, 3], rgb [n, 3]) float32."""
    n_planes = int(n_points * 0.6)
    n_blobs = n_points - n_planes
    pts = np.empty((n_points, 3), np.float32)
    # floor + 4 walls
    k = n_planes // 5
    e = np.asarray(extent)
    pts[:k] = rng.uniform(0, 1, (k, 3)) * [e[0], e[1], 0.02]
    pts[k:2 * k] = rng.uniform(0, 1, (k, 3)) * [e[0], 0.02, e[2]]
    pts[2 * k:3 * k] = (rng.uniform(0, 1, (k, 3)) * [0.02, e[1], e[2]]
                        + [e[0] - 0.02, 0, 0])
    pts[3 * k:4 * k] = (rng.uniform(0, 1, (k, 3)) * [e[0], 0.02, e[2]]
                        + [0, e[1] - 0.02, 0])
    pts[4 * k:n_planes] = (rng.uniform(0, 1, (n_planes - 4 * k, 3))
                           * [0.02, e[1], e[2]])
    # furniture blobs
    centers = rng.uniform(0.5, 1, (12, 3)) * (e - 1.0)
    blob = rng.randint(0, 12, n_blobs)
    pts[n_planes:] = centers[blob] + rng.normal(0, 0.25, (n_blobs, 3))
    colors = rng.uniform(0, 255, (n_points, 3)).astype(np.float32)
    return pts, colors


def add_height(points: np.ndarray, floor_percentile: float = 0.99
               ) -> np.ndarray:
    """[N, 3+C] -> [N, 4+C] f32: xyz, then the height above the floor (z
    minus its `floor_percentile` percentile), then the other columns (the
    port's `data.points.add_height`)."""
    arr = np.asarray(points, np.float32)
    z = arr[:, 2]
    floor = np.percentile(z, floor_percentile)
    height = (z - floor).astype(np.float32)[:, None]
    return np.concatenate([arr[:, :3], height, arr[:, 3:]], axis=1)


def make_scene(kind: str, args: dict, rng: np.random.Generator,
               n_classes: int, with_yaw: bool) -> dict:
    """One raw scene {"points": [N, 6] xyz + rgb, "gt_boxes": [G, 7],
    "gt_labels": [G]}."""
    if kind == "crowded":
        scene = densify(crowded_scene(args["n_boxes"], n_classes, rng,
                                      extent=args["extent"],
                                      with_yaw=with_yaw),
                        args["box_points"], args["floor_points"], rng)
        return scene
    if kind == "room":
        state = np.random.RandomState(int(rng.integers(2 ** 32)))
        xyz, rgb = synth_scene(state, args["raw_points"])
        return {"points": np.concatenate([xyz, rgb], axis=1),
                "gt_boxes": np.zeros((0, 7), np.float32),
                "gt_labels": np.zeros(0, np.int64)}
    raise ValueError(f"no scene generator {kind!r}")


def make_batch(traffic: dict, config: dict, seed: int, index: int
               ) -> Dict[str, np.ndarray]:
    """Batch `index` of the pool of `seed`: points [B, P, 3], colors [B, P,
    3] (0-255), valid [B, P], gt_boxes [B, G, 7], gt_labels [B, G],
    gt_valid [B, G], P the configuration's `num_points` and G its
    `max_gt_boxes`."""
    cfg = config["config"]
    p, g = cfg["num_points"], cfg["max_gt_boxes"]
    rows: Dict[str, List[np.ndarray]] = {k: [] for k in (
        "points", "colors", "gt_boxes", "gt_labels", "gt_valid")}
    for row in range(traffic["batch"]):
        rng = np.random.default_rng([seed, index, row])
        scene = make_scene(traffic["scene"], traffic["scene_args"], rng,
                           cfg["n_classes"], cfg["with_yaw"])
        pts = scene["points"]
        pick = rng.choice(len(pts), p, replace=len(pts) < p)
        rows["points"].append(pts[pick, :3])
        rows["colors"].append(pts[pick, 3:6])
        n = len(scene["gt_boxes"])
        if n > g:
            raise ValueError(f"{n} boxes, the configuration holds {g}")
        boxes = np.zeros((g, 7), np.float32)
        labels = np.zeros(g, np.int32)
        boxes[:n], labels[:n] = scene["gt_boxes"], scene["gt_labels"]
        rows["gt_boxes"].append(boxes)
        rows["gt_labels"].append(labels)
        rows["gt_valid"].append(np.arange(g) < n)
    batch = {k: np.stack(v) for k, v in rows.items()}
    batch["points"] = batch["points"].astype(np.float32)
    batch["colors"] = batch["colors"].astype(np.float32)
    batch["valid"] = np.ones(batch["points"].shape[:2], bool)
    return batch


def make_pool(traffic: dict, config: dict, seed: int
              ) -> List[Dict[str, np.ndarray]]:
    """The run's `traffic["pool"]` distinct batches."""
    return [make_batch(traffic, config, seed, i)
            for i in range(traffic["pool"])]
