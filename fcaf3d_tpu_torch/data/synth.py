"""Synthetic scenes, host numpy.

- `sample_box_surface`, `densify`, `crowded_scene`: scenes built from box
  annotations (a copy of `fcaf3d_tpu/data/synth.py`, held equal to it by a
  test; the JAX package's `data` imports jax through its package init).
  Points are sampled on the boxes' surfaces plus a floor sheet, so the box
  geometry and labels are exact.
- `crowded_rotated_sample`: the scene of the JAX package's crowded-rotated
  overfit proof (a copy of `tests/test_overfit_fixture.py`'s
  `_crowded_rotated_sample`, held equal to it by a test): 20 yawed boxes,
  their surface points, a floor and clutter that belongs to no box.
- `synth_scene`: a room-like cloud without annotations (a copy of the JAX
  benchmark's `bench.synth_scene`, held equal to it by a test).
- `synth_room`, `synth_sunrgbd`, `synth_s3dis`: the acquisition models that
  set the budgets of the SUN RGB-D and S3DIS configs (copies of
  `tools/calibrate_budgets.py`'s generators, held equal to them by a test):
  a room's surfaces (floor, walls, furniture shells) sampled with scanner
  noise; one z-buffered Kinect frame of such a room; a dense 1M-point room
  sampled to 100k.
"""
from __future__ import annotations

import numpy as np

S3DIS_RAW_POINTS = 1000000  # a dense Matterport room before the sample


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


def crowded_rotated_sample(rng, n_classes, n_boxes=20, n_clutter=640,
                           pts_per_box=96, gt=None):
    """Crowded rotated scene with distractor clutter: `n_boxes` random-yaw
    boxes on a jittered grid (`crowded_scene`, 6 m), their surface samples
    and a floor sheet (`densify`), and `n_clutter` points that belong to no
    box, so that detection has to separate objects from distractor
    geometry. Pass `gt` ({"gt_boxes", "gt_labels"}) to draw fresh points
    for the same annotations (the held-out evaluation)."""
    if gt is None:
        gt = crowded_scene(n_boxes, n_classes, rng, extent=6.0,
                           with_yaw=True)
    sample = densify(gt, pts_per_box, n_floor=256, rng=rng)
    lo = gt["gt_boxes"][:, :3].min(axis=0) - 0.5
    hi = (gt["gt_boxes"][:, :3] + gt["gt_boxes"][:, 3:6]).max(axis=0) + 0.5
    clutter = np.stack([
        rng.uniform(lo[0], hi[0], n_clutter),
        rng.uniform(lo[1], hi[1], n_clutter),
        rng.uniform(0.0, 2.2, n_clutter),
    ], axis=1).astype(np.float32)
    ccol = rng.uniform(0, 255, (n_clutter, 3)).astype(np.float32)
    sample["points"] = np.concatenate(
        [sample["points"], np.concatenate([clutter, ccol], axis=1)])
    return sample


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


def synth_room(rng, n_points=100000, size=None):
    """Point cloud of a room interior: floor, partial ceiling, partially
    observed walls and 5-13 furniture boxes (top + sides), sampled by area
    x density, with 4 mm noise. `rng` is a `np.random.RandomState`; returns
    [n_points, 3] float32 metres (z up, origin at a floor corner)."""
    if size is None:
        size = rng.uniform([4.0, 4.0, 2.4], [9.0, 9.0, 3.2])
    sx, sy, sz = size
    patches = []
    weights = []

    def rect(origin, u, v, density):
        patches.append((np.asarray(origin, np.float64),
                        np.asarray(u, np.float64), np.asarray(v, np.float64)))
        weights.append(np.linalg.norm(u) * np.linalg.norm(v) * density)

    rect([0, 0, 0], [sx, 0, 0], [0, sy, 0], 1.0)  # floor
    if rng.rand() < 0.5:
        rect([0, 0, sz], [sx, 0, 0], [0, sy, 0], 0.3)  # ceiling
    for origin, u in [([0, 0, 0], [sx, 0, 0]), ([0, sy, 0], [sx, 0, 0]),
                      ([0, 0, 0], [0, sy, 0]), ([sx, 0, 0], [0, sy, 0])]:
        rect(origin, u, [0, 0, sz], rng.uniform(0.4, 0.9))
    for _ in range(rng.randint(5, 14)):  # tables, cabinets, beds
        w, d, h = rng.uniform([0.3, 0.3, 0.3], [2.0, 2.0, 1.2])
        x0, y0 = rng.uniform([0.2, 0.2], [sx - w - 0.2, sy - d - 0.2])
        rect([x0, y0, h], [w, 0, 0], [0, d, 0], 1.2)  # top
        for o, u in [([x0, y0, 0], [w, 0, 0]), ([x0, y0 + d, 0], [w, 0, 0]),
                     ([x0, y0, 0], [0, d, 0]), ([x0 + w, y0, 0], [0, d, 0])]:
            rect(o, u, [0, 0, h], rng.uniform(0.3, 0.9))

    w = np.asarray(weights)
    counts = rng.multinomial(n_points, w / w.sum())
    pts = []
    for (o, u, v), c in zip(patches, counts):
        a = rng.rand(c, 1)
        b = rng.rand(c, 1)
        pts.append(o + a * u + b * v)
    p = np.concatenate(pts, 0)
    p += rng.randn(*p.shape) * 0.004  # scanner noise
    return p.astype(np.float32)


def synth_sunrgbd(rng, n_points=100000, width=640, height=480, fx=570.0):
    """One Kinect depth frame of a `synth_room` (SUN RGB-D back-projects
    every valid depth pixel, without ScanNet's 50k cap): dense room samples
    z-buffered into a 640 x 480 frame, the nearest sample a pixel kept,
    then `n_points` sampled (with replacement when fewer). Returns
    [n_points, 3] float32."""
    pts = synth_room(rng, n_points=700000)
    # the camera in a corner region at sensor height, looking into the room
    ext = pts.max(0)
    cam = np.array([rng.uniform(0.2, 0.8), rng.uniform(0.2, 0.8),
                    rng.uniform(0.9, 1.7)])
    target = np.array([ext[0] * rng.uniform(0.4, 0.8),
                       ext[1] * rng.uniform(0.4, 0.8),
                       rng.uniform(0.6, 1.4)])
    f = target - cam
    f = f / np.linalg.norm(f)
    r = np.cross(f, np.array([0.0, 0.0, 1.0]))
    r = r / np.linalg.norm(r)
    u = np.cross(r, f)
    # camera frame: x right, y down, z forward
    rel = pts - cam
    xc = rel @ r
    yc = -(rel @ u)
    zc = rel @ f
    vis = zc > 0.4
    ui = np.floor(fx * xc[vis] / zc[vis] + width / 2).astype(np.int64)
    vi = np.floor(fx * yc[vis] / zc[vis] + height / 2).astype(np.int64)
    inb = (ui >= 0) & (ui < width) & (vi >= 0) & (vi < height)
    pix = vi[inb] * width + ui[inb]
    depth = zc[vis][inb]
    src = np.where(vis)[0][inb]
    order = np.lexsort((depth, pix))  # the nearest sample a pixel first
    pix_s = pix[order]
    first = np.ones(len(pix_s), bool)
    first[1:] = pix_s[1:] != pix_s[:-1]
    cloud = pts[src[order][first]]
    cloud = cloud[rng.choice(len(cloud), n_points,
                             replace=len(cloud) < n_points)]
    return cloud.astype(np.float32)


def synth_s3dis(rng, n_points=100000):
    """A dense Matterport room (S3DIS): a `synth_room` of 1M raw points in
    a room of sides drawn from [4, 9] m, sampled to `n_points`. Returns
    [n_points, 3] float32."""
    size = rng.uniform([4.0, 4.0, 2.4], [9.0, 9.0, 3.2])
    p = synth_room(rng, max(S3DIS_RAW_POINTS, n_points), size=size)
    if S3DIS_RAW_POINTS < len(p):
        p = p[rng.choice(len(p), S3DIS_RAW_POINTS, replace=False)]
    if len(p) != n_points:
        p = p[rng.choice(len(p), n_points, replace=len(p) < n_points)]
    return p
