"""Differentiable box IoUs (port of `fcaf3d_tpu/core/rotated_iou.py`).

The rotated IoU clips two convex quadrilaterals with fixed shapes: the
intersection has at most 8 vertices among 24 candidates (the 16 edge-pair
intersections and each box's 4 corners inside the other), which are masked,
sorted by angle around their centroid (a stable argsort) and summed by the
shoelace formula. Everything broadcasts over leading dims, so the NMS runs
it on [..., K, K] pairs at once.

Where the JAX package's functions are not differentiable (ties), the port
keeps their gradients: `maximum` / `minimum` against a tensor split a tie
1/2 : 1/2 (`torch.clamp` would give 1), `where(x >= 0, x, -x)` gives |x|
the gradient 1 at 0 (`torch.abs` gives 0), and `amax` / `amin` split the
gradient equally among tied elements (`torch.max(dim=)` gives it all to
one).
"""
from __future__ import annotations

import numpy as np
import torch

from .geometry import bev_corners

_EPS = 1e-8
_BEV = (0, 1, 3, 4, 6)  # (x, y, dx, dy, yaw) columns of a box7


def _bev(boxes7: torch.Tensor) -> torch.Tensor:
    return boxes7[..., list(_BEV)]


def _clip0(x: torch.Tensor) -> torch.Tensor:
    """max(x, 0), with the gradient 1/2 at 0 of `jnp.clip(x, 0.0)`."""
    return torch.maximum(x, x.new_zeros(()))


def _floor(x: torch.Tensor, eps: float) -> torch.Tensor:
    return torch.maximum(x, x.new_full((), eps))


def _cross2(o, a, b):
    """2D cross product (a - o) x (b - o) of [..., 2] tensors."""
    return ((a[..., 0] - o[..., 0]) * (b[..., 1] - o[..., 1])
            - (a[..., 1] - o[..., 1]) * (b[..., 0] - o[..., 0]))


def _segment_intersections(c1, c2):
    """The 16 edge-pair intersections of two quads [..., 4, 2].

    Returns (pts [..., 16, 2], zero where invalid; valid [..., 16]); the
    first index runs over the edges of box 1."""
    a = c1[..., :, None, :]
    b = torch.roll(c1, -1, dims=-2)[..., :, None, :]
    c = c2[..., None, :, :]
    d = torch.roll(c2, -1, dims=-2)[..., None, :, :]
    r = b - a
    s = d - c
    denom = r[..., 0] * s[..., 1] - r[..., 1] * s[..., 0]  # [..., 4, 4]
    ok = denom.abs() > _EPS
    safe = torch.where(ok, denom, torch.ones_like(denom))
    qp = c - a
    t = (qp[..., 0] * s[..., 1] - qp[..., 1] * s[..., 0]) / safe
    u = (qp[..., 0] * r[..., 1] - qp[..., 1] * r[..., 0]) / safe
    valid = ok & (t >= 0.0) & (t <= 1.0) & (u >= 0.0) & (u <= 1.0)
    pts = torch.where(valid[..., None], a + t[..., None] * r, 0.0)
    lead = pts.shape[:-3]
    return pts.reshape(lead + (16, 2)), valid.reshape(lead + (16,))


def _corners_in_quad(pts, quad):
    """Points [..., 4, 2] inside the convex quad [..., 4, 2] (either winding,
    edges included within _EPS) -> bool [..., 4]."""
    o = quad[..., None, :, :]
    nxt = torch.roll(quad, -1, dims=-2)[..., None, :, :]
    cr = _cross2(o, nxt, pts[..., :, None, :])  # [..., points, edges]
    return (cr >= -_EPS).all(-1) | (cr <= _EPS).all(-1)


def quad_intersection_area(c1: torch.Tensor, c2: torch.Tensor) -> torch.Tensor:
    """Intersection area of two convex quads [..., 4, 2] -> [...]
    (broadcast)."""
    c1, c2 = torch.broadcast_tensors(c1, c2)
    inter_pts, inter_valid = _segment_intersections(c1, c2)
    pts = torch.cat([inter_pts, c1, c2], dim=-2)  # [..., 24, 2]
    valid = torch.cat([inter_valid, _corners_in_quad(c1, c2),
                       _corners_in_quad(c2, c1)], dim=-1)
    num = valid.sum(-1)  # [...]
    denom = num.clamp_min(1).to(pts.dtype)[..., None]
    center = (pts * valid[..., None].to(pts.dtype)).sum(-2) / denom
    rel = pts - center[..., None, :]
    # the angles only order the vertices: no gradient flows through them
    ang = torch.atan2(rel[..., 1], rel[..., 0])
    ang = torch.where(valid, ang, 1e9)  # invalid candidates last
    order = torch.argsort(ang, dim=-1, stable=True)
    spts = torch.take_along_dim(pts, order[..., None], dim=-2)

    # shoelace over the first `num` sorted vertices, wrapping to vertex 0
    idx = torch.arange(24, device=pts.device)
    nxt = torch.where(idx + 1 >= num[..., None], 0, idx + 1)
    npts = torch.take_along_dim(spts, nxt[..., None], dim=-2)
    cross = spts[..., 0] * npts[..., 1] - spts[..., 1] * npts[..., 0]
    twice = torch.where(idx < num[..., None], cross, 0.0).sum(-1)
    area = 0.5 * torch.where(twice >= 0, twice, -twice)
    return torch.where(num >= 3, area, 0.0)


def rotated_iou_2d(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """IoU of pairs of rotated BEV boxes (x, y, dx, dy, yaw) [..., 5]
    (broadcast)."""
    inter = quad_intersection_area(bev_corners(boxes1), bev_corners(boxes2))
    a1 = boxes1[..., 2] * boxes1[..., 3]
    a2 = boxes2[..., 2] * boxes2[..., 3]
    return inter / _floor(a1 + a2 - inter, _EPS)


def _z_overlap(b1: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """Vertical overlap of gravity-centred box7 pairs [..., 7]."""
    zmax = torch.minimum(b1[..., 2] + b1[..., 5] * 0.5,
                         b2[..., 2] + b2[..., 5] * 0.5)
    zmin = torch.maximum(b1[..., 2] - b1[..., 5] * 0.5,
                         b2[..., 2] - b2[..., 5] * 0.5)
    return _clip0(zmax - zmin)


def _volume(b: torch.Tensor) -> torch.Tensor:
    return b[..., 3] * b[..., 4] * b[..., 5]


def iou_3d(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """3D IoU of pairs of gravity-centred box7 (x, y, z, dx, dy, dz, yaw)
    [..., 7]: the BEV intersection times the vertical overlap, over the 3D
    union."""
    inter = quad_intersection_area(bev_corners(_bev(boxes1)),
                                   bev_corners(_bev(boxes2)))
    inter = inter * _z_overlap(boxes1, boxes2)
    return inter / _floor(_volume(boxes1) + _volume(boxes2) - inter, _EPS)


def pairwise_iou_3d(boxes1: torch.Tensor, boxes2: torch.Tensor
                    ) -> torch.Tensor:
    """[..., N, M] 3D IoU of gravity-centred box7 [..., N, 7] x [..., M, 7]."""
    return iou_3d(boxes1[..., :, None, :], boxes2[..., None, :, :])


def pairwise_iou_bev(boxes1: torch.Tensor, boxes2: torch.Tensor
                     ) -> torch.Tensor:
    """[..., N, M] rotated BEV IoU of (x, y, dx, dy, yaw) boxes [..., N, 5]
    x [..., M, 5] (the NMS criterion)."""
    return rotated_iou_2d(boxes1[..., :, None, :], boxes2[..., None, :, :])


def axis_aligned_iou(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """IoU of pairs of axis-aligned gravity-centred boxes [..., 6]
    (cx, cy, cz, dx, dy, dz)."""
    lo1 = pred[..., :3] - pred[..., 3:6] * 0.5
    hi1 = pred[..., :3] + pred[..., 3:6] * 0.5
    lo2 = target[..., :3] - target[..., 3:6] * 0.5
    hi2 = target[..., :3] + target[..., 3:6] * 0.5
    inter = _clip0(torch.minimum(hi1, hi2) - torch.maximum(lo1, lo2))
    inter_vol = torch.prod(inter, dim=-1)
    v1 = torch.prod(hi1 - lo1, dim=-1)
    v2 = torch.prod(hi2 - lo2, dim=-1)
    return inter_vol / _floor(v1 + v2 - inter_vol, _EPS)


def min_enclosing_rect_area(points: torch.Tensor) -> torch.Tensor:
    """Smallest-area enclosing rectangle of point sets [..., P, 2] -> [...].

    The optimal rectangle has a side along a convex-hull edge, and each hull
    edge joins two of the points, so the minimum over all P (P - 1) / 2
    point-pair directions of the bounding area in that frame is the true
    minimum. Coincident pairs take the direction (1, 0)."""
    ii, jj = np.triu_indices(points.shape[-2], k=1)
    d = points[..., jj, :] - points[..., ii, :]  # [..., pairs, 2]
    norm = torch.sqrt((d * d).sum(-1, keepdim=True))
    ok = norm[..., 0] > 1e-6
    d = torch.where(ok[..., None], d / _floor(norm, 1e-6),
                    torch.tensor([1.0, 0.0], dtype=points.dtype,
                                 device=points.device))
    # the points in each candidate frame: u = p . d, v = p x d
    u = torch.einsum("...pk,...ck->...cp", points, d)
    v = (points[..., None, :, 1] * d[..., :, None, 0]
         - points[..., None, :, 0] * d[..., :, None, 1])
    areas = ((u.amax(-1) - u.amin(-1)) * (v.amax(-1) - v.amin(-1)))
    return areas.amin(-1)


def giou_3d(boxes1: torch.Tensor, boxes2: torch.Tensor):
    """3D generalized IoU of gravity-centred box7 pairs [..., 7]: the
    enclosing box is the smallest enclosing rectangle of both boxes' BEV
    corners times the vertical span. Returns (GIoU loss, IoU)."""
    iou = iou_3d(boxes1, boxes2)
    c1 = bev_corners(_bev(boxes1))
    c2 = bev_corners(_bev(boxes2))
    area_c = min_enclosing_rect_area(torch.cat([c1, c2], dim=-2))
    zmax = torch.maximum(boxes1[..., 2] + boxes1[..., 5] * 0.5,
                         boxes2[..., 2] + boxes2[..., 5] * 0.5)
    zmin = torch.minimum(boxes1[..., 2] - boxes1[..., 5] * 0.5,
                         boxes2[..., 2] - boxes2[..., 5] * 0.5)
    v_c = _floor(area_c * (zmax - zmin), _EPS)
    inter = quad_intersection_area(c1, c2) * _z_overlap(boxes1, boxes2)
    union = _volume(boxes1) + _volume(boxes2) - inter
    return 1.0 - iou + (v_c - union) / v_c, iou
