"""The port's host box and points API against the JAX package's, on the CPU:
`core/boxes.py` (`Box3DMode`, `convert_points`, `convert_boxes`,
`Boxes3D`), `core/box_np_ops.py`, `core/points.py::Points3D` and the
geometry helpers `limit_period`, `box_volume`, `rotate_box7`,
`scale_box7`, `translate_box7`, on the inputs of `test_boxes_api.py`,
`test_box_np_ops.py` and `test_points.py`.

Where the JAX function is numpy the results must be exactly equal; where
it goes through jnp (`Boxes3D.corners`, `.rotate`, `rotate_box7`: float32
sin / cos of XLA against PyTorch's) within ROT_ATOL = 1e-6; the boolean
point-in-box masks and the rest of the jnp helpers exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fcaf3d_tpu.core import box_np_ops as jops
from fcaf3d_tpu.core import boxes as jboxes
from fcaf3d_tpu.core import geometry as jgeo
from fcaf3d_tpu.core import points as jpoints
from fcaf3d_tpu_torch.core import box_np_ops as tops
from fcaf3d_tpu_torch.core import boxes as tboxes
from fcaf3d_tpu_torch.core import geometry as tgeo
from fcaf3d_tpu_torch.core import points as tpoints
from tests.test_box_np_ops import RECT, TRV2C

ROT_ATOL = 1e-6


def rand_boxes(seed, n=8, yaw=True):
    rng = np.random.RandomState(seed)
    b = np.zeros((n, 7), np.float32)
    b[:, :3] = rng.randn(n, 3)
    b[:, 3:6] = rng.uniform(0.5, 2, (n, 3))
    b[:, 6] = rng.uniform(-np.pi, np.pi, n) if yaw else 0.0
    return b


def test_mode_conversions_equal_jax():
    """Every pair of modes: points (with extra columns, and with explicit
    3x3 / 4x4 transforms) and boxes exactly the JAX package's."""
    assert list(tboxes.Box3DMode) == list(jboxes.Box3DMode)
    pts = np.random.RandomState(0).randn(10, 5).astype(np.float32)
    boxes = rand_boxes(1, 6)
    for a in tboxes.Box3DMode:
        for b in tboxes.Box3DMode:
            ja, jb = jboxes.Box3DMode(a), jboxes.Box3DMode(b)
            np.testing.assert_array_equal(
                tboxes.convert_points(pts, a, b),
                jboxes.convert_points(pts, ja, jb))
            np.testing.assert_array_equal(
                tboxes.convert_boxes(boxes, a, b),
                jboxes.convert_boxes(boxes, ja, jb))
    for rt in (RECT[:3, :3].astype(np.float32), TRV2C.astype(np.float32)):
        np.testing.assert_array_equal(
            tboxes.convert_points(pts, tboxes.Box3DMode.DEPTH,
                                  tboxes.Box3DMode.CAM, rt),
            jboxes.convert_points(pts, jboxes.Box3DMode.DEPTH,
                                  jboxes.Box3DMode.CAM, rt))


@pytest.mark.parametrize("case", ["gravity6", "yawed"])
def test_boxes3d_equals_jax(case):
    """`Boxes3D` built as `test_boxes_api.py` builds it (a gravity-centred
    6-column box) and from yawed boxes: every property and method as the
    JAX wrapper gives it."""
    if case == "gravity6":
        raw = np.array([[1.0, 2.0, 1.5, 2.0, 2.0, 1.0],
                        [0.5, -1.0, 0.8, 1.0, 3.0, 0.6]], np.float32)
        kw = {"box_dim": 6, "origin": (0.5, 0.5, 0.5)}
    else:
        raw, kw = rand_boxes(2), {}
    got, want = tboxes.Boxes3D(raw, **kw), jboxes.Boxes3D(raw, **kw)
    assert got.with_yaw == want.with_yaw and len(got) == len(want)
    for attr in ("tensor", "gravity_center", "bottom_center", "dims", "yaw",
                 "volume", "height", "bev"):
        np.testing.assert_array_equal(getattr(got, attr),
                                      getattr(want, attr), err_msg=attr)
    np.testing.assert_array_equal(got.nearest_bev(), want.nearest_bev())
    np.testing.assert_allclose(got.corners, want.corners, rtol=0,
                               atol=ROT_ATOL)
    assert got.corners.dtype == want.corners.dtype == np.float32
    np.testing.assert_allclose(got.rotate(0.7).tensor, want.rotate(0.7).tensor,
                               rtol=0, atol=ROT_ATOL)
    for direction in ("horizontal", "vertical"):
        np.testing.assert_array_equal(got.flip(direction).tensor,
                                      want.flip(direction).tensor)
    np.testing.assert_array_equal(got.scale(2.0).tensor,
                                  want.scale(2.0).tensor)
    np.testing.assert_array_equal(got.translate([1.0, -2.0, 0.5]).tensor,
                                  want.translate([1.0, -2.0, 0.5]).tensor)
    np.testing.assert_array_equal(got[1:].tensor, want[1:].tensor)
    pts = np.concatenate([
        np.random.RandomState(3).uniform(-3, 3, (300, 3)),
        got.gravity_center], axis=0).astype(np.float32)
    inside = got.points_in_boxes(pts)
    assert inside.dtype == bool and inside.any()
    np.testing.assert_array_equal(inside, want.points_in_boxes(pts))
    np.testing.assert_array_equal(got.overlaps(got), want.overlaps(want))
    for dst in (tboxes.Box3DMode.CAM, tboxes.Box3DMode.LIDAR):
        c, w = got.convert_to(dst), want.convert_to(jboxes.Box3DMode(dst))
        np.testing.assert_array_equal(c.tensor, w.tensor)
        assert int(c.mode) == int(w.mode)


def test_box_np_ops_equal_jax():
    """Every function of `box_np_ops` on the inputs of `test_box_np_ops.py`
    (and yawed random boxes): exactly the JAX package's."""
    points = np.array([[1.84, 1.47, 8.41]])
    box = np.array([[1.84, 1.47, 8.41, 1.2, 1.89, 0.48, 0.01]])
    dims = np.array([[0.47, 0.98]])
    angles = np.array([-3.14])
    center = np.array([[9.348705, -3.6271024]])
    corners = jops.corners_nd(dims)
    boxes = rand_boxes(0, 5)
    cloud = np.random.RandomState(1).uniform(-3, 3, (200, 3))
    k = np.array([[500.0, 0, 320], [0, 500, 240], [0, 0, 1]])
    cases = {
        "camera_to_lidar": ((points, RECT, TRV2C), {}),
        "box_camera_to_lidar": ((box, RECT, TRV2C), {}),
        "corners_nd": ((dims,), {}),
        "rotation_2d": ((corners, angles), {}),
        "rotation_points_single_angle": ((cloud, 0.3), {"axis": 2}),
        "center_to_corner_box2d": ((center, dims, angles), {}),
        "center_to_corner_box3d": ((boxes[:, :3], boxes[:, 3:6],
                                    boxes[:, 6]),
                                   {"origin": (0.5, 0.5, 0.0)}),
        "points_in_rbbox": ((cloud, boxes), {}),
        "points_cam2img": ((np.array([[0.0, 0.0, 2.0], [1.0, 0.5, 5.0]]),
                            k), {}),
    }
    for name, (args, kw) in cases.items():
        got, want = getattr(tops, name)(*args, **kw), \
            getattr(jops, name)(*args, **kw)
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    for axis in (0, 1):
        np.testing.assert_array_equal(
            tops.rotation_points_single_angle(cloud, 0.3, axis),
            jops.rotation_points_single_angle(cloud, 0.3, axis))
        np.testing.assert_array_equal(
            tops.center_to_corner_box3d(boxes[:, :3], boxes[:, 3:6],
                                        boxes[:, 6], axis=axis),
            jops.center_to_corner_box3d(boxes[:, :3], boxes[:, 3:6],
                                        boxes[:, 6], axis=axis))
    assert tops.points_in_rbbox(cloud, boxes).any()


def test_points3d_equals_jax():
    """`Points3D` (the arrays of `test_points.py`'s `make_points`): every
    accessor and in-place op, `add_height`, `convert_to`, `shuffle` and
    indexing exactly as the JAX class gives them."""
    arr = np.random.RandomState(0).uniform(-2, 2, (32, 6)).astype(np.float32)
    assert tpoints.default_attribute_dims(7, shift_height=True) == \
        jpoints.default_attribute_dims(7, shift_height=True)
    got = tpoints.Points3D(arr.copy(), tpoints.default_attribute_dims(6))
    want = jpoints.Points3D(arr.copy(), jpoints.default_attribute_dims(6))

    def same(a, b, what):
        np.testing.assert_array_equal(a.arr, b.arr, err_msg=what)
        assert a.attribute_dims == b.attribute_dims, what
        assert int(a.mode) == int(b.mode), what

    same(got, want, "built")
    np.testing.assert_array_equal(got.color, want.color)
    assert got.height is None and want.height is None
    np.testing.assert_array_equal(got.rotate(0.3), want.rotate(0.3))
    for direction in ("horizontal", "vertical"):
        got.flip(direction)
        want.flip(direction)
    got.translate([1.0, 2.0, 3.0])
    want.translate([1.0, 2.0, 3.0])
    got.scale(2.0)
    want.scale(2.0)
    same(got, want, "geometry")
    rng = [0, -10, -10, 10, 10, 10]
    np.testing.assert_array_equal(got.in_range_3d(rng), want.in_range_3d(rng))
    same(got[3:9], want[3:9], "getitem")
    gh, wh = got.add_height(), want.add_height()
    same(gh, wh, "add_height")
    np.testing.assert_array_equal(gh.height, wh.height)
    gc = gh.convert_to(tpoints.Box3DMode.CAM)
    wc = wh.convert_to(jboxes.Box3DMode.CAM)
    same(gc, wc, "convert_to")
    same(gc.convert_to(tpoints.Box3DMode.DEPTH),
         wc.convert_to(jboxes.Box3DMode.DEPTH), "round trip")
    np.testing.assert_array_equal(got.shuffle(np.random.default_rng(5)),
                                  want.shuffle(np.random.default_rng(5)))
    same(got, want, "shuffle")
    got.color = np.zeros((32, 3), np.float32)
    want.color = np.zeros((32, 3), np.float32)
    same(got, want, "color setter")


def test_geometry_helpers_equal_jax():
    """`limit_period`, `box_volume`, `scale_box7`, `translate_box7` exactly
    the jnp versions on the same float32 values; `rotate_box7` within
    ROT_ATOL."""
    boxes = rand_boxes(4, 16)
    t = torch.from_numpy(boxes)
    j = jnp.asarray(boxes)
    vals = np.linspace(-10, 10, 41, dtype=np.float32)
    for offset, period in ((0.5, np.pi), (0.0, 2 * np.pi), (1.0, np.pi)):
        np.testing.assert_array_equal(
            tgeo.limit_period(torch.from_numpy(vals), offset, period).numpy(),
            np.asarray(jgeo.limit_period(jnp.asarray(vals), offset, period)))
    np.testing.assert_array_equal(tgeo.box_volume(t).numpy(),
                                  np.asarray(jgeo.box_volume(j)))
    np.testing.assert_array_equal(tgeo.scale_box7(t, 1.5).numpy(),
                                  np.asarray(jgeo.scale_box7(j, 1.5)))
    trans = np.array([0.5, -1.0, 2.0], np.float32)
    np.testing.assert_array_equal(
        tgeo.translate_box7(t, trans).numpy(),
        np.asarray(jgeo.translate_box7(j, jnp.asarray(trans))))
    for angle in (0.7, -2.5):
        np.testing.assert_allclose(
            tgeo.rotate_box7(t, angle).numpy(),
            np.asarray(jgeo.rotate_box7(j, angle)), rtol=0, atol=ROT_ATOL)
