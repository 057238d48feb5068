"""The frame conversions (``geometry/modes.py``) and the point-cloud ops
(``geometry/points_ops.py``) against the reference package on the same
seeded inputs. Both are numpy on the host in both packages, so every output
is identical to the reference's, to the last bit, float64 and float32
alike; the known values of the reference's own tests hold too."""

import numpy as np
import pytest

from embodiedscan_tpu.geometry import modes as jM
from embodiedscan_tpu.geometry import points_ops as jP
from embodiedscan_torch.geometry import modes as tM
from embodiedscan_torch.geometry import points_ops as tP

FRAMES = (tM.LIDAR, tM.CAM, tM.DEPTH)
PAIRS = [(a, b) for a in FRAMES for b in FRAMES]


def _same(got, want):
    assert type(got) is type(want)
    if isinstance(got, tuple):
        for g, w in zip(got, want):
            _same(g, w)
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _yaw_boxes(rng, n, dtype):
    return np.concatenate([rng.randn(n, 3), rng.uniform(0.2, 2.0, (n, 3)),
                           rng.uniform(-2 * np.pi, 2 * np.pi, (n, 1)),
                           rng.randn(n, 2)], -1).astype(dtype)


def _euler_boxes(rng, n, dtype):
    return np.concatenate([rng.randn(n, 3), rng.uniform(0.2, 2.0, (n, 3)),
                           rng.uniform(-np.pi, np.pi, (n, 1)),
                           rng.uniform(-1.5, 1.5, (n, 2))], -1).astype(dtype)


def _rigid(rng, rows=4):
    q = np.linalg.qr(rng.randn(3, 3))[0]
    q[:, 0] *= np.sign(np.linalg.det(q))
    t = np.eye(4)
    t[:3, :3] = q
    t[:3, 3] = rng.randn(3)
    return t[:rows] if rows != 3 else q


def test_constants():
    assert (tM.LIDAR, tM.CAM, tM.DEPTH) == (jM.LIDAR, jM.CAM, jM.DEPTH)
    assert tM._RT == jM._RT and tM._SIZE_PERM == jM._SIZE_PERM
    assert tP.ROTATION_AXIS == jP.ROTATION_AXIS
    assert tP.BEV_AXES == jP.BEV_AXES and tP.FLIP_COLS == jP.FLIP_COLS


@pytest.mark.parametrize('dtype', [np.float32, np.float64])
def test_limit_period(dtype):
    val = np.random.RandomState(0).uniform(-20, 20, 200).astype(dtype)
    for offset, period in ((0.5, np.pi), (0.0, 2 * np.pi), (1.0, 1.0)):
        _same(tM.limit_period(val, offset, period),
              jM.limit_period(val, offset, period))


@pytest.mark.parametrize('rt', [None, 3, 4])
@pytest.mark.parametrize('dtype', [np.float32, np.float64])
def test_convert_points(dtype, rt):
    rng = np.random.RandomState(1)
    pts = rng.randn(2, 16, 5).astype(dtype)  # xyz and two passed columns
    mat = None if rt is None else _rigid(rng, rt)
    for a, b in PAIRS:
        if mat is None and a == b:
            assert tM.convert_points(pts, a, b) is pts
            continue
        _same(tM.convert_points(pts, a, b, mat),
              jM.convert_points(pts, a, b, mat))
        _same(tP.convert_to(pts, a, b, mat), jP.convert_to(pts, a, b, mat))
    np.testing.assert_allclose(
        tM.convert_points(np.array([[1.0, 2.0, 3.0, 0.5]]), tM.DEPTH,
                          tM.CAM), [[1.0, -3.0, 2.0, 0.5]])


@pytest.mark.parametrize('correct_yaw', [False, True])
@pytest.mark.parametrize('rt', [None, 3, 4])
@pytest.mark.parametrize('dtype', [np.float32, np.float64])
def test_convert_boxes(dtype, rt, correct_yaw):
    rng = np.random.RandomState(2)
    boxes = _yaw_boxes(rng, 24, dtype)
    mat = None if rt is None else _rigid(rng, rt)
    for a, b in PAIRS:
        if mat is None and a == b:
            assert tM.convert_boxes(boxes, a, b) is boxes
            continue
        _same(tM.convert_boxes(boxes, a, b, mat, correct_yaw),
              jM.convert_boxes(boxes, a, b, mat, correct_yaw))
    # the reference's size permutation and yaw remap, by hand
    box = np.array([[1.0, 2.0, 3.0, 0.4, 0.5, 0.6, 0.3]])
    np.testing.assert_allclose(tM.convert_boxes(box, tM.DEPTH, tM.CAM),
                               [[1.0, -3.0, 2.0, 0.4, 0.6, 0.5, -0.3]],
                               atol=1e-12)
    np.testing.assert_allclose(
        tM.convert_boxes(box, tM.LIDAR, tM.DEPTH),
        [[-2.0, 1.0, 3.0, 0.4, 0.5, 0.6, 0.3 + np.pi / 2]], atol=1e-12)


@pytest.mark.parametrize('rt', [None, 3, 4])
@pytest.mark.parametrize('dtype', [np.float32, np.float64])
def test_convert_euler_boxes(dtype, rt):
    rng = np.random.RandomState(3)
    boxes = _euler_boxes(rng, 24, dtype)
    boxes[0, 7] = np.pi / 2  # gimbal lock
    mat = None if rt is None else _rigid(rng, rt)
    for a, b in PAIRS:
        _same(tM.convert_euler_boxes(boxes, a, b, mat),
              jM.convert_euler_boxes(boxes, a, b, mat))
    t = _rigid(rng)
    _same(tM.cam_boxes_to_depth(boxes, t), jM.cam_boxes_to_depth(boxes, t))
    for mode in FRAMES:
        _same(tM.boxes_corners_mode(boxes, mode),
              jM.boxes_corners_mode(boxes, mode))
        _same(tM.boxes_corners_mode(boxes[:, :7], mode),
              jM.boxes_corners_mode(boxes[:, :7], mode))


def test_unsupported_conversion():
    box = np.zeros((1, 7))
    for M in (jM, tM):
        with pytest.raises(ValueError, match='unsupported'):
            M.convert_boxes(box, 'lidar', 'nowhere')


@pytest.mark.parametrize('mode', FRAMES)
@pytest.mark.parametrize('dtype', [np.float32, np.float64])
def test_points_ops(mode, dtype):
    rng = np.random.RandomState(4)
    pts = rng.uniform(-3, 3, (64, 5)).astype(dtype)
    for axis in (None, 0, 1, 2, -1, -2, -3):
        _same(tP.rotate(pts, 0.7, mode, axis), jP.rotate(pts, 0.7, mode, axis))
    q = _rigid(rng, 3)
    _same(tP.rotate(pts, q, mode), jP.rotate(pts, q, mode))
    for direction in ('horizontal', 'vertical'):
        _same(tP.flip(pts, direction, mode), jP.flip(pts, direction, mode))
    _same(tP.translate(pts, [0.5, -1, 2]), jP.translate(pts, [0.5, -1, 2]))
    _same(tP.scale(pts, 1.7), jP.scale(pts, 1.7))
    _same(tP.shuffle(pts, np.random.RandomState(9)),
          jP.shuffle(pts, np.random.RandomState(9)))
    rng6, rng4 = (-1, -2, -1.5, 2, 1, 2.5), (-1, -2, 2, 1)
    _same(tP.in_range_3d(pts, rng6), jP.in_range_3d(pts, rng6))
    _same(tP.bev(pts, mode), jP.bev(pts, mode))
    _same(tP.in_range_bev(pts, rng4, mode), jP.in_range_bev(pts, rng4, mode))
    with pytest.raises(ValueError):
        tP.rotate(pts, 0.1, mode, axis=3)


def test_points_ops_known_values():
    out, rot_t = tP.rotate(np.array([[1.0, 0.0, 5.0, 9.0]]), np.pi / 2,
                           mode=tM.DEPTH)
    np.testing.assert_allclose(out, [[0, 1, 5, 9]], atol=1e-12)
    pts = np.array([[1.0, 2.0, 3.0]])
    np.testing.assert_array_equal(tP.flip(pts, 'vertical', tM.CAM),
                                  [[1, 2, -3]])
    np.testing.assert_array_equal(tP.flip(pts, 'horizontal', tM.LIDAR),
                                  [[1, -2, 3]])
    np.testing.assert_array_equal(tP.bev(pts, tM.CAM), [[1, 3]])
