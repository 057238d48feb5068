"""Point-cloud ops on the host, aware of the frame (port of
``embodiedscan_tpu/geometry/points_ops.py``; numpy, no device).

A point cloud is an ``(N, 3+)`` array plus a frame name; every op returns a
new array, and extra columns (color, height, ...) pass through. The
per-frame rotation axis, BEV axes and flip columns are the reference's
(``depth_points.py``, ``cam_points.py``, ``lidar_points.py:37-50``).
"""

from typing import Optional, Union

import numpy as np

from .modes import CAM, DEPTH, LIDAR, convert_points

# default rotation axis per mode (z for depth/lidar, y for cam)
ROTATION_AXIS = {DEPTH: 2, LIDAR: 2, CAM: 1}
# bev columns per mode (base_points.py:263-266 uses [0, 1] for depth/lidar;
# cam bev is x/z)
BEV_AXES = {DEPTH: (0, 1), LIDAR: (0, 1), CAM: (0, 2)}
# (horizontal, vertical) flip column per mode
FLIP_COLS = {DEPTH: (0, 1), CAM: (0, 2), LIDAR: (1, 0)}


def _rot_mat_t(angle: float, axis: int, dtype) -> np.ndarray:
    """Transposed axis-rotation matrix; ``xyz_new = xyz @ rot_mat_T``
    (utils.py:138-156 layouts, including axis=1's flipped sin signs)."""
    c, s = np.cos(angle), np.sin(angle)
    if axis in (1, -2):
        m = [[c, 0, -s], [0, 1, 0], [s, 0, c]]
    elif axis in (2, -1):
        m = [[c, s, 0], [-s, c, 0], [0, 0, 1]]
    elif axis in (0, -3):
        m = [[1, 0, 0], [0, c, s], [0, -s, c]]
    else:
        raise ValueError(f'axis should be in [-3, 2], got {axis}')
    return np.asarray(m, dtype=dtype)


def rotate(points: np.ndarray, rotation: Union[float, np.ndarray],
           mode: str = DEPTH, axis: Optional[int] = None):
    """Rotate xyz by an angle (about the mode's axis) or a 3x3 matrix.

    Returns (points, rot_mat_T) like ``BasePoints.rotate``
    (base_points.py:168-203), where ``xyz_new = xyz @ rot_mat_T``.
    """
    pts = np.asarray(points)
    if np.ndim(rotation) == 2:
        rot_t = np.asarray(rotation, pts.dtype)
    else:
        if axis is None:
            axis = ROTATION_AXIS[mode]
        rot_t = _rot_mat_t(float(rotation), axis, pts.dtype)
    xyz = pts[..., :3] @ rot_t
    return np.concatenate([xyz, pts[..., 3:]], -1), rot_t


def flip(points: np.ndarray, bev_direction: str = 'horizontal',
         mode: str = DEPTH) -> np.ndarray:
    """Mirror the mode's horizontal/vertical BEV column."""
    assert bev_direction in ('horizontal', 'vertical')
    col = FLIP_COLS[mode][0 if bev_direction == 'horizontal' else 1]
    out = np.array(points, copy=True)
    out[..., col] = -out[..., col]
    return out


def translate(points: np.ndarray, trans: np.ndarray) -> np.ndarray:
    out = np.array(points, copy=True)
    out[..., :3] = out[..., :3] + np.asarray(trans, out.dtype)
    return out


def scale(points: np.ndarray, factor: float) -> np.ndarray:
    out = np.array(points, copy=True)
    out[..., :3] *= factor
    return out


def shuffle(points: np.ndarray, rng=None) -> np.ndarray:
    rng = rng or np.random
    idx = rng.permutation(len(points))
    return np.asarray(points)[idx]


def in_range_3d(points: np.ndarray, rng6) -> np.ndarray:
    """(N,) bool: strictly inside (x0, y0, z0, x1, y1, z1)
    (base_points.py:236-262)."""
    p = np.asarray(points)
    return ((p[..., 0] > rng6[0]) & (p[..., 1] > rng6[1]) &
            (p[..., 2] > rng6[2]) & (p[..., 0] < rng6[3]) &
            (p[..., 1] < rng6[4]) & (p[..., 2] < rng6[5]))


def bev(points: np.ndarray, mode: str = DEPTH) -> np.ndarray:
    a, b = BEV_AXES[mode]
    p = np.asarray(points)
    return np.stack([p[..., a], p[..., b]], -1)


def in_range_bev(points: np.ndarray, rng4, mode: str = DEPTH) -> np.ndarray:
    """(N,) bool: BEV coords strictly inside (u0, v0, u1, v1)."""
    uv = bev(points, mode)
    return ((uv[..., 0] > rng4[0]) & (uv[..., 1] > rng4[1]) &
            (uv[..., 0] < rng4[2]) & (uv[..., 1] < rng4[3]))


def convert_to(points: np.ndarray, src: str, dst: str,
               rt_mat=None) -> np.ndarray:
    """Coordinate-mode change (``BasePoints.convert_to``,
    base_points.py:287-307)."""
    return convert_points(points, src, dst, rt_mat=rt_mat)
