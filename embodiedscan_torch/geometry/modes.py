"""Box and point frame conversions on the host (port of
``embodiedscan_tpu/geometry/modes.py``; numpy, no device).

Pure functions over ``(..., K)`` arrays in three frames:

    LIDAR  x front, y left,  z up    (yaw about z; bottom origin (.5,.5,0))
    CAM    x right, y down,  z front (yaw about y; origin (.5,1,.5))
    DEPTH  x right, y front, z up    (yaw about z; bottom origin (.5,.5,0))

Yaw-box conversions reproduce the reference's size permutations and yaw
remaps exactly (``box_3d_mode.py:123-244``). ``convert_euler_boxes``
converts 9-DoF euler boxes by composing the frame change into each box's
rotation matrix.
"""

import numpy as np

from .np_boxes import (corners_np, euler_zxy_to_matrix_np,
                       matrix_to_euler_zxy_np)

LIDAR = 'lidar'
CAM = 'cam'
DEPTH = 'depth'

# default src->dst rotation matrices (coord_3d_mode.py:218-233)
_RT = {
    (LIDAR, CAM): [[0, -1, 0], [0, 0, -1], [1, 0, 0]],
    (CAM, LIDAR): [[0, 0, 1], [-1, 0, 0], [0, -1, 0]],
    (DEPTH, CAM): [[1, 0, 0], [0, 0, -1], [0, 1, 0]],
    (CAM, DEPTH): [[1, 0, 0], [0, 0, 1], [0, -1, 0]],
    (LIDAR, DEPTH): [[0, -1, 0], [1, 0, 0], [0, 0, 1]],
    (DEPTH, LIDAR): [[0, 1, 0], [-1, 0, 0], [0, 0, 1]],
}

# (dx, dy, dz) index permutation of the box sizes per conversion
# (box_3d_mode.py:129-213: every cam<->lidar/depth swap exchanges y/z size)
_SIZE_PERM = {
    (LIDAR, CAM): (0, 2, 1),
    (CAM, LIDAR): (0, 2, 1),
    (DEPTH, CAM): (0, 2, 1),
    (CAM, DEPTH): (0, 2, 1),
    (LIDAR, DEPTH): (0, 1, 2),
    (DEPTH, LIDAR): (0, 1, 2),
}


def limit_period(val, offset: float = 0.5, period: float = np.pi):
    """Wrap angles into [-offset*period, (1-offset)*period) (utils.py:14)."""
    return val - np.floor(val / period + offset) * period


def _default_yaw(src: str, dst: str, yaw):
    """The reference's fixed-frame yaw remap (box_3d_mode.py:140-213)."""
    if (src, dst) in ((LIDAR, CAM), (CAM, LIDAR)):
        return limit_period(-yaw - np.pi / 2, period=2 * np.pi)
    if (src, dst) in ((DEPTH, CAM), (CAM, DEPTH)):
        return -yaw
    if (src, dst) == (LIDAR, DEPTH):
        return limit_period(yaw + np.pi / 2, period=2 * np.pi)
    return limit_period(yaw - np.pi / 2, period=2 * np.pi)


def convert_points(points, src: str, dst: str, rt_mat=None):
    """(..., 3+) points src->dst; extra columns (rgb etc.) pass through.

    Matches ``Coord3DMode.convert_point`` (coord_3d_mode.py:171-247).
    """
    if src == dst and rt_mat is None:
        return points
    pts = np.asarray(points)
    rt_mat = np.asarray(_RT[(src, dst)] if rt_mat is None else rt_mat,
                        dtype=pts.dtype)
    if rt_mat.shape[-1] == 4:
        xyz = pts[..., :3] @ rt_mat[:3, :3].T + rt_mat[:3, 3]
    else:
        xyz = pts[..., :3] @ rt_mat.T
    return np.concatenate([xyz, pts[..., 3:]], axis=-1)


def convert_boxes(boxes, src: str, dst: str, rt_mat=None,
                  correct_yaw: bool = False):
    """(..., 7+) yaw boxes src->dst (Box3DMode.convert, box_3d_mode.py:66).

    Args:
        boxes: (N, 7+) rows (x, y, z, dx, dy, dz, yaw, ...). Extra columns
            pass through unchanged.
        rt_mat: optional (3, 3) or (3, 4)/(4, 4) src->dst transform; defaults
            to the fixed frame change.
        correct_yaw: rotate the yaw direction vector through ``rt_mat``
            instead of applying the fixed-frame remap (box_3d_mode.py:131-138).
    """
    if src == dst and rt_mat is None:
        return boxes
    arr = np.asarray(boxes)
    if (src, dst) not in _SIZE_PERM and rt_mat is None:
        raise ValueError(f'unsupported conversion {src}->{dst}')
    perm = _SIZE_PERM.get((src, dst), (0, 1, 2))
    sizes = arr[..., 3:6][..., list(perm)]
    yaw = arr[..., 6]

    default_rt = np.asarray(_RT[(src, dst)], dtype=arr.dtype) \
        if (src, dst) in _RT else None
    mat = default_rt if rt_mat is None else np.asarray(rt_mat,
                                                       dtype=arr.dtype)
    if mat.shape[-1] == 4:
        xyz = arr[..., :3] @ mat[:3, :3].T + mat[:3, 3]
        rot = mat[:3, :3]
    else:
        xyz = arr[..., :3] @ mat.T
        rot = mat
    if correct_yaw:
        # rotate the in-plane yaw direction vector through rt_mat
        # (box_3d_mode.py:236-244)
        if src == CAM:
            vec = np.stack([np.cos(-yaw), np.zeros_like(yaw),
                            np.sin(-yaw)], -1)
        else:
            vec = np.stack([np.cos(yaw), np.sin(yaw),
                            np.zeros_like(yaw)], -1)
        rv = vec @ rot.T
        if dst == CAM:
            yaw = np.arctan2(-rv[..., 2], rv[..., 0])
        else:
            yaw = np.arctan2(rv[..., 1], rv[..., 0])
        yaw = limit_period(yaw, period=2 * np.pi)
    else:
        yaw = _default_yaw(src, dst, yaw)
    return np.concatenate(
        [xyz, sizes, yaw[..., None], arr[..., 7:]], axis=-1)


# ---------------------------------------------------------------------------
# 9-DoF euler boxes (the conversion the reference leaves unimplemented)
# ---------------------------------------------------------------------------

def convert_euler_boxes(boxes, src: str, dst: str, rt_mat=None):
    """(..., 9) euler boxes src->dst by rotation-matrix composition.

    ``R_dst = T[:3,:3] @ R_src`` with the box center transformed through
    ``T``; sizes are frame-invariant under a rigid transform (unlike the
    yaw-box path, no size permutation is needed because the full orientation
    travels with the box). Fills the hole at box_3d_mode.py:219
    ('TODO: add transformation between euler boxes').
    """
    arr = np.asarray(boxes)
    if rt_mat is None:
        if src == dst:
            return boxes
        rt_mat = np.asarray(_RT[(src, dst)], dtype=arr.dtype)
    else:
        rt_mat = np.asarray(rt_mat, dtype=arr.dtype)
    if rt_mat.shape[-1] == 4:
        xyz = arr[..., :3] @ rt_mat[:3, :3].T + rt_mat[:3, 3]
        rot = rt_mat[:3, :3]
    else:
        xyz = arr[..., :3] @ rt_mat.T
        rot = rt_mat
    r_src = euler_zxy_to_matrix_np(arr[..., 6:9])
    r_dst = rot @ r_src
    angles = matrix_to_euler_zxy_np(r_dst)
    return np.concatenate([xyz, arr[..., 3:6], angles], axis=-1)


def cam_boxes_to_depth(boxes, cam2global):
    """Euler boxes predicted in a camera frame -> global depth frame.

    ``cam2global`` is the 4x4 camera-to-world matrix (the dataset's
    ``axis_align_matrix @ cam2global``, embodiedscan_dataset.py:159). The
    in-the-wild demo uses this to accept scans annotated in cam frame.
    """
    return convert_euler_boxes(boxes, CAM, DEPTH, rt_mat=np.asarray(
        cam2global))


def boxes_corners_mode(boxes, mode: str):
    """Corners of yaw/euler boxes in any frame (debug/vis helper)."""
    arr = np.asarray(boxes)
    if arr.shape[-1] == 9:
        return corners_np(arr)
    padded = np.concatenate(
        [arr[..., :7],
         np.zeros(arr.shape[:-1] + (2,), arr.dtype)], -1)
    return corners_np(padded)
