"""Numpy 9-DoF box helpers for the host: the data pipeline, the synthetic
scans, the viewers and the frame conversions (port of
``embodiedscan_tpu/geometry/np_boxes.py``).

ZXY euler convention (reference ``euler_box3d.py``); the loader stays a
plain numpy program and touches no device.
"""

import numpy as np


def euler_zxy_to_matrix_np(angles: np.ndarray) -> np.ndarray:
    """(..., 3) ZXY euler -> (..., 3, 3): Rz(a) @ Rx(b) @ Ry(g)."""
    a, b, g = angles[..., 0], angles[..., 1], angles[..., 2]
    ca, sa = np.cos(a), np.sin(a)
    cb, sb = np.cos(b), np.sin(b)
    cg, sg = np.cos(g), np.sin(g)
    o, z = np.ones_like(a), np.zeros_like(a)
    rz = np.stack([ca, -sa, z, sa, ca, z, z, z, o],
                  -1).reshape(a.shape + (3, 3))
    rx = np.stack([o, z, z, z, cb, -sb, z, sb, cb],
                  -1).reshape(a.shape + (3, 3))
    ry = np.stack([cg, z, sg, z, o, z, -sg, z, cg],
                  -1).reshape(a.shape + (3, 3))
    return rz @ rx @ ry


def matrix_to_euler_zxy_np(mat: np.ndarray) -> np.ndarray:
    """Inverse of :func:`euler_zxy_to_matrix_np`."""
    beta = np.arcsin(np.clip(mat[..., 2, 1], -1.0, 1.0))
    alpha = np.arctan2(-mat[..., 0, 1], mat[..., 1, 1])
    gamma = np.arctan2(-mat[..., 2, 0], mat[..., 2, 2])
    return np.stack([alpha, beta, gamma], -1)


def transform_boxes_np(boxes: np.ndarray, matrix: np.ndarray) -> np.ndarray:
    """Rigid 4x4 transform of (N, 9) boxes (euler_box3d.py:190-213)."""
    rot = matrix[:3, :3]
    trans = matrix[:3, 3]
    center = boxes[:, :3] @ rot.T + trans
    ori = euler_zxy_to_matrix_np(boxes[:, 6:9])
    angles = matrix_to_euler_zxy_np(rot[None] @ ori)
    return np.concatenate([center, boxes[:, 3:6], angles],
                          -1).astype(np.float32)


def rotate_z_boxes_np(boxes: np.ndarray, angle: float) -> np.ndarray:
    """Rotate boxes about global Z (euler_box3d.py:215-259 with yaw angle)."""
    mat = np.eye(4, dtype=np.float32)
    mat[:3, :3] = euler_zxy_to_matrix_np(np.array([angle, 0.0, 0.0]))
    return transform_boxes_np(boxes, mat)


def flip_boxes_np(boxes: np.ndarray, direction: str = 'X') -> np.ndarray:
    """Mirror boxes (euler_box3d.py:269-289 formula)."""
    boxes = boxes.copy()
    if direction == 'X':
        boxes[:, 0] = -boxes[:, 0]
        boxes[:, 6] = -boxes[:, 6] + np.pi
        boxes[:, 8] = -boxes[:, 8]
    elif direction == 'Y':
        boxes[:, 1] = -boxes[:, 1]
        boxes[:, 6] = -boxes[:, 6]
        boxes[:, 7] = -boxes[:, 7] + np.pi
    else:
        raise ValueError(direction)
    return boxes


def corners_np(boxes: np.ndarray) -> np.ndarray:
    """(N, 9) -> (N, 8, 3) corners (reference ordering)."""
    norm = np.stack(np.unravel_index(np.arange(8), [2] * 3),
                    axis=1)[[0, 1, 3, 2, 4, 5, 7, 6]].astype(np.float32) - 0.5
    local = boxes[:, None, 3:6] * norm[None]
    rot = euler_zxy_to_matrix_np(boxes[:, 6:9])
    return np.einsum('nkj,nij->nki', local, rot) + boxes[:, None, :3]


def points_in_boxes_np(points: np.ndarray, boxes: np.ndarray) -> np.ndarray:
    """(P, 3) points x (N, 9) boxes -> (P, N) bool containment.

    Host-side analog of :func:`geometry.boxes.points_in_boxes` (reference
    ``EulerInstance3DBoxes.points_in_boxes``): a point is inside iff its
    box-frame coordinates are within the half-dims.
    """
    rot = euler_zxy_to_matrix_np(boxes[:, 6:9])  # (N, 3, 3)
    rel = points[:, None, :] - boxes[None, :, :3]  # (P, N, 3)
    local = np.einsum('pnj,njk->pnk', rel, rot)  # rel @ R = R^T(world->local)
    half = boxes[None, :, 3:6] / 2
    return np.all(np.abs(local) <= half, axis=-1)


def corner_to_standup_np(corners: np.ndarray) -> np.ndarray:
    """(N, 8, 3) corners -> (N, 6) axis-aligned [min_xyz, max_xyz] boxes.

    Host analog of the reference ``corner_to_standup_nd_jit``
    (structures/ops/box_np_ops.py:235-253), generalized to 3D.
    """
    return np.concatenate([corners.min(axis=1), corners.max(axis=1)], -1)


def boxes_to_standup_np(boxes: np.ndarray) -> np.ndarray:
    """(N, 9) rotated boxes -> (N, 6) enclosing axis-aligned boxes."""
    return corner_to_standup_np(corners_np(boxes))


def corners_bev_np(boxes: np.ndarray) -> np.ndarray:
    """(N, 9) -> (N, 4, 2) BEV (xy) corners of the yaw-rotated footprint.

    Mirrors the reference ``center_to_corner_box2d``
    (structures/ops/box_np_ops.py:96-120) applied to the box BEV projection:
    only the z-euler (yaw) rotates the footprint.
    """
    norm = np.array([[-0.5, -0.5], [-0.5, 0.5], [0.5, 0.5], [0.5, -0.5]],
                    np.float32)
    local = boxes[:, None, 3:5] * norm[None]  # (N, 4, 2)
    yaw = boxes[:, 6]
    c, s = np.cos(yaw), np.sin(yaw)
    rot = np.stack([np.stack([c, -s], -1), np.stack([s, c], -1)],
                   1)  # (N, 2, 2) row-major Rz
    return np.einsum('nkj,nij->nki', local, rot) + boxes[:, None, :2]
