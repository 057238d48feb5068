"""9-DoF Euler box helpers (port of ``embodiedscan_tpu/geometry/boxes.py``).

A box is ``(x, y, z, dx, dy, dz, alpha, beta, gamma)`` with ZXY euler angles
and a gravity-centered origin.
"""

import numpy as np
import torch

from .rotations import (euler_zxy_to_matrix, matrix_to_euler_zxy,
                        rotation_3d_in_euler)

# Corner order of the reference:
# (x0y0z0, x0y0z1, x0y1z1, x0y1z0, x1y0z0, x1y0z1, x1y1z1, x1y1z0).
_CORNERS_NORM = np.stack(np.unravel_index(np.arange(8), [2] * 3),
                         axis=1)[[0, 1, 3, 2, 4, 5, 7, 6]].astype(
                             np.float32) - 0.5


def corners(boxes: torch.Tensor) -> torch.Tensor:
    """(..., 9) boxes -> (..., 8, 3) corners in the reference's order."""
    dims = boxes[..., 3:6]
    ctr = boxes[..., :3]
    norm = torch.as_tensor(_CORNERS_NORM, dtype=boxes.dtype,
                           device=boxes.device)
    local = dims[..., None, :] * norm
    rotated = rotation_3d_in_euler(local, boxes[..., 6:9])
    return rotated + ctr[..., None, :]


def volume(boxes: torch.Tensor) -> torch.Tensor:
    """(..., 9) -> (...) box volumes."""
    return boxes[..., 3] * boxes[..., 4] * boxes[..., 5]


def gravity_center(boxes: torch.Tensor) -> torch.Tensor:
    """(..., 9) -> (..., 3). Euler boxes are already gravity-centered."""
    return boxes[..., :3]


def transform(boxes: torch.Tensor, matrix: torch.Tensor) -> torch.Tensor:
    """Apply a rigid 4x4 (or rotation-only 3x3) transform to boxes: the
    rotation composed with each box's euler matrix, the ZXY angles
    extracted again (euler_box3d.py:190-213)."""
    if matrix.shape[-1] == 3:
        rot = matrix
        trans = torch.zeros(3, dtype=boxes.dtype, device=boxes.device)
    else:
        rot = matrix[..., :3, :3]
        trans = matrix[..., :3, 3]
    center = boxes[..., :3] @ rot.T + trans
    angles = matrix_to_euler_zxy(rot @ euler_zxy_to_matrix(boxes[..., 6:9]))
    return torch.cat([center, boxes[..., 3:6], angles], dim=-1)


def rotate(boxes: torch.Tensor, rot_mat: torch.Tensor) -> torch.Tensor:
    """Rotate boxes by a 3x3 rotation matrix (euler_box3d.py:215-259)."""
    return transform(boxes, rot_mat)


def scale(boxes: torch.Tensor, factor) -> torch.Tensor:
    """Scale centers and sizes by a scalar factor (euler_box3d.py:261-267)."""
    return torch.cat([boxes[..., :6] * factor, boxes[..., 6:9]], dim=-1)


def translate(boxes: torch.Tensor, trans: torch.Tensor) -> torch.Tensor:
    """Shift box centers by a (3,) translation."""
    return torch.cat([boxes[..., :3] + trans, boxes[..., 3:]], dim=-1)


def flip(boxes: torch.Tensor, direction: str = 'X') -> torch.Tensor:
    """Mirror boxes along a coordinate plane with the reference's formula
    (euler_box3d.py:269-289): an exact mirror for yaw-only boxes.
    ``direction='X'`` negates x (the depth boxes' horizontal flip)."""
    x, y, z = boxes[..., 0], boxes[..., 1], boxes[..., 2]
    a, b, g = boxes[..., 6], boxes[..., 7], boxes[..., 8]
    if direction == 'X':
        x, a, g = -x, -a + torch.pi, -g
    elif direction == 'Y':
        y, a, b = -y, -a, -b + torch.pi
    elif direction == 'Z':
        z, b, g = -z, -b, -g + torch.pi
    else:
        raise ValueError(direction)
    return torch.cat([torch.stack([x, y, z], -1), boxes[..., 3:6],
                      torch.stack([a, b, g], -1)], dim=-1)


def points_in_boxes(points: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """(N, 3) points x (M, 9) boxes -> (N, M) bool: the point's box-frame
    coordinates lie within the half-dims."""
    rot = euler_zxy_to_matrix(boxes[..., 6:9])  # (M, 3, 3)
    rel = points[:, None, :] - boxes[None, :, :3]  # (N, M, 3)
    local = torch.einsum('nmj,mjk->nmk', rel, rot)  # rel @ R: world -> box
    half = boxes[None, :, 3:6] / 2
    return torch.all(torch.abs(local) <= half, dim=-1)


def face_distances(points: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """(N, 3) points x (M, 9) gravity-centered boxes -> (N, M, 6) distances
    to the faces (dx_min, dx_max, dy_min, dy_max, dz_min, dz_max), all
    positive iff the point is inside the box. The shift is rotated by the
    negated angles, as the reference does."""
    shift = points[:, None, :] - boxes[None, :, :3]  # (N, M, 3)
    rot = euler_zxy_to_matrix(-boxes[..., 6:9])  # (M, 3, 3)
    local = torch.einsum('nmj,mkj->nmk', shift, rot)
    half = boxes[None, :, 3:6] / 2
    d_min = local + half
    d_max = half - local
    return torch.stack([d_min[..., 0], d_max[..., 0], d_min[..., 1],
                        d_max[..., 1], d_min[..., 2], d_max[..., 2]], -1)
