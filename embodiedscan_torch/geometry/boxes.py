"""9-DoF Euler box helpers (port of ``embodiedscan_tpu/geometry/boxes.py``).

A box is ``(x, y, z, dx, dy, dz, alpha, beta, gamma)`` with ZXY euler angles
and a gravity-centered origin.
"""

import numpy as np
import torch

from .rotations import euler_zxy_to_matrix, rotation_3d_in_euler

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
