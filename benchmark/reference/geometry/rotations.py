"""Euler-angle (ZXY) rotation math for 9-DoF boxes.

Port of ``embodiedscan_tpu/geometry/rotations.py``: R = Rz(alpha) @ Rx(beta)
@ Ry(gamma), pytorch3d's 'ZXY' convention, in closed form.
"""

import torch


def euler_zxy_to_matrix(angles: torch.Tensor) -> torch.Tensor:
    """(..., 3) ZXY euler angles (alpha_z, beta_x, gamma_y) -> (..., 3, 3)."""
    a, b, g = angles[..., 0], angles[..., 1], angles[..., 2]
    ca, sa = torch.cos(a), torch.sin(a)
    cb, sb = torch.cos(b), torch.sin(b)
    cg, sg = torch.cos(g), torch.sin(g)
    return torch.stack([
        torch.stack([ca * cg - sa * sb * sg, -sa * cb,
                     ca * sg + sa * sb * cg], -1),
        torch.stack([sa * cg + ca * sb * sg, ca * cb,
                     sa * sg - ca * sb * cg], -1),
        torch.stack([-cb * sg, sb, cb * cg], -1),
    ], -2)


def matrix_to_euler_zxy(mat: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotation matrix -> (..., 3) ZXY euler angles."""
    beta = torch.asin(torch.clamp(mat[..., 2, 1], -1.0 + 1e-6, 1.0 - 1e-6))
    alpha = torch.atan2(-mat[..., 0, 1], mat[..., 1, 1])
    gamma = torch.atan2(-mat[..., 2, 0], mat[..., 2, 2])
    return torch.stack([alpha, beta, gamma], -1)


def rotation_3d_in_euler(points: torch.Tensor,
                         angles: torch.Tensor) -> torch.Tensor:
    """Rotate (N, M, 3) point sets by per-row (N, 3) ZXY angles: points @ R^T."""
    rot = euler_zxy_to_matrix(angles)
    return torch.einsum('...mj,...kj->...mk', points, rot)


def rotation_3d_in_axis(points: torch.Tensor, angles: torch.Tensor,
                        axis: int = 2) -> torch.Tensor:
    """Rotate (N, M, 3) points by per-row single-axis angles (N,)."""
    zeros = torch.zeros_like(angles)
    if axis in (0, -3):
        euler = torch.stack([zeros, angles, zeros], -1)  # X: the beta slot
    elif axis in (1, -2):
        euler = torch.stack([zeros, zeros, angles], -1)  # Y: the gamma slot
    elif axis in (2, -1):
        euler = torch.stack([angles, zeros, zeros], -1)  # Z: the alpha slot
    else:
        raise ValueError(f'axis must be in [-3, 2], got {axis}')
    return rotation_3d_in_euler(points, euler)


def ortho_6d_to_matrix(x_raw: torch.Tensor, y_raw: torch.Tensor) -> torch.Tensor:
    """6D rotation representation -> (..., 3, 3) matrix (Gram-Schmidt):
    y = norm(y_raw); z = norm(x_raw x y); x = y x z; columns (x, y, z)."""

    def _norm(v):
        return v / torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True) + 1e-12)

    y = _norm(y_raw)
    z = _norm(torch.linalg.cross(x_raw, y, dim=-1))
    x = torch.linalg.cross(y, z, dim=-1)
    return torch.stack([x, y, z], dim=-1)


def limit_period(val: torch.Tensor, offset: float = 0.5,
                 period: float = torch.pi) -> torch.Tensor:
    """Limit periodic values into [-offset*period, (1-offset)*period)."""
    return val - torch.floor(val / period + offset) * period
