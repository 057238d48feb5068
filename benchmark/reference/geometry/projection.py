"""Camera <-> image projection helpers (port of
``embodiedscan_tpu/geometry/projection.py``, the reference's
``structures/bbox_3d/utils.py:244-416``). Each runs on its inputs'
device."""

import torch


def _pad_to_4x4(mat: torch.Tensor) -> torch.Tensor:
    """Embed a (..., r<=4, c<=4) projection matrix into (..., 4, 4) identity."""
    r, c = mat.shape[-2:]
    if (r, c) == (4, 4):
        return mat
    out = torch.eye(4, dtype=mat.dtype, device=mat.device).expand(
        mat.shape[:-2] + (4, 4)).clone()
    out[..., :r, :c] = mat
    return out


def _homogeneous(points: torch.Tensor) -> torch.Tensor:
    return torch.cat([points, torch.ones_like(points[..., :1])], dim=-1)


def points_cam2img(points_3d: torch.Tensor, proj_mat: torch.Tensor,
                   with_depth: bool = False) -> torch.Tensor:
    """Project (..., 3) camera-frame points to the image plane through an
    (r, c) projection matrix -> (..., 2), or (..., 3) with the depth."""
    pt2d = _homogeneous(points_3d) @ _pad_to_4x4(proj_mat).T
    res = pt2d[..., :2] / pt2d[..., 2:3]
    if with_depth:
        res = torch.cat([res, pt2d[..., 2:3]], dim=-1)
    return res


def batch_points_cam2img(points_3d: torch.Tensor, proj_mat: torch.Tensor,
                         with_depth: bool = False) -> torch.Tensor:
    """(V, N, 3) points by (V, r, c) matrices -> (V, N, 2|3). The depth is
    clamped at 1e-3 before the division (``utils.py:290-334``), so points
    behind the camera stay finite."""
    pt2d = torch.einsum('vnj,vkj->vnk', _homogeneous(points_3d),
                        _pad_to_4x4(proj_mat))
    res = pt2d[..., :2] / torch.clamp(pt2d[..., 2:3], min=1e-3)
    if with_depth:
        res = torch.cat([res, pt2d[..., 2:3]], dim=-1)
    return res


def points_img2cam(points: torch.Tensor,
                   cam2img: torch.Tensor) -> torch.Tensor:
    """Back-project (..., 3) image points (u, v, depth) into the camera
    frame."""
    xys, depths = points[..., :2], points[..., 2:3]
    unnormed = torch.cat([xys * depths, depths], dim=-1)
    inv = torch.linalg.inv(_pad_to_4x4(cam2img))
    return (_homogeneous(unnormed) @ inv.T)[..., :3]


def get_lidar2img(cam2img: torch.Tensor,
                  lidar2cam: torch.Tensor) -> torch.Tensor:
    """Compose intrinsic and extrinsic into a single 4x4 projection."""
    return _pad_to_4x4(cam2img) @ _pad_to_4x4(lidar2cam)
