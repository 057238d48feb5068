"""Detection losses, masked over static shapes, and the occupancy head's
cross-entropy (port of ``embodiedscan_tpu/models/losses.py``).

Where a value has ties on valid rows, the ops are spelled as JAX
differentiates them: ``torch.maximum`` and ``torch.amin`` split a gradient
equally among tied elements, as ``jnp.maximum`` / ``jnp.min`` do
(``torch.clamp`` and ``torch.min(dim)`` would pass it whole to one).
"""

import numpy as np
import torch

from ..geometry.iou import _abs, boxes3d_overlap_paired, boxes7d_to_9d
from ..geometry.rotations import euler_zxy_to_matrix

_EPS = float(np.finfo(np.float32).eps)


def sigmoid_focal_loss(logits: torch.Tensor, labels: torch.Tensor,
                       valid: torch.Tensor, num_classes: int,
                       avg_factor: torch.Tensor, gamma: float = 2.0,
                       alpha: float = 0.25) -> torch.Tensor:
    """Masked multi-class sigmoid focal loss summed over classes.

    Args:
        logits: (..., P, C).
        labels: (..., P) int, class index or -1 for background.
        valid: (..., P) rows to include.
        avg_factor: scalar normalizer.
    """
    onehot = labels[..., None] == torch.arange(num_classes,
                                               device=labels.device)
    p = torch.sigmoid(logits)
    pt = torch.where(onehot, p, 1 - p)
    alpha_t = torch.where(onehot, alpha, 1 - alpha)
    ce = -torch.log(torch.maximum(pt, pt.new_tensor(1e-12)))
    loss = alpha_t * torch.pow(1 - pt, gamma) * ce
    loss = torch.where(valid[..., None], loss, torch.zeros_like(loss))
    return loss.sum() / (avg_factor + _EPS)


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor,
                    valid: torch.Tensor,
                    avg_factor: torch.Tensor) -> torch.Tensor:
    """Masked binary cross entropy with soft targets."""
    loss = torch.maximum(logits, logits.new_tensor(0.0)) - logits * targets \
        + torch.log1p(torch.exp(-_abs(logits)))
    loss = torch.where(valid, loss, torch.zeros_like(loss))
    return loss.sum() / (avg_factor + _EPS)


# Corner signs of the reference's CD-loss bbox_to_corners
_CD_CORNERS = np.stack([
    np.array([1, 1, 1, 1, -1, -1, -1, -1], np.float32),
    np.array([1, 1, -1, -1, 1, 1, -1, -1], np.float32),
    np.array([1, -1, 1, -1, 1, -1, 1, -1], np.float32),
], axis=-1)  # (8, 3)


def bbox_to_corners(bbox: torch.Tensor) -> torch.Tensor:
    """(N, 9) euler boxes -> (N, 8, 3) corners (the CD-loss layout)."""
    rot = euler_zxy_to_matrix(bbox[:, 6:9])
    half = bbox[:, None, 3:6] / 2
    local = torch.as_tensor(_CD_CORNERS, device=bbox.device) * half
    rotated = (local[:, :, None, :] * rot[:, None, :, :]).sum(-1)
    return bbox[:, None, :3] + rotated


def _corner_chamfer(src_c: torch.Tensor, dst_c: torch.Tensor,
                    mode: str) -> torch.Tensor:
    """Per-box one-directional chamfer over corners, (N, K, 3) -> (N, K):
    each source corner's distance to the nearest target corner, L1
    (``'l1'``) or the squared L2 (``'l2'``)."""
    diff = src_c[:, :, None, :] - dst_c[:, None, :, :]
    if mode == 'l1':
        dist = _abs(diff).sum(-1)
    elif mode == 'l2':
        dist = (diff * diff).sum(-1)
    else:
        raise ValueError(f'unknown cd_mode {mode!r}')
    return dist.amin(dim=2)


def bbox_cd_loss(src: torch.Tensor, dst: torch.Tensor, valid: torch.Tensor,
                 mode: str = 'l1', group: str = 'g8',
                 reduction: str = 'mean') -> torch.Tensor:
    """Corner chamfer distance between box sets (masked rows excluded):
    ``group='g8'`` matches each corner among all 8 target corners,
    ``'g4'`` among the 4 on its own side of the box's x axis.

    ``reduction='mean'`` averages over valid boxes x corners; ``'none'``
    returns (N, 8).
    """
    sc, dc = bbox_to_corners(src), bbox_to_corners(dst)
    if group == 'g8':
        per = _corner_chamfer(sc, dc, mode)
    elif group == 'g4':
        per = torch.cat([_corner_chamfer(sc[:, :4], dc[:, :4], mode),
                         _corner_chamfer(sc[:, 4:], dc[:, 4:], mode)], 1)
    else:
        raise ValueError(f'unknown cd_group {group!r}')
    per = torch.where(valid[:, None], per, torch.zeros_like(per))
    if reduction == 'none':
        return per
    denom = torch.clamp(valid.to(per.dtype).sum() * per.shape[1], min=1.0)
    return per.sum() / denom


def _valid_mean(loss: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """The mean of ``loss`` over the valid rows (0 without one)."""
    loss = torch.where(valid, loss, torch.zeros_like(loss))
    return loss.sum() / torch.clamp(valid.sum(), min=1)


def rotated_iou_loss(pred: torch.Tensor, target: torch.Tensor,
                     valid: torch.Tensor) -> torch.Tensor:
    """1 - IoU of rotated boxes (the reference's ``RotatedIoU3DLoss``),
    averaged over the valid rows: (N, 7 or 9) x 2 -> scalar. The exact
    oriented overlap, differentiated through the clip construction; 7-dim
    yaw boxes take zero pitch and roll."""
    _, iou = boxes3d_overlap_paired(boxes7d_to_9d(pred),
                                    boxes7d_to_9d(target))
    return _valid_mean(1.0 - iou, valid)


def axis_aligned_iou_loss(pred: torch.Tensor, target: torch.Tensor,
                          valid: torch.Tensor) -> torch.Tensor:
    """1 - IoU of axis-aligned boxes given as x1y1z1x2y2z2 (the
    reference's ``AxisAlignedIoULoss``), averaged over the valid rows."""
    lt = torch.maximum(pred[:, :3], target[:, :3])
    rb = torch.minimum(pred[:, 3:], target[:, 3:])
    zero = pred.new_tensor(0.0)
    whd = torch.maximum(rb - lt, zero)
    inter = whd[:, 0] * whd[:, 1] * whd[:, 2]
    vp = torch.prod(torch.maximum(pred[:, 3:] - pred[:, :3], zero), -1)
    vt = torch.prod(torch.maximum(target[:, 3:] - target[:, :3], zero), -1)
    iou = inter / torch.maximum(vp + vt - inter, pred.new_tensor(1e-8))
    return _valid_mean(1.0 - iou, valid)


def cross_entropy_ignore(logits: torch.Tensor, labels: torch.Tensor,
                         ignore_index: int = 255,
                         weight: torch.Tensor | None = None) -> torch.Tensor:
    """Mean cross-entropy over the labels that are not ``ignore_index``
    (the occupancy head's), optionally class-weighted: the sum over those
    voxels divided by their count (or weight), at least 1."""
    valid = labels != ignore_index
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    if weight is not None:
        w = weight[safe]
        nll = nll * w
        denom = torch.where(valid, w, torch.zeros_like(w)).sum()
    else:
        denom = valid.sum().to(nll.dtype)
    return torch.where(valid, nll, torch.zeros_like(nll)).sum() / \
        torch.clamp(denom, min=1.0)
