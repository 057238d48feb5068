"""Hungarian match costs (port of ``embodiedscan_tpu/models/match_costs.py``).

Each returns a (..., num_preds, num_gts) cost matrix over matching leading
dimensions (the reference's are unbatched: (Q, ...) x (G, ...) -> (Q, G));
weights are applied by the caller, the grounder's match step.
"""

import torch

from ..geometry.iou import boxes3d_iou


def _focal_terms(logits, alpha, gamma, eps):
    """(positive, negative) focal cost terms of sigmoid probabilities."""
    p = torch.sigmoid(logits)
    neg = -torch.log(1 - p + eps) * (1 - alpha) * torch.pow(p, gamma)
    pos = -torch.log(p + eps) * alpha * torch.pow(1 - p, gamma)
    return pos, neg


def bbox3d_l1_cost(pred_boxes: torch.Tensor,
                   gt_boxes: torch.Tensor) -> torch.Tensor:
    """L1 cdist over 9-dim boxes: (..., Q, 9) x (..., G, 9) -> (..., Q, G)."""
    return torch.abs(pred_boxes[..., :, None, :] -
                     gt_boxes[..., None, :, :]).sum(-1)


def iou3d_cost(pred_boxes: torch.Tensor,
               gt_boxes: torch.Tensor) -> torch.Tensor:
    """Negative exact oriented IoU: (Q, 9) x (G, 9) -> (Q, G)."""
    return -boxes3d_iou(pred_boxes, gt_boxes)


def token_map_cost(pred_logits: torch.Tensor,
                   gt_logits: torch.Tensor) -> torch.Tensor:
    """Inner-product token prediction cost (a similarity: its weight is
    negative when used as a cost): (..., Q, C) x (..., G, C) -> (..., Q, G)."""
    return pred_logits @ gt_logits.transpose(-1, -2)


def focal_loss_cost(cls_logits: torch.Tensor, gt_labels: torch.Tensor,
                    alpha: float = 0.25, gamma: float = 2.0,
                    eps: float = 1e-12) -> torch.Tensor:
    """Classification focal cost: (Q, C) class logits x (G,) int class ids
    -> (Q, G)."""
    pos, neg = _focal_terms(cls_logits, alpha, gamma, eps)
    labels = gt_labels.long()
    return pos[:, labels] - neg[:, labels]


def mask_focal_loss_cost(cls_logits: torch.Tensor, gt_masks: torch.Tensor,
                         alpha: float = 0.25, gamma: float = 2.0,
                         eps: float = 1e-12) -> torch.Tensor:
    """Binary-mask focal cost, mean over elements: (Q, ...) logits x (G, ...)
    masks -> (Q, G)."""
    q = cls_logits.reshape(cls_logits.shape[0], -1)
    g = gt_masks.reshape(gt_masks.shape[0], -1).to(cls_logits.dtype)
    pos, neg = _focal_terms(q, alpha, gamma, eps)
    return (pos @ g.T + neg @ (1 - g).T) / q.shape[1]


def binary_focal_cost(logits: torch.Tensor, pos_maps: torch.Tensor,
                      token_mask: torch.Tensor, alpha: float = 0.25,
                      gamma: float = 2.0, eps: float = 1e-12) -> torch.Tensor:
    """Token-map binary focal cost: (..., Q, T) token logits x (..., G, T)
    positive maps -> (..., Q, G); padded text positions are excluded by the
    (..., T) ``token_mask``."""
    pos, neg = _focal_terms(logits, alpha, gamma, eps)
    tm = token_mask.to(logits.dtype)[..., None, :]
    pos = pos * tm
    neg = neg * tm
    return pos @ pos_maps.transpose(-1, -2) + \
        neg @ ((1 - pos_maps) * tm).transpose(-1, -2)
