"""Greedy rotated 3D NMS (port of ``embodiedscan_tpu/geometry/nms.py``).

All classes in one pass: the suppression matrix (pairwise IoU above the
threshold, masked by label equality, upper triangle) is built once on the
input's device, by one kernel on a CUDA tensor (``iou.suppression_matrix``).
The greedy sweep over score-sorted candidates is inherently sequential; it
runs on the host over that matrix, one step per candidate, as the
reference's fori_loop.
"""

import torch

from ..utils.trace import span
from .iou import boxes7d_to_9d, suppression_matrix


def nms3d(boxes: torch.Tensor, scores: torch.Tensor, mask: torch.Tensor,
          iou_thr: float, labels: torch.Tensor | None = None,
          presorted: bool = False):
    """Greedy NMS over (K, >=7) boxes with yaw-only IoU.

    Args:
        boxes: (K, >=7) candidate boxes.
        scores: (K,) scores; mask: (K,) validity.
        labels: optional (K,) class ids — suppression only within a class.
        presorted: caller guarantees score-descending order.

    Returns:
        (order, keep): ``order`` (K,) score-descending indices into the
        input, ``keep`` (K,) bool mask in sorted order.
    """
    k = boxes.shape[0]
    dev = boxes.device
    if presorted:
        order = torch.arange(k, dtype=torch.int64, device=dev)
        b, m = boxes, mask
    else:
        neg = torch.finfo(scores.dtype).min
        order = torch.argsort(torch.where(mask, -scores,
                                          torch.full_like(scores, -neg)),
                              stable=True)
        b = boxes[order]
        m = mask[order]
    with span('es.nms.iou'):
        over = suppression_matrix(boxes7d_to_9d(b[:, :7]), iou_thr,
                                  None if labels is None else labels[order])
    with span('es.nms.wait'):
        over = over.cpu()
        alive = m.cpu()
    with span('es.nms.sweep'):
        suppressed = torch.zeros(k, dtype=torch.bool)
        for i in range(k):
            if alive[i] and not suppressed[i]:
                suppressed |= over[i]
        keep = (~suppressed & alive).to(dev)
    return order, keep
