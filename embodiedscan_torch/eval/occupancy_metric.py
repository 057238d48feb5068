"""Semantic occupancy evaluation (port of
``embodiedscan_tpu/eval/occupancy_metric.py``; reference
eval/metrics/occupancy_metric.py).

Per-class IoU over voxels, class 0 scored as occupied-vs-empty geometry IoU,
255-labeled voxels excluded (occupancy_metric.py:64-115). Numpy on the host.
"""

from typing import Dict, List

import numpy as np


def occupancy_eval(gt_occs: List[np.ndarray], pred_occs: List[np.ndarray],
                   num_classes: int,
                   class_names: List[str] | None = None) -> Dict[str, float]:
    """Evaluate dense occupancy predictions.

    Args:
        gt_occs: per sample (X, Y, Z) int labels (0 empty, 255 ignore).
        pred_occs: per sample (X, Y, Z) int predictions.
        num_classes: number of semantic classes INCLUDING empty (class 0).
        class_names: names of classes 1 .. num_classes - 1 (default: their
            ids).

    Returns:
        dict of per-class IoU (classes absent from both gt and predictions
        are left out) + 'mIoU' over the classes present.
    """
    score = np.zeros((num_classes, 3), np.float64)
    for gt, pr in zip(gt_occs, pred_occs):
        gt = np.asarray(gt)
        pr = np.asarray(pr)
        mask = gt != 255
        g = gt[mask]
        p = pr[mask]
        # class 0: geometry IoU (occupied vs empty)
        score[0, 0] += ((g != 0) & (p != 0)).sum()
        score[0, 1] += (g != 0).sum()
        score[0, 2] += (p != 0).sum()
        for j in range(1, num_classes):
            score[j, 0] += ((g == j) & (p == j)).sum()
            score[j, 1] += (g == j).sum()
            score[j, 2] += (p == j).sum()

    ret = {}
    ious = []
    for j in range(num_classes):
        tp, gsum, psum = score[j]
        union = gsum + psum - tp
        if union == 0:
            continue
        name = 'empty' if j == 0 else (
            class_names[j - 1] if class_names else str(j))
        ret[name] = float(tp / union)
        ious.append(ret[name])
    ret['mIoU'] = float(np.mean(ious)) if ious else 0.0
    return ret
