"""2D detection mAP over axis-aligned xyxy boxes (port of
``embodiedscan_tpu/eval/indoor_eval2d.py``, the reference's
``Indoor2DMetric``; host numpy).

Per class, greedy matching by score (``indoor_eval.eval_det_cls``) over the
2D IoU, with VOC 'area' AP.
"""

from typing import Dict, List, Sequence

import numpy as np

from .indoor_eval import eval_det_cls, per_class_table


def iou_2d(preds: np.ndarray, gts: np.ndarray) -> np.ndarray:
    """(N, 4) x (M, 4) axis-aligned IoU, boxes as xyxy."""
    preds = np.asarray(preds, np.float32).reshape(-1, 4)
    gts = np.asarray(gts, np.float32).reshape(-1, 4)
    if len(preds) == 0 or len(gts) == 0:
        return np.zeros((len(preds), len(gts)), np.float32)
    lt = np.maximum(preds[:, None, :2], gts[None, :, :2])
    rb = np.minimum(preds[:, None, 2:], gts[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_p = np.prod(np.clip(preds[:, 2:] - preds[:, :2], 0, None), -1)
    area_g = np.prod(np.clip(gts[:, 2:] - gts[:, :2], 0, None), -1)
    union = area_p[:, None] + area_g[None, :] - inter
    return (inter / np.maximum(union, 1e-9)).astype(np.float32)


def indoor_eval_2d(gt_annos: List[dict],
                   dt_annos: List[dict],
                   iou_thr: Sequence[float] = (0.5, ),
                   label2cat: Dict[int, str] | None = None,
                   verbose: bool = True) -> dict:
    """Evaluate 2D detections (Indoor2DMetric parity).

    Args:
        gt_annos: per image: dict(gt_bboxes (G, 4) xyxy, gt_labels (G,)).
        dt_annos: per image: dict(bboxes (D, 4), scores (D,), labels (D,)).
        iou_thr: IoU thresholds (reference default [0.5]).

    Returns:
        dict with mAP_<t> / mAR_<t> plus per-class entries.
    """
    assert len(gt_annos) == len(dt_annos)
    pred: Dict[int, Dict[int, list]] = {}
    gt: Dict[int, Dict[int, np.ndarray]] = {}
    ious_by_img: Dict[int, np.ndarray] = {}

    for img_id, (gta, dta) in enumerate(zip(gt_annos, dt_annos)):
        dboxes = np.asarray(dta['bboxes'], np.float32).reshape(-1, 4)
        dlabels = np.asarray(dta['labels']).astype(np.int64)
        dscores = np.asarray(dta['scores'], np.float32)
        gboxes = np.asarray(gta['gt_bboxes'], np.float32).reshape(-1, 4)
        glabels = np.asarray(gta['gt_labels']).astype(np.int64)
        ious_by_img[img_id] = iou_2d(dboxes, gboxes)

        for i, lab in enumerate(dlabels):
            lab = int(lab)
            pred.setdefault(lab, {}).setdefault(img_id, []).append(
                (i, float(dscores[i])))
            gt.setdefault(lab, {}).setdefault(img_id, np.zeros(0, np.int64))
        for lab in np.unique(glabels):
            idx = np.where(glabels == lab)[0]
            gt.setdefault(int(lab), {})[img_id] = idx

    rec, prec, ap = {}, {}, {}
    for t in iou_thr:
        rec[t], prec[t], ap[t] = {}, {}, {}
    for lab in gt:
        if lab not in pred:
            for t in iou_thr:
                rec[t][lab] = np.zeros(1)
                prec[t][lab] = np.zeros(1)
                ap[t][lab] = np.zeros(1)
            continue
        rets = eval_det_cls(pred[lab], gt[lab], ious_by_img, iou_thr)
        for t, (r, p, a) in zip(iou_thr, rets):
            rec[t][lab], prec[t][lab], ap[t][lab] = r, p, a

    for lab in list(ap[iou_thr[0]].keys()):
        if np.isnan(ap[iou_thr[0]][lab][0]):
            for t in iou_thr:
                del rec[t][lab], prec[t][lab], ap[t][lab]

    ret = {}
    for t in iou_thr:
        for lab in ap[t]:
            name = label2cat[lab] if label2cat else str(lab)
            ret[f'{name}_AP_{t:.2f}'] = float(ap[t][lab][0])
            ret[f'{name}_rec_{t:.2f}'] = float(rec[t][lab][-1])
        ret[f'mAP_{t:.2f}'] = float(
            np.mean([v[0] for v in ap[t].values()])) if ap[t] else 0.0
        ret[f'mAR_{t:.2f}'] = float(
            np.mean([rec[t][lab][-1] for lab in rec[t]])) if rec[t] else 0.0

    if verbose:
        print(per_class_table(ret, sorted(ap[iou_thr[0]]), iou_thr,
                              label2cat))
    return ret
