"""Indoor detection AP/AR evaluation engine (port of
``embodiedscan_tpu/eval/indoor_eval.py``).

VOC 'area' AP integration, per-class greedy confidence-ordered matching,
the tiny-box clamp and the head/common/tail split tables, in numpy as the
JAX package has them; each scene's pred x gt IoU matrix comes from one
call of the port's exact ``geometry.iou.boxes3d_iou`` on ``device`` (the
card unless the caller asks for the CPU).
"""

from typing import Dict, List, Sequence

import numpy as np
import torch


def average_precision(recalls: np.ndarray, precisions: np.ndarray,
                      mode: str = 'area') -> np.ndarray:
    """VOC AP from P/R curves ('area' mode, reference indoor_eval.py:8-54)."""
    if recalls.ndim == 1:
        recalls = recalls[np.newaxis, :]
        precisions = precisions[np.newaxis, :]
    num_scales = recalls.shape[0]
    ap = np.zeros(num_scales, dtype=np.float32)
    if mode == 'area':
        zeros = np.zeros((num_scales, 1), dtype=recalls.dtype)
        ones = np.ones((num_scales, 1), dtype=recalls.dtype)
        mrec = np.hstack((zeros, recalls, ones))
        mpre = np.hstack((zeros, precisions, zeros))
        for i in range(mpre.shape[1] - 1, 0, -1):
            mpre[:, i - 1] = np.maximum(mpre[:, i - 1], mpre[:, i])
        for i in range(num_scales):
            ind = np.where(mrec[i, 1:] != mrec[i, :-1])[0]
            ap[i] = np.sum(
                (mrec[i, ind + 1] - mrec[i, ind]) * mpre[i, ind + 1])
    elif mode == '11points':
        # recall thresholds [0, 0.1, ..., 1]; max precision at/after each
        # (reference indoor_eval.py:43-49, including its in-loop /= 11 —
        # reproduced exactly so multi-scale results match bit-for-bit)
        for i in range(num_scales):
            for thr in np.arange(0, 1 + 1e-3, 0.1):
                precs = precisions[i, recalls[i, :] >= thr]
                ap[i] += precs.max() if precs.size > 0 else 0
            ap /= 11
    else:
        raise ValueError(
            'Unrecognized mode, only "area" and "11points" are supported')
    return ap


def _batched_iou(preds: np.ndarray, gts: np.ndarray, device) -> np.ndarray:
    """(N, 9) x (M, 9) exact oriented IoU, computed on ``device``."""
    from ..geometry.iou import boxes3d_iou
    if len(preds) == 0 or len(gts) == 0:
        return np.zeros((len(preds), len(gts)), np.float32)
    return boxes3d_iou(
        torch.as_tensor(preds, dtype=torch.float32, device=device),
        torch.as_tensor(gts, dtype=torch.float32,
                        device=device)).cpu().numpy()


def _clamp_tiny(boxes: np.ndarray) -> np.ndarray:
    """Clamp too-thin predicted boxes (reference indoor_eval.py:112-120)."""
    boxes = boxes.copy()
    w, l, h = boxes[:, 3], boxes[:, 4], boxes[:, 5]
    faces = np.stack([w * l, w * h, h * l], -1)
    tiny = np.any(faces < 2e-4, axis=-1)
    boxes[tiny, 3:6] = np.clip(boxes[tiny, 3:6], 2e-2, None)
    return boxes


def eval_det_cls(pred: Dict[int, list], gt: Dict[int, np.ndarray],
                 ious_by_img: Dict[int, np.ndarray],
                 iou_thr: Sequence[float]):
    """Per-class PR/AP with greedy matching (reference indoor_eval.py:56-183).

    Args:
        pred: {img_id: list of (pred_row_idx_in_img, score)}.
        gt: {img_id: (G_c,) indices of this class's gt boxes in the image}.
        ious_by_img: {img_id: full (N_img, M_img) pred x gt IoU matrix}.
    """
    npos = sum(len(g) for g in gt.values())
    det_flags = {
        t: {img: np.zeros(len(g), bool) for img, g in gt.items()}
        for t in iou_thr
    }
    image_ids, confidence, ious = [], [], []
    for img_id, entries in pred.items():
        gt_idx = gt.get(img_id, np.zeros(0, np.int64))
        for row, score in entries:
            image_ids.append(img_id)
            confidence.append(score)
            if len(gt_idx):
                ious.append(ious_by_img[img_id][row, gt_idx])
            else:
                ious.append(np.zeros(1))
    confidence = np.asarray(confidence)
    order = np.argsort(-confidence)
    n = len(order)
    tp_thr = {t: np.zeros(n) for t in iou_thr}
    fp_thr = {t: np.zeros(n) for t in iou_thr}
    for d, oi in enumerate(order):
        img = image_ids[oi]
        cur = ious[oi]
        jmax = int(np.argmax(cur)) if len(cur) else 0
        iou_max = cur[jmax] if len(cur) else -np.inf
        has_gt = img in det_flags[iou_thr[0]] and len(
            det_flags[iou_thr[0]][img])
        for t in iou_thr:
            if iou_max > t and has_gt:
                if not det_flags[t][img][jmax]:
                    tp_thr[t][d] = 1.0
                    det_flags[t][img][jmax] = True
                else:
                    fp_thr[t][d] = 1.0
            else:
                fp_thr[t][d] = 1.0
    ret = []
    for t in iou_thr:
        fp = np.cumsum(fp_thr[t])
        tp = np.cumsum(tp_thr[t])
        with np.errstate(divide='ignore', invalid='ignore'):
            # npos == 0 -> NaN recall/AP, so the class is dropped upstream
            # exactly like the reference (indoor_eval.py:173, 286-295)
            recall = tp / float(npos)
        precision = tp / np.maximum(tp + fp, np.finfo(np.float64).eps)
        ret.append((recall, precision, average_precision(recall, precision)))
    return ret


def indoor_eval(gt_annos: List[dict],
                dt_annos: List[dict],
                iou_thr: Sequence[float] = (0.25, 0.5),
                label2cat: Dict[int, str] | None = None,
                classes_split=None,
                verbose: bool = True,
                device='cuda') -> dict:
    """Evaluate detections (reference indoor_eval.py:224-377).

    Args:
        gt_annos: per scene: dict(gt_boxes (G, 9) np, gt_labels (G,) np).
        dt_annos: per scene: dict(bboxes (D, 9), scores (D,), labels (D,)).
        iou_thr: IoU thresholds.
        label2cat: label -> name map for the report.
        device: where the IoU runs (``'cpu'`` to stay on the host).

    Returns:
        dict with mAP_<t> / mAR_<t> plus per-class entries.
    """
    assert len(gt_annos) == len(dt_annos)
    pred: Dict[int, Dict[int, list]] = {}
    gt: Dict[int, Dict[int, np.ndarray]] = {}
    ious_by_img: Dict[int, np.ndarray] = {}

    for img_id, (gta, dta) in enumerate(zip(gt_annos, dt_annos)):
        dboxes = _clamp_tiny(np.asarray(dta['bboxes'], np.float32).reshape(
            -1, 9))
        dlabels = np.asarray(dta['labels']).astype(np.int64)
        dscores = np.asarray(dta['scores'], np.float32)
        gboxes = np.asarray(gta['gt_boxes'], np.float32).reshape(-1, 9)
        glabels = np.asarray(gta['gt_labels']).astype(np.int64)
        ious_by_img[img_id] = _batched_iou(dboxes, gboxes, device)

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

    # drop classes with NaN AP (no gt at all), like the reference
    for lab in list(ap[iou_thr[0]].keys()):
        if np.isnan(ap[iou_thr[0]][lab][0]):
            for t in iou_thr:
                del rec[t][lab], prec[t][lab], ap[t][lab]

    ret = {}
    lines = []
    for t in iou_thr:
        for lab in ap[t]:
            name = label2cat[lab] if label2cat else str(lab)
            ret[f'{name}_AP_{t:.2f}'] = float(ap[t][lab][0])
            ret[f'{name}_rec_{t:.2f}'] = float(rec[t][lab][-1])
        ret[f'mAP_{t:.2f}'] = float(
            np.mean([v[0] for v in ap[t].values()])) if ap[t] else 0.0
        ret[f'mAR_{t:.2f}'] = float(
            np.mean([rec[t][lab][-1] for lab in rec[t]])) if rec[t] else 0.0
        lines.append(f'mAP_{t:.2f}: {ret[f"mAP_{t:.2f}"]:.4f}  '
                     f'mAR_{t:.2f}: {ret[f"mAR_{t:.2f}"]:.4f}')

    if classes_split is not None:
        for split_name, labels in zip(('head', 'common', 'tail'),
                                      classes_split):
            for t in iou_thr:
                ap_list = [
                    float(ap[t][lab][0]) for lab in labels if lab in ap[t]
                ]
                rec_list = [rec[t][lab][-1] for lab in labels if lab in rec[t]]
                ret[f'{split_name}_mAP_{t:.2f}'] = float(
                    np.mean(ap_list)) if ap_list else 0.0
                ret[f'{split_name}_mAR_{t:.2f}'] = float(
                    np.mean(rec_list)) if rec_list else 0.0

    if verbose:
        print(per_class_table(ret, sorted(ap[iou_thr[0]]), iou_thr,
                              label2cat))
        print('\n'.join(lines))
    return ret


def per_class_table(ret: dict, labels, iou_thr, label2cat=None) -> str:
    """Reference-style per-class AP/AR table (indoor_eval.py:329-334).

    Plain fixed-width text instead of terminaltables' AsciiTable (same
    columns: classes, then AP_tt/AR_tt per threshold, Overall last row).
    """
    header = ['classes'] + [
        f'{m}_{t:.2f}' for t in iou_thr for m in ('AP', 'AR')
    ]
    rows = []
    for lab in labels:
        name = label2cat[lab] if label2cat else str(lab)
        rows.append([name] + [
            f'{ret.get(f"{name}_{m}_{t:.2f}", float("nan")):.4f}'
            for t in iou_thr for m in (('AP', 'rec')[m_i] for m_i in (0, 1))
        ])
    rows.append(['Overall'] + [
        f'{ret.get(f"m{m}_{t:.2f}", 0.0):.4f}'
        for t in iou_thr for m in ('AP', 'AR')
    ])
    widths = [
        max(len(header[c]), *(len(r[c]) for r in rows))
        for c in range(len(header))
    ]
    sep = '+' + '+'.join('-' * (w + 2) for w in widths) + '+'
    out = [sep, '| ' + ' | '.join(h.ljust(w) for h, w in zip(header, widths))
           + ' |', sep]
    for r in rows:
        out.append('| ' + ' | '.join(v.ljust(w) for v, w in zip(r, widths))
                   + ' |')
    out.append(sep)
    return '\n'.join(out)
