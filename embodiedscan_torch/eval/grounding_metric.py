"""Visual grounding evaluation (port of
``embodiedscan_tpu/eval/grounding_metric.py``).

Top-10 predictions by score are matched against the gt box(es) with exact
oriented IoU (the port's, on ``device``); accuracy is bucketed Easy/Hard,
View-Dep/Indep, Unique/Multi and Overall at each IoU threshold.
"""

from typing import Dict, List, Sequence

import numpy as np


def ground_eval(gt_annos: List[dict], det_annos: List[dict],
                iou_thr: Sequence[float] = (0.25, 0.5),
                top_k: int = 10, device='cuda') -> Dict[str, float]:
    """Evaluate grounding predictions.

    Args:
        gt_annos: per sample: dict(gt_boxes (G, 9), is_view_dep, is_hard,
            is_unique — bools).
        det_annos: per sample: dict(bboxes (Q, 9), scores (Q,)).
        device: where the IoU runs (``'cpu'`` to stay on the host).

    Returns:
        dict of '<bucket>@<thr>' accuracies.
    """
    from .indoor_eval import _batched_iou

    object_types = ['Easy', 'Hard', 'View-Dep', 'View-Indep', 'Unique',
                    'Multi', 'Overall']
    pred = {f'{o}@{t}': 0 for t in iou_thr for o in object_types}
    cnt = {f'{o}@{t}': 1e-14 for t in iou_thr for o in object_types}

    for gt_anno, det_anno in zip(gt_annos, det_annos):
        scores = np.asarray(det_anno['scores'])
        boxes = np.asarray(det_anno['bboxes'], np.float32).reshape(-1, 9)
        gt_boxes = np.asarray(gt_anno['gt_boxes'], np.float32).reshape(-1, 9)
        top = np.argsort(-scores)[:top_k]
        iou = _batched_iou(boxes[top], gt_boxes, device)  # (top_k, G)
        buckets = [
            ('Hard' if gt_anno.get('is_hard') else 'Easy'),
            ('View-Dep' if gt_anno.get('is_view_dep') else 'View-Indep'),
            ('Unique' if gt_anno.get('is_unique') else 'Multi'),
            'Overall',
        ]
        for t in iou_thr:
            found = int((iou > t).any())
            for b in buckets:
                cnt[f'{b}@{t}'] += 1
                pred[f'{b}@{t}'] += found

    ret = {}
    for key in pred:
        ret[key] = pred[key] / max(cnt[key], 1)
    return ret


def format_results(det_annos: List[dict], result_path: str,
                   top_k: int = 20) -> str:
    """Challenge-submission dump: top-20 boxes per sample to one json.

    The test phase evaluates top-10, but submissions keep top-20.
    """
    import json
    import os

    results = []
    for det in det_annos:
        scores = np.asarray(det['scores'])
        boxes = np.asarray(det['bboxes'], np.float32).reshape(-1, 9)
        top = np.argsort(-scores)[:top_k]
        results.append(dict(bboxes_3d=boxes[top].tolist(),
                            scores_3d=scores[top].tolist()))
    os.makedirs(result_path, exist_ok=True)
    out = os.path.join(result_path, 'test_results.json')
    with open(out, 'w') as f:
        json.dump(results, f)
    return out
