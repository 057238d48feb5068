"""Offline submission evaluator (the reference package's
``tools/eval_script.py``).

Scores a submission pkl (or a results json) against a ground-truth info
pkl with the port's ``indoor_eval`` (detection AP) or ``ground_eval``
(``--grounding``).

Submission: ``{'results': {scan_id: {'bboxes_3d': (N, 9), 'scores_3d':
(N,), 'labels_3d': (N,)}}, ...}`` or the mapping alone. Ground truth: the
standard info pkl (instances with ``bbox_3d`` and ``bbox_label_3d``).

Usage:
    python -m embodiedscan_torch.tools.eval_script --submission sub.pkl \\
        --gt infos_val.pkl [--grounding] [--device cuda|cpu]
"""

import argparse
import json
import pickle

import numpy as np


def load_any(path):
    if path.endswith('.json'):
        with open(path) as f:
            return json.load(f)
    with open(path, 'rb') as f:
        return pickle.load(f)


def main(argv=None) -> dict:
    """Scores as ``argv`` (default: the command line) asks, prints the
    mAP / mAR / per-threshold numbers as JSON and returns every metric."""
    parser = argparse.ArgumentParser()
    parser.add_argument('--submission', required=True)
    parser.add_argument('--gt', required=True)
    parser.add_argument('--grounding', action='store_true',
                        help='grounding protocol instead of detection AP')
    parser.add_argument('--device', default='cuda',
                        help="where the IoUs are computed: 'cuda' "
                             "(default) or 'cpu'")
    args = parser.parse_args(argv)

    sub = load_any(args.submission)
    results = sub.get('results', sub)
    from ..data.dataset import load_info_pkl
    infos, meta = load_info_pkl(args.gt)

    gts, dts = [], []
    for info in infos:
        sid = info['sample_idx']
        if sid not in results:
            continue
        r = results[sid]
        boxes = np.zeros((len(info.get('instances', [])), 9), np.float32)
        labels = np.zeros((len(boxes),), np.int64)
        for i, inst in enumerate(info.get('instances', [])):
            boxes[i] = inst['bbox_3d']
            labels[i] = inst['bbox_label_3d']
        if args.grounding:
            gts.append(dict(gt_boxes=boxes,
                            is_hard=info.get('is_hard', False),
                            is_view_dep=info.get('is_view_dep', False),
                            is_unique=info.get('is_unique', False)))
            dts.append(dict(bboxes=np.asarray(r['bboxes_3d'], np.float32),
                            scores=np.asarray(r['scores_3d'], np.float32)))
        else:
            gts.append(dict(gt_boxes=boxes, gt_labels=labels))
            dts.append(dict(bboxes=np.asarray(r['bboxes_3d'], np.float32),
                            scores=np.asarray(r['scores_3d'], np.float32),
                            labels=np.asarray(r['labels_3d'], np.int64)))

    if args.grounding:
        from ..eval.grounding_metric import ground_eval
        metrics = ground_eval(gts, dts, device=args.device)
    else:
        from ..eval.indoor_eval import indoor_eval
        cats = meta.get('categories', {})
        label2cat = {v: k for k, v in cats.items()} if cats else None
        metrics = indoor_eval(gts, dts, (0.25, 0.5), label2cat,
                              device=args.device)
    print(json.dumps({k: round(float(v), 5) for k, v in metrics.items()
                      if 'mAP' in k or 'mAR' in k or '@' in k}, indent=1))
    return metrics


if __name__ == '__main__':
    main()
