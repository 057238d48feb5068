"""From a predict output to the records the eval metrics take (port of
``_append_scene_results`` in ``embodiedscan_tpu/train/loop.py`` for the
detection and grounding tasks; the loop that drives it, ``evaluate``,
comes with the runtime)."""

import numpy as np
import torch


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _append_scene_results(cfg, batch: dict, preds: dict, real_rows: int,
                          gts: list, dts: list, n0: int) -> int:
    """Unpack one predict output and its batch into per-row gt / dt records:
    ``indoor_eval``'s for ``'mv_det3d'`` (the kept detections, the valid
    ground truth), ``ground_eval``'s for ``'mv_grounding'`` (every query,
    the valid ground truth and the prompt's bucket flags, which the batch
    must carry).

    The task is ``cfg.model.task``. Rows past ``real_rows`` are tail
    padding (repeated scenes) and dropped. Tensors may lie on any device.
    Returns the updated running row count.
    """
    task = cfg.model.task
    if task not in ('mv_det3d', 'mv_grounding'):
        raise NotImplementedError(f'task {task!r} is not ported yet')
    preds = {k: _host(v) for k, v in preds.items()}
    gt_mask = _host(batch['gt_mask'])
    gt_boxes = _host(batch['gt_boxes'])
    if task == 'mv_grounding':
        # without the flags every prompt would land in Easy / View-Indep /
        # Multi and the tables would look plausible and be wrong
        missing = [k for k in ('is_view_dep', 'is_hard', 'is_unique')
                   if k not in batch]
        if missing:
            raise KeyError(
                f'grounding eval batch lacks bucket flags {missing}; the '
                'loader must emit is_view_dep/is_hard/is_unique per prompt')
        flags = {k: _host(batch[k]) for k in ('is_view_dep', 'is_hard',
                                              'is_unique')}
    for i in range(real_rows):
        gm = gt_mask[i]
        if task == 'mv_det3d':
            keep = preds['mask'][i]
            dts.append(dict(bboxes=preds['bboxes'][i][keep],
                            scores=preds['scores'][i][keep],
                            labels=preds['labels'][i][keep]))
            gts.append(dict(gt_boxes=gt_boxes[i][gm],
                            gt_labels=_host(batch['gt_labels'])[i][gm]))
        else:
            dts.append(dict(bboxes=preds['bboxes'][i],
                            scores=preds['scores'][i]))
            gts.append(dict(gt_boxes=gt_boxes[i][gm],
                            **{k: bool(v[i]) for k, v in flags.items()}))
    return n0 + real_rows
