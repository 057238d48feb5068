"""Per-parameter lr multipliers, the loader of a config and the records
the eval metrics take (port of ``lr_mult_fn_for``, ``make_dataset``,
``_append_scene_results`` and ``_stack_eval_batches`` in
``embodiedscan_tpu/train/loop.py`` for all five tasks; the loops that
drive them, ``train`` and ``evaluate``, come with the runtime)."""

from typing import Callable, Iterable

import numpy as np
import torch


def lr_mult_fn_for(task: str) -> Callable[[tuple], float]:
    """The reference's paramwise lr multipliers as a function of a
    parameter's path (a tuple of names, joined by ``/`` as the flax path;
    the port's dotted names split at the dots give the same groups): 0
    freezes the 2D ResNet's stem and first stage (``frozen_stages=1``) for
    every task; the grounder also freezes everything under
    ``text_encoder`` (its output projection included) and trains the
    decoder (layers, both position embeddings, the decoder norm) at 0.1."""

    def base_freeze(path):
        joined = '/'.join(str(p) for p in path)
        if 'stem_conv' in joined or 'stem_bn' in joined or 'layer1_' in joined:
            return 0.0
        return 1.0

    if task == 'mv_grounding':

        def fn(path):
            joined = '/'.join(str(p) for p in path)
            if 'text_encoder' in joined:
                return 0.0
            # the decoder's layer0, layer1, ... at the top of the tree; the
            # ResNet's layer1_* sits under trunk and is frozen above
            if joined.startswith(('layer', 'self_posembed', 'cross_posembed',
                                  'decoder_norm')):
                return 0.1
            return base_freeze(path)

        return fn
    return base_freeze


def make_dataset(cfg, train: bool = True) -> Iterable:
    """Collated numpy batches of ``cfg``'s task (``data.loader.
    build_loader``); a train loader yields them forever, an eval one makes
    one pass."""
    from ..data.loader import build_loader
    return build_loader(cfg, train=train)


def _stack_eval_batches(batches):
    """Concatenate per-scene collated batches along the leading axis: both
    the standard and the sweep collate layouts stack there."""
    if len(batches) == 1:
        return batches[0]
    return {
        k: np.concatenate([b[k] for b in batches], axis=0)
        for k in batches[0]
    }


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _append_scene_results(cfg, batch: dict, preds: dict, real_rows: int,
                          gts: list, dts: list, n0: int) -> int:
    """Unpack one predict output and its batch into per-row gt / dt records:
    ``indoor_eval``'s for ``'mv_det3d'`` and ``'cont_det3d'`` (the kept
    detections, the valid ground truth; a sweep pseudo-batch gives one
    record per sweep row, with the gt visible up to that sweep),
    ``ground_eval``'s for ``'mv_grounding'`` (every query, the valid ground
    truth and the prompt's bucket flags, which the batch must carry),
    ``occupancy_eval``'s for ``'mv_occ'`` and ``'cont_occ'`` (the (X, Y, Z)
    predicted classes; the ground truth ``gt_occ`` / ``gt_occ_mask`` as a
    label grid at ``cfg.model.n_voxels``, 255 where ``visible_mask`` is
    False; one record per sweep row).

    The task is ``cfg.model.task``. Rows past ``real_rows`` are tail
    padding (repeated scenes) and dropped. Tensors may lie on any device.
    Returns the updated running row count.
    """
    task = cfg.model.task
    if task in ('mv_occ', 'cont_occ'):
        from ..models.occupancy import occ_multiscale_targets
        vis = batch.get('visible_mask')
        tgt = occ_multiscale_targets(
            torch.as_tensor(batch['gt_occ'][:real_rows]),
            torch.as_tensor(batch['gt_occ_mask'][:real_rows]), 1,
            tuple(cfg.model.n_voxels),
            None if vis is None else torch.as_tensor(vis[:real_rows]))
        dts.extend(_host(preds)[:real_rows])
        gts.extend(_host(tgt))
        return n0 + real_rows
    if task not in ('mv_det3d', 'cont_det3d', 'mv_grounding'):
        raise ValueError(f'unknown task {task!r}')
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
        if task != 'mv_grounding':
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
