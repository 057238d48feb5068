"""The training and evaluation loops (port of
``embodiedscan_tpu/train/loop.py``: ``train``, ``_train_epochs``,
``_vis_hook``, ``evaluate``, the per-parameter lr multipliers, the loader
of a config and the records the eval metrics take, for all five tasks).

The explicit replacement for mmengine's Runner: an epoch-based schedule,
the losses logged every ``log_interval`` steps (reference LoggerHook(50))
and written to ``scalars.jsonl``, a checkpoint at each epoch's end with
keep-N and ``resume`` (CheckpointHook, tools/train.py:111-117), and the
paramwise lr multipliers and frozen 2D stages. One process drives one
card; several processes of a ``torch.distributed`` group each train on
their own batch rows with the gradients averaged
(``train.state.train_step``) and evaluate their own shard of the
scans, gathered before the metric.
"""

import logging
import os
import time
from typing import Callable, Iterable

import numpy as np
import torch

log = logging.getLogger('embodiedscan_torch')


def _setup_logging():
    """INFO for this package's logger, WARNING for every other."""
    logging.basicConfig(level=logging.WARNING, force=True,
                        format='%(asctime)s %(levelname)s %(message)s')
    log.setLevel(logging.INFO)


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


def train(cfg, max_steps: int | None = None, device='cuda'):
    """Trains ``cfg``'s model from its loader; returns (model, optimizer).

    ``device`` is this process's card (``parallel.mesh.process_device``:
    ``cuda:LOCAL_RANK``) unless it is the CPU. In a ``torch.distributed``
    group (``parallel.multihost.init_distributed``) every process runs this
    function: the loader yields this process's batch rows (its shard of the
    scans), the model starts from rank 0's weights, each step averages
    gradients, statistics and losses over the group, and rank 0 alone
    writes checkpoints and ``scalars.jsonl``. An epoch is the loader's
    ``steps_per_epoch`` updates; the run ends after
    ``cfg.schedule.max_epochs`` epochs or ``max_steps`` more steps.
    ``cfg.resume``: '' starts afresh, 'auto' restores the latest checkpoint
    of ``cfg.work_dir`` (model, optimizer and schedule), a number that
    step.
    """
    from ..configs.base import build_train
    from ..parallel.mesh import process_device, replicate
    from ..parallel.multihost import is_main_process, process_count
    from .checkpoint import CheckpointManager
    from .metrics_writer import MetricsWriter
    _setup_logging()
    device = process_device(device)
    loader = make_dataset(cfg, train=True)
    steps_per_epoch = loader.steps_per_epoch
    model, opt = build_train(cfg, device=device,
                             steps_per_epoch=steps_per_epoch)
    replicate(model)
    n_params = sum(p.numel() for p in model.parameters())
    log.info('task=%s params=%.2fM devices=%d steps/epoch=%d',
             cfg.model.task, n_params / 1e6, process_count(),
             steps_per_epoch)

    ckpt = CheckpointManager(cfg.work_dir,
                             max_keep=4 if 'det' in cfg.model.task else 3)
    start_step = 0
    if cfg.resume:
        restored = ckpt.restore(
            model, opt, None if cfg.resume == 'auto' else int(cfg.resume))
        if restored is not None:
            start_step = restored
            log.info('resumed from step %d', start_step)

    total_steps = steps_per_epoch * cfg.schedule.max_epochs
    if max_steps is not None:
        total_steps = min(total_steps, start_step + max_steps)
    writer = MetricsWriter(cfg.work_dir, tuple(cfg.log_backends)) \
        if is_main_process() else None
    try:
        _train_epochs(cfg, loader, model, opt, ckpt, writer,
                      start_step, total_steps, steps_per_epoch, device)
    finally:
        if writer is not None:
            writer.close()
    return model, opt


def _start_profile(device):
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if device.type == 'cuda':
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    return prof


def _stop_profile(prof, cfg, device):
    from ..parallel.multihost import process_index
    if device.type == 'cuda':
        torch.cuda.synchronize(device)
    prof.stop()
    os.makedirs(cfg.profile_dir, exist_ok=True)
    path = os.path.join(cfg.profile_dir, f'trace_rank{process_index()}.json')
    prof.export_chrome_trace(path)
    log.info('profiler trace written to %s', path)


def _train_epochs(cfg, loader, model, opt, ckpt, writer, start_step,
                  total_steps, steps_per_epoch, device):
    """The loop of :func:`train` (apart, so that ``train`` closes the
    writer whatever happens): steps 5 to 10 of the run profiled when
    ``cfg.profile_dir`` is set (a chrome trace per process), the losses
    averaged over each ``log_interval`` window, a checkpoint at each
    epoch's end and at the end."""
    from ..data.loader import to_device
    from ..parallel.multihost import is_main_process
    from .state import train_step
    t0 = time.time()
    window = []
    step = start_step
    prof = None
    try:
        for batch in loader:
            if step >= total_steps:
                break
            if cfg.profile_dir and step - start_step == 5:
                prof = _start_profile(device)
            if prof is not None and step - start_step == 10:
                _stop_profile(prof, cfg, device)
                prof = None
            metrics = train_step(model, opt, to_device(batch, device))
            window.append(metrics)
            step += 1
            if step % cfg.log_interval == 0 or step == total_steps:
                vals = {
                    k: float(np.mean([float(m[k]) for m in window]))
                    for k in window[0]
                }
                dt = (time.time() - t0) / len(window)
                log.info('step %d/%d %.2fs/it %s', step, total_steps, dt,
                         ' '.join(f'{k}={v:.4f}' for k, v in vals.items()))
                if writer is not None:
                    writer.write(step, {**vals, 'sec_per_iter': dt}, 'train')
                window = []
                t0 = time.time()
            if step % steps_per_epoch == 0 and is_main_process():
                ckpt.save(step, model, opt)
                log.info('checkpoint saved at step %d (epoch %d)', step,
                         step // steps_per_epoch)
    finally:
        if prof is not None:  # the run ended inside the window
            _stop_profile(prof, cfg, device)
    if step % steps_per_epoch != 0 and is_main_process():
        ckpt.save(step, model, opt)


def _vis_hook(cfg, batch: dict, preds, i: int, n: int):
    """Exports row ``i`` of a batch as ``vis_dir/scene_{n:05d}.ply``: its
    valid points and, for a detector, its kept boxes scoring above
    ``cfg.vis_score_thr``, colored by label (reference
    base_visualizer.py:71-132)."""
    from ..vis.visualization import export_scene_ply
    pm = _host(batch['points_mask'][i])
    pts = _host(batch['points'][i])[pm]
    if isinstance(preds, dict) and 'mask' in preds:
        keep = _host(preds['mask'][i]) & \
            (_host(preds['scores'][i]) > cfg.vis_score_thr)
        boxes = _host(preds['bboxes'][i])[keep]
        labels = _host(preds['labels'][i])[keep] \
            if 'labels' in preds else None
    else:
        boxes, labels = None, None
    os.makedirs(cfg.vis_dir, exist_ok=True)
    export_scene_ply(os.path.join(cfg.vis_dir, f'scene_{n:05d}.ply'), pts,
                     boxes=boxes, labels=labels)


def _vis_rows(cfg, batch, preds, real_rows: int, n0: int):
    """:func:`_vis_hook` for every ``cfg.vis_interval``-th row counted from
    ``n0`` (not for mv_occ, as the reference), on the main process."""
    if not cfg.vis_dir or cfg.model.task == 'mv_occ':
        return
    from ..parallel.multihost import is_main_process
    if not is_main_process():
        return
    for i in range(real_rows):
        if (n0 + i) % cfg.vis_interval == 0:
            _vis_hook(cfg, batch, preds, i, n0 + i)


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


def evaluate(cfg, model=None, max_scenes: int | None = None,
             format_only: bool = False, device='cuda') -> dict:
    """The task's eval protocol over the val split: ``indoor_eval`` for the
    detectors (per-class tables and splits from the dataset's metainfo),
    ``ground_eval`` for the grounder, ``occupancy_eval`` for occupancy.

    ``model``: the model to evaluate (its mode is restored after); without
    one, the config's model restored from the latest checkpoint of
    ``cfg.work_dir`` (the initial weights when there is none). One scene a
    step. In a ``torch.distributed`` group each process infers its own
    shard of the scans, padded so every process runs as many steps, drops
    its padded tail and the records are gathered, in rank order, before
    the metric (the reference's collect_results); ``max_scenes`` is a
    one-process testing knob. ``format_only`` (grounding): no metric; the
    top-20 challenge-submission json is written into ``cfg.work_dir`` by
    the main process, and ``{'result_file': path}`` returned (None on the
    others).
    """
    from ..configs.base import build_model
    from ..data.loader import to_device
    from ..parallel.mesh import process_device
    from ..parallel.multihost import gather_objects, is_main_process
    from .checkpoint import CheckpointManager
    _setup_logging()
    device = process_device(device)
    loader = make_dataset(cfg, train=False)
    if model is None:
        model = build_model(cfg, device=device)
        step = CheckpointManager(cfg.work_dir).restore(model)
        if step is not None:
            log.info('loaded checkpoint step %d', step)
    was_training = model.training
    model.eval()
    gts, dts = [], []
    n = 0
    rows_per_scene = 1
    try:
        with torch.no_grad():
            for batch in loader:
                preds = model(to_device(batch, device), mode='predict')
                # rows per loader batch: 1 for mv tasks, V sweeps for cont
                rows_per_scene = batch['points'].shape[0]
                _vis_rows(cfg, batch, preds, rows_per_scene, n)
                n = _append_scene_results(cfg, batch, preds, rows_per_scene,
                                          gts, dts, n)
                if max_scenes is not None and n >= max_scenes:
                    break
    finally:
        model.train(was_training)

    # drop this rank's shard padding (repeated last scene), then gather
    local_real = getattr(loader, 'local_real', None)
    if local_real is not None:
        gts = gts[:local_real * rows_per_scene]
        dts = dts[:local_real * rows_per_scene]
    gts = gather_objects(gts)
    dts = gather_objects(dts)

    if format_only and cfg.model.task == 'mv_grounding':
        if not is_main_process():
            return {'result_file': None}
        from ..eval.grounding_metric import format_results
        out = format_results(dts, cfg.work_dir)
        log.info('submission dump written to %s', out)
        return {'result_file': out}
    if cfg.model.task in ('mv_det3d', 'cont_det3d'):
        from ..eval.indoor_eval import indoor_eval
        return indoor_eval(gts, dts, (0.25, 0.5),
                           label2cat=getattr(loader, 'label2cat', None),
                           classes_split=getattr(loader, 'classes_split',
                                                 None),
                           verbose=True, device=device)
    if cfg.model.task == 'mv_grounding':
        from ..eval.grounding_metric import ground_eval
        return ground_eval(gts, dts, device=device)
    from ..eval.occupancy_metric import occupancy_eval
    return occupancy_eval(gts, dts, cfg.model.occ_classes)
