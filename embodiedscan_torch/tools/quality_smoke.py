"""Overfit harness: tiny models trained on one fixed synthetic batch (the
reference package's ``tools/quality_smoke.py``, on the port).

Each task (detection, grounding, occupancy) trains a tiny model on one
batch of the synthetic dataset, then runs its whole predict -> metric
chain on that batch: detection NMS -> ``indoor_eval``, grounding top-k ->
``ground_eval``, occupancy argmax -> ``occupancy_eval``. The gate is what a
working trainer must show: every loss finite, and the mean of the last 5
losses below the mean of the first 5. The metrics are reported, not gated
(the reference's own detection gate, mAP@0.25 >= 0.9, does not hold on the
reference either).

Usage:
    python -m embodiedscan_torch.tools.quality_smoke [--device cuda]
        [--steps 100] [--out PATH]
"""

import argparse
import time

import numpy as np
import torch


def tiny_cfg(task: str):
    """The preset of ``task`` cut to a tiny model on a tiny synthetic batch
    (two scans, two views of 32 x 32, 512 points, 4 boxes, 5 classes,
    ResNet-18 and MinkResNet-18): the reference's ``tests/test_quality.py``
    configuration, field for field."""
    from ..configs.base import PRESETS
    cfg = PRESETS[task]()
    d = cfg.data
    d.synthetic = True
    d.batch_size = 2
    d.n_views_train = 2
    d.n_views_test = 2
    d.n_points = 512
    d.points_per_view = 256
    d.max_boxes = 4
    d.image_hw = (32, 32)
    m = cfg.model
    m.num_classes = 5
    if task == 'mv_det3d':
        # capacities that cover the batch's voxel counts (an overflow drops
        # voxels, and with them the gt boxes' positive locations), and
        # 0.01 m voxels, so that level 0's 0.08 m cells lie inside the
        # batch's boxes of 0.5 m and more
        m.voxel_size = 0.01
        m.input_capacity = 512
        m.backbone_capacities = (512, 512, 512, 512, 512, 384)
        m.fpn_capacities = (512, 512, 384, 192)
    else:
        m.voxel_size = 0.05
        m.input_capacity = 512
        m.backbone_capacities = (512, 256, 256, 128, 64, 32)
        m.fpn_capacities = (256, 128, 64, 32)
    m.resnet_depth = 18
    m.mink_depth = 18
    m.max_dets = 16
    m.nms_pre = 64
    m.max_candidates = 64
    if task == 'mv_grounding':
        m.num_queries = 8
        m.text_arch = 'tiny'
        # the reference's tiny text encoder has its 30522 rows (the preset's
        # 50265 are roberta-base's); the hash tokenizer's ids lie below them
        m.text_vocab_size = 30522
        m.text_layers = 1
        m.text_hidden = 32
        m.text_heads = 2
        m.max_text_len = 16
    if task in ('mv_occ', 'cont_occ'):
        m.n_voxels = (16, 16, 8)
        m.occ_classes = 6
    return cfg


def overfit(cfg, steps: int, device, lr: float = 1e-3):
    """``steps`` train steps on the first train batch of the synthetic
    dataset drawn from ``cfg.seed`` (AdamW at the constant rate ``lr``,
    weight decay 1e-4, clip 10; no parameter frozen). Returns (model in
    eval mode, the batch on ``device``, the total loss of each step)."""
    from ..configs.base import build_model
    from ..data.loader import SyntheticLoader, to_device
    from ..train.state import make_optimizer, train_step
    batch = to_device(next(iter(SyntheticLoader(cfg, True, seed=cfg.seed))),
                      device)
    model = build_model(cfg, device=device).train()
    cfg.schedule.lr, cfg.schedule.weight_decay = lr, 1e-4
    cfg.schedule.clip_norm = 10.0
    # an epoch longer than the run: the milestones are never reached
    opt = make_optimizer(model, cfg, steps_per_epoch=steps + 1)
    losses = [float(train_step(model, opt, batch)['loss_total'])
              for _ in range(steps)]
    return model.eval(), batch, losses


def _numpy(preds):
    return {k: v.cpu().numpy() for k, v in preds.items()}


def detection_metrics(cfg, steps: int, device):
    from ..eval.indoor_eval import indoor_eval
    model, batch, losses = overfit(cfg, steps, device)
    with torch.no_grad():
        preds = _numpy(model(batch, mode='predict'))
    gts, dts = [], []
    for i in range(batch['points'].shape[0]):
        keep = preds['mask'][i]
        dts.append(dict(bboxes=preds['bboxes'][i][keep],
                        scores=preds['scores'][i][keep],
                        labels=preds['labels'][i][keep]))
        gm = batch['gt_mask'][i].cpu().numpy()
        gts.append(dict(gt_boxes=batch['gt_boxes'][i].cpu().numpy()[gm],
                        gt_labels=batch['gt_labels'][i].cpu().numpy()[gm]))
    return indoor_eval(gts, dts, (0.25, 0.5), verbose=False,
                       device=device), losses


def grounding_metrics(cfg, steps: int, device):
    from ..eval.grounding_metric import ground_eval
    model, batch, losses = overfit(cfg, steps, device)
    with torch.no_grad():
        preds = _numpy(model(batch, mode='predict'))
    gts, dts = [], []
    for i in range(batch['points'].shape[0]):
        dts.append(dict(bboxes=preds['bboxes'][i], scores=preds['scores'][i]))
        gm = batch['gt_mask'][i].cpu().numpy()
        gts.append(dict(gt_boxes=batch['gt_boxes'][i].cpu().numpy()[gm],
                        **{k: bool(batch[k][i]) for k in (
                            'is_view_dep', 'is_hard', 'is_unique')}))
    return ground_eval(gts, dts, device=device), losses


def occupancy_metrics(cfg, steps: int, device):
    from ..eval.occupancy_metric import occupancy_eval
    from ..models.occupancy import occ_multiscale_targets
    model, batch, losses = overfit(cfg, steps, device)
    with torch.no_grad():
        preds = model(batch, mode='predict').cpu().numpy()
        vis = batch.get('visible_mask')
        targets = occ_multiscale_targets(
            batch['gt_occ'], batch['gt_occ_mask'], 1,
            tuple(cfg.model.n_voxels), vis).cpu().numpy()
    return occupancy_eval(list(targets), list(preds),
                          cfg.model.occ_classes), losses


def windows(losses) -> tuple:
    """The means of the first and the last 5 losses (of the first and last
    half, for fewer than 10)."""
    w = max(1, min(5, len(losses) // 2))
    return float(np.mean(losses[:w])), float(np.mean(losses[-w:]))


def learned(losses) -> bool:
    """The gate: every loss finite, and the mean of the last 5 below the
    mean of the first 5."""
    first, last = windows(losses)
    return bool(np.isfinite(losses).all() and last < first)


def main(argv=None) -> dict:
    """Trains and evaluates the three tasks as ``argv`` (default: the
    command line) asks; returns, per task, its steps, losses, metrics,
    seconds and whether it passed the gate. Raises unless all three
    passed."""
    parser = argparse.ArgumentParser()
    parser.add_argument('--device', default='cuda',
                        help="'cuda' (default) or 'cpu'")
    parser.add_argument('--steps', type=int, default=100)
    parser.add_argument('--out', default='',
                        help='also write the report to this markdown file')
    args = parser.parse_args(argv)
    device = torch.device(args.device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('CUDA is not available; pass --device cpu')
    # as the reference harness: det steps, grounding 8/10 of them,
    # occupancy 6/10 of them and at least 40
    tasks = (('mv_det3d', args.steps, detection_metrics,
              ('mAP_0.25', 'mAP_0.50')),
             ('mv_grounding', max(1, args.steps * 8 // 10),
              grounding_metrics, ('Overall@0.25', 'Overall@0.5')),
             ('mv_occ', max(40, args.steps * 6 // 10), occupancy_metrics,
              ('empty', 'mIoU')))
    lines = ['# Overfit evidence of the port', '',
             f'Tiny models trained on one fixed synthetic batch on '
             f'{device.type}; gate: finite losses and the mean of the last 5 '
             f'below the mean of the first 5.', '']
    report = {}
    for task, steps, run, keys in tasks:
        t0 = time.perf_counter()
        metrics, losses = run(tiny_cfg(task), steps, device)
        ok = learned(losses)
        report[task] = dict(steps=steps, losses=losses, metrics=metrics,
                            seconds=time.perf_counter() - t0, passed=ok)
        shown = '  '.join(f'{k}: {metrics.get(k, float("nan")):.3f}'
                          for k in keys)
        first, last = windows(losses)
        lines += [f'## {task} ({steps} steps)', '',
                  f'- loss: {first:.4f} -> {last:.4f} '
                  f'({"passed" if ok else "FAILED"})',
                  f'- {shown}', '']
        print('\n'.join(lines[-5:-1]), flush=True)
    if args.out:
        with open(args.out, 'w') as f:
            f.write('\n'.join(lines) + '\n')
        print(f'wrote {args.out}')
    failed = [t for t, r in report.items() if not r['passed']]
    if failed:
        raise RuntimeError(f'quality_smoke: no learning in {failed}')
    return report


if __name__ == '__main__':
    main()
