"""The 3D detection task (``SparseFusionDetector``, the FCAF3D head): its
reference model, its trained parameters, its head's initialization and how
its served boxes are compared.

Serving is compared over every request of the window, each against the
reference's answer for its scene at the program's ``max_dets`` D; a
candidate is live above the score threshold:

- ``score_gap``: the scores rank by rank, |program - reference| /
  max(reference, threshold), the worst;
- ``box_gap``: each live candidate against the nearest live candidate of
  the same label on the other side within ``WINDOW`` ranks (near-equal
  scores may reorder), both ways (the reference's first D - ``WINDOW``
  ranks against the program's), by the largest over the box's fields of
  |program - reference| / max(|reference|, 1): metres, or a share of
  sizes above 1 m, and radians; the worst;
- ``keep_diff``: live candidates whose NMS keep differs from that of
  their match on the reference's side (the kept sets), per request;
- ``nms_diff``: the program's keep mask against the reference's NMS run
  over the program's own candidates, entries that differ (exact).
"""

import math

import torch

from benchmark.harness.cells import log
from benchmark.harness.check import WINDOW, box_gaps, worse
from benchmark.reference.models.fcaf3d import _CLS_BIAS, FCAF3DHead

FROZEN = ('stem_conv', 'stem_bn', 'layer1_')


def build(model: dict, serve: bool = False) -> torch.nn.Module:
    """The detector of the configuration's ``model`` section; ``serve``:
    it keeps all of its ``max_candidates`` (the check keeps all)."""
    from benchmark.reference.models.detector import SparseFusionDetector
    m = model
    return SparseFusionDetector(
        num_classes=m['num_classes'], voxel_size=m['voxel_size'],
        input_capacity=m['input_capacity'],
        backbone_capacities=tuple(m['backbone_capacities']),
        fpn_capacities=tuple(m['fpn_capacities']),
        resnet_depth=m['resnet_depth'], mink_depth=m['mink_depth'],
        nms_pre=m['nms_pre'], max_candidates=m['max_candidates'],
        max_dets=m['max_candidates'] if serve else m['max_dets'],
        bbox_mode=m['bbox_mode'], predict_protocol=m['predict_protocol'])


def trained(name: str) -> bool:
    """Whether the parameter ``name`` is trained (the 2D stem and first
    stage are frozen: ``frozen_stages=1``)."""
    return not any(f in name for f in FROZEN)


def weight_rules(ref) -> dict:
    """The head's projections at N(0, 0.01) and its class bias at the
    prior probability, as the port initializes them."""
    rules = {}
    for mod_name, mod in ref.named_modules():
        if isinstance(mod, FCAF3DHead):
            pre = mod_name + '.' if mod_name else ''
            for lin in ('conv_center', 'conv_reg', 'conv_cls'):
                rules[f'{pre}{lin}.weight'] = ('normal', 0.01)
            rules[f'{pre}conv_cls.bias'] = ('const', _CLS_BIAS)
    return rules


@torch.no_grad()
def predict(model, batch: dict):
    """The reference's candidates (all of them, with the NMS keep mask)."""
    return model(batch, mode='predict')


def compare_serve(outs: list, logits: list, refs: dict, work: dict,
                  device) -> dict:
    """``outs``: [(scene index, the program's answer)]; ``refs``: scene
    index -> the reference's answer over all its candidates, of which the
    first D (the program's ``max_dets``) are its answer at the program's
    size and the rest let a program candidate near the cut find its
    match; ``work['score_thr']``: the score threshold."""
    from benchmark.reference.geometry.nms import nms3d
    score_thr = work['score_thr']
    s, keep = outs[0][1]['scores'][0], outs[0][1]['mask'][0]
    log(f'request 0 served scores {float(s[0])!r} to {float(s[-1])!r}, '
        f'{int((s > score_thr).sum())} live, {int(keep.sum())} kept')
    worst, nms_keep = {}, {}
    for i, (scene, out) in enumerate(outs):
        ref = {k: v[0].to(device) for k, v in refs[scene].items()}
        s = out['scores'][0].to(device)
        boxes = out['bboxes'][0].to(device)
        labels = out['labels'][0].to(device)
        keep = out['mask'][0].to(device)
        d, c = s.shape[0], ref['scores'].shape[0]
        live, live_r = s > score_thr, ref['scores'] > score_thr
        # the scores rank by rank: a candidate lost, added, zeroed or
        # rescored moves every score below it
        sr = ref['scores'][:d]
        worse(worst, 'score_gap', ((s - sr).abs() / sr.clamp(
            min=score_thr)).max(), f'request {i}')
        # each live candidate against the other side's live candidates of
        # its label within WINDOW ranks, both ways
        ranks = torch.arange(c, device=device)
        near = (ranks[:d, None] - ranks[None]).abs() <= WINDOW
        gaps = torch.where(near & (labels[:, None] == ref['labels'][None]) &
                           live_r[None], box_gaps(boxes, ref['bboxes']),
                           torch.full((d, c), math.inf, device=device))
        match = gaps.amin(1)
        to_ref = torch.where(live, match, torch.zeros_like(match))
        back = torch.where(live[:, None], gaps[:, :d],
                           torch.full_like(gaps[:, :d], math.inf)).amin(0)
        to_prog = torch.where(live_r[:d] & (ranks[:d] < d - WINDOW), back,
                              torch.zeros_like(back))
        worse(worst, 'box_gap', torch.maximum(to_ref.max(), to_prog.max()),
              f'request {i}')
        # the kept sets: each live candidate's keep against its match's
        j = gaps.argmin(1)
        matched = torch.where(torch.isfinite(match), ref['mask'][j], keep)
        worse(worst, 'keep_diff', ((keep != matched) & live).sum(),
              f'request {i}')
        # the program's NMS over its own candidates, exactly
        key = (boxes.cpu().numpy().tobytes(), s.cpu().numpy().tobytes(),
               labels.cpu().numpy().tobytes())
        if key not in nms_keep:
            nms_keep[key] = nms3d(boxes, s, live, 0.5, labels,
                                  presorted=True)[1]
        worse(worst, 'nms_diff', (nms_keep[key] != keep).sum(),
              f'request {i}')
    return worst
