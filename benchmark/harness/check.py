"""How ``correct`` is decided: the program's outputs on the timed path
against the plain reference (``benchmark/reference``) on the same seeded
weights and inputs, each number against its limit from the cell's file.

Training (the first ``checked_steps`` steps through the window's own
``train_step`` and feed, on batches whose scenes all differ):

- ``loss_gap``: over the checked steps and the loss terms, the largest
  |program - reference| / |reference|;
- ``grad_gap``: the first step's clipped gradient as the optimizer got it
  (AdamW's first moment after one step over 1 - beta1), per trained leaf:
  |norm(program) - norm(reference)| / max(norm(reference), the median
  leaf's norm), the worst leaf;
- ``update_gap``: the same of each leaf's change after the checked steps,
  over the leaves whose reference gradient is at least a thousandth of the
  median leaf's (the others move by round-off under Adam): the worst leaf,
  or where the cell's file says ``"update": "median"``, the median leaf.

The cell's file also says over how many of the checked steps the losses
are compared (``loss_steps``). A value that is not finite on either side
fails, and so does a program leaf whose change is not finite.

Detection serving (every request of the window, each against the
reference's answer for its scene at the program's ``max_dets`` D; a
candidate is live above the score threshold):

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

Occupancy serving: ``class_gap``, the widest gap by which the reference's
logit of the class that the program served lies below its best, over
every cell of every request; ``logit_gap``, the program's logits at every
scale against the reference's, max |program - reference| / max
|reference| per scale, over a sample of the window's requests drawn from
the seed.
"""

import math
import statistics

import torch

from ..reference import build as R

WINDOW = 16   # ranks by which near-equal scores may reorder a candidate


def leaf_norms(tensors: dict) -> dict:
    names = list(tensors)
    norms = torch.stack(torch._foreach_norm([tensors[n].float()
                                             for n in names])).cpu()
    return dict(zip(names, norms.tolist()))


def worst_leaf(prog: dict, ref: dict, leaves=None) -> tuple:
    """(the largest gap of norms over the leaves, that leaf): |prog - ref|
    / max(ref, the median of ref over the leaves compared)."""
    leaves = list(ref) if leaves is None else list(leaves)
    if not leaves:
        return 0.0, None
    med = statistics.median(ref[n] for n in leaves)
    gaps = {n: _gap(prog[n], ref[n], med) for n in leaves}
    name = max(gaps, key=gaps.get)
    return gaps[name], name


def moved_leaves(ref_grads: dict) -> list:
    med = statistics.median(ref_grads.values())
    return [n for n, v in ref_grads.items() if v >= 1e-3 * med]


def program_train_readings(model, opt) -> dict:
    """The optimizer's first gradient per trained leaf, read from AdamW's
    state after one step."""
    names = {id(p): n for n, p in model.named_parameters()}
    grads = {}
    for group in opt.param_groups:
        b1 = group['betas'][0]
        for p in group['params']:
            grads[names[id(p)]] = opt.state[p]['exp_avg'] / (1 - b1)
    return leaf_norms(grads)


def loss_gap(prog: list, ref: list) -> tuple:
    worst, where = 0.0, None
    for i, (lp, lr) in enumerate(zip(prog, ref)):
        for k in lr:
            gap = _gap(abs(lp[k]), abs(lr[k]), 0.0)
            if gap > worst or where is None:
                worst, where = gap, f'step {i + 1} {k}'
    return worst, where


def reference_train(conf: dict, plan, seed: int, batches, device) -> dict:
    """The reference's readings over the checked steps: loss terms per
    step, the first clipped gradient's norm and the change's norm per
    trained leaf."""
    from . import weights as W
    R.plain_float32()
    with torch.device(device):
        model = R.build_model(conf['model']).train()
    W.load(model, plan, seed)
    params = [(n, p) for n, p in model.named_parameters() if R.trained(n)]
    for n, p in model.named_parameters():
        p.requires_grad_(R.trained(n))
    p0 = {n: p.detach().clone() for n, p in params}
    s = conf['schedule']
    opt = R.PlainAdamW(params, s['lr'], s['weight_decay'], s['clip_norm'])
    losses, grad = [], None
    for b in batches():
        step_losses, grads = R.train_step(model, opt, b)
        losses.append(step_losses)
        if grad is None:
            grad = leaf_norms(grads)
        del grads
    change = leaf_norms({n: p.detach() - p0[n] for n, p in params})
    return dict(losses=losses, grad=grad, change=change)


def median_leaf(prog: dict, ref: dict, leaves) -> tuple:
    """(the median over the leaves of the gap of norms, as in
    :func:`worst_leaf`, the leaf it falls on)."""
    leaves = list(leaves)
    med = statistics.median(ref[n] for n in leaves)
    gaps = sorted((_gap(prog[n], ref[n], med), n) for n in leaves)
    return gaps[len(gaps) // 2]


def _gap(p, r, med):
    """|p - r| / max(r, med); a value that is not finite on either side
    fails."""
    if not (math.isfinite(p) and math.isfinite(r)):
        return math.inf
    return abs(p - r) / max(r, med, 1e-30)


def compare_train(prog: dict, ref: dict, loss_steps: int,
                  update: str = 'worst') -> dict:
    """{number: (value, where)} of a training cell: the losses of the
    first ``loss_steps`` steps, the first gradient by the worst leaf, the
    change by the worst leaf or (``update='median'``) the median one."""
    if set(prog['grad']) != set(ref['grad']):
        missing = sorted(set(prog['grad']) ^ set(ref['grad']))
        return dict(loss_gap=(math.inf, f'leaves differ: {missing[:4]}'))
    moved = moved_leaves(ref['grad'])
    pick = median_leaf if update == 'median' else worst_leaf
    bad = [n for n, v in prog['change'].items() if not math.isfinite(v)]
    return dict(loss_gap=loss_gap(prog['losses'][:loss_steps],
                                  ref['losses'][:loss_steps]),
                grad_gap=worst_leaf(prog['grad'], ref['grad']),
                update_gap=(math.inf, f'{len(bad)} leaves not finite, '
                            f'e.g. {bad[0]}') if bad else
                pick(prog['change'], ref['change'], moved))


def _box_gaps(boxes, ref_boxes):
    """(D, C): for each pair, the largest over the fields of |a - b| /
    max(|b|, 1); a field that is not finite on either side fails."""
    a, b = boxes[:, None], ref_boxes[None]
    rel = (a - b).abs() / b.abs().clamp(min=1.0)
    rel = torch.where(torch.isfinite(rel), rel, torch.full_like(rel,
                                                                math.inf))
    return rel.amax(-1)


def _worse(worst: dict, name: str, value, where: str) -> None:
    value = float(value)
    if math.isnan(value):
        value = math.inf
    if worst.get(name) is None or value >= worst[name][0]:
        worst[name] = (value, where)


def compare_det(outs: list, refs: dict, score_thr: float, device) -> dict:
    """``outs``: [(scene index, the program's answer)]; ``refs``: scene
    index -> the reference's answer over all its candidates, of which the
    first D (the program's ``max_dets``) are its answer at the program's
    size and the rest let a program candidate near the cut find its
    match."""
    from ..reference.geometry.nms import nms3d
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
        _worse(worst, 'score_gap', ((s - sr).abs() / sr.clamp(
            min=score_thr)).max(), f'request {i}')
        # each live candidate against the other side's live candidates of
        # its label within WINDOW ranks, both ways
        ranks = torch.arange(c, device=device)
        near = (ranks[:d, None] - ranks[None]).abs() <= WINDOW
        gaps = torch.where(near & (labels[:, None] == ref['labels'][None]) &
                           live_r[None], _box_gaps(boxes, ref['bboxes']),
                           torch.full((d, c), math.inf, device=device))
        match = gaps.amin(1)
        to_ref = torch.where(live, match, torch.zeros_like(match))
        back = torch.where(live[:, None], gaps[:, :d],
                           torch.full_like(gaps[:, :d], math.inf)).amin(0)
        to_prog = torch.where(live_r[:d] & (ranks[:d] < d - WINDOW), back,
                              torch.zeros_like(back))
        _worse(worst, 'box_gap', torch.maximum(to_ref.max(), to_prog.max()),
               f'request {i}')
        # the kept sets: each live candidate's keep against its match's
        j = gaps.argmin(1)
        matched = torch.where(torch.isfinite(match), ref['mask'][j], keep)
        _worse(worst, 'keep_diff', ((keep != matched) & live).sum(),
               f'request {i}')
        # the program's NMS over its own candidates, exactly
        key = (boxes.cpu().numpy().tobytes(), s.cpu().numpy().tobytes(),
               labels.cpu().numpy().tobytes())
        if key not in nms_keep:
            nms_keep[key] = nms3d(boxes, s, live, 0.5, labels,
                                  presorted=True)[1]
        _worse(worst, 'nms_diff', (nms_keep[key] != keep).sum(),
               f'request {i}')
    return worst


def compare_occ(outs: list, logits: list, refs: dict) -> dict:
    """``outs``: [(scene index, the served classes)] of every request;
    ``logits``: [(request, scene index, the program's per-scale logits)]
    of the sampled requests; ``refs``: scene index -> the reference's
    per-scale logits."""
    worst = {}
    for i, (scene, classes) in enumerate(outs):
        ref = refs[scene][0].cpu()
        served = torch.gather(ref, -1, classes.long()[..., None])[..., 0]
        _worse(worst, 'class_gap', (ref.amax(-1) - served).amax(),
               f'request {i}')
    for i, scene, prog in logits:
        if len(prog) != len(refs[scene]):
            _worse(worst, 'logit_gap', math.inf, f'request {i}: scales')
        for k, (p, r) in enumerate(zip(prog, refs[scene])):
            p, r = p.to(r.device).float(), r.float()
            gap = (p - r).abs().amax() / r.abs().amax().clamp(min=1e-30) \
                if p.shape == r.shape else math.inf
            _worse(worst, 'logit_gap', gap, f'request {i} scale {k}')
    return worst


def verdict(numbers: dict, limits: dict) -> tuple:
    """(correct, lines): each number beside its limit; correct when every
    number is finite and at most its limit."""
    ok = True
    lines = []
    for name, (value, where) in numbers.items():
        lim = limits[name]
        good = math.isfinite(value) and value <= lim
        ok &= good
        lines.append(f'{name} {value!r} limit {lim!r} '
                     f'{"ok" if good else "OVER"} ({where})')
    return ok, lines
