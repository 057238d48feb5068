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

Serving: the numbers of the configuration's task file
(``tasks/<task>.py``, ``compare_serve``), which compares the program's
outputs of the window's requests with its reference's. A task file may
also add numbers to the training comparison (``compare_train``).
"""

import contextlib
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


def reference_train(task, conf: dict, plan, seed: int, batches,
                    device) -> dict:
    """The reference's readings over the checked steps: loss terms per
    step, the first clipped gradient's norm and the change's norm per
    trained leaf, and what the task file's ``watch_train`` kept."""
    from . import weights as W
    R.plain_float32()
    with torch.device(device):
        model = task.build(conf['model']).train()
    W.load(model, plan, seed)
    params = [(n, p) for n, p in model.named_parameters() if task.trained(n)]
    for n, p in model.named_parameters():
        p.requires_grad_(task.trained(n))
    p0 = {n: p.detach().clone() for n, p in params}
    s = conf['schedule']
    opt = R.PlainAdamW(params, s['lr'], s['weight_decay'], s['clip_norm'])
    losses, grad = [], None
    with watch_train(task, model) as watched:
        for b in batches():
            step_losses, grads = R.train_step(model, opt, b)
            losses.append(step_losses)
            if grad is None:
                grad = leaf_norms(grads)
            del grads
    change = leaf_norms({n: p.detach() - p0[n] for n, p in params})
    return dict(losses=losses, grad=grad, change=change, watched=watched)


def watch_train(task, model):
    """The task file's ``watch_train(model)``, or a context that keeps
    nothing."""
    watch = getattr(task, 'watch_train', None)
    return watch(model) if watch else contextlib.nullcontext({})


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


def compare_train(prog: dict, ref: dict, loss_steps: int, update: str,
                  task) -> dict:
    """{number: (value, where)} of a training cell: the losses of the
    first ``loss_steps`` steps, the first gradient by the worst leaf, the
    change by the worst leaf or (``update='median'``) the median one, and
    the numbers of the task file's ``compare_train``, where it has one."""
    if set(prog['grad']) != set(ref['grad']):
        missing = sorted(set(prog['grad']) ^ set(ref['grad']))
        return dict(loss_gap=(math.inf, f'leaves differ: {missing[:4]}'))
    moved = moved_leaves(ref['grad'])
    pick = median_leaf if update == 'median' else worst_leaf
    bad = [n for n, v in prog['change'].items() if not math.isfinite(v)]
    numbers = dict(
        loss_gap=loss_gap(prog['losses'][:loss_steps],
                          ref['losses'][:loss_steps]),
        grad_gap=worst_leaf(prog['grad'], ref['grad']),
        update_gap=(math.inf, f'{len(bad)} leaves not finite, '
                    f'e.g. {bad[0]}') if bad else
        pick(prog['change'], ref['change'], moved))
    if hasattr(task, 'compare_train'):
        numbers.update(task.compare_train(prog['watched'], ref['watched']))
    return numbers


def box_gaps(boxes, ref_boxes):
    """(D, C): for each pair, the largest over the fields of |a - b| /
    max(|b|, 1); a field that is not finite on either side fails."""
    a, b = boxes[:, None], ref_boxes[None]
    rel = (a - b).abs() / b.abs().clamp(min=1.0)
    rel = torch.where(torch.isfinite(rel), rel, torch.full_like(rel,
                                                                math.inf))
    return rel.amax(-1)


def worse(worst: dict, name: str, value, where: str) -> None:
    """Keeps in ``worst[name]`` the largest (value, where); NaN counts
    as infinite."""
    value = float(value)
    if math.isnan(value):
        value = math.inf
    if worst.get(name) is None or value >= worst[name][0]:
        worst[name] = (value, where)


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
