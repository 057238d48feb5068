"""What the metrics of the port's own spans (``es.*``,
``embodiedscan_torch/utils/trace.py``) read from a traced run, beside the
readers of ``harness/readers.py``. Not a metric itself: the training
cells' ``*_dev_ms`` and ``*_idle_ms`` readers import it.

A training step opens ``es.step`` around ``es.fwd``, ``es.bwd`` and
``es.optim`` on the thread that calls ``train_step`` (the step thread).
The backward's kernels are mostly launched by autograd's device thread,
where no span of the step thread is open, and the trace keeps for each
device operation only the innermost span open on its launching thread
(its owner). So a device operation belongs to

- no phase where its owner is ``bench.count``: the benchmark's own
  counting, not the program's work;
- ``es.bwd`` where its owner is None or a span name that only other
  threads' spans hold: it was launched off the step thread, by autograd;
- else to the phase whose spans on the step thread enclose the spans of
  that name (a phase span is its own);
- else, where the name lies under several phases or under none, to the
  phase of the program's operation before it in device order (after it,
  for the first): the port runs on the one current stream, so device
  order is launch order.

Each idle gap of the device goes to the phase open on the step thread when
the gap began (when the device ran out of work); a gap that began while
no phase was open goes to none.
"""

import collections

PHASES = ('es.fwd', 'es.bwd', 'es.optim')
COUNT = 'bench.count'


def step_thread(tr: dict):
    """The thread whose spans hold the most ``es.step`` spans, or None
    where the trace has none."""
    counts = {tid: sum(s[2] == 'es.step' for s in ss)
              for tid, ss in tr['host_spans'].items()}
    tid = max(counts, key=counts.get, default=None)
    return tid if tid is not None and counts[tid] else None


def _name_phases(spans: list) -> dict:
    """{span name: the set of phases enclosing its spans} on one thread."""
    phases = [s for s in spans if s[2] in PHASES]
    out = collections.defaultdict(set)
    for s in spans:
        out[s[2]].update(p[2] for p in phases
                         if p[0] <= s[0] and s[1] <= p[1])
    return out


def device_phases(tr: dict):
    """[(t0, t1, phase or None)] of the trace's device operations in
    device order, each in one phase or (``bench.count``) in none; None
    where no thread holds an ``es.step`` span."""
    tid = step_thread(tr)
    if tid is None:
        return None
    here = _name_phases(tr['host_spans'][tid])
    there = {s[2] for t, ss in tr['host_spans'].items() if t != tid
             for s in ss}
    ops = sorted(tr['device'])
    phases = []
    for _, _, _, owner in ops:
        if owner == COUNT:
            phases.append(None)
        elif owner is None or owner not in here:
            phases.append('es.bwd')
        elif len(here[owner]) == 1 and owner not in there:
            phases.append(next(iter(here[owner])))
        else:
            phases.append('?')
    known = [p for p in phases if p not in (None, '?')]
    last = known[0] if known else None
    for i, p in enumerate(phases):
        if p == '?':
            phases[i] = last
        elif p is not None:
            last = p
    return [(t0, t1, p) for (t0, t1, _, _), p in zip(ops, phases)]


def device_ms(ctx, phase: str):
    """Device ms per step of the operations of ``phase``; None without the
    program's step spans or without device operations (a CPU run)."""
    ops = device_phases(ctx['trace'])
    if not ops:
        return None
    return sum(t1 - t0 for t0, t1, p in ops if p == phase) * 1e-3 / \
        ctx['steps']


def idle_us(tr: dict):
    """{phase or None: device idle us} over the profiled stretch, each gap
    under the phase open on the step thread when it began; None without
    the program's step spans or without device operations."""
    tid = step_thread(tr)
    if tid is None or not tr['device']:
        return None
    phases = sorted(s for s in tr['host_spans'][tid] if s[2] in PHASES)
    ivs = sorted((max(a, tr['w0']), min(b, tr['w1']))
                 for a, b, _, _ in tr['device'])
    out = collections.Counter()
    end = tr['w0']
    for a, b in ivs + [(tr['w1'], tr['w1'])]:
        if a > end:
            open_ = [p[2] for p in phases if p[0] <= end <= p[1]]
            out[open_[-1] if open_ else None] += a - end
        end = max(end, b)
    return dict(out)


def idle_ms(ctx, phase: str):
    """Device idle ms per step that began while ``phase`` was open on the
    step thread."""
    gaps = idle_us(ctx['trace'])
    if gaps is None:
        return None
    return gaps.get(phase, 0.0) * 1e-3 / ctx['steps']
