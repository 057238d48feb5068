"""One run of one cell: set-up, the measured window (or, with tracing, the
profiled stretch), the peak, then the comparison with the reference.

A training cell drives the port's ``train_step`` in a closed loop over a
pool of batches made on the device. Its first ``checked_steps`` steps are
the set-up's warm-up and what the reference follows. A serving cell offers
requests at the traffic file's fixed rate, each a batch in pinned host
memory handed to the port's ``to_device`` and ``model(..., 'predict')``,
timed from when it was due to its outputs on the host.
"""

import gc
import math
import statistics
import sys
import time

import torch

from ..traffic import generate as G
from . import check as C
from . import program as P
from . import trace as T
from . import weights as W
from .spec import sub_seed


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _sync(device):
    if torch.device(device).type == 'cuda':
        torch.cuda.synchronize(device)


def _free():
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def _peak(device):
    if torch.device(device).type != 'cuda':
        return 0
    return int(torch.cuda.max_memory_allocated(device))


def _change_norms(model, plan, seed, names, device) -> dict:
    """Each trained leaf's change from its seeded start, the start drawn
    again from the seed (no copy is kept through the steps)."""
    params = dict(model.named_parameters())
    out = {}
    with torch.no_grad():
        for name, v0 in W.values(plan, seed, device):
            if name in names:
                out[name] = torch.linalg.vector_norm(
                    (params[name].detach() - v0).float())
    keys = list(out)
    vals = torch.stack([out[k] for k in keys]).cpu().tolist()
    return dict(zip(keys, vals))


def run_train(cell, seed, seconds, trace, device, t_start, control=False,
              faults=None):
    conf, t, work = cell['conf'], cell['traffic'], cell['work']
    task, bench_dir = cell['task'], cell['bench_dir']
    n_checked = work['checked_steps']
    if t['pool'] < n_checked:
        raise ValueError('the pool must hold a batch for every checked step')
    marks = [('start', time.perf_counter())]
    plan = W.plan(task, conf['model'], work.get('init'))
    model, opt = P.build(conf, True, seed, device, plan)
    marks.append(('model', time.perf_counter()))
    pool = G.pool(t, conf, seed, device, bench_dir)
    marks.append(('pool', time.perf_counter()))
    step = (faults or {}).get('train_step', P.train_step)
    if control:
        P.set_control(True)
    losses, grad = [], None
    with C.watch_train(task, model) as watched:
        for i in range(n_checked):
            out = step(model, opt, pool[i])
            losses.append({k: float(v) for k, v in out.items()
                           if k != 'loss_total'})
            if i == 0:
                grad = C.program_train_readings(model, opt)
            marks.append((f'step {i + 1}', time.perf_counter()))
    change = _change_norms(model, plan, seed, set(grad), device)
    marks.append(('change', time.perf_counter()))
    log('set-up: ' + ', '.join(f'{name} {t1 - t0:.2f} s' for (_, t0), (
        name, t1) in zip([('import', t_start)] + marks, marks)))
    prog = dict(losses=losses, grad=grad, change=change, watched=watched)
    res = dict(metrics={}, attempted=0, failed=0)
    b = t['batch']
    if not trace:
        _sync(device)
        t0 = time.perf_counter()
        res['setup_s'] = t0 - t_start
        n = 0
        while True:
            step(model, opt, pool[(n_checked + n) % len(pool)])
            n += 1
            if time.perf_counter() - t0 >= seconds:
                break
        _sync(device)
        t1 = time.perf_counter()
        res['metrics']['train_scenes_per_s'] = b * n / (t1 - t0)
        res['attempted'] = n
        log(f'window: {n} steps of {b} scenes in {t1 - t0:.3f} s')
    else:
        res.update(_traced(cell, model, device, training=True,
                           run=lambda i: step(model, opt,
                                              pool[i % len(pool)]),
                           per=b))
    res['peak'] = _peak(device)
    if control:
        P.set_control(False)
    model = opt = pool = None
    _free()
    t_ref = time.perf_counter()
    ref = C.reference_train(
        task, conf, plan, seed,
        lambda: (G.batch(t, conf, seed, i, device, bench_dir)
                 for i in range(n_checked)),
        device)
    log(f'reference: {n_checked} steps in {time.perf_counter() - t_ref:.1f} s')
    for side, r in (('program', prog), ('reference', ref)):
        bad = [n for n, v in r['change'].items() if not math.isfinite(v)]
        if bad:
            log(f'{side}: {len(bad)} of {len(r["change"])} leaves changed by '
                f'a non-finite amount, e.g. {bad[0]}')
    for i, (lp, lr) in enumerate(zip(prog['losses'], ref['losses'])):
        log(f'losses step {i + 1}: ' + ', '.join(
            f'{k} {lp[k]!r} / {lr[k]!r}' for k in lr) + ' (program / reference)')
    res['numbers'] = C.compare_train(prog, ref, work['loss_steps'],
                                     work.get('update', 'worst'), task)
    moved = C.moved_leaves(ref['grad'])
    log('readings: loss_gap by step ' + ', '.join(
        f'{C.loss_gap([lp], [lr])[0]!r}' for lp, lr in
        zip(prog['losses'], ref['losses'])) +
        f'; grad_gap median {C.median_leaf(prog["grad"], ref["grad"], ref["grad"])}'
        f'; update_gap worst {C.worst_leaf(prog["change"], ref["change"], moved)}'
        f', median {C.median_leaf(prog["change"], ref["change"], moved)}')
    return res


def _requests(model, pool_np, device, due, request, stop_after=None):
    """Serves ``due`` (s from now) in order; returns (latencies, lateness,
    [(scene, outputs)], elapsed). ``stop_after``: seconds after which no
    further request starts (the capacity sweep's rates above capacity)."""
    lat, late, outs = [], [], []
    t0 = time.perf_counter()
    for i, d in enumerate(due):
        if stop_after is not None and time.perf_counter() - t0 > stop_after:
            break
        wait = t0 + d - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        late.append(max(0.0, time.perf_counter() - (t0 + d)))
        scene = i % len(pool_np)
        out = request(model, pool_np[scene][1], device)
        lat.append(time.perf_counter() - (t0 + d))
        outs.append((scene, out))
    return lat, late, outs, time.perf_counter() - t0


def serve_setup(cell, seed, device):
    """The served model with the seed's weights, and the pool of requests
    in (pinned, on a card) host memory: [(tensors, numpy views)]."""
    conf, t = cell['conf'], cell['traffic']
    plan = W.plan(cell['task'], conf['model'], cell['work'].get('init'))
    model, _ = P.build(conf, False, seed, device, plan)
    pinned = torch.device(device).type == 'cuda'
    pool_np = []
    for i in range(t['pool']):
        b = G.batch(t, conf, seed, i, device, cell['bench_dir'])
        host = {k: (v.cpu().pin_memory() if pinned else v.cpu())
                for k, v in b.items()}
        pool_np.append((host, {k: v.numpy() for k, v in host.items()}))
        del b
    return model, pool_np, plan


def run_serve(cell, seed, seconds, trace, device, t_start, control=False,
              faults=None):
    conf, t, work = cell['conf'], cell['traffic'], cell['work']
    task = cell['task']
    model, pool_np, plan = serve_setup(cell, seed, device)
    request = (faults or {}).get('request', P.request)
    if control:
        P.set_control(True)
    for i in range(work['warmup_requests']):
        request(model, pool_np[i % len(pool_np)][1], device)
    _sync(device)
    res = dict(metrics={}, failed=0)
    due = G.arrivals(t, seconds)
    kept = _Logits(model, conf, work, seed,
                   2 * work['trace_steps'] + 1 if trace else len(due))
    request = kept.wrap(request)
    if not trace:
        t0 = time.perf_counter()
        res['setup_s'] = t0 - t_start
        lat, late, outs, el = _requests(model, pool_np, device, due,
                                        request)
        ms = sorted(x * 1e3 for x in lat)
        res['metrics']['latency_p50_ms'] = statistics.median(ms)
        res['metrics']['latency_p90_ms'] = statistics.quantiles(
            ms, n=10, method='inclusive')[8]
        log(f'window: {len(ms)} requests at {t["rate_per_s"]}/s in '
            f'{el:.3f} s; started late by up to {max(late) * 1e3:.1f} ms '
            f'(median {statistics.median(late) * 1e3:.1f})')
    else:
        outs = []

        def run(i):
            outs.append((i % len(pool_np),
                         request(model, pool_np[i % len(pool_np)][1],
                                 device)))

        res.update(_traced(cell, model, device, training=False, run=run,
                           per=1))
    res['attempted'] = len(outs)
    res['peak'] = _peak(device)
    kept.close()
    if control:
        P.set_control(False)
    model = pool_np = None
    _free()
    t_ref = time.perf_counter()
    scenes = sorted({s for s, _ in outs})
    from ..reference import build as R
    R.plain_float32()
    with torch.device(device):
        ref_model = task.build(conf['model'], serve=True).eval()
    W.load(ref_model, plan, seed)
    refs = {s: task.predict(ref_model, G.batch(t, conf, seed, s, device,
                                               cell['bench_dir']))
            for s in scenes}
    log(f'reference: {len(scenes)} scenes in '
        f'{time.perf_counter() - t_ref:.1f} s')
    res['numbers'] = task.compare_serve(
        outs, [(i, outs[i][0], lg) for i, lg in kept.logits], refs, work,
        device)
    return res


class _Logits:
    """Holds the per-scale logits of a sample of a run's ``n`` requests,
    drawn from the seed: the output of the module that the configuration
    names under ``logits``, kept on the device (no copy, no sync) until
    the window has closed. Does nothing where the configuration names
    none."""

    def __init__(self, model, conf, work, seed, n):
        self.logits, self.i, self.handle = [], -1, None
        if conf.get('logits'):
            g = torch.Generator()
            g.manual_seed(sub_seed(seed, 'sample'))
            self.sample = set(torch.randperm(n, generator=g)
                              [:work.get('logit_sample', 8)].tolist())
            self.handle = dict(model.named_modules())[
                conf['logits']].register_forward_hook(self._keep)

    def _keep(self, mod, args, out):
        if self.i in self.sample:
            self.logits.append((self.i, list(out)))

    def wrap(self, request):
        def counted(model, batch_np, device):
            self.i += 1
            return request(model, batch_np, device)
        return counted

    def close(self):
        if self.handle is not None:
            self.handle.remove()


def _traced(cell, model, device, training, run, per):
    """An untimed-by-the-profiler stretch of ``trace_steps`` steps or
    requests (its host time sets ``mfu``), then the same number profiled
    with the benchmark's spans on; returns what the metric readers take."""
    n = cell['work']['trace_steps']
    _sync(device)
    t0 = time.perf_counter()
    for i in range(n):
        run(i)
    _sync(device)
    plain_s = time.perf_counter() - t0
    with T.Spans(model, cell['conf'], training) as spans:
        tr = T.profile(lambda: [run(n + i) for i in range(n)])
    dense = T.dense_flops(lambda: run(2 * n))
    busy = T.busy_us(tr)
    ctx = dict(trace=tr, spans=spans, steps=n, sec_per_step=plain_s / n,
               dense_flops=dense,
               per_step=per, busy_us=busy, cell=cell)
    return dict(ctx=ctx, busy_s=busy * 1e-6, window_s=tr['window_us'] * 1e-6,
                breakdown=T.breakdown(tr), attempted=n)
