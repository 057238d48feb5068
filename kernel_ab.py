"""Kernel times of one checkout of the PyTorch/CUDA port, under one harness.

Run from the repository root on a machine with one CUDA card:

    python3 kernel_ab.py [--plans] [ROOT]

It imports ``embodiedscan_torch`` from ROOT (default: the directory of this
script), builds its kernels, and serves one warm-up and three full-width
mv_det3d requests as ``chip_smoke.py`` does (host-clock latency of the
three), recording every kernel call of the warm-up request. Then it times
each call with ``chip_smoke.cuda_ms`` (CUDA events over back-to-back wrapper
calls after three warm-up calls: 5 timed calls per sparse conv, 20 per join
scan), all before any profiler session, and last counts each call's CUDA
launches and device time under torch.profiler. It uses only what every
version of the port has, so two checkouts run in turns (parent, change,
change, parent) compare on one card under one harness.

``--plans`` (the current tree only) also times every tensor-core plan of
:func:`embodiedscan_torch.ops.sparse.conv_plan`'s space (tile width 64 or
128; 27, 14, 9 or 3 offsets per split) on every tensor-core call, each held
to the plain version within chip_smoke's gate.

Prints the card, then one JSON line of per-request sums; the per-call
numbers are appended to chiprun_out/kernel_ab.jsonl.

    python3 kernel_ab.py --train [--plans] [ROOT]

does the same for the training path: one recorded warm-up train step of
the full-width mv_det3d (chip_smoke's batch: 100k points, 20 views, 128 GT
boxes), three timed steps (host clock, peak memory) and the forward /
backward / optimizer split of one more, then every K3 call
(``conv_wgrad``) and K2 input-gradient call (``conv_dgrad``) of the
warm-up step timed as above, and its host cost (the time to enqueue one
call, no synchronize), all before the profiler counts each call's launches
and device time. It uses only ``build_train``, ``train_step``,
``conv_wgrad``, ``conv_dgrad`` and ``cuda_wgrad_plan``, which every
version of the training port has. ``--plans`` (the current tree only) also
times each tensor-core K3 call at every pair-chunk count of
``WG_PLAN_CHUNKS``, each held to the plain versions as chip_smoke holds it.

    python3 kernel_ab.py --bf16 [--plans] [--cont]

times the bfloat16 kernels of the current tree: under
``set_conv_compute_dtype(torch.bfloat16)`` it records one full-width
mv_det3d request (``mode='feats'``: every conv, no NMS) and one train step
(and with ``--cont`` one 50-sweep cont_det3d request and one 10-sweep
cont_det3d train step, calls of up to 3.3M rows), then times each K2-bf16
call (forward and input gradient) and each K3-bf16 call as shipped, by
CUDA events over its kernel alone (the operands cast beforehand). With
``--plans`` it also times every tensor-core plan of each call: K2-bf16
every tile of ``BF16_TILES`` by 27, 9, 5 or 3 offsets per split, K3-bf16
every tile by ``WG_PLAN_CHUNKS`` chunks, each held to the call's plain
version within chip_smoke's gate (the data ``conv_plan(..., bf16=True)`` and
``wgrad_plan(bf16=True)`` were fitted to). Prints one JSON line of sums
per group; the per-call numbers go to chiprun_out/kernel_ab.jsonl.

    python3 kernel_ab.py --nms

is the card check of K4 (``csrc/nms_overlap.cu``, the rotated NMS's
suppression matrix), which no cell runs alone. It compares K4's matrix
with the torch route's (``geometry/iou.py:_suppression_matrix_plain``) on
the card, on the same inputs: the candidates ``nms3d`` gets in every
request of ``mv_det3d.serve.v50``'s pool for 12 seeds (the cell's seeded
weights and scenes), the adversarial sets of
``tests/test_torch_nms_overlap.py`` at two thresholds, and a set of 512
labelled pairs whose IoU lies within ~1e-5 of 0.5. It counts mismatches
(0 expected everywhere), and IoUs that differ in any bit (K4 run at each
pair's own torch-route IoU and the float below it, on the near set and on
clipped pairs of the requests). It times K4 on a request's candidates
(CUDA events, with and without its per-box prep; launches and device ms
under the profiler) against the torch route, and reads K4's counters:
the share of the pairs given (j > i) that it clipped.

    python3 kernel_ab.py --tf32-control [ROOT]

is the control for chip_smoke's GRAD_GATE: chip_smoke's CPU-against-card
train step (``chip_smoke.train_parity``) from ROOT as it is, then from
temporary copies of its ``embodiedscan_torch`` whose 3xTF32 products keep
only the single-TF32 term: K2's (``csrc/sparse_mma.cuh:mma_3xtf32``) and
K3's (``WG_TF32_TERMS``), then K3's alone; each in a process of its own. Prints one JSON line per tree with the worst
max|d|/max|cpu| over the leaves of each kind.
"""

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

import chip_smoke as cs

REPS = {'sparse_conv': 5, 'join_scan': 20}
WG_PLAN_CHUNKS = (1, 2, 4, 8, 16, 32, 64)
WG_PLAN_MAX_WS = 2**30  # bytes of chunk partials a timed plan may take
PLAN_WIDTHS = (64, 128)
PLAN_OFFSETS = (27, 14, 9, 3)


def serve(S, P):
    """One recorded warm-up request and three timed ones."""
    from embodiedscan_torch.configs.base import build_model, mv_det3d
    from embodiedscan_torch.utils.convert_weights import load_jax_variables
    cfg = mv_det3d()
    torch.manual_seed(0)
    model = build_model(cfg, device='cuda')
    load_jax_variables(model, {'bbox_head': {'conv_cls': {'bias': np.zeros(
        cfg.model.num_classes, np.float32)}}}, strict=False)
    d = cfg.data
    requests = [cs.make_request(d.n_points, d.n_views_test, d.image_hw[0], s)
                for s in range(4)]
    with torch.no_grad():
        with cs.Recorder(S, P) as rec:
            model(cs.to_device(requests[0], 'cuda'), mode='predict')
            torch.cuda.synchronize()
        lat = []
        for req in requests[1:]:
            batch = cs.to_device(req, 'cuda')
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model(batch, mode='predict')
            torch.cuda.synchronize()
            lat.append((time.perf_counter() - t0) * 1e3)
    return rec, lat


def plan_space(S, k):
    plans = []
    for bn in PLAN_WIDTHS:
        for per in PLAN_OFFSETS:
            per = min(per, k)
            plan = S.ConvPlan('tc', S.TC_BM, bn, -(-k // per), per)
            if plan not in plans:
                plans.append(plan)
    return plans


@torch.no_grad()
def time_calls(S, P, rec, plans):
    conv, scan = [], []
    for feats, mask, nbr, w, *rest in rec.conv:
        bias = rest[0] if rest else None
        m, k = nbr.shape
        row = dict(m=m, k=k, cin=w.shape[1], cout=w.shape[2], ms=cs.cuda_ms(
            lambda: S.gather_matmul_conv(feats, mask, nbr, w, bias),
            reps=REPS['sparse_conv']))
        if plans and S.cuda_plan(feats, nbr, w).route == 'tc':
            row['plan'] = list(S.cuda_plan(feats, nbr, w)[1:])
            row['plans'] = []
            for plan in plan_space(S, k):
                cs._check_conv(S, feats, mask, nbr, w, bias, 'plan', plan)
                row['plans'].append(dict(plan=list(plan[1:]), ms=cs.cuda_ms(
                    lambda: S._gather_matmul_conv_cuda(feats, mask, nbr, w,
                                                       bias, plan),
                    reps=REPS['sparse_conv'])))
        conv.append(row)
    for skey, saux, ranges, sbits in rec.scan:
        scan.append(dict(n=skey.shape[0], k=len(ranges), ms=cs.cuda_ms(
            lambda: P.join_scan(skey, saux, ranges, sbits),
            reps=REPS['join_scan'])))
    # profiler sessions only after every event timing (see cs.cuda_ms)
    for row, (feats, mask, nbr, w, *rest) in zip(conv, rec.conv):
        bias = rest[0] if rest else None
        row['launches'], row['device_ms'] = cs.device_profile(
            lambda: S.gather_matmul_conv(feats, mask, nbr, w, bias))
    for row, (skey, saux, ranges, sbits) in zip(scan, rec.scan):
        row['launches'], row['device_ms'] = cs.device_profile(
            lambda: P.join_scan(skey, saux, ranges, sbits))
    return conv, scan


def sums(rows):
    out = dict(calls=len(rows), ms=sum(r['ms'] for r in rows),
               device_ms=sum(r['device_ms'] for r in rows),
               launches=sum(r['launches'] for r in rows))
    if rows and 'host_ms' in rows[0]:
        out['host_ms'] = sum(r['host_ms'] for r in rows)
    return out


def plan_sums(conv):
    """Per request: the shipped rule's plans, the best plan of each call,
    and each fixed (width, offsets per split) everywhere it applies."""
    rows = [r for r in conv if 'plans' in r]
    out = dict(rule=sum(p['ms'] for r in rows for p in r['plans']
                        if p['plan'] == r['plan']),
               best=sum(min(p['ms'] for p in r['plans']) for r in rows))
    for bn in PLAN_WIDTHS:
        for per in PLAN_OFFSETS:
            out[f'{bn}/{per}'] = sum(
                next(p['ms'] for p in r['plans'] if p['plan'][1] == bn and
                     p['plan'][3] == min(per, r['k'])) for r in rows)
    return out


def train(S, P):
    """One recorded warm-up train step, three timed ones (host clock and
    peak memory each) and the forward / backward / optimizer split of one
    more."""
    from embodiedscan_torch.configs.base import build_train, mv_det3d
    from embodiedscan_torch.train.state import train_step
    cfg = mv_det3d()
    torch.manual_seed(0)
    model, opt = build_train(cfg, device='cuda', steps_per_epoch=1)
    d = cfg.data
    batch = cs.to_device(cs.make_batch(1, d.n_points, d.n_views_train,
                                       d.image_hw[0], cs.N_GT,
                                       cfg.model.num_classes), 'cuda')
    with cs.Recorder(S, P) as rec:
        train_step(model, opt, batch)
        torch.cuda.synchronize()
    rec.conv, rec.scan = [], []
    step_ms, peak = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        train_step(model, opt, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        peak.append(torch.cuda.max_memory_allocated() / 2**30)
    opt.zero_grad(set_to_none=True)
    torch.cuda.synchronize()
    t = [time.perf_counter()]
    total = sum(model(batch, mode='loss').values())
    torch.cuda.synchronize()
    t.append(time.perf_counter())
    total.backward()
    torch.cuda.synchronize()
    t.append(time.perf_counter())
    opt.step()
    torch.cuda.synchronize()
    t.append(time.perf_counter())
    split = dict(zip(('forward', 'backward', 'optimizer'),
                     [(b - a) * 1e3 for a, b in zip(t, t[1:])]))
    return rec, dict(step_ms=step_ms, peak_gib=max(peak), split_ms=split)


def host_ms(fn, reps=20):
    """Host time to enqueue one call of ``fn`` (mean over ``reps``
    back-to-back calls with no synchronize between them): the wrapper's
    Python and its launches, which a host-bound step pays in full."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    ms = (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize()
    return ms


def wgrad_plans(S, args):
    """Each pair-chunk count of one tensor-core K3 call, checked and timed
    (ms by CUDA events)."""
    x, xm, idx, y, ym = args
    base = S.cuda_wgrad_plan(x, idx, y)
    rows = []
    for chunks in sorted(set(WG_PLAN_CHUNKS + (base.chunks,))):
        if chunks > 1 and 4 * chunks * idx.shape[1] * x.shape[1] * \
                y.shape[1] > WG_PLAN_MAX_WS:
            continue
        plan = base._replace(chunks=chunks)
        cs._check_wgrad(S, x, xm, idx, y, ym, 'plan', plan)
        rows.append(dict(tile=[plan.bm, plan.bn], chunks=chunks,
                         ms=cs.cuda_ms(lambda: S._wgrad_cuda(
                             x, xm, idx, y, ym, plan),
                             reps=REPS['sparse_conv'])))
    return base, rows


@torch.no_grad()
def time_train_calls(S, rec, plans):
    wgrad, dgrad = [], []
    for a in rec.wgrad:
        x, _, idx, y, _ = a
        row = dict(r=idx.shape[0], k=idx.shape[1], cx=x.shape[1],
                   cy=y.shape[1], route=S.cuda_wgrad_plan(x, idx, y).route,
                   ms=cs.cuda_ms(lambda: S.conv_wgrad(*a),
                                 reps=REPS['sparse_conv']),
                   host_ms=host_ms(lambda: S.conv_wgrad(*a)))
        if plans and row['route'] == 'tc':
            base, row['plans'] = wgrad_plans(S, a)
            row['plan'] = [base.bm, base.bn, base.chunks]
        wgrad.append(row)
    for a in rec.dgrad:
        dout, _, table, wt = a[:4]
        dgrad.append(dict(m=table.shape[0], k=table.shape[1],
                          cin=dout.shape[1], cout=wt.shape[2],
                          ms=cs.cuda_ms(lambda: S.conv_dgrad(*a[:4]),
                                        reps=REPS['sparse_conv']),
                          host_ms=host_ms(lambda: S.conv_dgrad(*a[:4]))))
    # profiler sessions only after every event timing (see cs.cuda_ms)
    for rows, recs, run in ((wgrad, rec.wgrad, S.conv_wgrad),
                            (dgrad, rec.dgrad, S.conv_dgrad)):
        for row, a in zip(rows, recs):
            row['launches'], row['device_ms'] = cs.device_profile(
                lambda: run(*a[:(5 if run is S.conv_wgrad else 4)]))
    return wgrad, dgrad


def wgrad_plan_sums(rows):
    """Per step: the shipped rule's chunks, the best count of each call and
    each fixed count wherever it was timed."""
    rows = [r for r in rows if 'plans' in r]
    out = dict(rule=sum(p['ms'] for r in rows for p in r['plans']
                        if p['chunks'] == r['plan'][2]),
               best=sum(min(p['ms'] for p in r['plans']) for r in rows))
    for c in WG_PLAN_CHUNKS:
        got = [next((p['ms'] for p in r['plans'] if p['chunks'] == c), None)
               for r in rows]
        if None not in got:
            out[str(c)] = sum(got)
    return out


BF16_PLAN_OFFSETS = (27, 9, 5, 3)


def record_bf16(S, P, cont):
    """The recorders of the bf16 groups: 'request' and 'step' (mv_det3d at
    full width), with ``cont`` also 'cont_request' (cont_det3d, 50 sweeps)
    and 'cont_step' (10 sweeps)."""
    from embodiedscan_torch.configs.base import (build_model, build_train,
                                                 cont_det3d, mv_det3d)
    from embodiedscan_torch.data.synthetic import make_scan, scan_to_sweeps
    from embodiedscan_torch.train.state import train_step
    recs = {}
    torch.manual_seed(0)

    def record(name, fn):
        with cs.Recorder(S, P) as rec:
            fn()
            torch.cuda.synchronize()
        rec.to_host()
        recs[name] = rec
        torch.cuda.empty_cache()

    with cs.bf16_route(S):
        cfg = mv_det3d()
        d = cfg.data
        model = build_model(cfg, device='cuda')
        batch = cs.to_device(cs.make_request(d.n_points, d.n_views_test,
                                             d.image_hw[0], 0), 'cuda')
        with torch.no_grad():
            record('request', lambda: model(batch, mode='feats'))
        del model, batch
        model, opt = build_train(cfg, device='cuda', steps_per_epoch=1)
        batch = cs.to_device(cs.make_batch(1, d.n_points, d.n_views_train,
                                           d.image_hw[0], cs.N_GT,
                                           cfg.model.num_classes), 'cuda')
        record('step', lambda: train_step(model, opt, batch))
        del model, opt, batch
        if cont:
            cfg = cont_det3d()
            d = cfg.data
            scan = make_scan(seed=0, n_views=d.n_views_test,
                             hw=tuple(d.image_hw), g=32)
            batch = cs.to_device(scan_to_sweeps(
                scan, n_views=d.n_views_test, num_points=d.n_points,
                num_boxes=d.max_boxes, seed=0, train=False,
                points_per_view=d.points_per_view), 'cuda')
            model = build_model(cfg, device='cuda')
            with torch.no_grad():
                record('cont_request', lambda: model(batch, mode='feats'))
            del model, batch, scan
            model, opt = build_train(cfg, device='cuda', steps_per_epoch=1)
            scan = make_scan(seed=1, n_views=d.n_views_train,
                             hw=tuple(d.image_hw), g=32)
            batch = cs.to_device(scan_to_sweeps(
                scan, n_views=d.n_views_train, num_points=d.n_points,
                num_boxes=d.max_boxes, seed=0, train=True,
                points_per_view=d.points_per_view), 'cuda')
            record('cont_step', lambda: train_step(model, opt, batch))
            del model, opt, batch, scan
    torch.cuda.empty_cache()
    return recs


def _gate(got, ref, what):
    err = float((got - ref).abs().max())
    scale = float(ref.abs().max())
    if not err <= cs.CONV_GATE * max(scale, 1e-30):
        raise RuntimeError(f'{what}: max|d| {err} > {cs.CONV_GATE} x {scale}')


@torch.no_grad()
def time_bf16(S, recs, plans):
    """Per-call rows of every K2-bf16 (forward and input gradient) and
    K3-bf16 call of the recorded groups (see the module docstring)."""
    rows = []
    for group, rec in recs.items():
        for kind, calls in (('conv', rec.conv16), ('dgrad', rec.dgrad16),
                            ('wgrad', rec.wgrad16)):
            for args in calls:
                torch.cuda.empty_cache()
                a = cs._on(args, 'cuda')
                rows.append(dict(group=group, kind=kind,
                                 **_time_bf16_call(S, kind, a, plans)))
    # the kernels' own device time and launches of each call as shipped,
    # by the profiler, after every event timing (see cs.cuda_ms)
    for row in rows:
        row['launches'], row['device_ms'], row['by_kernel'] = \
            _profile_by_kernel(row.pop('run'))
    return rows


def _profile_by_kernel(fn):
    """(launches, device ms, {kernel name: device ms}) of one call of
    ``fn`` under the profiler (after a call outside it)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages()
          if str(e.device_type).endswith('CUDA')]
    by = {}
    for e in ev:
        key = e.key.replace('(anonymous namespace)::', '')
        name = key.split('<')[0].split('(')[0].split('::')[-1].split()[-1]
        by[name] = by.get(name, 0.0) + cs._self_device_us(e) / 1e3
    return sum(e.count for e in ev), sum(by.values()), by


def _time_bf16_call(S, kind, a, plans):
    if kind == 'wgrad':
        x, xm, idx, y, ym = a
        x16, y16 = S._as_bf16(x), S._as_bf16(y)
        rule = S.bf16_wgrad_plan(x, idx, y)
        row = dict(r=idx.shape[0], k=idx.shape[1], cx=x.shape[1],
                   cy=y.shape[1], plan=list(rule))
        run = (lambda plan: S._wgrad_cuda(x16, xm, idx, y16, ym, plan))
        ref = S._conv_wgrad_bf16_plain(x, xm, idx, y, ym)
        space = [S.WgradPlan('tc', bm, bn, c) for bm in (64, 128)
                 for bn in (64, 128) for c in WG_PLAN_CHUNKS] \
            if rule.route == 'tc' else []
    else:
        feats, mask, nbr, w = a[:4]
        if kind == 'conv':
            bias, mode, (k, cin, cout) = a[4], S.KB_FORWARD, w.shape
            ref = S._gather_matmul_conv_bf16_plain(feats, mask, nbr, w, bias)
        else:
            bias = None
            mode = S.KB_MIRROR if a[4] else S.KB_TRANSPOSE
            k, cout, cin = w.shape
            ref = S._conv_dgrad_bf16_plain(feats, mask, nbr, w, a[4])
        m = nbr.shape[0]
        rule = S.conv_plan(m, k, cin, cout, bf16=True)
        f16, w16 = S._as_bf16(feats), S.bf16_weights(w)
        row = dict(m=m, k=k, cin=cin, cout=cout, plan=list(rule))

        def run(plan):
            if plan.route == 'simt':
                return S._launch_k2(f16, mask, nbr, w16 if mode == 0 else
                                    S._dgrad_weights_t(w16, a[4]), bias,
                                    plan, '_bf16')
            return S._launch_k2_bf16(f16, mask, nbr, w16, bias, plan, mode)
        space = [S.ConvPlan('tc', bm, bn, -(-k // min(per, k)), min(per, k))
                 for bm, bn in S.BF16_TILES for per in BF16_PLAN_OFFSETS] \
            if rule.route == 'tc' else []
        space = list(dict.fromkeys(space))
    _gate(run(rule), ref, f'{kind} {row}')
    row['ms'] = cs.cuda_ms(lambda: run(rule), reps=3, warmup=1)
    row['run'] = lambda: run(rule)  # profiled after every event timing
    if plans:
        row['plans'] = []
        for plan in space:
            _gate(run(plan), ref, f'{kind} {row} plan {plan}')
            row['plans'].append(dict(plan=list(plan), ms=cs.cuda_ms(
                lambda: run(plan), reps=3, warmup=1)))
    return row


def bf16_sums(rows):
    """Per group and kind: calls, the shipped rule's events ms, device ms
    and device ms by kernel, and with plans the best plan of each call
    summed (events ms)."""
    out = {}
    for r in rows:
        s = out.setdefault(f'{r["group"]}/{r["kind"]}',
                           dict(calls=0, ms=0.0, device_ms=0.0, best=0.0))
        s['calls'] += 1
        s['ms'] += r['ms']
        s['device_ms'] += r['device_ms']
        for name, ms in r['by_kernel'].items():
            kernels = s.setdefault('by_kernel', {})
            kernels[name] = kernels.get(name, 0.0) + ms
        s['best'] += min([p['ms'] for p in r.get('plans', [])] + [r['ms']])
    return out


# the single-TF32 cut: (file under csrc, 3xTF32 text, single-TF32 text) for
# K2's and the mma.sync products (sparse_mma.cuh) and K3's wgmma ones
SINGLE_TF32 = (
    ('sparse_mma.cuh', '  mma_tf32(d, alo, bhi);\n  mma_tf32(d, ahi, blo);\n'
     '  mma_tf32(d, ahi, bhi);\n', '  mma_tf32(d, ahi, bhi);\n'),
    ('sparse_conv_wgrad.cu', 'constexpr int WG_TF32_TERMS = 3;',
     'constexpr int WG_TF32_TERMS = 1;'))


NMS_SEEDS = tuple(3_000_000_019 + 7_919 * i for i in range(12))


def nms_candidates(seeds, dev):
    """[(boxes (K, 9), thr, labels)] as ``nms3d`` hands them to
    ``suppression_matrix`` in mv_det3d.serve.v50's requests
    (:class:`chip_smoke.NmsInputs`): each seed's model and pool (the cell's
    weights and scenes), every scene of the pool served once."""
    from benchmark.harness import cells
    from benchmark.harness import program as BP
    from benchmark.harness import spec
    cell = spec.cell('mv_det3d.serve.v50', spec.benchmark())
    with cs.NmsInputs() as nms:
        for seed in seeds:
            model, pool, _ = cells.serve_setup(cell, seed, dev)
            with torch.no_grad():
                for _, batch in pool:
                    BP.request(model, batch, dev)
            del model, pool
            torch.cuda.empty_cache()
    return nms.calls


def near_threshold_set(thr=0.5, pairs=512, seed=0):
    """(2 pairs, 9) yaw boxes and labels: pair m is boxes 2m, 2m + 1, of
    label m, the second the first moved along its own x axis by the
    distance that gives IoU ``thr``, times 1 +- 2e-5."""
    rng = np.random.RandomState(seed)
    a = np.zeros((pairs, 9))
    a[:, :3] = rng.uniform(0, 8, (pairs, 3))
    a[:, 3:6] = rng.uniform(0.2, 2.0, (pairs, 3))
    a[:, 6] = rng.uniform(-np.pi, np.pi, pairs)
    shift = a[:, 3] * (1 - thr) / (1 + thr) * (
        1 + rng.uniform(-2e-5, 2e-5, pairs))
    b = a.copy()
    b[:, 0] += shift * np.cos(a[:, 6])
    b[:, 1] += shift * np.sin(a[:, 6])
    boxes = np.stack([a, b], 1).reshape(2 * pairs, 9).astype(np.float32)
    return boxes, np.repeat(np.arange(pairs), 2)


def _iou_bits_diff(I, b9, labels, pairs):
    """Pairs (i, j) whose K4 IoU differs from the torch route's in any bit:
    K4 over (i, j) must be false at the torch IoU v and true at the float
    below v."""
    iou = I.boxes3d_iou(b9, b9).cpu().numpy()
    fields, lab = I.nms_fields(b9, labels)
    bad = 0
    for i, j in pairs:
        v = np.float32(iou[i, j])
        below = np.nextafter(v, np.float32(-np.inf))
        at_v = bool(I._nms_overlap_cuda(fields, lab, float(v))[i, j])
        at_below = bool(I._nms_overlap_cuda(fields, lab, float(below))[i, j])
        bad += int(at_v or not at_below)
    return bad


def nms_check(dev):
    """The ``--nms`` mode: K4 against the torch route on the card ``dev``."""
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), 'tests'))
    from test_torch_nms_overlap import SETS, _set
    from embodiedscan_torch.geometry import iou as I
    counts = I.suppression_matrix.pair_counts
    t0 = time.perf_counter()
    cands = nms_candidates(NMS_SEEDS, dev)
    torch.cuda.synchronize()
    served_s = time.perf_counter() - t0
    before = counts[dev.index].tolist()
    req, bits_pairs, per_req = [], [], []
    for n, (b9, thr, labels) in enumerate(cands):
        got = I.suppression_matrix(b9, thr, labels)
        want = I._suppression_matrix_plain(b9, thr, labels)
        req.append(int((got != want).sum()))
        per_req.append(int(want.sum()))
        if n < 4:  # clipped pairs of the first requests for the bit check
            iou = I.boxes3d_iou(b9, b9)
            same = labels[:, None] == labels[None, :]
            ii, jj = torch.nonzero(torch.triu((iou > 0) & same, 1),
                                   as_tuple=True)
            bits_pairs.append((b9, labels, list(zip(ii.tolist()[:64],
                                                    jj.tolist()[:64]))))
    after = counts[dev.index].tolist()
    clipped, given = after[0] - before[0], after[1] - before[1]
    adv = {}
    for idx in range(len(SETS)):
        boxes, labels = _set(idx)
        b9 = torch.from_numpy(boxes).to(dev)
        lab = None if labels is None else torch.from_numpy(labels).to(dev)
        for thr in (0.25, 0.5):
            got = I.suppression_matrix(b9, thr, lab)
            want = I._suppression_matrix_plain(b9, thr, lab)
            adv[f'set{idx}@{thr}'] = int((got != want).sum())
    boxes, labels = near_threshold_set()
    b9 = torch.from_numpy(boxes).to(dev)
    lab = torch.from_numpy(labels).to(dev)
    iou = I.boxes3d_iou(b9, b9).cpu().numpy()
    pair_iou = iou[np.arange(0, len(boxes), 2), np.arange(1, len(boxes), 2)]
    near = dict(pairs=len(pair_iou),
                within_1e5=int((np.abs(pair_iou - 0.5) < 1e-5).sum()),
                mismatches=int((I.suppression_matrix(b9, 0.5, lab) !=
                                I._suppression_matrix_plain(b9, 0.5, lab))
                               .sum().item()))
    near['iou_bits_diff'] = _iou_bits_diff(
        I, b9, lab, [(2 * m, 2 * m + 1) for m in range(len(pair_iou))])
    req_bits = sum(_iou_bits_diff(I, b, lb, pr) for b, lb, pr in bits_pairs)
    # timing on the first request's candidates (the main path's shape)
    b9, thr, labels = cands[0]
    fields, lab = I.nms_fields(b9, labels)
    timing = dict(
        k=int(b9.shape[0]),
        k4_ms=cs.cuda_ms(lambda: I.suppression_matrix(b9, thr, labels),
                         reps=50),
        k4_kernel_ms=cs.cuda_ms(lambda: I._nms_overlap_cuda(fields, lab, thr),
                                reps=50),
        k4_host_ms=host_ms(lambda: I.suppression_matrix(b9, thr, labels)),
        torch_ms=cs.cuda_ms(
            lambda: I._suppression_matrix_plain(b9, thr, labels), reps=3,
            warmup=1))
    launches, dev_ms = cs.device_profile(
        lambda: I.suppression_matrix(b9, thr, labels))
    _, _, by_kernel = _profile_by_kernel(
        lambda: I._nms_overlap_cuda(fields, lab, thr))
    t_launches, t_dev_ms = cs.device_profile(
        lambda: I._suppression_matrix_plain(b9, thr, labels))
    timing.update(k4_launches=launches, k4_device_ms=dev_ms,
                  k4_kernel_device_ms=by_kernel.get('nms_overlap'),
                  torch_launches=t_launches, torch_device_ms=t_dev_ms)
    return dict(
        requests=len(cands), seeds=len(NMS_SEEDS), served_s=served_s,
        request_mismatches=sum(req), worst_request=max(req),
        over_pairs_per_request=[min(per_req), max(per_req)],
        request_iou_bits_diff=req_bits,
        request_bits_pairs=sum(len(p) for _, _, p in bits_pairs),
        clipped=clipped, given=given, clipped_share=clipped / max(given, 1),
        adversarial_mismatches=adv, near_threshold=near, timing=timing,
        launches=I.suppression_matrix.launches)


def tf32_control(root):
    """chip_smoke's train parity from ROOT, from a copy with every 3xTF32
    product cut to single TF32 and from one with K3's products alone cut."""
    trees = [('as is', root, ())]
    with tempfile.TemporaryDirectory() as tmp:
        for tree, cut in (('single TF32', SINGLE_TF32),
                          ('single TF32 in K3 only', SINGLE_TF32[1:])):
            path = os.path.join(tmp, str(len(trees)))
            shutil.copytree(os.path.join(root, 'embodiedscan_torch'),
                            os.path.join(path, 'embodiedscan_torch'),
                            ignore=shutil.ignore_patterns('_build',
                                                          '__pycache__'))
            for name, three, one in cut:
                src = os.path.join(path, 'embodiedscan_torch', 'csrc', name)
                with open(src) as f:
                    text = f.read()
                if text.count(three) != 1:
                    raise RuntimeError(f'the 3xTF32 products not found in '
                                       f'{name}')
                with open(src, 'w') as f:
                    f.write(text.replace(three, one))
            trees.append((tree, path, cut))
        for tree, path, _ in trees:
            out = subprocess.run(
                [sys.executable, os.path.abspath(__file__), '--train-parity',
                 path], check=True, capture_output=True, text=True).stdout
            print(json.dumps(dict(json.loads(out.splitlines()[-1]),
                                  tree=tree)), flush=True)
    return 0


def main(argv):
    plans = '--plans' in argv
    cont = '--cont' in argv
    mode = next((a for a in argv if a in ('--tf32-control', '--train',
                                          '--train-parity', '--bf16',
                                          '--nms')), None)
    args = [a for a in argv if a not in ('--plans', '--cont', mode)]
    root = os.path.abspath(args[0] if args else os.path.dirname(
        os.path.abspath(__file__)))
    if not torch.cuda.is_available():
        print('kernel_ab: no CUDA device', file=sys.stderr)
        return 2
    if mode == '--tf32-control':
        return tf32_control(root)
    sys.path.insert(0, root)
    from embodiedscan_torch.ops import pscan as P
    from embodiedscan_torch.ops import sparse as S
    if not S.__file__.startswith(root):
        raise RuntimeError(f'embodiedscan_torch came from {S.__file__}')
    card = cs.phase_build()
    if mode == '--train-parity':
        _, _, _, worst = cs.train_parity('cuda')
        print(json.dumps(dict(card=card, worst={
            k: dict(ratio=r, leaf=p) for k, (r, p) in worst.items()})))
        return 0
    if mode == '--nms':
        result = dict(card=card, mode='nms', **nms_check(
            torch.device('cuda', torch.cuda.current_device())))
        os.makedirs(cs.OUT_DIR, exist_ok=True)
        with open(os.path.join(cs.OUT_DIR, 'kernel_ab.jsonl'), 'a') as f:
            f.write(json.dumps(result) + '\n')
        print(json.dumps(result))
        return 0
    if mode == '--bf16':
        rows = time_bf16(S, record_bf16(S, P, cont), plans)
        result = dict(root=root, card=card, mode='bf16', sums=bf16_sums(rows))
        os.makedirs(cs.OUT_DIR, exist_ok=True)
        with open(os.path.join(cs.OUT_DIR, 'kernel_ab.jsonl'), 'a') as f:
            f.write(json.dumps(dict(result, rows=rows)) + '\n')
        print(json.dumps(result))
        return 0
    if mode == '--train':
        rec, stats = train(S, P)
        wgrad, dgrad = time_train_calls(S, rec, plans)
        result = dict(root=root, card=card, mode='train', **stats,
                      sparse_wgrad=sums(wgrad), sparse_dgrad=sums(dgrad))
        if plans:
            result['wgrad_plans'] = wgrad_plan_sums(wgrad)
        os.makedirs(cs.OUT_DIR, exist_ok=True)
        with open(os.path.join(cs.OUT_DIR, 'kernel_ab.jsonl'), 'a') as f:
            f.write(json.dumps(dict(result, wgrad=wgrad, dgrad=dgrad)) + '\n')
        print(json.dumps(result))
        return 0
    rec, lat = serve(S, P)
    conv, scan = time_calls(S, P, rec, plans)
    result = dict(root=root, card=card, latency_ms=lat,
                  sparse_conv=sums(conv), join_scan=sums(scan))
    if plans:
        result['plans'] = plan_sums(conv)
    os.makedirs(cs.OUT_DIR, exist_ok=True)
    with open(os.path.join(cs.OUT_DIR, 'kernel_ab.jsonl'), 'a') as f:
        f.write(json.dumps(dict(result, conv=conv, scan=scan)) + '\n')
    print(json.dumps(result))
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
