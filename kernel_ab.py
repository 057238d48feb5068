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

    python3 kernel_ab.py --tf32-control [ROOT]

is the control for chip_smoke's GRAD_GATE: chip_smoke's CPU-against-card
train step (``chip_smoke.train_parity``) from ROOT as it is, then from a
temporary copy of its ``embodiedscan_torch`` whose 3xTF32 product
(``csrc/sparse_mma.cuh:mma_3xtf32``) keeps only the single-TF32 term, each
in a process of its own. Prints one JSON line per tree with the worst
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
    return dict(calls=len(rows), ms=sum(r['ms'] for r in rows),
                device_ms=sum(r['device_ms'] for r in rows),
                launches=sum(r['launches'] for r in rows))


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


SINGLE_TF32 = ('  mma_tf32(d, alo, bhi);\n  mma_tf32(d, ahi, blo);\n'
               '  mma_tf32(d, ahi, bhi);\n', '  mma_tf32(d, ahi, bhi);\n')


def tf32_control(root):
    """chip_smoke's train parity from ROOT and from a single-TF32 copy."""
    with tempfile.TemporaryDirectory() as tmp:
        shutil.copytree(os.path.join(root, 'embodiedscan_torch'),
                        os.path.join(tmp, 'embodiedscan_torch'),
                        ignore=shutil.ignore_patterns('_build',
                                                      '__pycache__'))
        header = os.path.join(tmp, 'embodiedscan_torch', 'csrc',
                              'sparse_mma.cuh')
        with open(header) as f:
            text = f.read()
        if text.count(SINGLE_TF32[0]) != 1:
            raise RuntimeError('mma_3xtf32 body not found in sparse_mma.cuh')
        with open(header, 'w') as f:
            f.write(text.replace(*SINGLE_TF32))
        for tree, path in (('as is', root), ('single TF32', tmp)):
            out = subprocess.run(
                [sys.executable, os.path.abspath(__file__), '--train-parity',
                 path], check=True, capture_output=True, text=True).stdout
            print(json.dumps(dict(json.loads(out.splitlines()[-1]),
                                  tree=tree)), flush=True)
    return 0


def main(argv):
    plans = '--plans' in argv
    mode = next((a for a in argv if a in ('--tf32-control',
                                          '--train-parity')), None)
    args = [a for a in argv if a not in ('--plans', mode)]
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
