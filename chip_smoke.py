"""GPU smoke run of the PyTorch/CUDA port (embodiedscan_torch).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (one line each; any failure exits non-zero before the last line):
  1. device and build: the card's name and power limit, then the build of
     the hand-written kernels from embodiedscan_torch/csrc;
  2. main path: the full-width mv_det3d detector (284 classes,
     MinkResNet-34 + ResNet-50/16, shipped capacities) serves one warm-up
     and three synthetic requests of 100k points and 50 views of 480x480;
     launch counts are reset before each request and read after it; then
     the host-clock time of each stage of one request;
  3. kernel parity and times: every kernel call of the warm-up request is
     replayed on its recorded inputs against the kernel's plain PyTorch
     version (join scan bit-exact, sparse conv within 1e-4 x max|ref| and
     bit-identical when run twice), with the kernel, plain and library
     times, the least time the card could take and, for the sparse conv,
     the plan (route, tile, split) and the share of the dense work that
     hits and that the kernel computes; after every timing, the profiler
     counts each call's CUDA launches and device time and traces one
     request (device busy time and idle share);
  4. edge shapes: the sparse conv at Cin = 3, K = 1, ragged M, Cout 64 /
     128 / 512, all-absent and all-masked tables, a misaligned view, split
     against unsplit; the join scan at the reference's unit-test cases,
     one tile, one tile plus one row and ~2M rows;
  5. end-to-end parity: a small detector on cuda (kernels) and on cpu
     (plain versions) with the same weights;
  6. one JSON line with the kernels, then the result line.
Per-call details go to chiprun_out/chip_smoke_calls.json.

``python3 chip_smoke.py --kernels-only`` runs phases 1 and 4 and stops
(no result line): the quickest check that the kernels build and agree.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet; 700 W): HBM bytes/s, non-tensor FP32,
# dense TF32 tensor cores (3xTF32 takes three TF32 products per product)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
TF32_FLOPS = 495e12
# wrapper calls per request: K2 by route (the stem's Cin = 3 takes SIMT)
EXPECTED_LAUNCHES = {'sparse_conv_tc': 43, 'sparse_conv_simt': 1,
                     'join_scan': 12}
CONV_GATE = 1e-4  # K2: max|kernel - plain| <= CONV_GATE x max|plain|
OUT_DIR = 'chiprun_out'


def log(msg):
    print(msg, flush=True)


def make_request(p=100000, v=50, hw=480, seed=0):
    """One b=1 scene: a surface-like room cloud (floor and two walls of an
    8 m room, 1 cm noise) seen by a ring of 50 cameras. Numpy, from a seed."""
    rng = np.random.RandomState(seed)
    u = rng.uniform(0, 8, (p, 2)).astype(np.float32)
    which = rng.randint(0, 3, p)
    pts = np.zeros((p, 3), np.float32)
    for w, cols in ((0, lambda a: (a[:, 0], a[:, 1], 0 * a[:, 0])),
                    (1, lambda a: (a[:, 0], 0 * a[:, 0], a[:, 1] * 3 / 8)),
                    (2, lambda a: (0 * a[:, 0], a[:, 0], a[:, 1] * 3 / 8))):
        sel = which == w
        pts[sel] = np.stack(cols(u[sel]), -1)
    pts = pts[None] + rng.randn(1, p, 3).astype(np.float32) * 0.01
    k = np.array([[500.0, 0, hw / 2, 0], [0, 500.0, hw / 2, 0], [0, 0, 1, 0],
                  [0, 0, 0, 1]], np.float32)
    exts = []
    for i in range(v):
        ext = np.eye(4, dtype=np.float32)
        ext[:3, 3] = [-4.0 + 0.1 * i, -4.0, 8.0]
        exts.append(k @ ext)
    return dict(
        points=pts,
        points_mask=np.ones((1, p), bool),
        imgs=rng.randn(1, v, hw, hw, 3).astype(np.float32),
        proj=np.stack(exts)[None].astype(np.float32),
        aug_inv=np.eye(4, dtype=np.float32)[None],
    )


def to_device(batch, device):
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def cuda_ms(fn, reps=5):
    """Mean device time of ``fn`` over ``reps`` back-to-back calls, after
    three warm-up calls. Take it before any torch.profiler session: one
    leaves the host slower per op for the rest of the process."""
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


class Recorder:
    """Records the inputs of every kernel call (and of the plain versions
    that CPU tensors take) while active; the launch counts are untouched."""

    NAMES = {'conv': ('_gather_matmul_conv_cuda', '_gather_matmul_conv_plain'),
             'scan': ('_join_scan_cuda', '_join_scan_plain')}

    def __init__(self, S, P):
        self.mods = {'conv': S, 'scan': P}
        self.conv, self.scan = [], []
        self.orig = {}

    def __enter__(self):
        for kind, names in self.NAMES.items():
            mod, log_ = self.mods[kind], getattr(self, kind)
            for name in names:
                fn = getattr(mod, name)
                self.orig[(kind, name)] = fn

                def wrapped(*args, _fn=fn, _log=log_):
                    _log.append(args)
                    return _fn(*args)

                setattr(mod, name, wrapped)
        return self

    def __exit__(self, *exc):
        for (kind, name), fn in self.orig.items():
            setattr(self.mods[kind], name, fn)


def phase_build():
    from embodiedscan_torch.ops import kernels
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    t0 = time.perf_counter()
    kernels.library()
    regs = [ln.strip() for ln in kernels.build_log.splitlines()
            if 'registers' in ln or 'spill' in ln]
    log(f'[build] kernels built in {time.perf_counter() - t0:.1f} s '
        f'(nvcc {kernels.build_seconds:.1f} s): ' + ' | '.join(regs))
    return card


def phase_main_path(device):
    from embodiedscan_torch.configs.base import build_model, mv_det3d
    from embodiedscan_torch.ops import pscan as P
    from embodiedscan_torch.ops import sparse as S
    from embodiedscan_torch.utils.convert_weights import load_jax_variables
    cfg = mv_det3d()
    t0 = time.perf_counter()
    model = build_model(cfg, device=device)
    # a checkpoint's class bias: candidates clear score_thr, NMS has work
    load_jax_variables(model, {'bbox_head': {'conv_cls': {'bias': np.zeros(
        cfg.model.num_classes, np.float32)}}}, strict=False)
    log(f'[main] built mv_det3d on {device} in '
        f'{time.perf_counter() - t0:.1f} s: '
        f'{sum(p.numel() for p in model.parameters())} parameters')
    d = cfg.data
    requests = [make_request(d.n_points, d.n_views_test, d.image_hw[0], s)
                for s in range(4)]
    with Recorder(S, P) as rec:  # warm-up request: record kernel inputs
        t0 = time.perf_counter()
        preds = model(to_device(requests[0], device), mode='predict')
        torch.cuda.synchronize()
    log(f'[main] warm-up request {time.perf_counter() - t0:.2f} s, '
        f'{len(rec.conv)} conv and {len(rec.scan)} join-scan calls recorded')
    lat, mem, kept = [], [], []
    totals = dict.fromkeys(EXPECTED_LAUNCHES, 0)
    for i, req in enumerate(requests[1:]):
        batch = to_device(req, device)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(S, P)
        t0 = time.perf_counter()
        preds = model(batch, mode='predict')
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
        counts = read_counts(S, P)
        mem.append(torch.cuda.max_memory_allocated() / 2**30)
        for key, val in preds.items():
            if val.is_floating_point() and not torch.isfinite(val).all():
                raise RuntimeError(f'request {i}: non-finite {key}')
        if preds['bboxes'].shape != (1, cfg.model.max_dets, 9):
            raise RuntimeError(f'bboxes shape {tuple(preds["bboxes"].shape)}')
        kept.append(int(preds['mask'].sum()))
        for name, want in EXPECTED_LAUNCHES.items():
            if counts[name] != want:
                raise RuntimeError(f'request {i}: {name} launched '
                                   f'{counts[name]} times, expected {want}')
            totals[name] += counts[name]
        log(f'[main] request {i}: {lat[-1] * 1e3:.1f} ms, peak '
            f'{mem[-1]:.2f} GiB, kept {kept[-1]} of '
            f'{preds["mask"].shape[1]} detections, launches {counts}')
    if not all(kept):
        raise RuntimeError('a request kept no detection')
    log(f'[main] latency ms per request: '
        f'{[round(t * 1e3, 3) for t in lat]}, peak GiB {max(mem):.3f}')
    stats = dict(latency_ms=[t * 1e3 for t in lat], peak_gib=max(mem),
                 kept=kept)
    batch = to_device(requests[1], device)
    stats.update(stage_times(model, batch))
    return rec, totals, stats, model, batch


def reset_counts(S, P):
    S.gather_matmul_conv.launches = {'tc': 0, 'simt': 0}
    P.join_scan.launches = 0


def read_counts(S, P):
    routes = S.gather_matmul_conv.launches
    return {'sparse_conv_tc': routes['tc'],
            'sparse_conv_simt': routes['simt'],
            'join_scan': P.join_scan.launches}


def _self_device_us(event):
    # the attribute's name changed across PyTorch releases
    for name in ('self_device_time_total', 'self_cuda_time_total'):
        if hasattr(event, name):
            return getattr(event, name)
    raise AttributeError('profiler event without a device time')


def _host_ms(fn, reps=3):
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3, out


@torch.no_grad()
def stage_times(model, batch):
    """Where one request's time goes on the host clock, stage by stage
    (each ends in a synchronize)."""
    from embodiedscan_torch.ops import sparse as S
    trunk, head = model.trunk, model.bbox_head
    pts, pm = batch['points'], batch['points_mask']
    imgs = batch['imgs']
    bi, v, h, w, _ = imgs.shape
    st_ms, st = _host_ms(lambda: S.from_points_b(
        pts, pts, pm, trunk.voxel_size, trunk.input_capacity))
    mink_ms, _ = _host_ms(lambda: trunk.MinkResNet_0(st))
    r2d_ms, _ = _host_ms(lambda: trunk.ResNet_0(
        imgs.reshape(bi * v, h, w, 3)))
    trunk_ms, feats = _host_ms(lambda: trunk(batch))
    head_ms, outs = _host_ms(lambda: head(feats))
    pred_ms, _ = _host_ms(lambda: head.predict(outs))
    # the NMS pairwise IoU alone, on as many boxes as the NMS takes
    from embodiedscan_torch.geometry.iou import boxes3d_iou
    g = torch.Generator(device=pts.device).manual_seed(0)
    k = head.max_candidates
    boxes = torch.cat([torch.rand(k, 3, generator=g, device=pts.device) * 8,
                       torch.rand(k, 3, generator=g, device=pts.device) + .2,
                       torch.rand(k, 1, generator=g, device=pts.device) * 6,
                       torch.zeros(k, 2, device=pts.device)], 1)
    iou_ms, _ = _host_ms(lambda: boxes3d_iou(boxes, boxes))
    stages = dict(voxelize=st_ms, mink_resnet34=mink_ms, resnet50=r2d_ms,
                  fusion=trunk_ms - st_ms - mink_ms - r2d_ms,
                  fcaf3d_head=head_ms, predict_nms=pred_ms,
                  of_which_nms_iou=iou_ms)
    log('[breakdown] host ms per stage: ' + ', '.join(
        f'{k} {v:.2f}' for k, v in stages.items()))
    return dict(stages_ms=stages)


@torch.no_grad()
def profile_request(model, batch):
    """One request under torch.profiler: device busy time and idle share,
    device time by op."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model(batch, mode='predict')
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    # device-side entries only (kernels, copies): the host-side aten
    # entries report the same device time again
    ops = [(e.key, _self_device_us(e) / 1e3, e.count)
           for e in prof.key_averages()
           if str(e.device_type).endswith('CUDA') and _self_device_us(e) > 0]
    ops.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in ops)
    log(f'[breakdown] profiled request {wall:.1f} ms wall, device busy '
        f'{busy:.1f} ms (idle share {1 - busy / wall:.3f}); top ops: ' +
        '; '.join(f'{k[:90]} {t:.2f} ms x{c}' for k, t, c in ops[:8]))
    return dict(profiled_wall_ms=wall, device_busy_ms=busy,
                device_ops=[dict(op=k, ms=t, count=c) for k, t, c in ops])


def _conv_bound(feats, mask, nbr, w, bias):
    """(bytes, flops, hits) this call needs: inputs read once, output
    written once; FLOPs over the (row, offset) pairs that hit a valid row."""
    n, cin = feats.shape
    m, k = nbr.shape
    cout = w.shape[-1]
    safe = torch.where(nbr >= 0, nbr, torch.zeros_like(nbr)).long()
    hits = int(((nbr >= 0) & mask[safe]).sum())
    nbytes = (feats.numel() * 4 + mask.numel() + nbr.numel() * 4 +
              w.numel() * 4 + (0 if bias is None else cout * 4) + m * cout * 4)
    return nbytes, 2.0 * cin * cout * hits, hits


def _work_share(mask, nbr, bm):
    """The (row, offset) pairs a kernel with bm-row tiles computes (every
    row of a tile at each offset some row of the tile has), over M x K."""
    m, k = nbr.shape
    safe = torch.where(nbr >= 0, nbr, torch.zeros_like(nbr)).long()
    hit = (nbr >= 0) & mask[safe]
    tiles = -(-m // bm)
    hit = torch.cat([hit, hit.new_zeros(tiles * bm - m, k)])
    active = hit.reshape(tiles, bm, k).any(1)            # (tiles, K)
    rows = torch.full((tiles,), bm, device=nbr.device)
    rows[-1] = m - (tiles - 1) * bm
    return float((active.sum(1) * rows).sum()) / (m * k)


def device_profile(fn):
    """(launches, device ms) of one call of ``fn``: the CUDA kernels,
    memsets and copies it puts on the card, counted and timed by the
    profiler (the device's own time, without the host's launch gaps)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages()
          if str(e.device_type).endswith('CUDA')]
    return sum(e.count for e in ev), sum(_self_device_us(e) for e in ev) / 1e3


def _check_conv(S, feats, mask, nbr, w, bias, what, plan=None):
    """Kernel vs plain within the gate, and the same bits twice; returns
    (out, max|d|, max|ref|)."""
    ref = S._gather_matmul_conv_plain(feats, mask, nbr, w, bias)
    got = S._gather_matmul_conv_cuda(feats, mask, nbr, w, bias, plan)
    again = S._gather_matmul_conv_cuda(feats, mask, nbr, w, bias, plan)
    err = float((got - ref).abs().max()) if ref.numel() else 0.0
    scale = float(ref.abs().max()) if ref.numel() else 0.0
    if not err <= CONV_GATE * max(scale, 1e-30):
        raise RuntimeError(f'sparse_conv {what} {tuple(nbr.shape)} x '
                           f'{tuple(w.shape)}: max|d| {err} > {CONV_GATE} x '
                           f'{scale}')
    if not torch.equal(got, again):
        raise RuntimeError(f'sparse_conv {what} {tuple(nbr.shape)} x '
                           f'{tuple(w.shape)}: two runs differ')
    return got, err, scale


@torch.no_grad()
def phase_kernels(rec, device):
    from embodiedscan_torch.ops import pscan as P
    from embodiedscan_torch.ops import sparse as S
    calls = {'sparse_conv': [], 'join_scan': []}
    # sparse conv: every call of the warm-up request on its own inputs
    for feats, mask, nbr, w, *rest in rec.conv:
        bias = rest[0] if rest else None
        plan = S.cuda_plan(feats, nbr, w)
        _, err, scale = _check_conv(S, feats, mask, nbr, w, bias, 'main')
        padded = torch.cat([torch.where(mask[:, None], feats,
                                        torch.zeros_like(feats)),
                            feats.new_zeros(1, feats.shape[1])])
        idx = torch.where(nbr >= 0, nbr, torch.full_like(nbr, feats.shape[0]))
        kcin = w.shape[0] * w.shape[1]
        w2 = w.reshape(kcin, w.shape[2])
        nbytes, flops, hits = _conv_bound(feats, mask, nbr, w, bias)
        t_bytes = nbytes / HBM_BYTES_PER_S
        t_ops = 3 * flops / TF32_FLOPS
        m, k = nbr.shape
        calls['sparse_conv'].append(dict(
            m=m, k=k, cin=w.shape[1], cout=w.shape[2], n=feats.shape[0],
            route=plan.route, tile=[plan.bm, plan.bn], splits=plan.splits,
            per_split=plan.per_split,
            hit_share=hits / (m * k), work_share=_work_share(mask, nbr,
                                                             plan.bm),
            max_abs_err=err, max_abs_ref=scale, deterministic=True,
            ms=cuda_ms(lambda: S.gather_matmul_conv(feats, mask, nbr, w,
                                                    bias)),
            plain_ms=cuda_ms(lambda: S._gather_matmul_conv_plain(
                feats, mask, nbr, w, bias)),
            library_ms=cuda_ms(lambda: padded[idx].reshape(-1, kcin) @ w2),
            bytes=nbytes, flops=flops, bound_ms=max(t_bytes, t_ops) * 1e3,
            bound_by='bytes' if t_bytes >= t_ops else 'operations',
            bound_fp32_ms=max(t_bytes, flops / FP32_FLOPS) * 1e3))
    # join scan: every call of the warm-up request
    for skey, saux, ranges, sbits in rec.scan:
        calls['join_scan'].append(_scan_call(P, skey, saux, ranges, sbits,
                                             time_it=True))
    # launches and device time per call, after every timing (see cuda_ms)
    for r, (feats, mask, nbr, w, *rest) in zip(calls['sparse_conv'],
                                               rec.conv):
        bias = rest[0] if rest else None
        r['cuda_launches'], r['device_ms'] = device_profile(
            lambda: S.gather_matmul_conv(feats, mask, nbr, w, bias))
    for r, (skey, saux, ranges, sbits) in zip(calls['join_scan'], rec.scan):
        r['cuda_launches'], r['device_ms'] = device_profile(
            lambda: P.join_scan(skey, saux, ranges, sbits))
    for name, rows in calls.items():
        log(f'[kernels] {name}: {len(rows)} main-path calls checked, '
            f'kernel {sum(r["ms"] for r in rows):.3f} ms, plain '
            f'{sum(r["plain_ms"] for r in rows):.3f} ms, library '
            f'{sum(r["library_ms"] for r in rows):.3f} ms, bound '
            f'{sum(r["bound_ms"] for r in rows):.3f} ms per request; '
            f'max|d| {max(r["max_abs_err"] for r in rows)}; CUDA launches '
            f'{sum(r["cuda_launches"] for r in rows)}, device-only '
            f'{sum(r["device_ms"] for r in rows):.3f} ms')
    for r in calls['sparse_conv']:
        log(f'[kernels] conv {r["m"]}x{r["k"]} {r["cin"]}->{r["cout"]} '
            f'{r["route"]} {r["tile"][0]}x{r["tile"][1]} split '
            f'{r["splits"]}x{r["per_split"]}: {r["ms"]:.4f} ms (device '
            f'{r["device_ms"]:.4f}, bound {r["bound_ms"]:.4f}, fp32 bound '
            f'{r["bound_fp32_ms"]:.4f}, library {r["library_ms"]:.4f}), hit '
            f'{r["hit_share"]:.3f} work {r["work_share"]:.3f}, launches '
            f'{r["cuda_launches"]}, max|d|/max|ref| '
            f'{r["max_abs_err"] / max(r["max_abs_ref"], 1e-30):.2e}')
    for r in calls['join_scan']:
        log(f'[kernels] join scan n={r["n"]} k={r["k"]}: {r["ms"]:.4f} ms '
            f'(device {r["device_ms"]:.4f}, bound {r["bound_ms"]:.4f}, '
            f'library {r["library_ms"]:.4f}), launches {r["cuda_launches"]}')
    return calls


def _scan_call(P, skey, saux, ranges, sbits, time_it):
    sb = int(sbits) & 0xFFFFFFFF
    sb = sb - (1 << 32) if sb >= 1 << 31 else sb
    ref = P._join_scan_plain(skey, saux, ranges, sb)
    got = P.join_scan(skey, saux, ranges, sbits)
    for (rk, ra), (gk, ga) in zip(ref, got):
        if not (torch.equal(rk, gk) and torch.equal(ra, ga)):
            raise RuntimeError(f'join_scan n={skey.shape[0]} ranges={ranges} '
                               f'sbits={sbits}: kernel != plain')
    if not time_it:
        return None
    n, k = skey.shape[0], len(ranges)
    kfill = torch.full_like(skey, -2**31)
    masked = [torch.where((saux >= lo) & (saux < hi), skey, kfill)
              for lo, hi in ranges]
    nbytes = 8 * n + 8 * k * n
    return dict(n=n, k=k, max_abs_err=0, ms=cuda_ms(
        lambda: P.join_scan(skey, saux, ranges, sbits), reps=20),
        plain_ms=cuda_ms(lambda: P._join_scan_plain(skey, saux, ranges, sb)),
        library_ms=cuda_ms(lambda: [torch.cummax(x, 0) for x in masked +
                                    masked]),
        bytes=nbytes, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
        bound_by='bytes')


def _conv_case(g, n, m, k, cin, cout, hit=0.3, bias=True, device='cuda'):
    """Random sparse-conv inputs: ~``hit`` of the (row, offset) pairs point
    at a row, 10% of the rows are masked."""
    feats = torch.randn(n, cin, generator=g, device=device)
    mask = torch.rand(n, generator=g, device=device) > 0.1
    nbr = torch.randint(0, n, (m, k), generator=g, device=device,
                        dtype=torch.int32)
    absent = torch.rand(m, k, generator=g, device=device) > hit
    nbr = torch.where(absent, torch.full_like(nbr, -1), nbr)
    w = torch.randn(k, cin, cout, generator=g, device=device) * cin ** -0.5
    b = torch.randn(cout, generator=g, device=device) if bias else None
    return feats, mask, nbr, w, b


@torch.no_grad()
def phase_edges(device):
    """Edge shapes of both kernels on the card against the plain versions."""
    from embodiedscan_torch.ops import pscan as P
    from embodiedscan_torch.ops import sparse as S
    g = torch.Generator(device=device).manual_seed(0)
    checked = []

    def conv(what, *shape, route, **kw):
        feats, mask, nbr, w, b = _conv_case(g, *shape, device=device, **kw)
        plan = S.cuda_plan(feats, nbr, w)
        if plan.route != route:
            raise RuntimeError(f'{what}: route {plan.route}, want {route}')
        _, err, scale = _check_conv(S, feats, mask, nbr, w, b, what)
        checked.append(f'{what} ({plan.route}, split {plan.splits}, '
                       f'max|d|/max|ref| {err / scale:.1e})')
        return feats, mask, nbr, w, b

    conv('cin3', 5000, 4100, 27, 3, 64, route='simt')
    conv('k1', 9000, 777, 1, 64, 128, route='tc')
    conv('ragged_m', 3000, 1001, 27, 64, 64, route='tc', bias=False)
    conv('cout128', 8000, 8191, 27, 128, 128, route='tc')
    conv('cout512', 4000, 2047, 27, 512, 512, route='tc')
    conv('wide_m', 70000, 65536, 27, 128, 128, route='tc', hit=0.25)
    for what in ('all_absent', 'all_masked'):
        feats, mask, nbr, w, b = _conv_case(g, 2000, 1500, 27, 64, 128,
                                            device=device)
        if what == 'all_absent':
            nbr = torch.full_like(nbr, -1)
        else:
            mask = torch.zeros_like(mask)
        got, _, _ = _check_conv(S, feats, mask, nbr, w, b, what)
        if not torch.equal(got, b.expand_as(got)):
            raise RuntimeError(f'sparse_conv {what}: output is not the bias')
        checked.append(what)
    # a view that is not 16-byte aligned takes the SIMT route
    feats, mask, nbr, w, b = _conv_case(g, 3000, 1000, 27, 64, 64,
                                        device=device)
    flat = torch.empty(feats.numel() + 1, device=device)
    view = flat[1:].view_as(feats).copy_(feats)
    if S.cuda_plan(view, nbr, w).route != 'simt':
        raise RuntimeError('misaligned view did not take the SIMT route')
    _check_conv(S, view, mask, nbr, w, b, 'misaligned')
    checked.append('misaligned (simt)')
    # one shape split and unsplit: both within the gate, of each other too
    feats, mask, nbr, w, b = _conv_case(g, 4000, 4096, 27, 256, 256,
                                        device=device)
    plan = S.cuda_plan(feats, nbr, w)
    one = plan._replace(splits=1, per_split=27)
    if plan.splits == 1:
        raise RuntimeError(f'{tuple(nbr.shape)} x {tuple(w.shape)}: no split')
    a, _, scale = _check_conv(S, feats, mask, nbr, w, b, 'split', plan)
    c, _, _ = _check_conv(S, feats, mask, nbr, w, b, 'unsplit', one)
    d = float((a - c).abs().max())
    if not d <= CONV_GATE * scale:
        raise RuntimeError(f'split vs unsplit: max|d| {d} > {CONV_GATE} x '
                           f'{scale}')
    checked.append(f'split {plan.splits}x{plan.per_split} vs unsplit '
                   f'(max|d| {d:.3g})')
    # join scan: the reference's unit-test cases, one tile, one tile plus
    # one row, and a stem-sized call with many tiles
    tile = S.kernels.library().es_join_scan_tile()
    rng = np.random.RandomState(0)
    for n, k, sbits in ((1000, 1, 0), (70001, 3, 0),
                        (40000, 2, (1 << 30) - 1), (5000, 1, 0xFFFFFFFF),
                        (tile, 2, 0), (tile + 1, 3, 0), (1867776, 1, 0),
                        (4000037, 3, (1 << 20) - 1)):
        skey = torch.from_numpy(np.sort(rng.randint(
            -2**31, 2**31 - 1, n)).astype(np.int32)).to(device)
        saux = torch.from_numpy(rng.permutation(n).astype(np.int32)).to(
            device)
        cuts = sorted(rng.choice(n, 2 * k, replace=False))
        ranges = tuple((int(cuts[2 * i]), int(cuts[2 * i + 1]))
                       for i in range(k))
        _scan_call(P, skey, saux, ranges, sbits, time_it=False)
        checked.append(f'join_scan n={n} k={k}')
    log('[edges] kernel == plain (join scan bit-exact, sparse conv within '
        f'{CONV_GATE} x max|ref| and the same bits twice): ' +
        '; '.join(checked))


@torch.no_grad()
def phase_e2e_parity(device):
    """A small detector on ``device`` and on cpu with the same weights."""
    from embodiedscan_torch.configs.base import build_model, mv_det3d
    from embodiedscan_torch.ops import pscan as P
    from embodiedscan_torch.ops import sparse as S
    cfg = mv_det3d()
    m = cfg.model
    m.num_classes, m.voxel_size, m.input_capacity = 18, 0.04, 4096
    m.backbone_capacities = (4096, 2048, 2048, 1024, 512, 256)
    m.fpn_capacities = (1024, 512, 256, 128)
    m.nms_pre, m.max_candidates, m.max_dets = 128, 128, 32
    cpu = build_model(cfg, device='cpu')
    with torch.no_grad():
        cpu.bbox_head.conv_cls.bias.zero_()
    gpu = build_model(cfg, device=device)
    gpu.load_state_dict(cpu.state_dict())
    req = make_request(p=6000, v=4, hw=96, seed=7)
    out = {}
    for name, model, dev in (('cpu', cpu, 'cpu'), ('cuda', gpu, device)):
        with Recorder(S, P) as rec:
            feats = model(to_device(req, dev), mode='feats')
            preds = model(to_device(req, dev), mode='predict')
        out[name] = (rec, feats, {k: v.cpu() for k, v in preds.items()})
    (rc, fc, pc), (rg, fg, pg) = out['cpu'], out['cuda']
    if len(rc.conv) != len(rg.conv) or not rc.conv:
        raise RuntimeError('cpu and cuda runs made different conv calls')
    for ac, ag in zip(rc.conv, rg.conv):
        if not torch.equal(ac[2], ag[2].cpu()):
            raise RuntimeError('neighbor tables differ between cpu and cuda')
    worst = 0.0
    for field in ('center', 'reg', 'cls'):
        for c, g in zip(getattr(fc, field), getattr(fg, field)):
            worst = max(worst, _close(c, g.cpu(), field))
    for field in ('points', 'masks'):
        for c, g in zip(getattr(fc, field), getattr(fg, field)):
            if not torch.equal(c, g.cpu()):
                raise RuntimeError(f'feats {field} differ')
    for field in ('labels', 'mask'):
        if not torch.equal(pc[field], pg[field]):
            raise RuntimeError(f'predict {field} differ')
    for field in ('bboxes', 'scores'):
        worst = max(worst, _close(pc[field], pg[field], field))
    log(f'[parity] cpu vs cuda: {len(rc.conv)} neighbor tables identical, '
        f'labels/masks identical, kept {int(pc["mask"].sum())}, '
        f'worst float |d| - tol {worst:.3g}')


def _close(a, b, what):
    tol = 1e-4 + 1e-5 * b.abs()
    excess = float(((a - b).abs() - tol).max())
    if excess > 0:
        raise RuntimeError(f'{what}: cpu and cuda differ beyond tolerance '
                           f'(max excess {excess})')
    return excess


def kernel_line(calls, totals):
    rows = []
    conv = ('embodiedscan_torch/csrc/sparse_conv.cu',
            'embodiedscan_tpu/experimental/pallas_conv.py:62')
    meta = {  # kernel -> (route, source, replaces, its calls)
        'sparse_conv_tc': ('cuda', *conv, [
            r for r in calls['sparse_conv'] if r['route'] == 'tc']),
        'sparse_conv_simt': ('cuda', *conv, [
            r for r in calls['sparse_conv'] if r['route'] == 'simt']),
        'join_scan': ('cuda', 'embodiedscan_torch/csrc/join_scan.cu',
                      'embodiedscan_tpu/ops/pscan.py:101',
                      calls['join_scan']),
    }
    for name, (route, source, replaces, rs) in meta.items():
        bound = sum(r['bound_ms'] for r in rs)
        by_bytes = sum(r['bound_ms'] for r in rs if r['bound_by'] == 'bytes')
        rows.append(dict(
            name=name, route=route, source=source, replaces=replaces,
            launches=totals[name],
            max_abs_err=max(r['max_abs_err'] for r in rs),
            ms=sum(r['ms'] for r in rs),
            plain_ms=sum(r['plain_ms'] for r in rs), bound_ms=bound,
            bound_by='bytes' if by_bytes >= bound / 2 else 'operations',
            library_ms=sum(r['library_ms'] for r in rs)))
    return json.dumps({'kernels': rows})


def main():
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    card = phase_build()
    if sys.argv[1:] == ['--kernels-only']:
        phase_edges('cuda')
        log(f'[done] kernels only, {time.perf_counter() - t_start:.1f} s')
        return 0
    torch.manual_seed(0)
    rec, totals, main_stats, model, batch = phase_main_path('cuda')
    calls = phase_kernels(rec, 'cuda')
    main_stats.update(profile_request(model, batch))
    del rec, model, batch
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, 'chip_smoke_calls.json'), 'w') as f:
        json.dump(dict(card=card, main=main_stats, calls=calls), f, indent=1)
    phase_edges('cuda')
    phase_e2e_parity('cuda')
    log(f'[done] {time.perf_counter() - t_start:.1f} s')
    print(kernel_line(calls, totals))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
