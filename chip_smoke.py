"""GPU smoke run of the PyTorch/CUDA port (embodiedscan_torch).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (one line each; any failure exits non-zero before the last line):
  1. device and build: the card's name and power limit, the versions of
     python, torch and scipy (the grounder's host matcher; its import
     failing fails the run), then the build of the hand-written kernels
     from embodiedscan_torch/csrc;
  2. serving path: the full-width mv_det3d detector (284 classes,
     MinkResNet-34 + ResNet-50/16, shipped capacities) serves one warm-up
     and three synthetic requests of 100k points and 50 views of 480x480;
     launch counts are reset before each request and read after it; then
     the host-clock time of each stage of one request;
  3. grounding path: the full-width mv_grounding grounder (the same trunk,
     the sparse neck, RoBERTa-base 12 x 768 over 256 tokens, 256 queries,
     6 decoder layers) serves one warm-up and three requests of the same
     scenes, each with a prompt tokenized by the port's SimpleTokenizer;
     launch counts per request; then the host-clock time of each stage
     (voxelize + trunk, neck, text encoder, query selection, decoder,
     predict);
  4. training path: the same detector in training mode takes one warm-up
     and three timed train steps (loss, backward, clip, AdamW; the 2D stem
     and first stage frozen) on a scene of 100k points, 20 views of
     480x480 and 128 GT boxes, with launch counts reset before each step
     and read after it; then the forward, backward and optimizer times of
     one step;
  5. grounding training path: the full-width grounder in training mode
     (text encoder and 2D stem and first stage frozen, decoder at 0.1 of
     the rate) takes one warm-up and three timed steps on the same scene
     with 64 padded gt boxes, 4 of them valid, each matched to a word of
     the prompt; launch counts per step; the split, with the IoU match cost
     and the Hungarian matcher (scipy on the host, its copies included);
     frozen parameters bit-identical and the others moved;
  6. kernel parity and times: every kernel call of both warm-up requests,
     of the detector's warm-up step's backward and of the grounder's
     warm-up step is replayed on its recorded inputs against the kernel's
     plain PyTorch version (join scan bit-exact, sparse conv and weight
     gradient within 1e-4 x max|ref| and bit-identical when run twice, the
     weight gradient's pair lists identical to the plain pair pass), with
     the kernel, plain and library times, the least time the card could
     take, the plan (route, tile, split or chunks) and the share of the
     dense work that hits and that the kernel computes; after every
     timing, the profiler counts each call's CUDA launches and device time
     and traces one request of each path and one step of each train path
     (device busy time and idle share);
  7. eval: indoor_eval over the detector's requests and ground_eval over
     the grounder's, against synthetic ground truth, with the IoU on the
     card and on the cpu (metric dicts within 1e-6; times printed);
  8. published checkpoints ([ckpt]): a seeded state_dict in the layout of
     a reference EmbodiedScan checkpoint for each preset, at its full
     width (torchvision ResNet, ME MinkResNet, FCAF3D head or MinkNeck,
     roberta-base with its 50265-token vocabulary, decoder, head
     branches), saved as a .pth, converted by
     ``embodiedscan_torch.tools.convert_checkpoint.main`` on the card (no
     skip for the detector, only the word embedding for the grounder),
     restored into a fresh model (bit-identical); converted and restored
     serve one request each with the same bits and the main paths' launch
     counts (the grounder's prompt tokenized by BPETokenizer from
     tests/fixtures/roberta_tok); conversion, checkpoint size, restore and
     request times beside the card's name and power limit;
  9. edge shapes: the sparse conv at Cin = 3, K = 1, ragged M, Cout 64 /
     128 / 512, all-absent and all-masked tables, indices N, N + 5 and -7
     (absent) on both routes, a misaligned view, split
     against unsplit; the weight gradient at C of 3, 4, 8 and 12, channels
     that are not a multiple of the tile, C 128 to 1024, K = 1, ragged R,
     R = 1, offsets of 0, 1, 31, 32 and 33 pairs, all-absent and
     all-masked tables, a misaligned view, many pair chunks against one
     (its pair lists held identical to the plain pair pass everywhere);
     the join scan at the reference's unit-test cases, one tile, one tile
     plus one row and ~4M rows;
 10. end-to-end parity: a small detector and a small grounder (shipped
     widths, cut capacities) on cuda (kernels) and on cpu (plain versions)
     with the same weights, serving, then the same two loaded from
     reference state_dicts by load_reference_model; each also one train
     step (the grounder's matched gt indices identical);
 11. one JSON line with the kernels, then the result line.
Per-call details go to chiprun_out/chip_smoke_calls.json.

``python3 chip_smoke.py --kernels-only`` runs phases 1 and 9 and stops
(no result line): the quickest check that the kernels build and agree.
"""

import contextlib
import functools
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
# wrapper calls per request: K2 by route (the stem's Cin = 3 takes SIMT);
# serving runs no backward kernel
EXPECTED_LAUNCHES = {'sparse_conv_tc': 43, 'sparse_conv_simt': 1,
                     'sparse_dgrad_tc': 0, 'sparse_dgrad_simt': 0,
                     'sparse_wgrad_tc': 0, 'sparse_wgrad_narrow': 0,
                     'join_scan': 12}
# wrapper calls per train step: the 44 forward convs; K2 again for the
# input gradient of the 35 submanifold and 4 strided convs (the stem's
# input needs none, the 4 K = 1 downsamples take index_add_); K3 for the
# weight gradient of all 44 (the stem's Cy = 3 on the narrow route); K1's
# 12 joins, the stages' now with their transpose queries
EXPECTED_TRAIN_LAUNCHES = {'sparse_conv_tc': 43, 'sparse_conv_simt': 1,
                           'sparse_dgrad_tc': 39, 'sparse_dgrad_simt': 0,
                           'sparse_wgrad_tc': 43, 'sparse_wgrad_narrow': 1,
                           'join_scan': 12}
# wrapper calls per grounding request: the trunk's 37 convs and the neck's
# 7 on K2 (the stem on SIMT); K1 for the trunk's stage tables and the
# neck's FPN and neighbor tables
EXPECTED_GROUND_LAUNCHES = {'sparse_conv_tc': 43, 'sparse_conv_simt': 1,
                            'sparse_dgrad_tc': 0, 'sparse_dgrad_simt': 0,
                            'sparse_wgrad_tc': 0, 'sparse_wgrad_narrow': 0,
                            'join_scan': 12}
# wrapper calls per grounding train step: as the detector's step, the
# neck's 7 convs in place of the head's (all 27-offset submanifold, with
# their input gradient on K2 and weight gradient on K3); the frozen 2D stem
# and first stage run no sparse kernel
EXPECTED_GROUND_TRAIN_LAUNCHES = {'sparse_conv_tc': 43, 'sparse_conv_simt': 1,
                                  'sparse_dgrad_tc': 39,
                                  'sparse_dgrad_simt': 0,
                                  'sparse_wgrad_tc': 43,
                                  'sparse_wgrad_narrow': 1, 'join_scan': 12}
CONV_GATE = 1e-4  # K2, K3: max|kernel - plain| <= CONV_GATE x max|plain|
EVAL_GATE = 1e-6  # metric dicts with the IoU on the card vs on the cpu
SPLIT_GATE = 1e-6  # K3 many chunks vs one: max|d| <= SPLIT_GATE x max
# CPU vs CUDA train step: every gradient leaf and batch statistic within
# GRAD_GATE x its max|cpu| (3xTF32 kernels, cuDNN and atomic sums in
# another order, through ~90 layers forward and back). On an H100 the
# shipped kernels' worst leaf is 9.95e-5 and, with K2's and K3's products
# cut to single TF32, 0.473 (``kernel_ab.py --tf32-control``)
GRAD_GATE = 3e-4
OUT_DIR = 'chiprun_out'
# RoBERTa's byte-level BPE files of the repo's tokenizer fixture
ROBERTA_TOK = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           'tests', 'fixtures', 'roberta_tok')
# the one leaf of a grounder checkpoint the port skips: roberta-base's 50265
# rows against the 30522 of both packages' encoders
WORD_EMBEDDING = ('text_encoder/FlaxRobertaModule_0/embeddings/'
                  'word_embeddings/embedding')


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


def make_batch(b, p, v, hw, g, num_classes, seed=0):
    """A numpy copy of the reference's ``bench.py:make_batch``: the same
    room cloud, cameras, GT boxes and labels from the same seed."""
    rng = np.random.RandomState(seed)
    u = rng.uniform(0, 8, (p, 2)).astype(np.float32)
    which = rng.randint(0, 3, p)
    pts = np.zeros((p, 3), np.float32)
    pts[which == 0] = np.stack([u[which == 0, 0], u[which == 0, 1],
                                np.zeros((which == 0).sum())], -1)
    pts[which == 1] = np.stack([u[which == 1, 0],
                                np.zeros((which == 1).sum()),
                                u[which == 1, 1] * 3 / 8], -1)
    pts[which == 2] = np.stack([np.zeros((which == 2).sum()),
                                u[which == 2, 0],
                                u[which == 2, 1] * 3 / 8], -1)
    pts = np.tile(pts[None], (b, 1, 1)) + rng.randn(b, p, 3).astype(
        np.float32) * 0.01
    k = np.array([[500.0, 0, hw / 2, 0], [0, 500.0, hw / 2, 0], [0, 0, 1, 0],
                  [0, 0, 0, 1]], np.float32)
    exts = []
    for i in range(v):
        ext = np.eye(4, dtype=np.float32)
        ext[:3, 3] = [-4.0 + 0.1 * i, -4.0, 8.0]
        exts.append(k @ ext)
    boxes = gt_boxes(rng, b, g)
    return dict(
        points=pts.astype(np.float32),
        points_mask=np.ones((b, p), bool),
        imgs=rng.randn(b, v, hw, hw, 3).astype(np.float32),
        proj=np.tile(np.stack(exts)[None], (b, 1, 1, 1)).astype(np.float32),
        aug_inv=np.tile(np.eye(4, dtype=np.float32), (b, 1, 1)),
        gt_boxes=boxes,
        gt_labels=rng.randint(0, num_classes, (b, g)).astype(np.int32),
        gt_mask=np.ones((b, g), bool),
    )


def gt_boxes(rng, b, g):
    """(b, g, 9) boxes in the room, as ``bench.py:make_batch`` draws them."""
    return np.concatenate([
        rng.uniform(0.5, 7.5, (b, g, 2)),
        rng.uniform(0.2, 2.0, (b, g, 1)),
        rng.uniform(0.2, 1.5, (b, g, 3)),
        rng.uniform(-0.5, 0.5, (b, g, 3)),
    ], -1).astype(np.float32)


PROMPTS = ('find the chair that is closest to the window',
           'the lamp on the small table in the corner of the room',
           'select the tall cabinet to the left of the door',
           'the pillow on the bed, facing the wall')


def make_ground_request(max_text_len, seed=0, tokenizer=None, **kw):
    """``make_request`` plus one prompt tokenized by ``tokenizer`` (default:
    the port's ``SimpleTokenizer``)."""
    from embodiedscan_torch.models.text import SimpleTokenizer
    req = make_request(seed=seed, **kw)
    tokenizer = tokenizer or SimpleTokenizer(max_len=max_text_len)
    enc = tokenizer([PROMPTS[seed % len(PROMPTS)]])
    req.update(text_ids=enc['input_ids'], text_mask=enc['attention_mask'])
    return req


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
    that CPU tensors take) while active; the launch counts are untouched.

    ``conv``: K2's forward calls (feats, mask, nbr, weights, bias);
    ``dgrad``: K2's input-gradient calls (dout, out_mask, table, weights_t,
    None); ``wgrad``: K3's calls (x, x_mask, idx, y, y_mask); ``scan``:
    K1's calls. A name the checkout lacks (an earlier one, timed by
    kernel_ab.py) is not patched.
    """

    def __init__(self, S, P):
        self.S, self.P = S, P
        self.conv, self.dgrad, self.wgrad, self.scan = [], [], [], []
        self.orig = []
        self.in_dgrad = False

    def _patch(self, mod, name, make):
        fn = getattr(mod, name, None)
        if fn is not None:
            self.orig.append((mod, name, fn))
            # wraps() shares the wrapper's attributes (launch counts) too
            setattr(mod, name, functools.wraps(fn)(make(fn)))

    @staticmethod
    def _logging(log_of):
        def make(fn):
            def wrapped(*args):
                log_of().append(args[:5])
                return fn(*args)
            return wrapped
        return make

    def __enter__(self):
        def k2_log():
            return self.dgrad if self.in_dgrad else self.conv

        def dgrad(fn):
            def wrapped(*args):
                self.in_dgrad = True
                out = fn(*args)
                self.in_dgrad = False
                return out
            return wrapped

        for name in ('_gather_matmul_conv_cuda', '_gather_matmul_conv_plain'):
            self._patch(self.S, name, self._logging(k2_log))
        self._patch(self.S, 'conv_dgrad', dgrad)
        for name in ('_conv_wgrad_cuda', '_conv_wgrad_plain'):
            self._patch(self.S, name, self._logging(lambda: self.wgrad))
        for name in ('_join_scan_cuda', '_join_scan_plain'):
            self._patch(self.P, name, self._logging(lambda: self.scan))
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.orig:
            setattr(mod, name, fn)

    def to_host(self):
        """Moves every recorded tensor to host memory: the device then holds
        nothing of the recorded run (replays copy one call back at a
        time)."""
        for log_ in (self.conv, self.dgrad, self.wgrad, self.scan):
            log_[:] = [_on(args, 'cpu') for args in log_]


def _on(args, device):
    return tuple(a.to(device) if isinstance(a, torch.Tensor) else a
                 for a in args)


def phase_build():
    import scipy  # the grounder's host matcher: no fallback without it
    from embodiedscan_torch.ops import kernels
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f'[build] python {sys.version.split()[0]}, torch {torch.__version__} '
        f'(CUDA {torch.version.cuda}), scipy {scipy.__version__}')
    t0 = time.perf_counter()
    kernels.library()
    # registers, spills, and the compiler's notes on serialized wgmma (C7xxx)
    regs = [ln.strip() for ln in kernels.build_log.splitlines()
            if 'registers' in ln or 'spill' in ln or '(C7' in ln]
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
    lat, mem, kept, served = [], [], [], []
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
        served.append(preds)
        for key, val in preds.items():
            if val.is_floating_point() and not torch.isfinite(val).all():
                raise RuntimeError(f'request {i}: non-finite {key}')
        if preds['bboxes'].shape != (1, cfg.model.max_dets, 9):
            raise RuntimeError(f'bboxes shape {tuple(preds["bboxes"].shape)}')
        kept.append(int(preds['mask'].sum()))
        check_counts(counts, EXPECTED_LAUNCHES, f'request {i}')
        for name in totals:
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
    return rec, totals, stats, model, batch, served


def phase_grounding(device, cfg=None):
    """The mv_grounding serving path at full width (RoBERTa-base 12 x 768,
    256 queries, 6 decoder layers, max_text_len 256; the trunk as the
    detector's): one recorded warm-up request, then three timed ones, each
    with its peak memory and its launch counts against
    EXPECTED_GROUND_LAUNCHES; then the host-clock time of each stage."""
    from embodiedscan_torch.configs.base import build_model, mv_grounding
    from embodiedscan_torch.ops import pscan as P
    from embodiedscan_torch.ops import sparse as S
    cfg = cfg or mv_grounding()
    m, d = cfg.model, cfg.data
    t0 = time.perf_counter()
    # a checkpoint's box branch (see _box_branch): the boxes follow the
    # queries, so the grounding metric has hits to count
    model = _box_branch(build_model(cfg, device=device), 0)
    log(f'[ground] built mv_grounding on {device} in '
        f'{time.perf_counter() - t0:.1f} s: '
        f'{sum(p.numel() for p in model.parameters())} parameters, text '
        f'{m.text_arch} {m.text_layers}x{m.text_hidden}, {m.num_queries} '
        f'queries, {model.num_decoder_layers} decoder layers')
    requests = [make_ground_request(m.max_text_len, seed=s, p=d.n_points,
                                    v=d.n_views_test, hw=d.image_hw[0])
                for s in range(4)]
    with Recorder(S, P) as rec:  # warm-up request: record kernel inputs
        t0 = time.perf_counter()
        model(to_device(requests[0], device), mode='predict')
        torch.cuda.synchronize()
    log(f'[ground] warm-up request {time.perf_counter() - t0:.2f} s, '
        f'{len(rec.conv)} conv and {len(rec.scan)} join-scan calls recorded')
    lat, mem, served = [], [], []
    totals = dict.fromkeys(EXPECTED_GROUND_LAUNCHES, 0)
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
                raise RuntimeError(f'grounding request {i}: non-finite {key}')
        shapes = (tuple(preds['bboxes'].shape), tuple(preds['scores'].shape))
        if shapes != ((1, m.num_queries, 9), (1, m.num_queries)):
            raise RuntimeError(f'grounding request {i}: shapes {shapes}')
        check_counts(counts, EXPECTED_GROUND_LAUNCHES,
                     f'grounding request {i}')
        for name in totals:
            totals[name] += counts[name]
        served.append(preds)
        log(f'[ground] request {i}: {lat[-1] * 1e3:.1f} ms, peak '
            f'{mem[-1]:.2f} GiB, {int(preds["mask"].sum())} valid queries, '
            f'best score {float(preds["scores"].max()):.4f}, launches '
            f'{counts}')
    log(f'[ground] latency ms per request: '
        f'{[round(t * 1e3, 3) for t in lat]}, peak GiB {max(mem):.3f}')
    stats = dict(latency_ms=[t * 1e3 for t in lat], peak_gib=max(mem))
    batch = to_device(requests[1], device)
    stats.update(ground_stage_times(model, batch))
    return rec, totals, stats, model, batch, served


def grounding_parts(model, batch, timer=None):
    """The grounder's request stage by stage (voxelize + trunk, neck, text
    encoder, query selection, decoder, predict), each through ``timer``
    (``fn -> (ms, out)``) when one is given; returns (ms per stage, neck
    output, selected query indices, decoder outputs, predictions)."""
    timer = timer or (lambda fn: (0.0, fn()))
    ms = {}

    def stage(name, fn):
        ms[name], out = timer(fn)
        return out

    with torch.no_grad():
        feats3d = stage('voxelize_trunk', lambda: model.trunk(batch))
        feats, scores, xyz, mask = stage('neck', lambda: model.neck(feats3d))
        text_mask = batch['text_mask'] > 0
        text = stage('text_encoder', lambda: model.text_encoder(
            batch['text_ids'], batch['text_mask']))
        query, coords, qmask, top = stage(
            'query_selection', lambda: model.select_queries(
                feats, xyz, mask, text, text_mask))
        outs = stage('decoder', lambda: model.decoder(
            query, coords, qmask, feats, xyz, mask, text, text_mask))
        preds = stage('predict', lambda: model.predict(outs))
    return ms, dict(feats=feats, scores=scores, xyz=xyz, mask=mask), top, \
        outs, preds


def ground_stage_times(model, batch):
    """Where one grounding request's time goes on the host clock, stage by
    stage (each ends in a synchronize)."""
    stages = grounding_parts(model, batch, _host_ms)[0]
    log('[breakdown] grounding host ms per stage: ' + ', '.join(
        f'{k} {v:.2f}' for k, v in stages.items()))
    return dict(stages_ms=stages)


def reset_counts(S, P):
    S.gather_matmul_conv.launches = {'tc': 0, 'simt': 0}
    S.conv_dgrad.launches = {'tc': 0, 'simt': 0}
    S.conv_wgrad.launches = {'tc': 0, 'narrow': 0}
    P.join_scan.launches = 0


def read_counts(S, P):
    counts = {'join_scan': P.join_scan.launches}
    for name, fn in (('sparse_conv', S.gather_matmul_conv),
                     ('sparse_dgrad', S.conv_dgrad),
                     ('sparse_wgrad', S.conv_wgrad)):
        for route, n in fn.launches.items():
            counts[f'{name}_{route}'] = n
    return counts


def check_counts(counts, want, what):
    for name, n in want.items():
        if counts[name] != n:
            raise RuntimeError(f'{what}: {name} launched {counts[name]} '
                               f'times, expected {n}')


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


def phase_train(device, cfg=None):
    """The training path at full width: one recorded warm-up step, then
    three timed ones (host clock, each ending in a synchronize), each
    with its peak memory and its launch counts against
    EXPECTED_TRAIN_LAUNCHES; then one step split into forward, backward
    and optimizer."""
    from embodiedscan_torch.configs.base import build_train, mv_det3d
    cfg = cfg or mv_det3d()
    t0 = time.perf_counter()
    model, opt = build_train(cfg, device=device)
    d = cfg.data
    batch = to_device(make_batch(1, d.n_points, d.n_views_train,
                                 d.image_hw[0], d.n_gt,
                                 cfg.model.num_classes), device)
    log(f'[train] built mv_det3d and AdamW on {device} in '
        f'{time.perf_counter() - t0:.1f} s; batch b=1, '
        f'{d.n_points} points, {d.n_views_train} views, {d.n_gt} GT boxes')
    rec, totals, stats = train_steps('train', model, opt, batch,
                                     EXPECTED_TRAIN_LAUNCHES)
    rec.conv, rec.scan = [], []  # the serving replay covers K1 and K2 fwd
    return rec, totals, stats, model, opt, batch


def make_ground_train_batch(cfg, p, v, hw, seed=0):
    """``make_batch`` with ``cfg.data.max_boxes`` padded gt boxes, the first
    four valid, and one prompt (``PROMPTS[0]``) tokenized by the port's
    ``SimpleTokenizer``; each valid box's positive map covers its own word
    of the prompt (``build_positive_maps``)."""
    from embodiedscan_torch.models.text import (SimpleTokenizer,
                                                build_positive_maps)
    m, g = cfg.model, cfg.data.max_boxes
    batch = make_batch(1, p, v, hw, g, m.num_classes, seed)
    text = PROMPTS[0]
    tok = SimpleTokenizer(max_len=m.max_text_len)
    enc = tok([text])
    spans = [[[text.index(w), text.index(w) + len(w)]]
             for w in ('chair', 'window', 'closest', 'find')]
    batch['gt_mask'][:, len(spans):] = False
    batch.update(text_ids=enc['input_ids'], text_mask=enc['attention_mask'],
                 positive_maps=build_positive_maps(tok, [text], [spans],
                                                   m.max_text_len, g))
    return batch


def phase_ground_train(device, cfg=None):
    """The mv_grounding train step at full width (the serving grounder's
    widths; 20 views, ``max_boxes`` padded gt boxes, 4 valid): ``build_train``
    with the task's lr multipliers (text encoder, 2D stem and first stage
    frozen, decoder at 0.1), a checkpoint's box branch (``_box_branch``);
    :func:`train_steps` against EXPECTED_GROUND_TRAIN_LAUNCHES, the split
    naming the IoU match cost and the matcher; then every frozen parameter
    bit-identical and every other one moved."""
    from embodiedscan_torch.configs.base import build_train, mv_grounding
    cfg = cfg or mv_grounding()
    d = cfg.data
    t0 = time.perf_counter()
    model, opt = build_train(cfg, device=device)
    _box_branch(model, 0)
    batch = to_device(make_ground_train_batch(
        cfg, d.n_points, d.n_views_train, d.image_hw[0]), device)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    frozen = {n for n, p in model.named_parameters() if not p.requires_grad}
    groups = {g['lr_mult']: sum(p.numel() for p in g['params'])
              for g in opt.param_groups}
    log(f'[ground_train] built mv_grounding and AdamW on {device} in '
        f'{time.perf_counter() - t0:.1f} s: parameters by lr multiplier '
        f'{groups}, frozen {sum(before[n].numel() for n in frozen)} in '
        f'{len(frozen)} tensors; batch b=1, {d.n_points} points, '
        f'{d.n_views_train} views, {d.max_boxes} gt boxes '
        f'({int(batch["gt_mask"].sum())} valid), lr {cfg.schedule.lr}, '
        f'weight decay {cfg.schedule.weight_decay}, matcher '
        f'{cfg.model.matcher}')
    rec, totals, stats = train_steps('ground_train', model, opt, batch,
                                     EXPECTED_GROUND_TRAIN_LAUNCHES)
    params = dict(model.named_parameters())
    moved = [n for n in frozen if not torch.equal(params[n], before[n])]
    still = [n for n in params if n not in frozen and
             torch.equal(params[n], before[n])]
    # weight decay moves every nonzero tensor; a zero one stays where the
    # loss gives it no gradient
    stuck = [n for n in still if before[n].any()]
    if moved or stuck:
        raise RuntimeError(f'grounding train: frozen tensors moved {moved}, '
                           f'trained tensors did not move {stuck}')
    log(f'[ground_train] after {len(stats["losses"]) + 1} steps: the '
        f'{len(frozen)} frozen tensors bit-identical, '
        f'{len(params) - len(frozen) - len(still)} of the '
        f'{len(params) - len(frozen)} others moved, {len(still)} zero '
        f'tensors without a gradient stayed zero{still[:3]}')
    stats.update(unmoved_zero_tensors=still)
    stats.update(params_by_lr_mult=groups, frozen_tensors=len(frozen))
    return rec, totals, stats, model, opt, batch


def train_steps(tag, model, opt, batch, want):
    """One recorded warm-up step, then three timed ones (host clock, each
    ending in a synchronize), each with its peak memory and its launch
    counts against ``want``; losses finite and changing; then one step
    split into forward, backward and optimizer. Returns the recorder (on
    the host), the launch totals of the timed steps and the stats."""
    from embodiedscan_torch.ops import pscan as P
    from embodiedscan_torch.ops import sparse as S
    from embodiedscan_torch.train.state import train_step
    reset_counts(S, P)
    with Recorder(S, P) as rec:  # warm-up step: record kernel inputs
        t0 = time.perf_counter()
        metrics = train_step(model, opt, batch)
        torch.cuda.synchronize()
    check_counts(read_counts(S, P), want, f'{tag} warm-up step')
    rec.to_host()
    log(f'[{tag}] warm-up step {time.perf_counter() - t0:.2f} s, '
        f'{len(rec.conv)} conv, {len(rec.dgrad)} dgrad, {len(rec.wgrad)} '
        f'wgrad and {len(rec.scan)} join-scan calls recorded')
    history = [metrics]
    step_ms, mem = [], []
    totals = dict.fromkeys(want, 0)
    for i in range(3):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(S, P)
        t0 = time.perf_counter()
        metrics = train_step(model, opt, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        counts = read_counts(S, P)
        mem.append(torch.cuda.max_memory_allocated() / 2**30)
        check_counts(counts, want, f'{tag} step {i}')
        for name in totals:
            totals[name] += counts[name]
        vals = {k: float(v) for k, v in metrics.items()}
        if not all(np.isfinite(v) for v in vals.values()):
            raise RuntimeError(f'{tag} step {i}: non-finite losses {vals}')
        history.append(metrics)
        log(f'[{tag}] step {i}: {step_ms[-1]:.1f} ms, peak {mem[-1]:.2f} '
            f'GiB, ' + ', '.join(f'{k} {v:.6g}' for k, v in vals.items()) +
            f', launches {counts}')
    totals_seen = [float(m['loss_total']) for m in history]
    if len(set(totals_seen)) != len(totals_seen):
        raise RuntimeError(f'{tag}: loss_total did not change between '
                           f'steps: {totals_seen}')
    split = step_split(model, opt, batch, S, P, want)
    log(f'[{tag}] step ms {[round(t, 3) for t in step_ms]}, peak GiB '
        f'{max(mem):.3f}; one step split: ' + ', '.join(
            f'{k} {v:.2f} ms' for k, v in split.items()))
    stats = dict(step_ms=step_ms, peak_gib=mem, split_ms=split,
                 losses=[{k: float(v) for k, v in m.items()}
                         for m in history])
    return rec, totals, stats


def step_split(model, opt, batch, S, P, want):
    """Host-clock forward, backward and optimizer ms of one train step
    (each part ending in a synchronize); its launches are checked too. A
    grounder's forward also reports, each between synchronizes, its IoU
    match cost and its matcher (the host matcher's copies included)."""
    parts = {}
    restore = []
    if hasattr(model, 'match_fn'):
        from embodiedscan_torch.models import grounding as G

        def timed(name, fn):
            def run(*args):
                torch.cuda.synchronize()
                t = time.perf_counter()
                out = fn(*args)
                torch.cuda.synchronize()
                parts[name] = (time.perf_counter() - t) * 1e3
                return out
            return run

        for obj, name, part in ((G, 'paired_iou_pruned', 'of_which_iou_cost'),
                                (model, 'match_fn', 'of_which_matcher')):
            restore.append((obj, name, getattr(obj, name)))
            setattr(obj, name, timed(part, getattr(obj, name)))
    reset_counts(S, P)
    opt.zero_grad(set_to_none=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        losses = model(batch, mode='loss')
    finally:
        for obj, name, fn in restore:
            setattr(obj, name, fn)
    total = sum(losses.values())
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    total.backward()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    opt.step()
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    check_counts(read_counts(S, P), want, 'split step')
    return dict(forward=(t1 - t0) * 1e3, **parts, backward=(t2 - t1) * 1e3,
                optimizer=(t3 - t2) * 1e3)


def profile_run(fn, what):
    """One run of ``fn`` under torch.profiler: device busy time and idle
    share, device time by op."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    # device-side entries only (kernels, copies): the host-side aten
    # entries report the same device time again, and a record_function
    # span on the device (the optimizer's step) covers its kernels again
    device = [e for e in prof.key_averages()
              if str(e.device_type).endswith('CUDA')
              and _self_device_us(e) > 0]
    spans = sum(_self_device_us(e) / 1e3 for e in device
                if getattr(e, 'is_user_annotation', False))
    ops = [(e.key, _self_device_us(e) / 1e3, e.count) for e in device
           if not getattr(e, 'is_user_annotation', False)]
    ops.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in ops)
    log(f'[breakdown] profiled {what} {wall:.1f} ms wall, device busy '
        f'{busy:.1f} ms (idle share {1 - busy / wall:.3f}; record_function '
        f'spans on the device, not counted: {spans:.2f} ms); top ops: ' +
        '; '.join(f'{k[:90]} {t:.2f} ms x{c}' for k, t, c in ops[:8]))
    return dict(profiled_wall_ms=wall, device_busy_ms=busy,
                device_span_ms=spans,
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


def _check_wgrad(S, x, xm, idx, y, ym, what, plan=None):
    """K3 vs its plain versions: the pair lists and counts of the call
    identical to ``_wgrad_pairs_plain``, G within the gate of
    ``_conv_wgrad_plain``, and the same bits twice; returns (G, max|d|,
    max|ref|, counts)."""
    plan = plan or S.cuda_wgrad_plan(x, idx, y)
    shape = f'{tuple(idx.shape)} x {x.shape[1]} x {y.shape[1]}'
    ref = S._conv_wgrad_plain(x, xm, idx, y, ym)
    want_pairs, want_counts = S._wgrad_pairs_plain(xm, idx, ym)
    got, pairs, counts = S._wgrad_cuda(x, xm, idx, y, ym, plan, lists=True)
    again, pairs2, counts2 = S._wgrad_cuda(x, xm, idx, y, ym, plan,
                                           lists=True)
    if not (torch.equal(counts, want_counts) and torch.equal(counts2,
                                                             want_counts)):
        raise RuntimeError(f'sparse_wgrad {what} {shape}: counts differ '
                           'from the plain pair pass')
    for k, n in enumerate(want_counts.tolist()):
        if not (torch.equal(pairs[k, :n], want_pairs[k, :n]) and
                torch.equal(pairs2[k, :n], want_pairs[k, :n])):
            raise RuntimeError(f'sparse_wgrad {what} {shape}: pair list of '
                               f'offset {k} differs from the plain one')
    err = float((got - ref).abs().max()) if ref.numel() else 0.0
    scale = float(ref.abs().max()) if ref.numel() else 0.0
    if not err <= CONV_GATE * max(scale, 1e-30):
        raise RuntimeError(f'sparse_wgrad {what} {shape}: max|d| {err} > '
                           f'{CONV_GATE} x {scale}')
    if not torch.equal(got, again):
        raise RuntimeError(f'sparse_wgrad {what} {shape}: two runs differ')
    return got, err, scale, want_counts


def _wgrad_work_share(S, plan, counts, r, k):
    """The pairs K3 computes over R x K: each chunk's pairs, rounded up to
    a whole 32-pair step on the tensor-core route."""
    step = S.WG_STEP if plan.route == 'tc' else 1
    done = sum(-(-(p1 - p0) // step) * step for n in counts.tolist()
               for p0, p1 in S.wgrad_chunk_bounds(n, plan.chunks))
    return done / max(r * k, 1)


def _wgrad_bound(x, xm, idx, y, ym):
    """(bytes, flops, hits) of a K3 call: inputs read once, G written once;
    FLOPs over the (row, offset) pairs whose x row and gathered y row are
    both valid."""
    r, cx = x.shape
    k, cy = idx.shape[1], y.shape[1]
    safe = torch.where(idx >= 0, idx, torch.zeros_like(idx)).long()
    hits = int(((idx >= 0) & xm[:, None] & ym[safe]).sum())
    nbytes = (x.numel() * 4 + xm.numel() + idx.numel() * 4 + y.numel() * 4 +
              ym.numel() + k * cx * cy * 4)
    return nbytes, 2.0 * cx * cy * hits, hits


def _bound(nbytes, flops):
    """(bound ms, by what, FP32 bound ms): bytes at the HBM rate against
    3xTF32 operations (3 TF32 products each) at the TF32 peak."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 3 * flops / TF32_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            'bytes' if t_bytes >= t_ops else 'operations',
            max(t_bytes, flops / FP32_FLOPS) * 1e3)


def _conv_call(S, feats, mask, nbr, w, bias, what, run):
    """One K2 call (forward, or dgrad with ``run`` = conv_dgrad): checked,
    then timed beside its plain version and the library gather-matmul."""
    plan = S.cuda_plan(feats, nbr, w)
    _, err, scale = _check_conv(S, feats, mask, nbr, w, bias, what)
    padded = torch.cat([torch.where(mask[:, None], feats,
                                    torch.zeros_like(feats)),
                        feats.new_zeros(1, feats.shape[1])])
    idx = torch.where(nbr >= 0, nbr, torch.full_like(nbr, feats.shape[0]))
    kcin = w.shape[0] * w.shape[1]
    w2 = w.reshape(kcin, w.shape[2])
    nbytes, flops, hits = _conv_bound(feats, mask, nbr, w, bias)
    bound, by, bound32 = _bound(nbytes, flops)
    m, k = nbr.shape
    return dict(
        m=m, k=k, cin=w.shape[1], cout=w.shape[2], n=feats.shape[0],
        route=plan.route, tile=[plan.bm, plan.bn], splits=plan.splits,
        per_split=plan.per_split, hit_share=hits / (m * k),
        work_share=_work_share(mask, nbr, plan.bm), max_abs_err=err,
        max_abs_ref=scale, deterministic=True, ms=cuda_ms(run),
        plain_ms=cuda_ms(lambda: S._gather_matmul_conv_plain(
            feats, mask, nbr, w, bias)),
        library_ms=cuda_ms(lambda: padded[idx].reshape(-1, kcin) @ w2),
        bytes=nbytes, flops=flops, bound_ms=bound, bound_by=by,
        bound_fp32_ms=bound32)


def _wgrad_call(S, x, xm, idx, y, ym):
    """One K3 call: checked, then timed beside its plain version and the
    library product of x^T with the gathered y rows."""
    plan = S.cuda_wgrad_plan(x, idx, y)
    _, err, scale, counts = _check_wgrad(S, x, xm, idx, y, ym, 'main')
    r, k, cy = x.shape[0], idx.shape[1], y.shape[1]
    xs = torch.where(xm[:, None], x, torch.zeros_like(x))
    ypad = torch.cat([torch.where(ym[:, None], y, torch.zeros_like(y)),
                      y.new_zeros(1, cy)])
    gi = torch.where(idx >= 0, idx, torch.full_like(idx, y.shape[0])).long()
    nbytes, flops, hits = _wgrad_bound(x, xm, idx, y, ym)
    bound, by, bound32 = _bound(nbytes, flops)
    return dict(
        r=r, k=k, cx=x.shape[1], cy=cy, ny=y.shape[0], route=plan.route,
        tile=[plan.bm, plan.bn], chunks=plan.chunks,
        hit_share=hits / max(r * k, 1),
        work_share=_wgrad_work_share(S, plan, counts, r, k),
        max_abs_err=err, max_abs_ref=scale,
        deterministic=True, ms=cuda_ms(lambda: S.conv_wgrad(x, xm, idx, y,
                                                            ym)),
        plain_ms=cuda_ms(lambda: S._conv_wgrad_plain(x, xm, idx, y, ym)),
        library_ms=cuda_ms(lambda: xs.T @ ypad[gi].reshape(r, k * cy)),
        bytes=nbytes, flops=flops, bound_ms=bound, bound_by=by,
        bound_fp32_ms=bound32)


@torch.no_grad()
def phase_kernels(rec, train_rec, device, ground_rec, ground_train_rec):
    """Every recorded call of the serving requests (K2 forward, K1: the
    detector's and the grounder's warm-up requests), of the detector's
    warm-up step's backward (K2 dgrad, K3) and of the grounder's whole
    warm-up step (K1, K2 forward and dgrad, K3) on the card, one call's
    inputs on the device at a time; the profiler only after all timings.
    Each row names its path (det, grounding, train or ground_train)."""
    from embodiedscan_torch.ops import pscan as P
    from embodiedscan_torch.ops import sparse as S
    fwd = (('det', rec), ('grounding', ground_rec),
           ('ground_train', ground_train_rec))
    bwd = (('train', train_rec), ('ground_train', ground_train_rec))
    runs = {
        'sparse_conv': ([(p, a) for p, r in fwd for a in r.conv],
                        lambda a: S.gather_matmul_conv(*a)),
        'sparse_dgrad': ([(p, a) for p, r in bwd for a in r.dgrad],
                         lambda a: S.conv_dgrad(*a[:4])),
        'sparse_wgrad': ([(p, a) for p, r in bwd for a in r.wgrad],
                         lambda a: S.conv_wgrad(*a)),
        'join_scan': ([(p, a) for p, r in fwd for a in r.scan],
                      lambda a: P.join_scan(*a)),
    }
    calls = {name: [] for name in runs}
    for name, (recs, run) in runs.items():
        for path, args in recs:
            a = _on(args, device)
            if name == 'join_scan':
                row = _scan_call(P, *a, time_it=True)
            elif name == 'sparse_wgrad':
                row = _wgrad_call(S, *a)
            else:
                row = _conv_call(S, *a, name, lambda: run(a))
            row['path'] = path
            calls[name].append(row)
    # launches and device time per call, after every timing (see cuda_ms)
    for name, (recs, run) in runs.items():
        for row, (_, args) in zip(calls[name], recs):
            a = _on(args, device)
            row['cuda_launches'], row['device_ms'] = device_profile(
                lambda: run(a))
    for name, rows in calls.items():
        for path in sorted({r['path'] for r in rows}):
            rs = [r for r in rows if r['path'] == path]
            log(f'[kernels] {name} ({path}): {len(rs)} main-path calls '
                f'checked, kernel {sum(r["ms"] for r in rs):.3f} ms, plain '
                f'{sum(r["plain_ms"] for r in rs):.3f} ms, library '
                f'{sum(r["library_ms"] for r in rs):.3f} ms, bound '
                f'{sum(r["bound_ms"] for r in rs):.3f} ms per '
                f'{"request" if path in ("det", "grounding") else "step"}; '
                f'max|d| '
                f'{max(r["max_abs_err"] for r in rs)}; CUDA launches '
                f'{sum(r["cuda_launches"] for r in rs)}, device-only '
                f'{sum(r["device_ms"] for r in rs):.3f} ms')
    for name in ('sparse_conv', 'sparse_dgrad'):
        for r in calls[name]:
            log(f'[kernels] {name} ({r["path"]}) {r["m"]}x{r["k"]} '
                f'{r["cin"]}->{r["cout"]} '
                f'{r["route"]} {r["tile"][0]}x{r["tile"][1]} split '
                f'{r["splits"]}x{r["per_split"]}: {r["ms"]:.4f} ms (device '
                f'{r["device_ms"]:.4f}, bound {r["bound_ms"]:.4f}, fp32 '
                f'bound {r["bound_fp32_ms"]:.4f}, library '
                f'{r["library_ms"]:.4f}), hit {r["hit_share"]:.3f} work '
                f'{r["work_share"]:.3f}, launches {r["cuda_launches"]}, '
                f'max|d|/max|ref| '
                f'{r["max_abs_err"] / max(r["max_abs_ref"], 1e-30):.2e}')
    for r in calls['sparse_wgrad']:
        log(f'[kernels] sparse_wgrad ({r["path"]}) {r["r"]}x{r["k"]} '
            f'{r["cx"]}x{r["cy"]} '
            f'{r["route"]} {r["tile"][0]}x{r["tile"][1]} chunks '
            f'{r["chunks"]}: '
            f'{r["ms"]:.4f} ms (device {r["device_ms"]:.4f}, bound '
            f'{r["bound_ms"]:.4f}, fp32 bound {r["bound_fp32_ms"]:.4f}, '
            f'plain {r["plain_ms"]:.4f}, library {r["library_ms"]:.4f}), '
            f'hit {r["hit_share"]:.3f} work {r["work_share"]:.3f}, '
            f'launches {r["cuda_launches"]}, '
            f'max|d|/max|ref| '
            f'{r["max_abs_err"] / max(r["max_abs_ref"], 1e-30):.2e}')
    for r in calls['join_scan']:
        log(f'[kernels] join scan ({r["path"]}) n={r["n"]} k={r["k"]}: '
            f'{r["ms"]:.4f} ms (device {r["device_ms"]:.4f}, bound '
            f'{r["bound_ms"]:.4f}, library {r["library_ms"]:.4f}), launches '
            f'{r["cuda_launches"]}')
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


def _wgrad_case(g, r, ny, k, cx, cy, hit=0.3, device='cuda'):
    """Random K3 inputs: ~``hit`` of the (row, offset) pairs point at a y
    row, 10% of the x and y rows are masked."""
    x = torch.randn(r, cx, generator=g, device=device)
    xm = torch.rand(r, generator=g, device=device) > 0.1
    y = torch.randn(ny, cy, generator=g, device=device)
    ym = torch.rand(ny, generator=g, device=device) > 0.1
    idx = torch.randint(0, ny, (r, k), generator=g, device=device,
                        dtype=torch.int32)
    absent = torch.rand(r, k, generator=g, device=device) > hit
    return x, xm, torch.where(absent, torch.full_like(idx, -1), idx), y, ym


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
    # indices N, N + 5 and -7 read as absent on both routes, as in the
    # plain version and the reference (its zero pad row)
    for cin, route in ((64, 'tc'), (3, 'simt')):
        feats, mask, nbr, w, b = _conv_case(g, 2000, 1500, 27, cin, 128,
                                            device=device)
        n = feats.shape[0]
        nbr[0::3, 0], nbr[1::3, 5], nbr[2::3, 9] = n, n + 5, -7
        if S.cuda_plan(feats, nbr, w).route != route:
            raise RuntimeError(f'out_of_range: not the {route} route')
        got, _, scale = _check_conv(S, feats, mask, nbr, w, b,
                                    f'out_of_range_{route}')
        absent = torch.where((nbr >= 0) & (nbr < n), nbr,
                             torch.full_like(nbr, -1))
        want = S._gather_matmul_conv_plain(feats, mask, absent, w, b)
        if not float((got - want).abs().max()) <= CONV_GATE * scale:
            raise RuntimeError(f'out_of_range_{route}: not read as absent')
        checked.append(f'out_of_range N, N+5, -7 ({route})')
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
    # K3: every check of _check_wgrad (pair lists, gate, bits) on each case
    def wgrad(what, *shape, route, hit=0.3, edit=None):
        x, xm, idx, y, ym = _wgrad_case(g, *shape, hit=hit, device=device)
        if edit is not None:
            x, xm, idx, y, ym = edit(x, xm, idx, y, ym)
        plan = S.cuda_wgrad_plan(x, idx, y)
        if plan.route != route:
            raise RuntimeError(f'wgrad {what}: route {plan.route}, want '
                               f'{route}')
        got, err, scale, counts = _check_wgrad(S, x, xm, idx, y, ym, what)
        checked.append(f'wgrad {what} ({plan.route} {plan.bm}x{plan.bn}, '
                       f'chunks {plan.chunks}, max|d|/max|ref| '
                       f'{err / max(scale, 1e-30):.1e})')
        return got, counts, (x, xm, idx, y, ym)

    def set_counts(*x_):  # offsets 0-3 with 1, 31, 32 and 33 pairs
        x, xm, idx, y, ym = x_
        xm, ym = torch.ones_like(xm), torch.ones_like(ym)
        idx[:, :4] = -1
        for j, n in enumerate((1, 31, 32, 33)):
            idx[:n, j] = torch.arange(n, dtype=idx.dtype, device=device)
        return x, xm, idx, y, ym

    def empty_offset(*x_):
        x, xm, idx, y, ym = x_
        idx[:, 13] = -1
        return x, xm, idx, y, ym

    # the narrow route: C = 3 or 4 on either side
    wgrad('cy3', 5000, 6000, 27, 64, 3, route='narrow')
    wgrad('cx3', 6000, 5000, 27, 3, 64, route='narrow')
    wgrad('cy4', 5000, 6000, 27, 64, 4, route='narrow')
    wgrad('cx4', 6000, 5000, 27, 4, 64, route='narrow')
    # tensor cores: C of 8 and 12, channels that are not a multiple of the
    # tile, 128 to 1024, K = 1, ragged R and R = 1
    wgrad('c8', 3000, 3000, 27, 8, 8, route='tc')
    wgrad('c12x64', 3000, 3000, 27, 12, 64, route='tc')
    wgrad('c200x136', 3000, 3000, 27, 200, 136, route='tc')
    wgrad('k1', 9000, 9000, 1, 64, 128, route='tc')
    wgrad('ragged_r', 1001, 3000, 27, 64, 64, route='tc')
    wgrad('r1', 1, 3000, 27, 64, 64, route='tc', hit=1.0,
          edit=lambda x, xm, *rest: (x, torch.ones_like(xm), *rest))
    wgrad('c128', 8192, 8192, 27, 128, 128, route='tc')
    wgrad('c512', 2048, 2048, 27, 512, 512, route='tc')
    wgrad('c64x512', 4096, 2048, 27, 64, 512, route='tc')
    wgrad('c512x128', 2048, 4096, 27, 512, 128, route='tc')
    wgrad('c1024', 2048, 2048, 27, 1024, 1024, route='tc')
    _, counts, _ = wgrad('counts_1_31_32_33', 3000, 3000, 27, 64, 64,
                         route='tc', edit=set_counts)
    if counts[:4].tolist() != [1, 31, 32, 33]:
        raise RuntimeError(f'wgrad counts {counts[:4].tolist()}')
    _, counts, _ = wgrad('one_offset_empty', 3000, 3000, 27, 64, 64,
                         route='tc', edit=empty_offset)
    if int(counts[13]) != 0:
        raise RuntimeError('wgrad: offset 13 is not empty')
    for what, route, c in (('all_absent', 'tc', 128),
                           ('all_absent_narrow', 'narrow', 3),
                           ('all_masked_x', 'tc', 128),
                           ('all_masked_y', 'tc', 128)):
        def clear(x, xm, idx, y, ym, what=what):
            if what.startswith('all_absent'):
                idx = torch.full_like(idx, -1)
            elif what == 'all_masked_x':
                xm = torch.zeros_like(xm)
            else:
                ym = torch.zeros_like(ym)
            return x, xm, idx, y, ym
        got, counts, _ = wgrad(what, 2000, 1500, 27, 64, c, route=route,
                               edit=clear)
        if got.any() or counts.any():
            raise RuntimeError(f'sparse_wgrad {what}: output is not zero')
    # a view that is not 16-byte aligned takes the narrow route
    x, xm, idx, y, ym = _wgrad_case(g, 3000, 3000, 27, 64, 64, device=device)
    flat = torch.empty(x.numel() + 1, device=device)
    view = flat[1:].view_as(x).copy_(x)
    if S.cuda_wgrad_plan(view, idx, y).route != 'narrow':
        raise RuntimeError('wgrad: misaligned view did not take the narrow '
                           'route')
    _check_wgrad(S, view, xm, idx, y, ym, 'misaligned')
    checked.append('wgrad misaligned (narrow)')
    # many chunks against one: both within the gate, of each other too
    for what, c in (('tc', 64), ('narrow', 3)):
        x, xm, idx, y, ym = _wgrad_case(g, 8192, 8192, 27, 64, c,
                                        device=device)
        plan = S.cuda_wgrad_plan(x, idx, y)
        _, counts = S._wgrad_pairs_plain(xm, idx, ym)
        most = max(len(S.wgrad_chunk_bounds(n, plan.chunks))
                   for n in counts.tolist())
        if most < 4:
            raise RuntimeError(f'wgrad {what}: the chunked case fills '
                               f'{most} chunks')
        a, _, scale, _ = _check_wgrad(S, x, xm, idx, y, ym, 'chunks', plan)
        c1, _, _, _ = _check_wgrad(S, x, xm, idx, y, ym, 'one chunk',
                                   plan._replace(chunks=1))
        d = float((a - c1).abs().max())
        if not d <= SPLIT_GATE * scale:
            raise RuntimeError(f'wgrad {what} {plan.chunks} chunks vs one: '
                               f'max|d| {d} > {SPLIT_GATE} x {scale}')
        checked.append(f'wgrad {what} {plan.chunks} chunks (up to {most} '
                       f'filled) vs one (max|d|/max|ref| {d / scale:.2e})')
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
    log('[edges] kernel == plain (join scan bit-exact, sparse conv and '
        f'weight gradient within {CONV_GATE} x max|ref| and the same bits '
        'twice): ' +
        '; '.join(checked))


@torch.no_grad()
def phase_e2e_parity(device):
    """A small detector on ``device`` and on cpu with the same weights."""
    from embodiedscan_torch.configs.base import build_model
    cfg = _parity_cfg()
    cpu = build_model(cfg, device='cpu')
    with torch.no_grad():
        cpu.bbox_head.conv_cls.bias.zero_()
    gpu = build_model(cfg, device=device)
    gpu.load_state_dict(cpu.state_dict())
    det_parity(cpu, gpu, make_request(p=6000, v=4, hw=96, seed=7), device,
               'cpu vs cuda')


def det_parity(cpu, gpu, req, device, what):
    """One request of a detector on cpu (plain versions) and its twin on
    ``device`` (kernels): neighbor tables, feature coordinates and masks,
    labels and keep masks identical; head outputs, boxes and scores within
    atol 1e-4 + rtol 1e-5."""
    from embodiedscan_torch.ops import pscan as P
    from embodiedscan_torch.ops import sparse as S
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
    if not pc['mask'].any():
        raise RuntimeError(f'{what}: no detection kept')
    log(f'[parity] {what}: {len(rc.conv)} neighbor tables identical, '
        f'labels/masks identical, kept {int(pc["mask"].sum())}, '
        f'worst float |d| - tol {worst:.3g}')


def _close(a, b, what):
    tol = 1e-4 + 1e-5 * b.abs()
    excess = float(((a - b).abs() - tol).max())
    if excess > 0:
        raise RuntimeError(f'{what}: cpu and cuda differ beyond tolerance '
                           f'(max excess {excess})')
    return excess


def _parity_cfg():
    """The small mv_det3d of the parity phases: shipped depths and widths,
    capacities cut for a 6000-point scene."""
    from embodiedscan_torch.configs.base import mv_det3d
    cfg = mv_det3d()
    m = cfg.model
    m.num_classes, m.voxel_size, m.input_capacity = 18, 0.04, 4096
    m.backbone_capacities = (4096, 2048, 2048, 1024, 512, 256)
    m.fpn_capacities = (1024, 512, 256, 128)
    m.nms_pre, m.max_candidates, m.max_dets = 128, 128, 32
    return cfg


def train_parity(device):
    """One train step of the small detector on ``device`` (kernels) and on
    cpu (plain versions) from the same weights and batch. Raises unless the
    integer tables are identical; returns the cpu and cuda metrics and, per
    kind (losses, grads, batch stats), the worst max|d|/max|cpu| over its
    leaves with that leaf's path."""
    from embodiedscan_torch.configs.base import build_model
    from embodiedscan_torch.ops import pscan as P
    from embodiedscan_torch.ops import sparse as S
    from embodiedscan_torch.train.state import make_optimizer, train_step
    from embodiedscan_torch.utils.convert_weights import export_jax_tree
    cfg = _parity_cfg()
    cpu = build_model(cfg, device='cpu').train()
    gpu = build_model(cfg, device=device).train()
    gpu.load_state_dict(cpu.state_dict())
    batch = make_batch(1, 6000, 4, 96, 16, cfg.model.num_classes, seed=7)
    out = {}
    for name, model, dev in (('cpu', cpu, 'cpu'), ('cuda', gpu, device)):
        with Recorder(S, P) as rec:
            metrics = train_step(model, make_optimizer(model, cfg),
                                 to_device(batch, dev))
        out[name] = (rec, {k: float(v) for k, v in metrics.items()},
                     export_jax_tree(model, 'grads'),
                     export_jax_tree(model, 'buffers'))
    (rc, mc, gc, bc), (rg, mg, gg, bg) = out['cpu'], out['cuda']
    tables = [(a[2], b[2]) for kind in ('conv', 'dgrad', 'wgrad')
              for a, b in zip(getattr(rc, kind), getattr(rg, kind))]
    if any(len(getattr(rc, k)) != len(getattr(rg, k)) or not getattr(rc, k)
           for k in ('conv', 'dgrad', 'wgrad')):
        raise RuntimeError('cpu and cuda train steps made different calls')
    for a, b in tables:
        if not torch.equal(a, b.cpu()):
            raise RuntimeError('train step tables differ between cpu and '
                               'cuda')
    worst = {what: _worst({'/'.join(k): v for k, v in _tree_leaves(c)},
                          {'/'.join(k): v for k, v in _tree_leaves(g)})
             for what, c, g in (('losses', mc, mg), ('grads', gc, gg),
                                ('batch stats', bc, bg))}
    return len(tables), mc, mg, worst


def _worst(cpu, cuda, scales=None):
    """(the worst max|cuda - cpu| / scale over the leaves of two flat dicts
    of arrays or tensors, that leaf's key); the scale is ``scales[key]``
    or max|cpu|; a non-finite ratio is the worst."""
    worst = (0.0, '')
    for key, a in cpu.items():
        a, b = np.asarray(a), np.asarray(cuda[key])
        scale = max(scales[key] if scales else float(np.abs(a).max()), 1e-30)
        ratio = float(np.abs(a - b).max()) / scale
        if not np.isfinite(ratio) or ratio >= worst[0]:
            worst = (ratio, key)
    return worst


def phase_train_parity(device):
    """:func:`train_parity`: losses, every gradient leaf the optimizer used
    and the batch statistics after the step within GRAD_GATE x max|cpu| of
    each leaf."""
    n_tables, mc, mg, worst = train_parity(device)
    for what, (ratio, path) in worst.items():
        if not np.isfinite(ratio) or ratio > GRAD_GATE:
            raise RuntimeError(f'train step {what} {path}: max|d|/max|cpu| '
                               f'{ratio} > {GRAD_GATE}')
    log(f'[parity] train step cpu vs cuda: {n_tables} tables identical '
        f'(forward, dgrad, wgrad), loss_total {mc["loss_total"]:.6g} vs '
        f'{mg["loss_total"]:.6g}; worst max|d|/max|cpu| per leaf: ' +
        ', '.join(f'{k} {v:.2e} ({p})' for k, (v, p) in worst.items()) +
        f' (gate {GRAD_GATE})')


LOSS_RTOL = 1e-5  # grounding train step cpu vs cuda: each loss
# A gradient leaf five orders below the largest of its block (the module
# holding its layer: an attention, a position embedding) is rounding
# residue: an attention's key bias and a position embedding's bias before
# its batch-statistics norm are zero in exact arithmetic, and the random
# RoBERTa's output tokens nearly coincide (spread ~1e-4 of their size),
# which leaves the text attention's query and key gradients near zero.
# Such a leaf is held to GRAD_GATE x its block's max|cpu|.
RESIDUE = 1e-5


def _gate_scales(grads):
    """Each gradient leaf's scale for the gate: its max|cpu|, or its
    block's where that is RESIDUE times larger (see RESIDUE)."""
    block = {}
    for name, g in grads.items():
        key = name.rsplit('.', 2)[0]
        block[key] = max(block.get(key, 0.0), float(g.abs().max()))
    scales = {}
    for name, g in grads.items():
        own, top = float(g.abs().max()), block[name.rsplit('.', 2)[0]]
        scales[name] = top if own < RESIDUE * top else own
    return scales


# A ReLU's gradient jumps where its input crosses 0. The card and the cpu
# compute the forward in another order, so a unit whose input lies within
# rounding of 0 can switch on one side only: in the small grounder's step
# the card's text and neck outputs differ from the cpu's by ~1.5e-5 and
# switch one of 524,288 units of a decoder FFN, which moves that layer's
# fc1 gradient by 6.7e-2 of its max (on the cpu alone, moving the neck
# output by 1e-6 of its size moves it by 3.5e-4). As with the matched
# indices, the cpu step takes the card's decisions: where the two differ,
# the cpu's input must be within FLIP_ATOL x max|input| of 0.
FLIP_ATOL = 1e-4


@contextlib.contextmanager
def _relu_decisions(follow=None):
    """While active, every ``F.relu`` logs its decisions (input > 0) into
    the yielded ``decisions`` list; with ``follow`` (another run's list),
    call k returns ``x * follow[k]``: that run's decisions on this run's
    values (the same values and gradients wherever the two agree). Each
    differing decision must be a tie within FLIP_ATOL x max|x|; ``flips``
    collects (call, count, worst |x| / max|x|)."""
    functional = torch.nn.functional
    relu = functional.relu
    decisions, flips = [], []

    def patched(x, inplace=False):
        mine = x > 0
        decisions.append(mine.cpu())
        if follow is None:
            return relu(x, inplace=inplace)
        want = follow[len(decisions) - 1].to(x.device)
        diff = want != mine
        if diff.any():
            size = x.detach().abs()
            worst = float(size[diff].max()) / max(float(size.max()), 1e-30)
            if not worst <= FLIP_ATOL:
                raise RuntimeError(f'relu call {len(decisions) - 1}: '
                                   f'{int(diff.sum())} decisions differ, '
                                   f'|x| up to {worst:.3g} x max|x|')
            flips.append((len(decisions) - 1, int(diff.sum()), worst))
        return x * want.to(x.dtype)

    functional.relu = patched
    try:
        yield decisions, flips
    finally:
        functional.relu = relu


def _ground_step(model, cfg, batch, dev, follow=None):
    """One train step of a grounder with the task's lr multipliers, its
    ReLUs logged or following ``follow`` (:func:`_relu_decisions`): the
    recorder, the losses, the gradients, the buffers after the step, the
    matched gt indices, the ReLU decisions and the flips."""
    from embodiedscan_torch.ops import pscan as P
    from embodiedscan_torch.ops import sparse as S
    from embodiedscan_torch.train.loop import lr_mult_fn_for
    from embodiedscan_torch.train.state import make_optimizer, train_step
    opt = make_optimizer(model, cfg, lr_mult_fn_for(cfg.model.task))
    seen = []
    match = model.match
    model.match = lambda *a: seen.append(match(*a)) or seen[-1]
    try:
        with Recorder(S, P) as rec, _relu_decisions(follow) as (dec, flips):
            metrics = train_step(model, opt, to_device(batch, dev))
    finally:
        del model.match  # back to the class's method
    return (rec, {k: float(v) for k, v in metrics.items()},
            {n: p.grad.cpu() for n, p in model.named_parameters()
             if p.grad is not None},
            {n: b.cpu() for n, b in model.named_buffers()}, seen[0].cpu(),
            dec, flips)


def phase_ground_train_parity(device):
    """One train step of the small grounder (``_ground_parity_cfg``: the
    shipped widths, RoBERTa-base) with the task's lr multipliers on
    ``device`` (kernels), then on cpu (plain versions) taking the card's
    ReLU decisions (``_relu_decisions``), from the same weights and batch:
    every conv, dgrad and wgrad table and every layer's matched gt indices
    identical, each loss within LOSS_RTOL of the cpu's, every gradient leaf
    within GRAD_GATE x its scale (``_gate_scales``) and every batch
    statistic within GRAD_GATE x its max|cpu|."""
    from embodiedscan_torch.configs.base import build_model
    cfg = _ground_parity_cfg()
    cpu = _box_branch(build_model(cfg, device='cpu'), 7).train()
    gpu = build_model(cfg, device=device).train()
    gpu.load_state_dict(cpu.state_dict())
    batch = make_ground_train_batch(cfg, 6000, 4, 96, seed=7)
    rg, mg, gg, bg, ig, dec, _ = _ground_step(gpu, cfg, batch, device)
    rc, mc, gc, bc, ic, _, flips = _ground_step(cpu, cfg, batch, 'cpu', dec)
    kinds = ('conv', 'dgrad', 'wgrad')
    if any(len(getattr(rc, k)) != len(getattr(rg, k)) or not getattr(rc, k)
           for k in kinds):
        raise RuntimeError('cpu and cuda grounding train steps made '
                           'different calls')
    tables = [(a[2], b[2]) for k in kinds
              for a, b in zip(getattr(rc, k), getattr(rg, k))]
    if not all(torch.equal(a, b.cpu()) for a, b in tables):
        raise RuntimeError('grounding train step tables differ between cpu '
                           'and cuda')
    if not torch.equal(ic, ig):
        raise RuntimeError('grounding train step: matched gt indices differ '
                           'between cpu and cuda')
    loss_err = max(abs(mg[k] - v) / abs(v) for k, v in mc.items())
    if not loss_err <= LOSS_RTOL:
        raise RuntimeError(f'grounding train step losses: {mc} vs {mg}')
    if set(gc) != set(gg):
        raise RuntimeError('cpu and cuda grounders have gradients for '
                           'different parameters')
    scales = _gate_scales(gc)
    residue = sorted(n for n, v in scales.items()
                     if v > float(gc[n].abs().max()))
    worst = {'grads': _worst(gc, gg, scales), 'batch stats': _worst(bc, bg)}
    for what, (ratio, key) in worst.items():
        if not np.isfinite(ratio) or ratio > GRAD_GATE:
            raise RuntimeError(f'grounding train step {what} {key}: '
                               f'max|d|/scale {ratio} > {GRAD_GATE}')
    log(f'[parity] grounding train step cpu vs cuda: {len(tables)} tables '
        f'and the matched gt indices of {ic.shape[0]} layers identical '
        f'({int((ic >= 0).sum())} matches), losses within {loss_err:.2e} '
        f'relative (gate {LOSS_RTOL}), loss_total {mc["loss_total"]:.6g}; '
        f'{sum(n for _, n, _ in flips)} of the cpu\'s ReLU decisions in '
        f'{len(flips)} of {len(dec)} calls took the card\'s, each a tie '
        f'within {max([w for _, _, w in flips], default=0):.2e} x max|x| '
        f'(gate {FLIP_ATOL}); worst max|d|/scale over {len(gc)} gradient '
        f'leaves and the batch statistics: ' +
        ', '.join(f'{k} {v:.2e} ({p})' for k, (v, p) in worst.items()) +
        f' (gate {GRAD_GATE}); {len(residue)} residue leaves on their '
        f'block\'s scale ({", ".join(residue[:4])}, ...)')
    return dict(worst=worst, flips=flips, loss_rel=loss_err)


def _tree_leaves(tree, prefix=()):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _tree_leaves(val, prefix + (key,))
        else:
            yield prefix + (key,), val


def _box_branch(model, seed):
    """A checkpoint's box branch: the output layer of ``reg_branch``, zero
    at init, drawn N(0, 0.01) from ``seed`` so the boxes follow the
    queries."""
    from embodiedscan_torch.utils.convert_weights import load_jax_variables
    shape = tuple(model.reg_branch.out.weight.shape[::-1])
    kernel = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    load_jax_variables(model, {'reg_branch': {'out': {
        'kernel': kernel * 0.01}}}, strict=False)
    return model


def phase_ckpt(device, sds, card):
    """The published-checkpoint path at full width, in a temporary
    directory: each preset's reference state_dict (``sds``) is saved as a
    ``.pth``, converted by the CLI's ``main`` in-process on ``device``
    (tensors loaded, skips: none for the detector, only the word
    embedding for the grounder), restored into a fresh ``build_model``
    (bit-identical to the converted model), and both serve one request
    with the same bits and the launch counts of the main paths (the
    grounder's prompt tokenized by BPETokenizer)."""
    import tempfile
    from embodiedscan_torch.configs.base import PRESETS, build_model
    from embodiedscan_torch.models.text import BPETokenizer
    from embodiedscan_torch.ops import pscan as P
    from embodiedscan_torch.ops import sparse as S
    from embodiedscan_torch.tools import convert_checkpoint as cli
    from embodiedscan_torch.train.checkpoint import CheckpointManager
    stats = {}
    with tempfile.TemporaryDirectory() as tmp:
        for task, want_skip, want in (
                ('mv_det3d', [], EXPECTED_LAUNCHES),
                ('mv_grounding', [WORD_EMBEDDING], EXPECTED_GROUND_LAUNCHES)):
            cfg = PRESETS[task]()
            pth = os.path.join(tmp, f'{task}.pth')
            torch.save({'state_dict': {k: torch.from_numpy(v)
                                       for k, v in sds[task].items()},
                        'meta': {'seed': 0}}, pth)
            work = os.path.join(tmp, task)
            t0 = time.perf_counter()
            model, n, skipped = cli.main([task, pth, '--work-dir', work,
                                          '--device', device])
            torch.cuda.synchronize()
            convert_s = time.perf_counter() - t0
            total = sum(1 for _ in model.parameters()) + \
                sum(1 for _ in model.buffers())
            if skipped != want_skip or n != total - len(skipped):
                raise RuntimeError(f'[ckpt] {task}: loaded {n} of {total} '
                                   f'tensors, skipped {skipped}')
            ckpt_mb = os.path.getsize(os.path.join(
                work, 'checkpoints', '0.pt')) / 2**20
            t0 = time.perf_counter()
            restored = build_model(cfg, device=device)
            t1 = time.perf_counter()
            step = CheckpointManager(work).restore(restored)
            torch.cuda.synchronize()
            build_s, restore_s = t1 - t0, time.perf_counter() - t1
            a, b = model.state_dict(), restored.state_dict()
            if step != 0 or a.keys() != b.keys() or not all(
                    torch.equal(a[k], b[k]) for k in a):
                raise RuntimeError(f'[ckpt] {task}: the restored model '
                                   'differs from the converted one')
            d, m = cfg.data, cfg.model
            req = make_request(d.n_points, d.n_views_test, d.image_hw[0], 5)
            if task == 'mv_grounding':
                enc = BPETokenizer(ROBERTA_TOK, m.max_text_len)([PROMPTS[1]])
                req.update(text_ids=enc['input_ids'],
                           text_mask=enc['attention_mask'])
            batch = to_device(req, device)
            preds, ms = {}, {}
            for name, net in (('converted', model), ('restored', restored)):
                torch.cuda.synchronize()
                reset_counts(S, P)
                t0 = time.perf_counter()
                preds[name] = net(batch, mode='predict')
                torch.cuda.synchronize()
                ms[name] = (time.perf_counter() - t0) * 1e3
                counts = read_counts(S, P)
                check_counts(counts, want, f'[ckpt] {task} {name} request')
            for key, val in preds['converted'].items():
                if val.is_floating_point() and not torch.isfinite(val).all():
                    raise RuntimeError(f'[ckpt] {task}: non-finite {key}')
                if not torch.equal(val, preds['restored'][key]):
                    raise RuntimeError(f'[ckpt] {task}: {key} differs '
                                       'between converted and restored')
            kept = int(preds['converted']['mask'].sum())
            log(f'[ckpt] {task}: converted in {convert_s:.2f} s (CLI main: '
                f'load .pth, build, convert, save), {n} of {total} tensors '
                f'loaded, skipped {skipped}; checkpoint {ckpt_mb:.1f} MB; '
                f'restored in {restore_s:.2f} s (+ build_model '
                f'{build_s:.2f} s), bit-identical; request ms converted '
                f'{ms["converted"]:.1f}, restored {ms["restored"]:.1f}, '
                f'same bits, {kept} kept, launches {counts}; {card}')
            stats[task] = dict(convert_s=convert_s, n_loaded=n,
                               tensors=total, skipped=skipped,
                               checkpoint_mb=ckpt_mb, build_s=build_s,
                               restore_s=restore_s, request_ms=ms,
                               kept=kept)
            del model, restored, a, b, preds, batch
            torch.cuda.empty_cache()
    return stats


# --- reference checkpoints: seeded state_dicts in the reference's layout ---


def _ref_channels(resnet_depth, mink_depth):
    """Per-level channels of the fused trunk: MinkResNet's 64 x 2^i plus
    the 16-wide 2D ResNet's 16 x 2^i, each x4 at bottleneck depths."""
    e3 = 4 if mink_depth >= 50 else 1
    e2 = 4 if resnet_depth >= 50 else 1
    return tuple(64 * 2**i * e3 + 16 * 2**i * e2 for i in range(4))


class _RefSD(dict):
    """A reference-layout state_dict under construction: float32 arrays
    drawn from one seeded generator."""

    def __init__(self, seed):
        super().__init__()
        self.rng = np.random.default_rng(seed)

    def normal(self, key, shape, std):
        self[key] = self.rng.standard_normal(shape, dtype=np.float32) * \
            np.float32(std)

    def bn(self, name, c, tracked=False):
        """BatchNorm statistics and affine (``num_batches_tracked`` as
        torchvision writes it)."""
        self[f'{name}.weight'] = self.rng.uniform(0.5, 1.5, c).astype(
            np.float32)
        self.normal(f'{name}.bias', (c,), 0.1)
        self.normal(f'{name}.running_mean', (c,), 0.1)
        self[f'{name}.running_var'] = self.rng.uniform(0.5, 2.0, c).astype(
            np.float32)
        if tracked:
            self[f'{name}.num_batches_tracked'] = np.array(7, np.int64)

    def linear(self, name, cin, cout, std=None, bias=True):
        """torch Linear: weight (out, in), bias (out,)."""
        self.normal(f'{name}.weight', (cout, cin),
                    std if std is not None else cin ** -0.5)
        if bias:
            self.normal(f'{name}.bias', (cout,), 0.02)

    def me_conv(self, name, k, cin, cout):
        """ME kernel (K, Cin, Cout), (Cin, Cout) at kernel volume 1."""
        shape = (cin, cout) if k == 1 else (k, cin, cout)
        self.normal(f'{name}.kernel', shape, (2.0 / (k * cout)) ** 0.5)


def _ref_resnet2d(sd, depth, base=16):
    """torchvision ResNet names under ``backbone.``."""
    blocks = {18: (2, 2, 2, 2), 34: (3, 4, 6, 3), 50: (3, 4, 6, 3)}[depth]
    bottleneck = depth >= 50

    def conv(name, cout, cin, k):
        sd.normal(f'backbone.{name}.weight', (cout, cin, k, k),
                  (1.0 / (cin * k * k)) ** 0.5)

    conv('conv1', base, 3, 7)
    sd.bn('backbone.bn1', base, tracked=True)
    cin = base
    for i, n in enumerate(blocks):
        planes = base * 2**i
        cout = planes * (4 if bottleneck else 1)
        for j in range(n):
            p = f'layer{i + 1}.{j}'
            shapes = ((planes, cin, 1), (planes, planes, 3),
                      (cout, planes, 1)) if bottleneck else \
                ((planes, cin, 3), (planes, planes, 3))
            for c, (o, ci, k) in enumerate(shapes):
                conv(f'{p}.conv{c + 1}', o, ci, k)
                sd.bn(f'backbone.{p}.bn{c + 1}', o, tracked=True)
            if j == 0 and (i > 0 or cin != cout):
                conv(f'{p}.downsample.0', cout, cin, 1)
                sd.bn(f'backbone.{p}.downsample.1', cout, tracked=True)
            cin = cout


def _ref_mink(sd, depth):
    """ME MinkResNet (basic blocks) names under ``backbone_3d.``: ME row
    order, the K = 1 downsample as a (Cin, Cout) matrix, BatchNorm wrapped
    as ``norm.bn.*``."""
    blocks = {18: (2, 2, 2, 2), 34: (3, 4, 6, 3)}[depth]
    p = 'backbone_3d.'
    sd.me_conv(p + 'conv1', 27, 3, 64)
    sd[p + 'norm1.inst_norm.weight'] = sd.rng.uniform(0.5, 1.5, 64).astype(
        np.float32)
    sd.normal(p + 'norm1.inst_norm.bias', (64,), 0.1)
    cin = 64
    for i, n in enumerate(blocks):
        planes = 64 * 2**i
        for j in range(n):
            q = f'{p}layer{i + 1}.{j}'
            sd.me_conv(f'{q}.conv1', 27, cin if j == 0 else planes, planes)
            sd.me_conv(f'{q}.conv2', 27, planes, planes)
            sd.bn(f'{q}.norm1.bn', planes)
            sd.bn(f'{q}.norm2.bn', planes)
            if j == 0:
                sd.me_conv(f'{q}.downsample.0', 1, cin, planes)
                sd.bn(f'{q}.downsample.1.bn', planes)
        cin = planes


def _ref_fpn(sd, prefix, chans, out):
    """The up and out blocks shared by the FCAF3D head and MinkNeck: the
    generative transpose (8, C_{i+1}, C_i), its conv, their norms."""
    for i in range(1, len(chans)):
        sd.me_conv(f'{prefix}up_block_{i}.0', 8, chans[i], chans[i - 1])
        sd.bn(f'{prefix}up_block_{i}.1.bn', chans[i - 1])
        sd.me_conv(f'{prefix}up_block_{i}.3', 27, chans[i - 1], chans[i - 1])
        sd.bn(f'{prefix}up_block_{i}.4.bn', chans[i - 1])
    for i, c in enumerate(chans):
        sd.me_conv(f'{prefix}out_block_{i}.0', 27, c, out)
        sd.bn(f'{prefix}out_block_{i}.1.bn', out)


def _ref_mha(sd, name, e):
    sd.normal(f'{name}.attn.in_proj_weight', (3 * e, e), e ** -0.5)
    sd.normal(f'{name}.attn.in_proj_bias', (3 * e,), 0.02)
    sd.linear(f'{name}.attn.out_proj', e, e)


def _ref_ln(sd, name, c):
    sd[f'{name}.weight'] = sd.rng.uniform(0.8, 1.2, c).astype(np.float32)
    sd.normal(f'{name}.bias', (c,), 0.02)


def _ref_roberta(sd, hidden, layers, vocab):
    """HF RobertaModel names under ``text_encoder.`` (no pooler), weights
    N(0, 0.02) as HF initializes them."""
    p = 'text_encoder.'
    sd.normal(p + 'embeddings.word_embeddings.weight', (vocab, hidden), 0.02)
    sd.normal(p + 'embeddings.position_embeddings.weight', (514, hidden),
              0.02)
    sd.normal(p + 'embeddings.token_type_embeddings.weight', (1, hidden),
              0.02)
    _ref_ln(sd, p + 'embeddings.LayerNorm', hidden)
    for i in range(layers):
        q = f'{p}encoder.layer.{i}.'
        for name in ('query', 'key', 'value'):
            sd.linear(f'{q}attention.self.{name}', hidden, hidden, 0.02)
        sd.linear(q + 'attention.output.dense', hidden, hidden, 0.02)
        _ref_ln(sd, q + 'attention.output.LayerNorm', hidden)
        sd.linear(q + 'intermediate.dense', hidden, 4 * hidden, 0.02)
        sd.linear(q + 'output.dense', 4 * hidden, hidden, 0.02)
        _ref_ln(sd, q + 'output.LayerNorm', hidden)


def reference_state_dict(task, seed=0, num_classes=284, resnet_depth=50,
                         mink_depth=34, embed_dims=256, decoder_layers=6,
                         text_hidden=768, text_layers=12, vocab=50265):
    """A seeded state_dict (numpy float32) in the layout of a published
    EmbodiedScan checkpoint of ``task``, at the given widths (the
    defaults are the ``mv_det3d`` / ``mv_grounding`` presets' and
    roberta-base's 50265-token vocabulary): ``backbone.*`` (torchvision
    ResNet, 16 wide), ``backbone_3d.*`` (ME MinkResNet), then the
    detector's ``bbox_head.*`` (FCAF3D, 128 wide) or the grounder's
    ``neck_3d.*``, ``text_encoder.*``, ``text_feat_map.*``, ``decoder.*``
    and the shared head branches ``bbox_head.{reg,cls}_branches.0``."""
    sd = _RefSD(seed)
    _ref_resnet2d(sd, resnet_depth)
    _ref_mink(sd, mink_depth)
    chans = _ref_channels(resnet_depth, mink_depth)
    if task == 'mv_det3d':
        _ref_fpn(sd, 'bbox_head.', chans, 128)
        sd.normal('bbox_head.conv_center.kernel', (128, 1), 0.01)
        sd.normal('bbox_head.conv_reg.kernel', (128, 12), 0.01)
        sd.normal('bbox_head.conv_cls.kernel', (128, num_classes), 0.01)
        # a zero class bias: candidates clear score_thr, NMS has work
        sd['bbox_head.conv_cls.bias'] = np.zeros((1, num_classes),
                                                 np.float32)
        for i in range(4):
            sd[f'bbox_head.scales.{i}.scale'] = np.array(1.0 + 0.1 * i,
                                                         np.float32)
        return dict(sd)
    e = embed_dims
    _ref_fpn(sd, 'neck_3d.', chans, e)
    sd.normal('neck_3d.conv_cls.kernel', (e, 1), 0.01)
    sd.normal('neck_3d.conv_cls.bias', (1, 1), 0.01)
    _ref_roberta(sd, text_hidden, text_layers, vocab)
    sd.linear('text_feat_map', text_hidden, e)
    for i in range(decoder_layers):
        q = f'decoder.layers.{i}.'
        for name in ('self_attn', 'cross_attn_text', 'cross_attn'):
            _ref_mha(sd, q + name, e)
        sd.linear(q + 'ffn.layers.0.0', e, 2048, (2.0 / e) ** 0.5)
        sd.linear(q + 'ffn.layers.1', 2048, e, 2048 ** -0.5)
        for n in range(4):
            _ref_ln(sd, f'{q}norms.{n}', e)
    for name, cin in (('self_posembed', 9), ('cross_posembed', 3)):
        h = f'decoder.{name}.position_embedding_head'
        sd.normal(f'{h}.0.weight', (e, cin, 1), cin ** -0.5)
        sd.normal(f'{h}.0.bias', (e,), 0.02)
        sd.bn(f'{h}.1', e)
        sd.normal(f'{h}.3.weight', (e, e, 1), e ** -0.5)
        sd.normal(f'{h}.3.bias', (e,), 0.02)
    _ref_ln(sd, 'decoder.norm', e)
    sd.linear('bbox_head.reg_branches.0.0', e, e)
    sd.linear('bbox_head.reg_branches.0.2', e, e)
    # the boxes follow the queries: small log sizes and angles
    sd.linear('bbox_head.reg_branches.0.4', e, 9, 0.01)
    sd['bbox_head.cls_branches.0.bias'] = np.array([0.1], np.float32)
    return dict(sd)


def eval_records(det_preds, ground_preds):
    """The two metrics' gt / dt records from the served predictions, through
    ``train.loop._append_scene_results``. Detection GT per request: 16
    boxes drawn as ``make_batch`` draws them and 8 kept detections moved by
    N(0, 5 cm) with their labels. Grounding GT: one box per prompt, the
    third-best query moved by N(0, 5 mm) for even requests, a drawn box
    for odd ones; bucket flags vary."""
    from embodiedscan_torch.configs.base import mv_det3d, mv_grounding
    from embodiedscan_torch.train.loop import _append_scene_results
    det, ground = ([], []), ([], [])
    num_classes = mv_det3d().model.num_classes
    for i, preds in enumerate(det_preds):
        rng = np.random.RandomState(100 + i)
        keep = preds['mask'][0].cpu().numpy()
        kb = preds['bboxes'][0].cpu().numpy()[keep][:8]
        kl = preds['labels'][0].cpu().numpy()[keep][:8]
        boxes = np.concatenate([gt_boxes(rng, 1, 16)[0],
                                kb + rng.normal(0, 0.05, kb.shape)])
        labels = np.concatenate([rng.randint(0, num_classes, 16), kl])
        _append_scene_results(mv_det3d(), dict(
            gt_boxes=boxes[None].astype(np.float32),
            gt_labels=labels[None].astype(np.int32),
            gt_mask=np.ones((1, len(boxes)), bool)), preds, 1, *det, i)
    for i, preds in enumerate(ground_preds):
        rng = np.random.RandomState(200 + i)
        if i % 2 == 0:
            order = np.argsort(-preds['scores'][0].cpu().numpy())
            box = preds['bboxes'][0, order[2]].cpu().numpy() + rng.normal(
                0, 0.005, 9)
        else:
            box = gt_boxes(rng, 1, 1)[0, 0]
        _append_scene_results(mv_grounding(), dict(
            gt_boxes=box[None, None].astype(np.float32),
            gt_mask=np.ones((1, 1), bool), is_view_dep=np.array([i < 2]),
            is_hard=np.array([i == 1]), is_unique=np.array([i != 2])),
            preds, 1, *ground, i)
    return det, ground


def phase_eval(det_preds, ground_preds, device):
    """``indoor_eval`` over the detector's timed requests and ``ground_eval``
    over the grounder's (``eval_records``), each with the IoU on the card
    (after one warm-up evaluation) and on the cpu: same keys, values within
    EVAL_GATE."""
    from embodiedscan_torch.eval.grounding_metric import ground_eval
    from embodiedscan_torch.eval.indoor_eval import indoor_eval
    (gts, dts), (ggts, gdts) = eval_records(det_preds, ground_preds)
    indoor_eval(gts, dts, verbose=False, device=device)
    out, ms = {}, {}
    for dev in (device, 'cpu'):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out[dev, 'det'] = indoor_eval(gts, dts, verbose=False, device=dev)
        t1 = time.perf_counter()
        out[dev, 'ground'] = ground_eval(ggts, gdts, device=dev)
        t2 = time.perf_counter()
        ms[dev] = dict(indoor_eval=(t1 - t0) * 1e3,
                       ground_eval=(t2 - t1) * 1e3)
    worst = 0.0
    for what in ('det', 'ground'):
        a, b = out[device, what], out['cpu', what]
        if set(a) != set(b):
            raise RuntimeError(f'{what} eval: keys differ between the card '
                               'and the cpu')
        worst = max([worst] + [abs(a[k] - b[k]) for k in a])
    if not worst <= EVAL_GATE:
        raise RuntimeError(f'eval: card and cpu metrics differ by {worst}')
    det, grd = out[device, 'det'], out[device, 'ground']
    if not det['mAP_0.25'] > 0 or not grd['Overall@0.25'] > 0:
        raise RuntimeError(f'eval: no hit (mAP_0.25 {det["mAP_0.25"]}, '
                           f'Overall@0.25 {grd["Overall@0.25"]})')
    log(f'[eval] indoor_eval over {len(gts)} scenes '
        f'({sum(len(d["scores"]) for d in dts)} detections, '
        f'{sum(len(g["gt_labels"]) for g in gts)} GT): mAP_0.25 '
        f'{det["mAP_0.25"]:.4f} mAR_0.25 {det["mAR_0.25"]:.4f} mAP_0.50 '
        f'{det["mAP_0.50"]:.4f}; ground_eval over {len(ggts)} prompts: '
        f'Overall@0.25 {grd["Overall@0.25"]:.4f} Overall@0.5 '
        f'{grd["Overall@0.5"]:.4f}; card vs cpu max|d| {worst} (gate '
        f'{EVAL_GATE}); ms on the card {ms[device]}, with the IoU on the '
        f'cpu {ms["cpu"]}')
    return dict(det=det, ground=grd, ms=ms, max_abs_diff=worst)


def _ground_parity_cfg():
    """The small mv_grounding of the parity phase: shipped widths and depths
    (RoBERTa-base, 256 queries, 6 decoder layers), trunk and neck
    capacities as ``_parity_cfg``'s for a 6000-point scene."""
    from embodiedscan_torch.configs.base import mv_grounding
    cfg = mv_grounding()
    small = _parity_cfg().model
    for key in ('voxel_size', 'input_capacity', 'backbone_capacities',
                'fpn_capacities'):
        setattr(cfg.model, key, getattr(small, key))
    return cfg


@torch.no_grad()
def phase_ground_parity(device):
    """The small grounder on ``device`` (kernels) and on cpu (plain
    versions) with the same weights."""
    from embodiedscan_torch.configs.base import build_model
    cfg = _ground_parity_cfg()
    cpu = _box_branch(build_model(cfg, device='cpu'), 7)
    gpu = build_model(cfg, device=device)
    gpu.load_state_dict(cpu.state_dict())
    ground_parity(cpu, gpu, make_ground_request(
        cfg.model.max_text_len, seed=7, p=6000, v=4, hw=96), device,
        'grounder cpu vs cuda')


def ground_parity(cpu, gpu, req, device, what):
    """One request of a grounder on cpu and its twin on ``device``:
    neighbor tables, neck coordinates and masks, selected query indices and
    query masks identical; neck features and scores, per-layer token logits
    and boxes, and the predictions within atol 1e-4 + rtol 1e-5."""
    from embodiedscan_torch.ops import pscan as P
    from embodiedscan_torch.ops import sparse as S
    out = {}
    for name, model, dev in (('cpu', cpu, 'cpu'), ('cuda', gpu, device)):
        with Recorder(S, P) as rec:
            _, neck, top, outs, preds = grounding_parts(
                model, to_device(req, dev))
        out[name] = (rec, {k: v.cpu() for k, v in neck.items()}, top.cpu(),
                     [t.cpu() for t in outs], {k: v.cpu()
                                               for k, v in preds.items()})
    (rc, nc, tc, oc, pc), (rg, ng, tg, og, pg) = out['cpu'], out['cuda']
    if len(rc.conv) != len(rg.conv) or not rc.conv:
        raise RuntimeError('cpu and cuda grounders made different conv calls')
    for ac, ag in zip(rc.conv, rg.conv):
        if not torch.equal(ac[2], ag[2].cpu()):
            raise RuntimeError('grounder neighbor tables differ between cpu '
                               'and cuda')
    for name, a, b in (('neck xyz', nc['xyz'], ng['xyz']),
                       ('neck mask', nc['mask'], ng['mask']),
                       ('query indices', tc, tg),
                       ('query mask', oc[2], og[2])):
        if not torch.equal(a, b):
            raise RuntimeError(f'{what}: {name} differ between cpu and cuda')
    diffs = {}
    for name, a, b in (('neck feats', nc['feats'], ng['feats']),
                       ('neck scores', nc['scores'], ng['scores']),
                       ('cls', oc[0], og[0]), ('boxes', oc[1], og[1]),
                       ('bboxes', pc['bboxes'], pg['bboxes']),
                       ('scores', pc['scores'], pg['scores'])):
        _close(a, b, f'{what} {name}')
        diffs[name] = float((a - b).abs().max())
    log(f'[parity] {what}: {len(rc.conv)} neighbor tables, '
        f'neck coordinates ({int(nc["mask"].sum())} valid of '
        f'{nc["mask"].shape[1]}) and {tc.shape[1]} query indices identical; '
        f'floats within atol 1e-4 + rtol 1e-5, max|d| ' + ', '.join(
            f'{k} {v:.3g}' for k, v in diffs.items()))


@torch.no_grad()
def phase_converted_parity(device, ground_sd):
    """The small detector and grounder of the parity phases (shipped
    widths, cut capacities) loaded from reference state_dicts by
    ``load_reference_model`` on cpu and on ``device``: the detector from a
    seeded one at its 18 classes, the grounder from ``ground_sd`` (the
    full-width reference grounder's, the same widths); each serves one
    request on both (the grounder's prompt tokenized by BPETokenizer)."""
    from embodiedscan_torch.models.text import BPETokenizer
    from embodiedscan_torch.utils.convert_weights import load_reference_model
    cfg = _parity_cfg()
    sd = reference_state_dict('mv_det3d', seed=1,
                              num_classes=cfg.model.num_classes)
    cpu, n, skipped = load_reference_model(cfg, sd, device='cpu')
    gpu = load_reference_model(cfg, sd, device=device)[0]
    if skipped:
        raise RuntimeError(f'converted small detector skipped {skipped}')
    det_parity(cpu, gpu, make_request(p=6000, v=4, hw=96, seed=8), device,
               f'converted detector ({n} tensors) cpu vs cuda')
    del cpu, gpu, sd
    cfg = _ground_parity_cfg()
    cpu, n, skipped = load_reference_model(cfg, ground_sd, device='cpu')
    gpu = load_reference_model(cfg, ground_sd, device=device)[0]
    if skipped != [WORD_EMBEDDING]:
        raise RuntimeError(f'converted small grounder skipped {skipped}')
    req = make_ground_request(cfg.model.max_text_len, seed=8, p=6000, v=4,
                              hw=96, tokenizer=BPETokenizer(
                                  ROBERTA_TOK, cfg.model.max_text_len))
    ground_parity(cpu, gpu, req, device,
                  f'converted grounder ({n} tensors) cpu vs cuda')


def kernel_line(calls, totals):
    """The kernels line: K2 forward and K1 rows (the detector's and the
    grounder's requests and the grounding train step), K2 dgrad and K3
    rows (the detector's and the grounder's train steps); launches summed
    over the main paths' timed runs, every other number from this run's
    replays (summed over one recorded detector request, one grounding
    request and the grounding train step, or over the two train steps)."""
    rows = []
    conv = ('embodiedscan_torch/csrc/sparse_conv.cu',
            'embodiedscan_tpu/experimental/pallas_conv.py:62')
    # the JAX package computes a sparse conv's gradients in XLA, in the
    # custom VJPs _subm_bwd and _strided_bwd (no Pallas kernel)
    bwd = 'embodiedscan_tpu/ops/sparse.py:354,413'
    wgrad = 'embodiedscan_torch/csrc/sparse_conv_wgrad.cu'
    meta = {  # kernel -> (source, replaces, its calls)
        'sparse_conv_tc': (*conv, [r for r in calls['sparse_conv']
                                   if r['route'] == 'tc']),
        'sparse_conv_simt': (*conv, [r for r in calls['sparse_conv']
                                     if r['route'] == 'simt']),
        'join_scan': ('embodiedscan_torch/csrc/join_scan.cu',
                      'embodiedscan_tpu/ops/pscan.py:101',
                      calls['join_scan']),
        'sparse_dgrad_tc': (conv[0], bwd, [r for r in calls['sparse_dgrad']
                                           if r['route'] == 'tc']),
        'sparse_wgrad_tc': (wgrad, bwd, [r for r in calls['sparse_wgrad']
                                         if r['route'] == 'tc']),
        'sparse_wgrad_narrow': (wgrad, bwd,
                                [r for r in calls['sparse_wgrad']
                                 if r['route'] == 'narrow']),
    }
    for name, (source, replaces, rs) in meta.items():
        if not rs or not totals[name]:
            raise RuntimeError(f'{name}: no call on its main path')
        bound = sum(r['bound_ms'] for r in rs)
        by_bytes = sum(r['bound_ms'] for r in rs if r['bound_by'] == 'bytes')
        rows.append(dict(
            name=name, route='cuda', source=source, replaces=replaces,
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
    rec, totals, main_stats, model, batch, det_preds = phase_main_path('cuda')
    rec.to_host()
    ground_rec, ground_totals, ground_stats, gmodel, gbatch, ground_preds = \
        phase_grounding('cuda')
    ground_rec.to_host()
    train_rec, train_totals, train_stats, tmodel, opt, tbatch = \
        phase_train('cuda')
    gt_rec, gt_totals, gt_stats, gtmodel, gtopt, gtbatch = \
        phase_ground_train('cuda')
    # event timings first, every profiler session after them (see cuda_ms)
    calls = phase_kernels(rec, train_rec, 'cuda', ground_rec, gt_rec)
    with torch.no_grad():
        main_stats.update(profile_run(
            lambda: model(batch, mode='predict'), 'request'))
        ground_stats.update(profile_run(
            lambda: gmodel(gbatch, mode='predict'), 'grounding request'))
    from embodiedscan_torch.train.state import train_step
    train_stats.update(profile_run(lambda: train_step(tmodel, opt, tbatch),
                                   'train step'))
    gt_stats.update(profile_run(lambda: train_step(gtmodel, gtopt, gtbatch),
                                'grounding train step'))
    del rec, ground_rec, train_rec, gt_rec, model, batch, gmodel, gbatch, \
        tmodel, opt, tbatch, gtmodel, gtopt, gtbatch
    eval_stats = phase_eval(det_preds, ground_preds, 'cuda')
    t0 = time.perf_counter()
    sds = {task: reference_state_dict(task)
           for task in ('mv_det3d', 'mv_grounding')}
    log(f'[ckpt] reference state_dicts drawn in '
        f'{time.perf_counter() - t0:.1f} s: ' + ', '.join(
            f'{t} {sum(v.size for v in sd.values())} values'
            for t, sd in sds.items()))
    ckpt_stats = phase_ckpt('cuda', sds, card)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, 'chip_smoke_calls.json'), 'w') as f:
        json.dump(dict(card=card, main=main_stats, grounding=ground_stats,
                       train=train_stats, ground_train=gt_stats,
                       eval=eval_stats, ckpt=ckpt_stats, calls=calls), f,
                  indent=1)
    phase_edges('cuda')
    phase_e2e_parity('cuda')
    phase_ground_parity('cuda')
    phase_converted_parity('cuda', sds['mv_grounding'])
    del sds
    phase_train_parity('cuda')
    phase_ground_train_parity('cuda')
    log(f'[done] {time.perf_counter() - t_start:.1f} s')
    for name, n in ground_totals.items():
        totals[name] += n
    for name, n in train_totals.items():
        if name.startswith(('sparse_dgrad', 'sparse_wgrad')):
            totals[name] = n
    for name, n in gt_totals.items():
        totals[name] += n
    print(kernel_line(calls, totals))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
