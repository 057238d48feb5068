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
     launch counts are reset before each request and read after it (K4,
     the NMS's suppression matrix, once a request); [nms] K4's matrix
     against the torch route's on the card over every request's own 1024
     candidates (identical, or the run fails) and over their first 128
     (mismatches counted: under 256 boxes the torch route's corners take
     another cuBLAS kernel), the share of the pairs given that K4 clipped
     in the timed requests (its device counters), K4's and the torch
     route's times; then the host-clock time of each stage of one request
     (``of_which_nms_iou``: the request's suppression matrices);
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
  5b. occupancy paths ([occ], [occ_train]): the full-width mv_occ model
     (81 classes, ResNet-50/64 + FPN 256, MinkResNet-34 at 0.0025 m
     voxels, the 768 -> 1536 -> 3072-channel dense U-Net on the 40 x 40 x
     16 prior grid; ~705M parameters, its seeded host init timed) serves
     one warm-up and three requests of 100k points in a 2.4 m tall room
     and 20 views of 480x480 (latency, peak, kept voxels, launches per
     request; host ms per stage: voxelize + MinkResNet, ResNet + FPN,
     image volume, U-Net, head + argmax), then from build_train takes one
     warm-up and three steps on 10 views with 16384 padded gt voxels and
     a visibility mask (launches, split, peak; frozen parameters
     bit-identical, the others and the U-Net's statistics moved);
  6. kernel parity and times: every kernel call of the warm-up requests,
     of the detector's warm-up step's backward and of the grounder's and
     the occupancy model's warm-up steps is replayed on its recorded
     inputs against the kernel's
     plain PyTorch version (join scan bit-exact, sparse conv and weight
     gradient within 1e-4 x max|ref| and bit-identical when run twice, the
     weight gradient's pair lists identical to the plain pair pass), with
     the kernel, plain and library times, the least time the card could
     take, the plan (route, tile, split or chunks) and the share of the
     dense work that hits and that the kernel computes; after every
     timing, the profiler counts each call's CUDA launches and device time
     and traces one request of each path and one step of each train path
     (device busy time and idle share), and the U-Net's device time in an
     occupancy request and step;
  7. eval: indoor_eval over the detector's requests and ground_eval over
     the grounder's, against synthetic ground truth, with the IoU on the
     card and on the cpu (metric dicts within 1e-6; times printed);
     occupancy_eval over the occupancy requests ([occ_eval]) with the
     ground truth's label grids built on the card and on the cpu
     (records and dicts identical);
  8. published checkpoints ([ckpt]): a seeded state_dict in the layout of
     a reference EmbodiedScan checkpoint for each preset, at its full
     width (torchvision ResNet, ME MinkResNet, FCAF3D head or MinkNeck,
     roberta-base with its 50265-token vocabulary, decoder, head
     branches), saved as a .pth, converted by
     ``embodiedscan_torch.tools.convert_checkpoint.main`` on the card (no
     skip: the grounder's presets hold roberta-base's 50265 rows),
     restored into a fresh model (bit-identical); converted and restored
     serve one request each with the same bits and the main paths' launch
     counts (the grounder's prompt tokenized by BPETokenizer from
     tests/fixtures/roberta_tok); conversion, checkpoint size, restore and
     request times beside the card's name and power limit;
  9. edge shapes: the sparse conv at Cin = 3, K = 1, ragged M, Cout 64 /
     128 / 512, a 50-sweep stem's 50 x 65536 rows (both routes),
     all-absent and all-masked tables,
     indices N, N + 5 and -7 (absent) on both routes, a misaligned view,
     split against unsplit; the weight gradient at C of 3, 4, 8 and 12,
     channels that are not a multiple of the tile, C 128 to 1024, K = 1,
     ragged R, R = 1, 50 x 65536 rows, offsets of 0, 1, 31, 32 and 33
     pairs, all-absent and all-masked tables, a misaligned view, many pair
     chunks against one (its pair lists held identical to the plain pair
     pass everywhere); the join scan at the reference's unit-test cases,
     one tile, one tile plus one row, ~4M rows and the 93.4M rows of a
     50-sweep request's stem join;
 10. end-to-end parity: a small detector and a small grounder (shipped
     widths, cut capacities) on cuda (kernels) and on cpu (plain versions)
     with the same weights, serving, then the same two loaded from
     reference state_dicts by load_reference_model; each also one train
     step (the grounder's matched gt indices identical); a small
     occupancy model (shipped widths up to a 32-channel pre-neck, the 40 x
     40 x 16 grid) at b = 2 serving with its norms' statistics taken from
     another scene (voxels and tables identical, logits within atol 1e-4
     + rtol 1e-5, classes identical but for reported top-2 ties; both
     sides' U-Net and head against float64) and one train step (leaves
     within 3e-4 x max|leaf|);
 11. the data path and the continuous tasks, in a process of their own
     (``--cont``, started by this one once its models are freed; each model
     freed before the next): [data] a synthetic scan of 50 views of
     480x480 through the port's loaders (``multiview_world_points`` on
     numpy and on the native host core, which must build, as point sets;
     ``pack_sweeps`` at 10 and 50 sweeps); [cont_det3d] the detector
     serving its eval shape, 50 cumulative sweeps of that scan (100k
     points a sweep), and [cont_det3d_train] 10 sweeps of a 10-view scan
     with 200 gt boxes visible per sweep; [cont_occ] the occupancy model
     with the bf16 U-Net serving 20 sweeps and [cont_occ_train] 10, of
     scans centred on the occupancy range (``occ_sweeps``): latency, peak,
     kept voxels per row, launches, host ms per stage, idle share, the
     U-Net's share, the train step's peak against the card (the remat
     decision); the replays of every K1, K2 and K3 call of the four
     paths; the small continuous models card vs cpu (3 sweeps), and the
     bf16 U-Net's error on the card against the cpu's;
 12. the runtime, in another process of its own (``--loop``): [loop] a
     dataset of 4 train and 4 val scenes of 50 views of 480x480 written in
     the reference layout (jpg, uint16 png, info pkls), a one-rank NCCL
     process group, one loop batch of the shipped mv_det3d preset (b = 4,
     20 views, 100k points) through a bare train step (recorded and
     timed), the gradients' all-reduce alone and the loader alone,
     the replays of that step's K1, K2 and K3 calls, then
     ``embodiedscan_torch.tools.train.main`` for 12 steps (past the
     epoch's end at 10; steps 6-10 profiled into a chrome trace) and again
     with ``--resume auto`` for 3 (wrapper calls per step equal to the
     train step's; checkpoints, save and restore seconds, the count and
     rate after the resume, the loop's sec/it from its own log, peak
     memory, the profiled steps' device busy time and idle share),
     ``tools.test.main`` over the val scenes from the last checkpoint, and
     a small checkpoint's ``evaluate`` on the card and on the cpu over the
     val scenes with gt boxes added at its detections (metrics within
     1e-6, mAP_0.25 > 0 on both); then, in a process of its own
     (``--demo``): [demo] ``embodiedscan_torch.tools.demo.main`` twice on
     a scan directory of 50 views of 480x480 at the shipped preset from
     the loop's last checkpoint (the restored step, each request's
     wrapper calls equal to [main]'s, the PLY against the kept boxes, the
     seconds of each part), the small checkpoint through the demo on the
     card and on the cpu (4 views of 96x96: the same kept labels, boxes
     within atol 1e-4 + rtol 1e-5), ``ChannelMapper(kernel_size=3)``
     over the first request's four MinkResNet-34 levels, and the replays
     of the first request's and the mapper's K1 and K2 calls;
12b. the head's other box modes and the tools, in a process of their own
     (``--heads``): [heads] the mv_det3d detector at its full width with the
     'yaw7d' head (the rotated-IoU loss) serving three of [main]'s requests
     and taking three of [train]'s steps (the gt boxes' pitch and roll
     zeroed), then with the 'aa6d' head (the axis-aligned IoU loss) three
     steps: latency, peak, the step's split with the rotated IoU
     (``of_which_rot_iou``), wrapper calls per request and step equal to
     [main]'s and [train]'s; [parity] the small detector card vs cpu with
     each head variant (``HEAD_VARIANTS``: both modes serving, and one train
     step of each of them and of cd_mode l2, cd_group g4, decouple_groups
     3, norm_decouple_loss and the undecoupled chamfer); [capacity]
     ``tools.occupancy_histogram`` at the bench scale on the card and the
     cpu, every count identical; [quality] ``tools.quality_smoke --steps
     60`` on the card, its report in chiprun_out/quality_smoke.md, failing
     on its gate.
12c. the bf16 sparse-conv route and remat, in a process of their own
     (``--precision``): the edge shapes of K2-bf16 and K3-bf16 (every
     tile, split and chunked calls, the input gradient through the
     transposed weights, the weights' bfloat16 copy across in-place
     updates); [sparse_bf16] the full-width mv_det3d under
     ``set_conv_compute_dtype(torch.bfloat16)`` serving three of [main]'s
     requests and taking three of [train]'s steps (latency, step, split,
     peak, wrapper calls), every K2-bf16 and K3-bf16 call of the warm-up
     request and step replayed against its plain version (within 1e-4 x
     max|ref|, the same bits twice) and timed beside it, the bound at the
     bf16 peak and the library call in bfloat16, its CUDA launches held
     to BF16_MAX_LAUNCHES (no reduction kernel, no cast of W or dout inside
     a call); the small detector in
     bf16 mode card vs cpu; [remat] the full-width mv_det3d step at b = 4
     under 'none', '2d', '3d' and 'all' and the cont_occ 10-sweep step
     under 'all' and 'none' (step, peak, wrapper calls; every gradient
     and statistic against 'none''s).
 13. one JSON line with the kernels (each kernel's row on the detection
     and grounding paths, then K4's, then on the occupancy paths, then on the
     continuous ones, then on the loop's step, the demo's request and
     ChannelMapper, then the bf16 variants'), then the result line.
Per-call details go to chiprun_out/chip_smoke_calls.json,
chiprun_out/chip_smoke_cont.json, chiprun_out/chip_smoke_loop.json,
chiprun_out/chip_smoke_demo.json and chiprun_out/chip_smoke_precision.json.

``python3 chip_smoke.py --kernels-only`` runs phases 1 and 9 and stops
(no result line): the quickest check that the kernels build and agree.
``python3 chip_smoke.py --cont`` runs phase 11 alone, ``--loop`` phase 12,
``--heads`` phase 12b and ``--precision`` phase 12c (no result line).
``python3 chip_smoke.py --ground-gate 7,101,... 201,...`` prints the
readings the grounding train parity's loss gate is set from: sound seeds,
then control seeds with a fault planted in the card's step.
"""

import contextlib
import copy
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
BF16_FLOPS = 989e12  # dense bf16 tensor cores (K2-bf16, K3-bf16)
# wrapper calls per request: K2 by route (the stem's Cin = 3 takes SIMT);
# serving runs no backward kernel; K4 (nms_overlap) once per scene of the
# batch, in the head's nms3d (every other path: 0)
EXPECTED_LAUNCHES = {'sparse_conv_tc': 43, 'sparse_conv_simt': 1,
                     'sparse_dgrad_tc': 0, 'sparse_dgrad_simt': 0,
                     'sparse_wgrad_tc': 0, 'sparse_wgrad_narrow': 0,
                     'join_scan': 12, 'nms_overlap': 1}
# wrapper calls per train step: the 44 forward convs; K2 again for the
# input gradient of the 35 submanifold and 4 strided convs (the stem's
# input needs none, the 4 K = 1 downsamples take index_add_); K3 for the
# weight gradient of all 44 (the stem's Cy = 3 on the narrow route); K1's
# 12 joins, the stages' now with their transpose queries
EXPECTED_TRAIN_LAUNCHES = {'sparse_conv_tc': 43, 'sparse_conv_simt': 1,
                           'sparse_dgrad_tc': 39, 'sparse_dgrad_simt': 0,
                           'sparse_wgrad_tc': 43, 'sparse_wgrad_narrow': 1,
                           'join_scan': 12, 'nms_overlap': 0}
# wrapper calls per grounding request: the trunk's 37 convs and the neck's
# 7 on K2 (the stem on SIMT); K1 for the trunk's stage tables and the
# neck's FPN and neighbor tables
EXPECTED_GROUND_LAUNCHES = {'sparse_conv_tc': 43, 'sparse_conv_simt': 1,
                            'sparse_dgrad_tc': 0, 'sparse_dgrad_simt': 0,
                            'sparse_wgrad_tc': 0, 'sparse_wgrad_narrow': 0,
                            'join_scan': 12, 'nms_overlap': 0}
# wrapper calls per grounding train step: as the detector's step, the
# neck's 7 convs in place of the head's (all 27-offset submanifold, with
# their input gradient on K2 and weight gradient on K3); the frozen 2D stem
# and first stage run no sparse kernel
EXPECTED_GROUND_TRAIN_LAUNCHES = {'sparse_conv_tc': 43, 'sparse_conv_simt': 1,
                                  'sparse_dgrad_tc': 39,
                                  'sparse_dgrad_simt': 0,
                                  'sparse_wgrad_tc': 43,
                                  'sparse_wgrad_narrow': 1, 'join_scan': 12,
                                  'nms_overlap': 0}
# wrapper calls per occupancy request: MinkResNet-34 alone (its 37 convs,
# the stem on SIMT, and its joins); the 2D branch and the U-Net run on
# cuDNN
EXPECTED_OCC_LAUNCHES = {'sparse_conv_tc': 36, 'sparse_conv_simt': 1,
                         'sparse_dgrad_tc': 0, 'sparse_dgrad_simt': 0,
                         'sparse_wgrad_tc': 0, 'sparse_wgrad_narrow': 0,
                         'join_scan': 5, 'nms_overlap': 0}
# wrapper calls per occupancy train step: the 37 forward convs; K2 for the
# input gradient of the 28 submanifold and 4 strided convs; K3 for the
# weight gradient of all 37 (the stem's on the narrow route)
EXPECTED_OCC_TRAIN_LAUNCHES = {'sparse_conv_tc': 36, 'sparse_conv_simt': 1,
                               'sparse_dgrad_tc': 32,
                               'sparse_dgrad_simt': 0,
                               'sparse_wgrad_tc': 36,
                               'sparse_wgrad_narrow': 1, 'join_scan': 5,
                               'nms_overlap': 0}
# K4 (csrc/nms_overlap.cu): float operations of one clipped pair, the
# NumPy model's count (tests/test_torch_nms_overlap.py:k4_model: 6.5k-7.3k
# a pair)
K4_OPS_PER_PAIR = 6900
# K4's counted check below the main path's K: the torch route's batched
# corner product takes another cuBLAS kernel under 256 boxes (a last bit
# apart, see csrc/nms_overlap.cu), so there mismatches are counted, not
# gated
K4_SMALL_K = 128
CONV_GATE = 1e-4  # K2, K3: max|kernel - plain| <= CONV_GATE x max|plain|
EVAL_GATE = 1e-6  # metric dicts with the IoU on the card vs on the cpu
SPLIT_GATE = 1e-6  # K3 many chunks vs one: max|d| <= SPLIT_GATE x max
# CPU vs CUDA train step: every gradient leaf and batch statistic within
# GRAD_GATE x its max|cpu| (3xTF32 kernels, cuDNN and atomic sums in
# another order, through ~90 layers forward and back). On an H100 the
# shipped kernels' worst leaf is 9.95e-5 and, with K2's and K3's products
# cut to single TF32, 0.473 (``kernel_ab.py --tf32-control``)
GRAD_GATE = 3e-4
# the schedule's epoch (updates) of the train phases outside [loop]: they
# take a few steps each, all before its first milestone, at the base rate
PHASE_EPOCH = 1000
OUT_DIR = 'chiprun_out'
# padded ground-truth boxes of the detector's training scene (the reference
# benchmark's, bench.py:make_batch)
N_GT = 128
# RoBERTa's byte-level BPE files of the repo's tokenizer fixture
ROBERTA_TOK = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           'tests', 'fixtures', 'roberta_tok')


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


def cuda_ms(fn, reps=5, warmup=3):
    """Mean device time of ``fn`` over ``reps`` back-to-back calls, after
    ``warmup`` warm-up calls. Take it before any torch.profiler session: one
    leaves the host slower per op for the rest of the process."""
    for _ in range(warmup):
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
    K1's calls; ``conv16``, ``wgrad16``: the same of K2-bf16 and K3-bf16
    (the inputs their wrappers got: float32, or the bfloat16 copies a
    backward made); ``dgrad16``: K2-bf16's input-gradient calls (dout,
    out_mask, table, the forward's weights, mirror). A call made inside a
    logged one (a plain bf16 version's float32 core) is not logged again.
    A name the checkout lacks (an earlier one, timed by kernel_ab.py) is
    not patched.
    """

    def __init__(self, S, P):
        self.S, self.P = S, P
        self.conv, self.dgrad, self.wgrad, self.scan = [], [], [], []
        self.conv16, self.dgrad16, self.wgrad16 = [], [], []
        self.orig = []
        self.in_dgrad = False
        self.busy = False

    def _patch(self, mod, name, make):
        fn = getattr(mod, name, None)
        if fn is not None:
            self.orig.append((mod, name, fn))
            # wraps() shares the wrapper's attributes (launch counts) too
            setattr(mod, name, functools.wraps(fn)(make(fn)))

    def _logging(self, log_of):
        def make(fn):
            def wrapped(*args, **kw):
                if self.busy:
                    return fn(*args, **kw)
                log_of().append(args[:5])
                self.busy = True
                try:
                    return fn(*args, **kw)
                finally:
                    self.busy = False
            return wrapped
        return make

    def __enter__(self):
        def k2_log():
            return self.dgrad if self.in_dgrad else self.conv

        def k2_log16():
            return self.dgrad16 if self.in_dgrad else self.conv16

        def dgrad(fn):
            def wrapped(*args, **kw):
                self.in_dgrad = True
                out = fn(*args, **kw)
                self.in_dgrad = False
                return out
            return wrapped

        for name in ('_gather_matmul_conv_cuda', '_gather_matmul_conv_plain'):
            self._patch(self.S, name, self._logging(k2_log))
        for name in ('_gather_matmul_conv_bf16_cuda',
                     '_gather_matmul_conv_bf16_plain'):
            self._patch(self.S, name, self._logging(k2_log16))
        self._patch(self.S, 'conv_dgrad', dgrad)
        for name in ('_conv_wgrad_cuda', '_conv_wgrad_plain'):
            self._patch(self.S, name, self._logging(lambda: self.wgrad))
        for name in ('_conv_dgrad_bf16_cuda', '_conv_dgrad_bf16_plain'):
            self._patch(self.S, name, self._logging(lambda: self.dgrad16))
        for name in ('_conv_wgrad_bf16_cuda', '_conv_wgrad_bf16_plain'):
            self._patch(self.S, name, self._logging(lambda: self.wgrad16))
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
        for log_ in (self.conv, self.dgrad, self.wgrad, self.scan,
                     self.conv16, self.dgrad16, self.wgrad16):
            log_[:] = [_on(args, 'cpu') for args in log_]


def _on(args, device):
    return tuple(a.to(device) if isinstance(a, torch.Tensor) else a
                 for a in args)


def phase_build():
    import scipy  # the grounder's host matcher: no fallback without it
    from embodiedscan_torch.ops import kernels
    card = card_name()
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
    with NmsInputs() as nms:  # every request's NMS candidates
        with Recorder(S, P) as rec:  # warm-up request: record kernel inputs
            t0 = time.perf_counter()
            preds = model(to_device(requests[0], device), mode='predict')
            torch.cuda.synchronize()
        log(f'[main] warm-up request {time.perf_counter() - t0:.2f} s, '
            f'{len(rec.conv)} conv and {len(rec.scan)} join-scan calls '
            'recorded')
        lat, mem, kept, served = [], [], [], []
        totals = dict.fromkeys(EXPECTED_LAUNCHES, 0)
        pairs0 = k4_pairs()
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
                raise RuntimeError(
                    f'bboxes shape {tuple(preds["bboxes"].shape)}')
            kept.append(int(preds['mask'].sum()))
            check_counts(counts, EXPECTED_LAUNCHES, f'request {i}')
            for name in totals:
                totals[name] += counts[name]
            log(f'[main] request {i}: {lat[-1] * 1e3:.1f} ms, peak '
                f'{mem[-1]:.2f} GiB, kept {kept[-1]} of '
                f'{preds["mask"].shape[1]} detections, launches {counts}')
        pairs = [b - a for a, b in zip(pairs0, k4_pairs())]
    if not all(kept):
        raise RuntimeError('a request kept no detection')
    log(f'[main] latency ms per request: '
        f'{[round(t * 1e3, 3) for t in lat]}, peak GiB {max(mem):.3f}')
    stats = dict(latency_ms=[t * 1e3 for t in lat], peak_gib=max(mem),
                 kept=kept)
    stats['nms'] = nms_check(nms.calls, pairs, len(lat))
    del nms
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
    from embodiedscan_torch.models.grounding import MinkNeck
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
    MinkNeck.live_counts.clear()
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
    live = int(sum(c.cpu() for c in MinkNeck.live_counts.values()))
    batch = to_device(requests[1], device)
    # the neck's rows a request: min(pts_prune_threshold, capacity) on the
    # upsampled levels, the trunk's capacity on the coarsest
    rows = grounding_parts(model, batch)[1]['mask'].shape[1]
    log(f'[ground] latency ms per request: '
        f'{[round(t * 1e3, 3) for t in lat]}, peak GiB {max(mem):.3f}; '
        f'the neck kept {live / len(lat):.0f} of its {rows} locations a '
        f'request (MinkNeck.live_counts over {len(lat)} requests)')
    stats = dict(latency_ms=[t * 1e3 for t in lat], peak_gib=max(mem))
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
        queries = stage('query_selection', lambda: model.select_queries(
            feats, xyz, mask, text, text_mask))
        outs = stage('decoder', lambda: model.decoder(
            *queries, feats, xyz, mask, text, text_mask))
        preds = stage('predict', lambda: model.predict(outs))
    return ms, dict(feats=feats, scores=scores, xyz=xyz, mask=mask), \
        queries[3], outs, preds


def ground_stage_times(model, batch):
    """Where one grounding request's time goes on the host clock, stage by
    stage (each ends in a synchronize)."""
    stages = grounding_parts(model, batch, _host_ms)[0]
    log('[breakdown] grounding host ms per stage: ' + ', '.join(
        f'{k} {v:.2f}' for k, v in stages.items()))
    return dict(stages_ms=stages)


def reset_counts(S, P):
    from embodiedscan_torch.geometry.iou import suppression_matrix
    for fn in (S.gather_matmul_conv, S.conv_dgrad, S.conv_wgrad):
        fn.launches = dict.fromkeys(fn.launches, 0)
    P.join_scan.launches = 0
    suppression_matrix.launches = 0


def read_counts(S, P):
    from embodiedscan_torch.geometry.iou import suppression_matrix
    counts = {'join_scan': P.join_scan.launches,
              'nms_overlap': suppression_matrix.launches}
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


class NmsInputs:
    """Records, while active, what every ``nms3d`` call of the FCAF3D head
    hands to ``suppression_matrix``: ``calls`` [(boxes (K, 9), iou_thr,
    labels)] (the head presorts its candidates)."""

    def __enter__(self):
        from embodiedscan_torch.geometry.iou import boxes7d_to_9d
        from embodiedscan_torch.models import fcaf3d as F
        self.calls, self._orig = [], F.nms3d
        orig = self._orig

        def record(boxes, scores, mask, iou_thr, labels=None,
                   presorted=False):
            if not presorted:
                raise RuntimeError('NmsInputs: an nms3d call not presorted')
            self.calls.append((boxes7d_to_9d(boxes[:, :7]).clone(),
                               float(iou_thr),
                               None if labels is None else labels.clone()))
            return orig(boxes, scores, mask, iou_thr, labels,
                        presorted=presorted)

        F.nms3d = record
        return self

    def __exit__(self, *exc):
        from embodiedscan_torch.models import fcaf3d as F
        F.nms3d = self._orig


def k4_pairs():
    """K4's counters on the current card: [pairs clipped, pairs given
    (j > i)] so far (reading them waits for the card)."""
    from embodiedscan_torch.geometry.iou import suppression_matrix
    counts = suppression_matrix.pair_counts.get(torch.cuda.current_device())
    return [0, 0] if counts is None else counts.tolist()


def nms_check(calls, pairs, n_requests):
    """K4 against the torch route on the card, over the main path's own
    candidates ``calls`` (:class:`NmsInputs`): every matrix identical at
    the main path's K (>= 256), and over each call's first K4_SMALL_K
    candidates the mismatches counted; the CUDA-event ms of K4 alone, with
    its per-box prep and of the torch route on the first call; the share of
    the pairs given that K4 clipped in the timed requests (``pairs``:
    [clipped, given] over ``n_requests``). Returns the numbers and the
    kernels line's K4 row (its launches are the caller's)."""
    from embodiedscan_torch.geometry import iou as I
    big = small = 0
    for b9, thr, lab in calls:
        if b9.shape[0] < 256:
            raise RuntimeError(f'[nms] K = {b9.shape[0]} on the main path')
        big += int((I.suppression_matrix(b9, thr, lab) !=
                    I._suppression_matrix_plain(b9, thr, lab)).sum())
        sb, sl = b9[:K4_SMALL_K], None if lab is None else lab[:K4_SMALL_K]
        small += int((I.suppression_matrix(sb, thr, sl) !=
                      I._suppression_matrix_plain(sb, thr, sl)).sum())
    b9, thr, lab = calls[0]
    fields, lab32 = I.nms_fields(b9, lab)
    ms = cuda_ms(lambda: I._nms_overlap_cuda(fields, lab32, thr), reps=20)
    prep_ms = cuda_ms(lambda: I.suppression_matrix(b9, thr, lab), reps=20)
    plain_ms = cuda_ms(lambda: I._suppression_matrix_plain(b9, thr, lab),
                       reps=3, warmup=1)
    clipped, given = pairs
    share = clipped / max(given, 1)
    bound_ms = clipped / n_requests * K4_OPS_PER_PAIR / FP32_FLOPS * 1e3
    log(f'[nms] K4 against the torch route over the main path\'s '
        f'{len(calls)} candidate sets of K = {b9.shape[0]}: {big} entries '
        f'differ; over their first {K4_SMALL_K}: {small} (counted: the '
        f'torch route\'s corners change cuBLAS kernel under K = 256); the '
        f'timed requests clipped {clipped} of {given} pairs given '
        f'({share:.4%}); K4 {ms:.4f} ms, with its prep {prep_ms:.4f}, the '
        f'torch route {plain_ms:.2f}; bound {bound_ms:.5f} ms (operations)')
    if big:
        raise RuntimeError(f'[nms] K4 differs from the torch route in {big} '
                           'entries on the main path')
    stats = dict(sets=len(calls), k=int(b9.shape[0]), mismatches=big,
                 small_k=K4_SMALL_K, small_k_mismatches=small,
                 clipped=clipped, given=given, clipped_share=share, ms=ms,
                 prep_ms=prep_ms, plain_ms=plain_ms, bound_ms=bound_ms)
    row = dict(name='nms_overlap', route='cuda',
               source='embodiedscan_torch/csrc/nms_overlap.cu',
               replaces='embodiedscan_tpu/geometry/nms.py:44', launches=None,
               max_abs_err=float(big), ms=ms, prep_ms=prep_ms,
               plain_ms=plain_ms, bound_ms=bound_ms, bound_by='operations',
               library_ms=None, clipped_share=share,
               small_k_mismatches=small)
    return dict(stats, row=row)


def _self_device_us(event):
    # the attribute's name changed across PyTorch releases
    for name in ('self_device_time_total', 'self_cuda_time_total'):
        if hasattr(event, name):
            return getattr(event, name)
    raise AttributeError('profiler event without a device time')


def _host_ms(fn, reps=3, warmup=True):
    if warmup:
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3, out


@torch.no_grad()
def stage_times(model, batch, reps=3, warmup=True):
    """Where one request's time goes on the host clock, stage by stage
    (each ends in a synchronize; ``reps`` runs of each after a warm-up
    one if ``warmup``)."""
    from embodiedscan_torch.ops import sparse as S
    trunk, head = model.trunk, model.bbox_head
    pts, pm = batch['points'], batch['points_mask']
    imgs = batch['imgs']
    bi, v, h, w, _ = imgs.shape

    def timed(fn):
        return _host_ms(fn, reps, warmup)

    st_ms, st = timed(lambda: S.from_points_b(
        pts, pts, pm, trunk.voxel_size, trunk.input_capacity))
    mink_ms, _ = timed(lambda: trunk.MinkResNet_0(st))
    r2d_ms, _ = timed(lambda: trunk.ResNet_0(
        imgs.reshape(bi * v, h, w, 3)))
    trunk_ms, feats = timed(lambda: trunk(batch))
    head_ms, outs = timed(lambda: head(feats))
    pred_ms, _ = timed(lambda: head.predict(outs))
    # the NMS's suppression matrices alone (K4 and its per-box prep on the
    # card), over the candidates of every nms3d call of one predict
    from embodiedscan_torch.geometry.iou import suppression_matrix
    with NmsInputs() as nms:
        head.predict(outs)
    iou_ms, _ = timed(lambda: [suppression_matrix(*c) for c in nms.calls])
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
    model, opt = build_train(cfg, device=device,
                             steps_per_epoch=PHASE_EPOCH)
    d = cfg.data
    batch = to_device(make_batch(1, d.n_points, d.n_views_train,
                                 d.image_hw[0], N_GT,
                                 cfg.model.num_classes), device)
    log(f'[train] built mv_det3d and AdamW on {device} in '
        f'{time.perf_counter() - t0:.1f} s; batch b=1, '
        f'{d.n_points} points, {d.n_views_train} views, {N_GT} GT boxes')
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
    model, opt = build_train(cfg, device=device,
                             steps_per_epoch=PHASE_EPOCH)
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


def train_steps(tag, model, opt, batch, want, record=True):
    """One warm-up step (``record``: its kernel inputs recorded), then three
    timed ones (host clock, each ending in a synchronize), each with its
    peak memory and its launch counts against ``want``; losses finite and
    changing; then one step split into forward, backward and optimizer.
    Returns the recorder (on the host), the launch totals of the timed
    steps and the stats."""
    from embodiedscan_torch.ops import pscan as P
    from embodiedscan_torch.ops import sparse as S
    from embodiedscan_torch.train.state import train_step
    reset_counts(S, P)
    with Recorder(S, P) if record else contextlib.nullcontext(
            Recorder(S, P)) as rec:  # warm-up step
        t0 = time.perf_counter()
        metrics = train_step(model, opt, batch)
        torch.cuda.synchronize()
    check_counts(read_counts(S, P), want, f'{tag} warm-up step')
    rec.to_host()
    bf16 = len(rec.conv16) + len(rec.dgrad16) + len(rec.wgrad16)
    log(f'[{tag}] warm-up step {time.perf_counter() - t0:.2f} s, '
        f'{len(rec.conv)} conv, {len(rec.dgrad)} dgrad, {len(rec.wgrad)} '
        f'wgrad and {len(rec.scan)} join-scan calls recorded' +
        (f'; bf16: {len(rec.conv16)} conv, {len(rec.dgrad16)} dgrad, '
         f'{len(rec.wgrad16)} wgrad' if bf16 else ''))
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
    match cost and its matcher (the host matcher's copies included); a
    yaw-head detector's, its rotated IoU loss (the exact paired clip)."""
    parts = {}
    restore = []

    def timed(name, fn):
        def run(*args):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            parts[name] = parts.get(name, 0.0) + (time.perf_counter() - t) \
                * 1e3
            return out
        return run

    if hasattr(model, 'match_fn'):
        from embodiedscan_torch.models import grounding as G
        for obj, name, part in ((G, 'paired_iou_pruned', 'of_which_iou_cost'),
                                (model, 'match_fn', 'of_which_matcher')):
            restore.append((obj, name, getattr(obj, name)))
            setattr(obj, name, timed(part, getattr(obj, name)))
    if getattr(getattr(model, 'bbox_head', None), 'bbox_mode', '') == 'yaw7d':
        from embodiedscan_torch.models import fcaf3d as F
        restore.append((F, 'rotated_iou_loss', F.rotated_iou_loss))
        F.rotated_iou_loss = timed('of_which_rot_iou', F.rotated_iou_loss)
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


def profile_run(fn, what, host=True):
    """One run of ``fn`` under torch.profiler: device busy time and idle
    share, device time by op. ``host=False`` records the device's activity
    alone (a run of hundreds of thousands of ops, whose host events would
    take minutes to read back)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host else [])
    with profile(activities=acts) as prof:
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


def _conv_bound(feats, mask, nbr, w, bias, mirror=None, bf16=False):
    """(bytes, flops, hits) this call needs: inputs read once (at the
    size the wrapper got them; with ``bf16`` the weights at 2 bytes, the
    kept copy the kernel reads: ``bf16_weights`` casts them once per
    version, outside the timed calls), output written once; FLOPs over
    the (row, offset) pairs that hit a valid row. ``mirror``: w is the
    forward's (K, Cout, Cin) of an input-gradient call."""
    n, cin = feats.shape
    m, k = nbr.shape
    cout = w.shape[-1] if mirror is None else w.shape[1]
    safe = torch.where(nbr >= 0, nbr, torch.zeros_like(nbr)).long()
    hits = int(((nbr >= 0) & mask[safe]).sum())
    wsize = 2 if bf16 else w.element_size()
    nbytes = (feats.numel() * feats.element_size() + mask.numel() +
              nbr.numel() * 4 + w.numel() * wsize +
              (0 if bias is None else cout * 4) + m * cout * 4)
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
    # every call launches something: a session that recorded nothing lost
    # its events (seen on the card now and then), so take another
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        ev = [e for e in prof.key_averages()
              if str(e.device_type).endswith('CUDA')]
        if ev:
            break
    return sum(e.count for e in ev), sum(_self_device_us(e) for e in ev) / 1e3


def _conv_fns(S, bf16, mirror=None):
    """(plain, kernel) of K2, or of K2-bf16 with ``bf16``: its forward,
    or with ``mirror`` (True or False) its input gradient from the
    forward's own weights, called as (feats, mask, nbr, w, bias[, plan])."""
    if bf16 and mirror is not None:
        return ((lambda f, m, n, w, b: S._conv_dgrad_bf16_plain(
                    f, m, n, w, mirror)),
                (lambda f, m, n, w, b, plan=None: S._conv_dgrad_bf16_cuda(
                    f, m, n, w, mirror, plan)))
    if bf16:
        return S._gather_matmul_conv_bf16_plain, \
            S._gather_matmul_conv_bf16_cuda
    return S._gather_matmul_conv_plain, S._gather_matmul_conv_cuda


def _check_conv(S, feats, mask, nbr, w, bias, what, plan=None, bf16=False,
                mirror=None):
    """Kernel (K2-bf16 with ``bf16``; its input gradient with
    ``mirror``) vs plain within the gate, and the same bits twice; returns
    (out, max|d|, max|ref|)."""
    plain, kernel = _conv_fns(S, bf16, mirror)
    ref = plain(feats, mask, nbr, w, bias)
    got = kernel(feats, mask, nbr, w, bias, plan)
    again = kernel(feats, mask, nbr, w, bias, plan)
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


def _check_wgrad(S, x, xm, idx, y, ym, what, plan=None, bf16=False):
    """K3 (K3-bf16 with ``bf16``) vs its plain versions: the pair lists and
    counts of the call identical to ``_wgrad_pairs_plain``, G within the
    gate of ``_conv_wgrad_plain`` (``_conv_wgrad_bf16_plain``), and the
    same bits twice; returns (G, max|d|, max|ref|, counts)."""
    if bf16:
        plan = plan or S.bf16_wgrad_plan(x, idx, y)
        plain, kernel = S._conv_wgrad_bf16_plain, S._conv_wgrad_bf16_cuda
    else:
        plan = plan or S.cuda_wgrad_plan(x, idx, y)
        plain, kernel = S._conv_wgrad_plain, S._wgrad_cuda
    shape = f'{tuple(idx.shape)} x {x.shape[1]} x {y.shape[1]}'
    ref = plain(x, xm, idx, y, ym)
    want_pairs, want_counts = S._wgrad_pairs_plain(xm, idx, ym)
    got, pairs, counts = kernel(x, xm, idx, y, ym, plan, lists=True)
    again, pairs2, counts2 = kernel(x, xm, idx, y, ym, plan, lists=True)
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


def _wgrad_work_share(S, plan, counts, r, k, bf16=False):
    """The pairs K3 computes over R x K: each chunk's pairs, rounded up to
    a whole 32-pair step on the tensor-core route (64 on K3-bf16's)."""
    step = (2 if bf16 else 1) * S.WG_STEP if plan.route == 'tc' else 1
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
    nbytes = (x.numel() * x.element_size() + xm.numel() + idx.numel() * 4 +
              y.numel() * y.element_size() + ym.numel() + k * cx * cy * 4)
    return nbytes, 2.0 * cx * cy * hits, hits


def _bound(nbytes, flops, bf16=False):
    """(bound ms, by what, FP32 bound ms): bytes at the HBM rate against
    3xTF32 operations (3 TF32 products each) at the TF32 peak, or with
    ``bf16`` bf16 operations at the bf16 peak."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / BF16_FLOPS if bf16 else 3 * flops / TF32_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            'bytes' if t_bytes >= t_ops else 'operations',
            max(t_bytes, flops / FP32_FLOPS) * 1e3)


def _conv_call(S, feats, mask, nbr, w, bias, what, run, timing, bf16=False,
               mirror=None):
    """One K2 call (forward, or dgrad with ``run`` = conv_dgrad; K2-bf16
    with ``bf16``, its input gradient from the forward's weights with
    ``mirror``): checked, then timed (``cuda_ms(**timing)``) beside its
    plain version and the library gather-matmul (in bfloat16 with
    ``bf16``)."""
    if mirror is not None:
        k_, cin_, cout_ = w.shape
        plan = S.conv_plan(nbr.shape[0], k_, cout_, cin_, bf16=True)
    else:
        plan = S.bf16_plan(nbr, feats, w) if bf16 else \
            S.cuda_plan(feats, nbr, w)
    _, err, scale = _check_conv(S, feats, mask, nbr, w, bias, what,
                                bf16=bf16, mirror=mirror)
    plain = _conv_fns(S, bf16, mirror)[0]
    dtype = torch.bfloat16 if bf16 else feats.dtype
    padded = torch.cat([torch.where(mask[:, None], feats,
                                    torch.zeros_like(feats)),
                        feats.new_zeros(1, feats.shape[1])]).to(dtype)
    idx = torch.where(nbr >= 0, nbr, torch.full_like(nbr, feats.shape[0]))
    wb = w if mirror is None else S._dgrad_weights_t(w, mirror)
    kcin = wb.shape[0] * wb.shape[1]
    w2 = wb.reshape(kcin, wb.shape[2]).to(dtype)
    nbytes, flops, hits = _conv_bound(feats, mask, nbr, w, bias, mirror,
                                      bf16)
    bound, by, bound32 = _bound(nbytes, flops, bf16)
    m, k = nbr.shape
    return dict(
        m=m, k=k, cin=wb.shape[1], cout=wb.shape[2], n=feats.shape[0],
        route=plan.route, tile=[plan.bm, plan.bn], splits=plan.splits,
        per_split=plan.per_split, hit_share=hits / (m * k),
        work_share=_work_share(mask, nbr, plan.bm), max_abs_err=err,
        max_abs_ref=scale, deterministic=True, ms=cuda_ms(run, **timing),
        plain_ms=cuda_ms(lambda: plain(feats, mask, nbr, w, bias), **timing),
        library_ms=cuda_ms(lambda: padded[idx].reshape(-1, kcin) @ w2,
                           **timing),
        bytes=nbytes, flops=flops, bound_ms=bound, bound_by=by,
        bound_fp32_ms=bound32)


def _wgrad_call(S, x, xm, idx, y, ym, timing, bf16=False):
    """One K3 call (K3-bf16 with ``bf16``): checked, then timed
    (``cuda_ms(**timing)``) beside its plain version and the library
    product of x^T with the gathered y rows (in bfloat16 with
    ``bf16``)."""
    plan = S.bf16_wgrad_plan(x, idx, y) if bf16 else \
        S.cuda_wgrad_plan(x, idx, y)
    _, err, scale, counts = _check_wgrad(S, x, xm, idx, y, ym, 'main',
                                         bf16=bf16)
    plain = S._conv_wgrad_bf16_plain if bf16 else S._conv_wgrad_plain
    dtype = torch.bfloat16 if bf16 else x.dtype
    r, k, cy = x.shape[0], idx.shape[1], y.shape[1]
    xs = torch.where(xm[:, None], x, torch.zeros_like(x)).to(dtype)
    ypad = torch.cat([torch.where(ym[:, None], y, torch.zeros_like(y)),
                      y.new_zeros(1, cy)]).to(dtype)
    gi = torch.where(idx >= 0, idx, torch.full_like(idx, y.shape[0])).long()
    nbytes, flops, hits = _wgrad_bound(x, xm, idx, y, ym)
    bound, by, bound32 = _bound(nbytes, flops, bf16)
    return dict(
        r=r, k=k, cx=x.shape[1], cy=cy, ny=y.shape[0], route=plan.route,
        tile=[plan.bm, plan.bn], chunks=plan.chunks,
        hit_share=hits / max(r * k, 1),
        work_share=_wgrad_work_share(S, plan, counts, r, k, bf16),
        max_abs_err=err, max_abs_ref=scale,
        deterministic=True, ms=cuda_ms(lambda: S.conv_wgrad(
            x, xm, idx, y, ym, bf16=bf16), **timing),
        plain_ms=cuda_ms(lambda: plain(x, xm, idx, y, ym), **timing),
        library_ms=cuda_ms(lambda: xs.T @ ypad[gi].reshape(r, k * cy),
                           **timing),
        bytes=nbytes, flops=flops, bound_ms=bound, bound_by=by,
        bound_fp32_ms=bound32)


@torch.no_grad()
def phase_kernels(fwd, bwd, device, timing=None, release=False):
    """Every recorded call of the paths' warm-up runs on the card, one
    call's inputs on the device at a time, each checked against its plain
    version and timed (``cuda_ms(**timing)``); the profiler only after all
    timings. ``fwd``: (path, recorder) pairs whose K1 and K2 forward calls
    are replayed (serving requests, whole train steps); ``bwd``: (path,
    recorder) pairs whose K2 dgrad and K3 calls are replayed. Each row names
    its path (det, grounding, occ, train, ground_train, occ_train, or a
    continuous one). ``release``: return the caching allocator's free
    blocks to the card before each call (with models resident, a 50-sweep
    call's library gather needs one 42 GiB block)."""
    from embodiedscan_torch.ops import pscan as P
    from embodiedscan_torch.ops import sparse as S
    timing = timing or {}
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
            if release:
                torch.cuda.empty_cache()
            a = _on(args, device)
            if name == 'join_scan':
                row = _scan_call(P, *a, time_it=True, timing=timing)
            elif name == 'sparse_wgrad':
                row = _wgrad_call(S, *a, timing)
            else:
                row = _conv_call(S, *a, name, lambda: run(a), timing)
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
                f'{"step" if "train" in path or path == "loop" else "request"}'
                f'; '
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


def _scan_call(P, skey, saux, ranges, sbits, time_it, timing=None):
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
    timing = timing or {}
    return dict(n=n, k=k, max_abs_err=0, ms=cuda_ms(
        lambda: P.join_scan(skey, saux, ranges, sbits),
        **{'reps': 20, **timing}),
        plain_ms=cuda_ms(lambda: P._join_scan_plain(skey, saux, ranges, sb),
                         **timing),
        library_ms=cuda_ms(lambda: [torch.cummax(x, 0) for x in masked +
                                    masked], **timing),
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
    # the most rows a call takes on the continuous paths: the stem conv of
    # a 50-sweep request (50 x 65536 output rows over 50 x 98304 input
    # voxels), on both routes
    conv('stem_50_sweeps', CONT_ROWS, 50 * 65536, 27, 3, 32, route='simt',
         hit=0.1)
    conv('rows_50_sweeps', CONT_ROWS, 50 * 65536, 27, 32, 32, route='tc',
         hit=0.1)
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
    wgrad('rows_50_sweeps', 50 * 65536, CONT_ROWS, 27, 32, 64, route='tc',
          hit=0.1)
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
    # the longest join of the continuous paths: the stem's strided join of
    # a 50-sweep request (50 x (98304 table + 65536 x 27 query rows))
    n = 50 * (98304 + 65536 * 27)
    skey = torch.sort(torch.randint(-2**31, 2**31 - 1, (n, ), generator=g,
                                    device=device, dtype=torch.int32)).values
    saux = torch.randperm(n, generator=g, device=device, dtype=torch.int32)
    cuts = sorted(rng.choice(n, 2, replace=False))
    _scan_call(P, skey, saux, ((int(cuts[0]), int(cuts[1])), ), 0,
               time_it=False)
    checked.append(f'join_scan n={n} k=1')
    del skey, saux
    log('[edges] kernel == plain (join scan bit-exact, sparse conv and '
        f'weight gradient within {CONV_GATE} x max|ref| and the same bits '
        'twice): ' +
        '; '.join(checked))


@torch.no_grad()
def phase_edges_bf16(device):
    """Edge shapes of K2-bf16 and K3-bf16 on the card against their plain
    versions (the float32 inputs rounded to bfloat16, float32 sums): the
    SIMT and narrow routes at C = 3, the tensor-core routes from their
    least channels (8) up, channels that fill no whole 128-byte line (24,
    40) and a Cout ragged against the tile (72, 200), the shapes whose
    channels are not 16-byte chunks of bfloat16 (12, 284: the SIMT and
    narrow routes), ragged rows, K = 1, a split K2 call against the
    unsplit one, the input gradient through the transposed weights (a
    submanifold and a strided table; a bfloat16 dout gives the same bits),
    every tile unsplit against split and one chunk against seven, the
    weights' bfloat16 copy across ``add_`` and an optimizer step, K3's
    64-pair steps at offsets of 1, 63, 64 and 65 pairs, many chunks against
    one, all-absent and all-masked tables."""
    from embodiedscan_torch.ops import sparse as S
    g = torch.Generator(device=device).manual_seed(1)
    checked = []

    def conv(what, *shape, route, plan=None, **kw):
        feats, mask, nbr, w, b = _conv_case(g, *shape, device=device, **kw)
        plan = plan or S.bf16_plan(nbr, feats, w)
        if plan.route != route:
            raise RuntimeError(f'bf16 {what}: route {plan.route}, want '
                               f'{route}')
        out, err, scale = _check_conv(S, feats, mask, nbr, w, b,
                                      f'bf16 {what}', plan, bf16=True)
        checked.append(f'{what} ({plan.route}, split {plan.splits}, '
                       f'max|d|/max|ref| {err / max(scale, 1e-30):.1e})')
        return out, scale, (feats, mask, nbr, w, b), plan

    conv('cin3', 5000, 4100, 27, 3, 64, route='simt')
    conv('cin8', 3000, 3000, 27, 8, 8, route='tc')
    conv('cin12', 3000, 3000, 27, 12, 64, route='simt')
    conv('cout284', 3000, 2000, 27, 64, 284, route='simt')
    conv('k1', 9000, 777, 1, 64, 128, route='tc')
    conv('ragged_m', 3000, 1001, 27, 64, 64, route='tc', bias=False)
    conv('cout128', 8000, 8191, 27, 128, 128, route='tc')
    conv('cout512', 4000, 2047, 27, 512, 512, route='tc')
    conv('c1024', 2048, 1024, 27, 1024, 1024, route='tc')
    conv('wide_m', 70000, 65536, 27, 128, 128, route='tc', hit=0.25)
    a, scale, args, plan = conv('split', 4000, 4096, 27, 256, 256,
                                route='tc')
    if plan.splits == 1:
        raise RuntimeError('bf16 split case: no split')
    c, _, _ = _check_conv(S, *args, 'bf16 unsplit',
                          plan._replace(splits=1, per_split=27), bf16=True)
    d = float((a - c).abs().max())
    if not d <= CONV_GATE * scale:
        raise RuntimeError(f'bf16 split vs unsplit: max|d| {d}')
    checked.append(f'split {plan.splits}x{plan.per_split} vs unsplit '
                   f'(max|d| {d:.3g})')
    # channels that fill no whole 128-byte line (a zero-filled tail), and
    # Cout ragged against the tile
    conv('cin24', 3000, 3000, 27, 24, 64, route='tc')
    conv('cin40_cout72', 3000, 3000, 27, 40, 72, route='tc')
    conv('cout200', 3000, 3000, 27, 64, 200, route='tc')

    def dgrad_case(n, m, k, cin, cout):
        """(dout, out_mask, table, W, None): the input gradient of a Cin ->
        Cout conv, W its own (K, Cin, Cout) weights."""
        dout, mask, table, wt, _ = _conv_case(g, n, m, k, cout, cin,
                                              bias=False, device=device)
        return dout, mask, table, wt.transpose(1, 2).contiguous(), None

    for what, shape, mirror in (('subm', (8000, 8000, 27, 128, 128), True),
                                ('strided', (9000, 4000, 27, 64, 128), False),
                                ('ragged', (3000, 2500, 27, 200, 72), True)):
        args = dgrad_case(*shape)
        dout, mask, table, w, _ = args
        plan = S.conv_plan(table.shape[0], 27, dout.shape[1], w.shape[1],
                           bf16=True)
        out, err, scale = _check_conv(S, *args, f'bf16 dgrad {what}', plan,
                                      bf16=True, mirror=mirror)
        if not torch.equal(out, S._conv_dgrad_bf16_cuda(
                dout.to(torch.bfloat16), mask, table, w, mirror, plan)):
            raise RuntimeError(f'bf16 dgrad {what}: a bfloat16 dout gives '
                               'other bits')
        checked.append(f'dgrad {what} ({plan.bm}x{plan.bn}, split '
                       f'{plan.splits}, max|d|/max|ref| '
                       f'{err / max(scale, 1e-30):.1e})')
    # every tile the plan may pick, forward and input gradient, unsplit
    # against split (the folded reduction)
    for bm, bn in S.BF16_TILES:
        fwd = _conv_case(g, 6000, 5000, 27, 64, 200, device=device)
        for args, mirror in ((fwd, None),
                             (dgrad_case(6000, 5000, 27, 64, 200), True)):
            outs = []
            for splits, per in ((1, 27), (9, 3)):
                out, err, scale = _check_conv(
                    S, *args, f'bf16 tile {bm}x{bn} split {splits}',
                    S.ConvPlan('tc', bm, bn, splits, per), bf16=True,
                    mirror=mirror)
                outs.append(out)
            d = float((outs[0] - outs[1]).abs().max())
            if not d <= CONV_GATE * scale:
                raise RuntimeError(f'bf16 {bm}x{bn} split vs unsplit '
                                   f'(mirror {mirror}): max|d| {d}')
            checked.append(f'tile {bm}x{bn} {"dgrad" if mirror else "fwd"} '
                           f'9 splits vs 1 (max|d|/max|ref| '
                           f'{d / scale:.1e})')
    # the weights' bfloat16 copy across in-place updates on the card
    feats, mask, nbr, w, b = _conv_case(g, 3000, 3000, 27, 64, 128,
                                        device=device)
    w = torch.nn.Parameter(w)
    first, _, _ = _check_conv(S, feats, mask, nbr, w, b, 'bf16 cache',
                              bf16=True)
    kept = S.bf16_weights(w)
    with torch.no_grad():
        w.add_(0.25 * torch.randn_like(w))
    again, _, _ = _check_conv(S, feats, mask, nbr, w, b,
                              'bf16 cache after add_', bf16=True)
    w.grad = torch.randn_like(w)
    torch.optim.AdamW([w], lr=0.05).step()
    stepped, _, _ = _check_conv(S, feats, mask, nbr, w, b,
                                'bf16 cache after a step', bf16=True)
    w.data.mul_(0.5)  # bumps no version counter: dropped by hand
    S.drop_bf16_weights()
    halved, _, _ = _check_conv(S, feats, mask, nbr, w, b,
                               'bf16 cache after a .data write', bf16=True)
    if S.bf16_weights(w) is kept or torch.equal(first, again) or \
            torch.equal(again, stepped) or torch.equal(stepped, halved):
        raise RuntimeError('bf16 weights cache: a stale copy')
    checked.append('weights cache across add_, an optimizer step and a '
                   '.data write')
    for what in ('all_absent', 'all_masked'):
        feats, mask, nbr, w, b = _conv_case(g, 2000, 1500, 27, 64, 128,
                                            device=device)
        if what == 'all_absent':
            nbr = torch.full_like(nbr, -1)
        else:
            mask = torch.zeros_like(mask)
        got, _, _ = _check_conv(S, feats, mask, nbr, w, b, f'bf16 {what}',
                                bf16=True)
        if not torch.equal(got, b.expand_as(got)):
            raise RuntimeError(f'bf16 {what}: output is not the bias')
        checked.append(what)

    def wgrad(what, *shape, route, hit=0.3, edit=None):
        x, xm, idx, y, ym = _wgrad_case(g, *shape, hit=hit, device=device)
        if edit is not None:
            x, xm, idx, y, ym = edit(x, xm, idx, y, ym)
        plan = S.bf16_wgrad_plan(x, idx, y)
        if plan.route != route:
            raise RuntimeError(f'bf16 wgrad {what}: route {plan.route}, '
                               f'want {route}')
        got, err, scale, counts = _check_wgrad(S, x, xm, idx, y, ym,
                                               f'bf16 {what}', plan,
                                               bf16=True)
        checked.append(f'wgrad {what} ({plan.route} {plan.bm}x{plan.bn}, '
                       f'chunks {plan.chunks}, max|d|/max|ref| '
                       f'{err / max(scale, 1e-30):.1e})')
        return got, counts

    def set_counts(x, xm, idx, y, ym):  # offsets 0-3: 1, 63, 64, 65 pairs
        xm, ym = torch.ones_like(xm), torch.ones_like(ym)
        idx[:, :4] = -1
        for j, n in enumerate((1, 63, 64, 65)):
            idx[:n, j] = torch.arange(n, dtype=idx.dtype, device=device)
        return x, xm, idx, y, ym

    wgrad('cy3', 5000, 6000, 27, 64, 3, route='narrow')
    wgrad('cx3', 6000, 5000, 27, 3, 64, route='narrow')
    wgrad('c12x64', 3000, 3000, 27, 12, 64, route='narrow')
    wgrad('c8', 3000, 3000, 27, 8, 8, route='tc')
    wgrad('c200x136', 3000, 3000, 27, 200, 136, route='tc')
    wgrad('k1', 9000, 9000, 1, 64, 128, route='tc')
    wgrad('ragged_r', 1001, 3000, 27, 64, 64, route='tc')
    wgrad('c128', 8192, 8192, 27, 128, 128, route='tc')
    wgrad('c512', 2048, 2048, 27, 512, 512, route='tc')
    wgrad('c64x512', 4096, 2048, 27, 64, 512, route='tc')
    wgrad('c1024', 2048, 2048, 27, 1024, 1024, route='tc')
    # every tile, one chunk against seven (the folded chunk reduction)
    for bm in (64, 128):
        for bn in (64, 128):
            x, xm, idx, y, ym = _wgrad_case(g, 6000, 6000, 27, 136, 200,
                                            device=device)
            res = []
            for chunks in (1, 7):
                got, err, scale, _ = _check_wgrad(
                    S, x, xm, idx, y, ym, f'bf16 tile {bm}x{bn} chunks '
                    f'{chunks}', S.WgradPlan('tc', bm, bn, chunks),
                    bf16=True)
                res.append(got)
            d = float((res[0] - res[1]).abs().max())
            if not d <= SPLIT_GATE * scale:
                raise RuntimeError(f'bf16 wgrad {bm}x{bn}: 7 chunks vs one: '
                                   f'max|d| {d} > {SPLIT_GATE} x {scale}')
            checked.append(f'wgrad tile {bm}x{bn} 7 chunks vs one '
                           f'(max|d|/max|ref| {d / scale:.1e})')
    _, counts = wgrad('counts_1_63_64_65', 3000, 3000, 27, 64, 64,
                      route='tc', edit=set_counts)
    if counts[:4].tolist() != [1, 63, 64, 65]:
        raise RuntimeError(f'bf16 wgrad counts {counts[:4].tolist()}')
    for what, c in (('all_absent', 128), ('all_absent_narrow', 3)):
        got, counts = wgrad(
            what, 2000, 1500, 27, 64, c, route='tc' if c > 3 else 'narrow',
            edit=lambda x, xm, idx, y, ym: (x, xm, torch.full_like(idx, -1),
                                            y, ym))
        if got.any() or counts.any():
            raise RuntimeError(f'bf16 wgrad {what}: output is not zero')
    for route, c in (('tc', 64), ('narrow', 3)):
        x, xm, idx, y, ym = _wgrad_case(g, 8192, 8192, 27, 64, c,
                                        device=device)
        plan = S.bf16_wgrad_plan(x, idx, y)
        if plan.route != route or plan.chunks < 4:
            raise RuntimeError(f'bf16 wgrad chunked case: {plan}')
        a, _, scale, _ = _check_wgrad(S, x, xm, idx, y, ym, 'bf16 chunks',
                                      plan, bf16=True)
        c1, _, _, _ = _check_wgrad(S, x, xm, idx, y, ym, 'bf16 one chunk',
                                   plan._replace(chunks=1), bf16=True)
        d = float((a - c1).abs().max())
        if not d <= SPLIT_GATE * scale:
            raise RuntimeError(f'bf16 wgrad {route} {plan.chunks} chunks vs '
                               f'one: max|d| {d} > {SPLIT_GATE} x {scale}')
        checked.append(f'wgrad {route} {plan.chunks} chunks vs one '
                       f'(max|d|/max|ref| {d / scale:.2e})')
    log('[edges] bf16 kernels == plain (K2-bf16 and K3-bf16 within '
        f'{CONV_GATE} x max|ref| and the same bits twice): ' +
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


@contextlib.contextmanager
def fusion_calls():
    """Records each call of the detectors' fusion (``models.trunk``'s
    ``point_image_sample_batched``) while active: its arguments and its
    output."""
    from embodiedscan_torch.models import trunk
    fuse = trunk.point_image_sample_batched
    calls = []

    def recorded(*args):
        out = fuse(*args)
        calls.append((args, out.detach()))
        return out

    trunk.point_image_sample_batched = recorded
    try:
        yield calls
    finally:
        trunk.point_image_sample_batched = fuse


def fusion_pixels(args):
    """(BI, S, V, N) the flat pixel of its view's feature map that each
    point reads in a recorded 'nearest' fusion call, -1 where the view
    does not see it: the fusion run again on the call's device, one view
    at a time, over a map that holds each pixel's index + 1."""
    from embodiedscan_torch.models.fusion import point_image_sample_batched
    points, mask, feats, proj, aug_inv, pad_hw, mode, view_mask = args[:8]
    bi, v, hf, wf, _ = feats.shape
    index = torch.arange(1, hf * wf + 1, dtype=torch.float32,
                         device=feats.device).reshape(1, 1, hf, wf, 1)
    out = []
    for j in range(v):
        one = torch.zeros_like(view_mask)
        one[:, :, j] = view_mask[:, :, j]
        out.append(point_image_sample_batched(
            points, mask, index.expand(bi, v, hf, wf, 1), proj, aug_inv,
            pad_hw, mode, one)[..., 0])
    return torch.stack(out, 2).round().long() - 1


def fusion_report(cpu_calls, cuda_calls):
    """One line per pair of recorded fusion calls (:func:`fusion_calls`) of
    a cpu and a cuda run: the (point, view) pairs whose nearest pixel
    differs, and the largest |d| of the fused features."""
    lines = []
    for i, ((ac, oc), (ag, og)) in enumerate(zip(cpu_calls, cuda_calls)):
        try:
            pc, pg = fusion_pixels(ac).cpu(), fusion_pixels(ag).cpu()
            where = torch.nonzero(pc != pg)[:8].tolist()
            lines.append(
                f'fusion call {i}: {int((pc != pg).sum())} of {pc.numel()} '
                f'(point, view) nearest pixels differ (first (b, s, v, n): '
                f'{where}), fused features max|d| '
                f'{float((oc.cpu() - og.cpu()).abs().max()):.3g}')
        except Exception as err:  # the report must not hide the failure
            lines.append(f'fusion call {i}: no report ({err!r})')
    if len(cpu_calls) != len(cuda_calls):
        lines.append(f'{len(cpu_calls)} fusion calls on the cpu, '
                     f'{len(cuda_calls)} on the card')
    return lines


def det_parity(cpu, gpu, req, device, what):
    """One request of a detector on cpu (plain versions) and its twin on
    ``device`` (kernels): neighbor tables, feature coordinates and masks,
    labels and keep masks identical; head outputs, boxes and scores within
    atol 1e-4 + rtol 1e-5. Where a check fails, the log names the field
    and the element, then compares the two runs' fusions
    (:func:`fusion_report`)."""
    from embodiedscan_torch.ops import pscan as P
    from embodiedscan_torch.ops import sparse as S
    out = {}
    for name, model, dev in (('cpu', cpu, 'cpu'), ('cuda', gpu, device)):
        with Recorder(S, P) as rec, fusion_calls() as fused:
            feats = model(to_device(req, dev), mode='feats')
            preds = model(to_device(req, dev), mode='predict')
        out[name] = (rec, feats, {k: v.cpu() for k, v in preds.items()},
                     fused)
    try:
        _det_checks(out, what)
    except RuntimeError:
        for line in fusion_report(out['cpu'][3], out['cuda'][3]):
            log(f'[parity] {what}: {line}')
        raise


def _det_checks(out, what):
    """:func:`det_parity`'s checks of the cpu and cuda runs ``out``."""
    (rc, fc, pc, _), (rg, fg, pg, _) = out['cpu'], out['cuda']
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
    excess = (a - b).abs() - tol
    worst = float(excess.max())
    if worst > 0:
        i = int(excess.argmax())
        raise RuntimeError(
            f'{what}: cpu and cuda differ beyond tolerance (max excess '
            f'{worst} at flat index {i} of {tuple(a.shape)}: cpu '
            f'{float(a.reshape(-1)[i])}, cuda {float(b.reshape(-1)[i])})')
    return worst


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


def train_parity(device, cfg=None, batch=None, build=None):
    """One train step of the small detector (``cfg``, default
    ``_parity_cfg()``; ``build(cfg, device)`` makes it, default
    ``build_model``) on ``device`` (kernels) and on cpu (plain versions)
    from the same weights and batch (default: ``make_batch``'s scene of
    6000 points, 4 views of 96x96 and 16 gt boxes). Raises unless the
    integer tables are identical; returns the cpu and cuda metrics and, per
    kind (losses, grads, batch stats), the worst max|d|/max|cpu| over its
    leaves with that leaf's path."""
    from embodiedscan_torch.configs.base import build_model
    from embodiedscan_torch.ops import pscan as P
    from embodiedscan_torch.ops import sparse as S
    from embodiedscan_torch.train.state import make_optimizer, train_step
    from embodiedscan_torch.utils.convert_weights import export_jax_tree
    cfg = cfg or _parity_cfg()
    build = build or build_model
    cpu = build(cfg, device='cpu').train()
    gpu = build(cfg, device=device).train()
    gpu.load_state_dict(cpu.state_dict())
    if batch is None:
        batch = make_batch(1, 6000, 4, 96, 16, cfg.model.num_classes, seed=7)
    out = {}
    for name, model, dev in (('cpu', cpu, 'cpu'), ('cuda', gpu, device)):
        with Recorder(S, P) as rec:
            metrics = train_step(model, make_optimizer(
                model, cfg, steps_per_epoch=PHASE_EPOCH),
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


def phase_train_parity(device, cfg=None, batch=None, what='train step'):
    """:func:`train_parity`: losses, every gradient leaf the optimizer used
    and the batch statistics after the step within GRAD_GATE x max|cpu| of
    each leaf."""
    n_tables, mc, mg, worst = train_parity(device, cfg, batch)
    for kind, (ratio, path) in worst.items():
        if not np.isfinite(ratio) or ratio > GRAD_GATE:
            raise RuntimeError(f'{what} {kind} {path}: max|d|/max|cpu| '
                               f'{ratio} > {GRAD_GATE}')
    log(f'[parity] {what} cpu vs cuda: {n_tables} tables identical '
        f'(forward, dgrad, wgrad), loss_total {mc["loss_total"]:.6g} vs '
        f'{mg["loss_total"]:.6g}; worst max|d|/max|cpu| per leaf: ' +
        ', '.join(f'{k} {v:.2e} ({p})' for k, (v, p) in worst.items()) +
        f' (gate {GRAD_GATE})')


LOSS_RTOL = 1e-5  # occupancy and head-variant train steps cpu vs cuda
# The grounding train step's losses, cpu vs cuda, relative, from
# ``--ground-gate`` (main_ground_gate) on an H100: sound readings 3.7e-6 to
# 3.5e-5 over 10 seeds of the scene and box branch (1.26e-5 at the phase's
# seed 7, the same on every run; at RoBERTa eps 1e-12, 1.6e-6 to 3.0e-5
# over 6), planted kernels 0.89 to 0.93 (K2 in 1xTF32, the bf16 route).
# 1e-4 is 2.9x the largest sound reading. K2
# outputs off by a random 1e-6 of their size, float32 rounding's scale,
# read 4.8e-5 to 6.7e-5 and pass, as they pass GRAD_GATE; from 1e-5 the
# matched indices change and the losses by 20% or more.
GROUND_LOSS_RTOL = 1e-4
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
def _relu_decisions(follow=None, atol=FLIP_ATOL):
    """While active, every ``F.relu`` logs its decisions (input > 0) into
    the yielded ``decisions`` list; with ``follow`` (another run's list),
    call k returns ``x * follow[k]``: that run's decisions on this run's
    values (the same values and gradients wherever the two agree). Each
    differing decision must be a tie within ``atol`` x max|x|; ``flips``
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
            if not worst <= atol:
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


def _ground_step(model, cfg, batch, dev, follow=None, atol=FLIP_ATOL):
    """One train step of a grounder with the task's lr multipliers, its
    ReLUs logged or following ``follow`` within ``atol``
    (:func:`_relu_decisions`): the
    recorder, the losses, the gradients, the buffers after the step, the
    matched gt indices, the ReLU decisions and the flips."""
    from embodiedscan_torch.ops import pscan as P
    from embodiedscan_torch.ops import sparse as S
    from embodiedscan_torch.train.loop import lr_mult_fn_for
    from embodiedscan_torch.train.state import make_optimizer, train_step
    opt = make_optimizer(model, cfg, lr_mult_fn_for(cfg.model.task),
                         steps_per_epoch=PHASE_EPOCH)
    seen = []
    match = model.match
    model.match = lambda *a: seen.append(match(*a)) or seen[-1]
    try:
        with Recorder(S, P) as rec, \
                _relu_decisions(follow, atol) as (dec, flips):
            metrics = train_step(model, opt, to_device(batch, dev))
    finally:
        del model.match  # back to the class's method
    return (rec, {k: float(v) for k, v in metrics.items()},
            {n: p.grad.cpu() for n, p in model.named_parameters()
             if p.grad is not None},
            {n: b.cpu() for n, b in model.named_buffers()}, seen[0].cpu(),
            dec, flips)


def ground_train_readings(device, seed=7, cfg=None, control=None):
    """One train step of the small grounder (``_ground_parity_cfg``: the
    shipped widths, RoBERTa-base) with the task's lr multipliers on
    ``device`` (kernels), then on cpu (plain versions) taking the card's
    ReLU decisions (``_relu_decisions``), from the same weights and batch:
    ``build_model``'s weights (from ``cfg.seed``) and ``PROMPTS[0]`` at
    every seed, the box branch's output and the scene from ``seed``, which
    also seeds torch's generator. ``control``
    plants a fault in the card's step alone (``_planted``), and the cpu
    then takes the card's ReLU decisions whatever their size. Returns
    the readings that :func:`phase_ground_train_parity` gates."""
    from embodiedscan_torch.configs.base import build_model
    cfg = cfg or _ground_parity_cfg()
    torch.manual_seed(seed)
    cpu = _box_branch(build_model(cfg, device='cpu'), seed).train()
    gpu = build_model(cfg, device=device).train()
    gpu.load_state_dict(cpu.state_dict())
    batch = make_ground_train_batch(cfg, 6000, 4, 96, seed=seed)
    with _planted(control):
        rg, mg, gg, bg, ig, dec, _ = _ground_step(gpu, cfg, batch, device)
    rc, mc, gc, bc, ic, _, flips = _ground_step(
        cpu, cfg, batch, 'cpu', dec,
        FLIP_ATOL if control is None else float('inf'))
    kinds = ('conv', 'dgrad', 'wgrad')
    calls = all(len(getattr(rc, k)) == len(getattr(rg, k)) and
                getattr(rc, k) for k in kinds)
    tables = [(a[2], b[2]) for k in kinds
              for a, b in zip(getattr(rc, k), getattr(rg, k))]
    if set(gc) != set(gg):
        raise RuntimeError('cpu and cuda grounders have gradients for '
                           'different parameters')
    scales = _gate_scales(gc)
    return dict(
        calls=calls, tables=len(tables),
        tables_equal=all(torch.equal(a, b.cpu()) for a, b in tables),
        matches_equal=torch.equal(ic, ig), layers=ic.shape[0],
        matches=int((ic >= 0).sum()),
        loss_rel=max(abs(mg[k] - v) / abs(v) for k, v in mc.items()),
        loss_key=max(mc, key=lambda k: abs(mg[k] - mc[k]) / abs(mc[k])),
        loss_total=mc['loss_total'],
        worst={'grads': _worst(gc, gg, scales),
               'batch stats': _worst(bc, bg)},
        leaves=len(gc), flips=flips, relu_calls=len(dec),
        residue=sorted(n for n, v in scales.items()
                       if v > float(gc[n].abs().max())))


def phase_ground_train_parity(device):
    """:func:`ground_train_readings` at its seed, gated: every conv, dgrad
    and wgrad table and every layer's matched gt indices identical, each
    loss within GROUND_LOSS_RTOL of the cpu's, every gradient leaf within
    GRAD_GATE x its scale (``_gate_scales``) and every batch statistic
    within GRAD_GATE x its max|cpu|."""
    r = ground_train_readings(device)
    if not r['calls']:
        raise RuntimeError('cpu and cuda grounding train steps made '
                           'different calls')
    if not r['tables_equal']:
        raise RuntimeError('grounding train step tables differ between cpu '
                           'and cuda')
    if not r['matches_equal']:
        raise RuntimeError('grounding train step: matched gt indices differ '
                           'between cpu and cuda')
    if not r['loss_rel'] <= GROUND_LOSS_RTOL:
        raise RuntimeError(f'grounding train step losses: relative '
                           f'{r["loss_rel"]:.3g} > {GROUND_LOSS_RTOL}')
    for what, (ratio, key) in r['worst'].items():
        if not np.isfinite(ratio) or ratio > GRAD_GATE:
            raise RuntimeError(f'grounding train step {what} {key}: '
                               f'max|d|/scale {ratio} > {GRAD_GATE}')
    flips = r['flips']
    log(f'[parity] grounding train step cpu vs cuda: {r["tables"]} tables '
        f'and the matched gt indices of {r["layers"]} layers identical '
        f'({r["matches"]} matches), losses within {r["loss_rel"]:.2e} '
        f'relative (gate {GROUND_LOSS_RTOL}), loss_total '
        f'{r["loss_total"]:.6g}; {sum(n for _, n, _ in flips)} of the '
        f'cpu\'s ReLU decisions in {len(flips)} of {r["relu_calls"]} calls '
        f'took the card\'s, each a tie within '
        f'{max([w for _, _, w in flips], default=0):.2e} x max|x| (gate '
        f'{FLIP_ATOL}); worst max|d|/scale over {r["leaves"]} gradient '
        f'leaves and the batch statistics: ' +
        ', '.join(f'{k} {v:.2e} ({p})' for k, (v, p) in r['worst'].items()) +
        f' (gate {GRAD_GATE}); {len(r["residue"])} residue leaves on their '
        f'block\'s scale ({", ".join(r["residue"][:4])}, ...)')
    return dict(worst=r['worst'], flips=flips, loss_rel=r['loss_rel'])


@contextlib.contextmanager
def _planted(control):
    """The faults of ``--ground-gate``'s controls, on the card's step only:
    ``'tf32'`` rounds K2's forward inputs to TF32 (features and weights
    to 10 mantissa bits, the gradient passed through): a 1xTF32 kernel
    where the port's is 3xTF32; ``'bf16'`` is the
    benchmark's control, the bf16 sparse-conv route with TF32 on."""
    from embodiedscan_torch.ops import sparse as S
    if control is None:
        yield
        return
    if control == 'bf16':
        S.set_conv_compute_dtype(torch.bfloat16)
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        try:
            yield
        finally:
            S.set_conv_compute_dtype(None)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        return
    if control != 'tf32':
        raise ValueError(f'unknown control {control!r}')

    def tf32(x):  # round to nearest, as the tensor cores' TF32 inputs
        bits = x.detach().contiguous().view(torch.int32)
        cut = ((bits + 4096) & -8192).view(torch.float32)
        return x + (cut - x).detach()

    conv = S.gather_matmul_conv

    def planted(feats, mask, nbr, weights, bias=None):
        return conv(tf32(feats), mask, nbr, tf32(weights), bias)

    planted.__dict__.update(conv.__dict__)  # its launch counts, shared
    S.gather_matmul_conv = planted
    try:
        yield
    finally:
        S.gather_matmul_conv = conv


def main_ground_gate(seeds, control_seeds=''):
    """``chip_smoke.py --ground-gate S1,S2,... C1,C2,...``: the readings
    GROUND_LOSS_RTOL is set from. At each sound seed the card's
    grounding train step against the cpu's (:func:`ground_train_readings`);
    at each control seed the same under each of ``_planted``'s faults.
    One JSON line a run, then each number's largest sound and least
    control reading; all of it in chiprun_out/chip_smoke_ground-gate.json.
    """
    log(f'[ground_gate] {torch.cuda.get_device_name(0)}')
    rows = []
    runs = [(int(s), None) for s in seeds.split(',') if s] + \
        [(int(s), c) for s in control_seeds.split(',') if s
         for c in ('tf32', 'bf16')]
    for seed, control in runs:
        t0 = time.perf_counter()
        r = ground_train_readings('cuda', seed, control=control)
        row = dict(seed=seed, control=control, loss_rel=r['loss_rel'],
                   loss_key=r['loss_key'],
                   grads=r['worst']['grads'][0],
                   batch_stats=r['worst']['batch stats'][0],
                   matches_equal=r['matches_equal'],
                   tables_equal=r['tables_equal'],
                   flips=sum(n for _, n, _ in r['flips']),
                   flip_worst=max([w for _, _, w in r['flips']], default=0),
                   seconds=time.perf_counter() - t0)
        print(json.dumps(row), flush=True)
        rows.append(row)
    summary = {}
    for key in ('loss_rel', 'grads', 'batch_stats', 'flip_worst'):
        sound = [r[key] for r in rows if r['control'] is None]
        summary[key] = dict(sound_max=max(sound, default=None), **{
            f'{c}_min': min([r[key] for r in rows if r['control'] == c],
                            default=None) for c in ('tf32', 'bf16')})
    print(json.dumps({'summary': summary}))
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, 'chip_smoke_ground-gate.json'),
              'w') as f:
        json.dump(dict(rows=rows, summary=summary), f, indent=1)
    return 0


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
    (every tensor loaded, none skipped: the grounder's preset has
    roberta-base's 50265-row vocabulary), restored into a fresh ``build_model``
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
        for task, want in (('mv_det3d', EXPECTED_LAUNCHES),
                           ('mv_grounding', EXPECTED_GROUND_LAUNCHES)):
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
            if skipped or n != total:
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
    worst = max(_metrics_diff(out[device, what], out['cpu', what],
                              f'{what} eval') for what in ('det', 'ground'))
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
                     [outs.cls.cpu(), outs.boxes.cpu(),
                      outs.query_mask.cpu()],
                     {k: v.cpu() for k, v in preds.items()})
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
    if skipped:
        raise RuntimeError(f'converted small grounder skipped {skipped}')
    req = make_ground_request(cfg.model.max_text_len, seed=8, p=6000, v=4,
                              hw=96, tokenizer=BPETokenizer(
                                  ROBERTA_TOK, cfg.model.max_text_len))
    ground_parity(cpu, gpu, req, device,
                  f'converted grounder ({n} tensors) cpu vs cuda')


# --- the occupancy paths (mv_occ) ---


def make_occ_request(p=100000, v=20, hw=480, seed=0, b=1, n_gt=0,
                     num_classes=81):
    """``b`` rooms of ``p`` points inside mv_occ's point_cloud_range: a
    floor at z = -0.7 m, four walls up to 1.7 m (2.4 m: taller than the
    1.28 m a 9-bit z reaches at 0.0025 m voxels) and a table top, 1 cm
    noise; ``v`` cameras 7 m above, looking down. With ``n_gt``, also
    ``gt_occ``: the prior-grid cells (0.16 m) the cloud occupies, labelled
    by surface (1-6, or with p 0.3 a class of 1 .. num_classes - 1),
    padded to ``n_gt`` rows, and a visibility mask. Numpy, from a seed."""
    rng = np.random.RandomState(seed)
    u = rng.uniform(0, 1, (b, p, 2)).astype(np.float32)
    a, h = -3.1 + 6.2 * u[..., 0], -0.7 + 2.4 * u[..., 1]
    which = rng.randint(0, 6, (b, p))
    const = np.full_like(a, 3.1)
    pts = np.select(
        [which[..., None] == k for k in range(6)],
        [np.stack(c, -1) for c in (
            (a, -3.1 + 6.2 * u[..., 1], np.full_like(a, -0.7)),  # floor
            (-const, a, h), (const, a, h), (a, -const, h), (a, const, h),
            (-1 + 2 * u[..., 0], -0.5 + u[..., 1], np.full_like(a, 0.05)))])
    pts = (pts + rng.randn(b, p, 3) * 0.01).astype(np.float32)
    k = np.array([[0.8 * hw, 0, hw / 2, 0], [0, 0.8 * hw, hw / 2, 0],
                  [0, 0, 1, 0], [0, 0, 0, 1]], np.float32)
    projs = []
    for i in range(v):
        ext = np.eye(4, dtype=np.float32)
        ext[:3, 3] = [0.3 * i - 0.15 * (v - 1), 0.2 * i - 0.1 * (v - 1), 7.0]
        projs.append(k @ ext)
    req = dict(points=pts, points_mask=np.ones((b, p), bool),
               imgs=rng.randn(b, v, hw, hw, 3).astype(np.float32),
               proj=np.tile(np.stack(projs)[None], (b, 1, 1, 1)),
               aug_inv=np.tile(np.eye(4, dtype=np.float32), (b, 1, 1)))
    if n_gt:
        gt = np.zeros((b, n_gt, 4), np.float32)
        gm = np.zeros((b, n_gt), bool)
        for i in range(b):
            cells = np.floor((pts[i] - np.array([-3.2, -3.2, -0.78])) /
                             0.16).astype(np.int64)
            cells, first = np.unique(cells, axis=0, return_index=True)
            labels = np.where(rng.uniform(size=len(cells)) < 0.3,
                              rng.randint(1, num_classes, len(cells)),
                              which[i][first] + 1)
            n = min(len(cells), n_gt)
            gt[i, :n] = np.concatenate([cells, labels[:, None]], 1)[:n]
            gm[i, :n] = True
        req.update(gt_occ=gt, gt_occ_mask=gm,
                   visible_mask=rng.uniform(size=(b, 40, 40, 16)) > 0.15)
    return req


def occ_parts(model, batch, timer=None):
    """The occupancy request stage by stage (voxelize + MinkResNet, ResNet
    + FPN, image volume, U-Net, head + argmax), each through ``timer``
    (``fn -> (ms, out)``) when one is given; returns (ms per stage, the
    logits, the predicted classes)."""
    timer = timer or (lambda fn: (0.0, fn()))
    ms = {}

    def stage(name, fn):
        ms[name], out = timer(fn)
        return out

    with torch.no_grad():
        points = stage('voxelize_mink_resnet34',
                       lambda: model.point_volume(batch))
        maps = stage('resnet50_fpn', lambda: model.image_maps(batch['imgs']))
        image = stage('image_volume', lambda: model.image_volume(batch,
                                                                 maps))
        x = model.fuse(image, points)
        feats = stage('unet', lambda: model.neck(x))
        logits, pred = stage('head_argmax', lambda: (lambda lg: (
            lg, model.OccHead_0.predict(lg)))(model.OccHead_0(feats)))
    return ms, logits, pred


@contextlib.contextmanager
def _timed_init(out):
    """While active, ``models.detector.init_weights`` (which
    ``build_model`` calls) adds its host seconds to ``out['init_s']``."""
    from embodiedscan_torch.models import detector as D
    init = D.init_weights

    def timed(*args):
        t0 = time.perf_counter()
        try:
            return init(*args)
        finally:
            out['init_s'] = out.get('init_s', 0.0) + time.perf_counter() - t0

    D.init_weights = timed
    try:
        yield out
    finally:
        D.init_weights = init


def phase_occ(device, card, cfg=None):
    """The mv_occ serving path at full width (81 classes, ResNet-50/64 +
    FPN 256, MinkResNet-34 at 0.0025 m, the 768 -> 1536 -> 3072 U-Net on
    40 x 40 x 16): one recorded warm-up request, then three timed ones
    (20 views of 480x480, 100k points), each with its peak memory, its
    kept voxels and its launch counts against EXPECTED_OCC_LAUNCHES; then
    the host-clock time of each stage."""
    from embodiedscan_torch.configs.base import build_model, mv_occ
    from embodiedscan_torch.ops import pscan as P
    from embodiedscan_torch.ops import sparse as S
    cfg = cfg or mv_occ()
    m, d = cfg.model, cfg.data
    t0 = time.perf_counter()
    with _timed_init({}) as init:
        model = build_model(cfg, device=device)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    unet = sum(p.numel() for p in model.ImVoxelNeck_0.parameters())
    log(f'[occ] built mv_occ on {device} in {time.perf_counter() - t0:.1f} '
        f's (seeded host init {init["init_s"]:.1f} s): {n_params} '
        f'parameters, of which the U-Net {unet}; {card}')
    requests = [make_occ_request(d.n_points, d.n_views_test, d.image_hw[0],
                                 seed=s, n_gt=d.max_occ_voxels,
                                 num_classes=m.occ_classes)
                for s in range(4)]
    with Recorder(S, P) as rec:  # warm-up request: record kernel inputs
        t0 = time.perf_counter()
        model(to_device(requests[0], device), mode='predict')
        torch.cuda.synchronize()
    log(f'[occ] warm-up request {time.perf_counter() - t0:.2f} s, '
        f'{len(rec.conv)} conv and {len(rec.scan)} join-scan calls recorded')
    lat, mem, kept, served = [], [], [], []
    totals = dict.fromkeys(EXPECTED_OCC_LAUNCHES, 0)
    shape = (1, *m.n_voxels)
    for i, req in enumerate(requests[1:]):
        batch = to_device(req, device)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(S, P)
        t0 = time.perf_counter()
        pred = model(batch, mode='predict')
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
        counts = read_counts(S, P)
        mem.append(torch.cuda.max_memory_allocated() / 2**30)
        if tuple(pred.shape) != shape or not (
                (pred >= 0) & (pred < m.occ_classes)).all():
            raise RuntimeError(f'occupancy request {i}: shape '
                               f'{tuple(pred.shape)}, classes out of range')
        check_counts(counts, EXPECTED_OCC_LAUNCHES, f'occupancy request {i}')
        for name in totals:
            totals[name] += counts[name]
        with torch.no_grad():
            kept.append(int(model.voxelize(batch).mask.sum()))
        served.append((batch, pred))
        log(f'[occ] request {i}: {lat[-1] * 1e3:.1f} ms, peak '
            f'{mem[-1]:.2f} GiB, {kept[-1]} of {d.n_points} points kept as '
            f'voxels (the 11-bit key reaches 5.12 m of the 6.4 m range), '
            f'{len(torch.unique(pred))} classes predicted, launches {counts}')
    log(f'[occ] latency ms per request: {[round(t * 1e3, 3) for t in lat]}, '
        f'peak GiB {max(mem):.3f}; {card}')
    stats = dict(latency_ms=[t * 1e3 for t in lat], peak_gib=max(mem),
                 kept_voxels=kept, parameters=n_params, unet_parameters=unet,
                 init_s=init['init_s'])
    batch = served[0][0]
    stages = occ_parts(model, batch, _host_ms)[0]
    log('[breakdown] occupancy host ms per stage: ' + ', '.join(
        f'{k} {v:.2f}' for k, v in stages.items()))
    stats.update(stages_ms=stages)
    return rec, totals, stats, model, batch, served


def phase_occ_train(device, card, cfg=None):
    """The mv_occ train step at full width: ``build_train`` (the 2D stem
    and first stage frozen); 10 views of 480x480, 100k points,
    ``max_occ_voxels`` padded gt voxels and a visibility mask;
    :func:`train_steps` against EXPECTED_OCC_TRAIN_LAUNCHES; then every
    frozen parameter bit-identical, every other one moved and the U-Net's
    running statistics moved."""
    from embodiedscan_torch.configs.base import build_train, mv_occ
    cfg = cfg or mv_occ()
    d = cfg.data
    t0 = time.perf_counter()
    model, opt = build_train(cfg, device=device,
                             steps_per_epoch=PHASE_EPOCH)
    batch = to_device(make_occ_request(
        d.n_points, d.n_views_train, d.image_hw[0], seed=9,
        n_gt=d.max_occ_voxels, num_classes=cfg.model.occ_classes), device)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    stats0 = {n: b.clone() for n, b in model.ImVoxelNeck_0.named_buffers()}
    frozen = {n for n, p in model.named_parameters() if not p.requires_grad}
    log(f'[occ_train] built mv_occ and AdamW on {device} in '
        f'{time.perf_counter() - t0:.1f} s: frozen '
        f'{sum(before[n].numel() for n in frozen)} parameters in '
        f'{len(frozen)} tensors; batch b=1, {d.n_points} points, '
        f'{d.n_views_train} views, {int(batch["gt_occ_mask"].sum())} of '
        f'{d.max_occ_voxels} gt voxels valid; {card}')
    rec, totals, stats = train_steps('occ_train', model, opt, batch,
                                     EXPECTED_OCC_TRAIN_LAUNCHES)
    params = dict(model.named_parameters())
    moved = [n for n in frozen if not torch.equal(params[n], before[n])]
    # the FPN outputs past the finest are not read: their zero biases get
    # no gradient and no decay
    stuck = [n for n in params if n not in frozen and before[n].any() and
             torch.equal(params[n], before[n])]
    still = {n: b for n, b in model.ImVoxelNeck_0.named_buffers()
             if torch.equal(b, stats0[n])}
    if moved or stuck or still:
        raise RuntimeError(f'occupancy train: frozen tensors moved {moved}, '
                           f'trained tensors did not move {stuck}, U-Net '
                           f'statistics did not move {list(still)}')
    log(f'[occ_train] after {len(stats["losses"]) + 1} steps: the '
        f'{len(frozen)} frozen tensors bit-identical, every other nonzero '
        f'tensor moved, the U-Net\'s {len(stats0)} running statistics '
        f'moved; {card}')
    return rec, totals, stats, model, opt, batch


def occ_unet_share(model, batch, stats, train_model, train_batch,
                   train_stats, card):
    """The U-Net's device time (profiler): its forward on the request's
    fused volume, and its forward and backward on the train batch's,
    beside the profiled request's and step's device busy time."""
    with torch.no_grad():
        x = model.features(batch)
    fwd = device_profile(lambda: model.neck(x))
    with torch.no_grad():
        xt = train_model.features(train_batch)
    xt.requires_grad_(True)

    def fwd_bwd():
        sum(f.sum() for f in train_model.neck(xt)).backward()

    both = device_profile(fwd_bwd)
    train_model.zero_grad(set_to_none=True)
    stats.update(unet_launches=fwd[0], unet_device_ms=fwd[1])
    train_stats.update(unet_launches=both[0], unet_device_ms=both[1])
    log(f'[breakdown] occupancy U-Net device time: request {fwd[1]:.2f} ms '
        f'({fwd[0]} launches) of {stats["device_busy_ms"]:.2f} ms busy '
        f'(share {fwd[1] / stats["device_busy_ms"]:.3f}); train step '
        f'forward + backward {both[1]:.2f} ms ({both[0]} launches) of '
        f'{train_stats["device_busy_ms"]:.2f} ms busy (share '
        f'{both[1] / train_stats["device_busy_ms"]:.3f}); {card}')


def phase_occ_eval(served, device):
    """``occupancy_eval`` over the served requests through
    ``_append_scene_results``, with the ground truth's label grids built on
    the card and on the cpu: identical records, identical metric dicts.
    Each request's gt is its own synthetic one, with a third of its cells
    relabelled as the prediction so classes overlap."""
    from embodiedscan_torch.configs.base import mv_occ
    from embodiedscan_torch.eval.occupancy_metric import occupancy_eval
    from embodiedscan_torch.train.loop import _append_scene_results
    cfg = mv_occ()
    out, ms = {}, {}
    for dev in (device, 'cpu'):
        gts, dts = [], []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i, (batch, pred) in enumerate(served):
            b = {k: v.to(dev) for k, v in batch.items()}
            c = b['gt_occ'][0, :, :3].long()
            agree = (torch.arange(c.shape[0], device=dev) % 3) == 0
            b['gt_occ'] = b['gt_occ'].clone()
            b['gt_occ'][0, :, 3] = torch.where(
                agree, pred.to(dev)[0, c[:, 0], c[:, 1], c[:, 2]].float(),
                b['gt_occ'][0, :, 3])
            _append_scene_results(cfg, b, pred.to(dev), 1, gts, dts, i)
        res = occupancy_eval(gts, dts, cfg.model.occ_classes)
        ms[dev] = (time.perf_counter() - t0) * 1e3
        out[dev] = (gts, dts, res)
    (gc, dc, rc), (gg, dg, rg) = out['cpu'], out[device]
    if not all(np.array_equal(a, b) for a, b in zip(gc + dc, gg + dg)):
        raise RuntimeError('occupancy eval: records differ between the card '
                           'and the cpu')
    if rc != rg:
        raise RuntimeError(f'occupancy eval: {rc} != {rg}')
    if not rg['mIoU'] > 0:
        raise RuntimeError(f'occupancy eval: no hit ({rg})')
    log(f'[occ_eval] occupancy_eval over {len(gg)} scenes: mIoU '
        f'{rg["mIoU"]:.4f}, empty (geometry) IoU {rg["empty"]:.4f}, '
        f'{len(rg) - 1} classes scored; card and cpu records and dicts '
        f'identical; ms with the targets on the card {ms[device]:.1f}, on '
        f'the cpu {ms["cpu"]:.1f}')
    return dict(metrics=rg, ms=ms)


def _occ_parity_cfg():
    """The small mv_occ of the parity phases: shipped depths and widths up
    to the U-Net (ResNet-50/64 + FPN 256, MinkResNet-34, 81 classes, the
    40 x 40 x 16 grid at 0.0025 m), a 32-channel pre-neck, capacities cut
    for 6000-point scenes."""
    from embodiedscan_torch.configs.base import mv_occ
    cfg = mv_occ()
    m = cfg.model
    m.input_capacity = 8192
    m.backbone_capacities = (8192, 8192, 4096, 2048, 1024, 1024)
    m.occ_pre_neck_channels = 32
    return cfg


# argmax at the finest scale: where the card and the cpu pick different
# classes, the two top logits must be a tie within the serving tolerance
ARGMAX_TIE = dict(atol=1e-4, rtol=1e-5)


@torch.no_grad()
def phase_occ_parity(device, cfg=None, req=None, calib=None,
                     what='occupancy'):
    """The small occupancy model (``cfg``, default ``_occ_parity_cfg()``;
    its norms calibrated on the scene ``calib`` by ``_calibrate_norms``) on
    ``device`` (kernels) and on cpu (plain versions) with the same weights,
    on ``req`` (default: b = 2 rooms of 2.4 m): voxel coordinates and
    masks and every conv table
    identical, per-scale logits within atol 1e-4 + rtol 1e-5, the
    predicted classes identical except where the top two logits tie
    within that tolerance (reported); then both sides' U-Net and head
    from the cpu's fused volume against a float64 copy."""
    from embodiedscan_torch.configs.base import build_model
    from embodiedscan_torch.ops import pscan as P
    from embodiedscan_torch.ops import sparse as S
    cfg = cfg or _occ_parity_cfg()
    if calib is None:
        calib = make_occ_request(p=6000, v=4, hw=96, seed=5, b=2)
    if req is None:
        req = make_occ_request(p=6000, v=4, hw=96, seed=7, b=2)
    cpu = _calibrate_norms(build_model(cfg, device='cpu'),
                           to_device(calib, 'cpu'))
    gpu = build_model(cfg, device=device)
    gpu.load_state_dict(cpu.state_dict())
    out = {}
    for name, model, dev in (('cpu', cpu, 'cpu'), ('cuda', gpu, device)):
        batch = to_device(req, dev)
        with Recorder(S, P) as rec:
            _, logits, pred = occ_parts(model, batch)
        st = model.voxelize(batch)
        out[name] = (rec, [t.cpu() for t in logits], pred.cpu(),
                     st.coords.cpu(), st.mask.cpu())
    (rc, lc, pc, cc, mc), (rg, lg, pg, cg, mg) = out['cpu'], out['cuda']
    if len(rc.conv) != len(rg.conv) or not rc.conv:
        raise RuntimeError(f'{what}: cpu and cuda models made different '
                           'conv calls')
    if not all(torch.equal(a[2], b[2].cpu()) for a, b in zip(rc.conv,
                                                             rg.conv)):
        raise RuntimeError(f'{what} neighbor tables differ between cpu '
                           'and cuda')
    if not (torch.equal(cc, cg) and torch.equal(mc, mg)):
        raise RuntimeError(f'{what} voxels differ between cpu and cuda')
    z = cc[..., 2][mc]
    diffs = [_close(a, b, f'{what} logits scale {i}')
             for i, (a, b) in enumerate(zip(lc, lg))]
    flips = (pc != pg).nonzero()
    for idx in flips.tolist():
        top = torch.topk(lc[0][tuple(idx)], 2).values
        tol = ARGMAX_TIE['atol'] + ARGMAX_TIE['rtol'] * float(top[0].abs())
        if not float(top[0] - top[1]) <= tol:
            raise RuntimeError(f'{what} predict: voxel {idx} differs '
                               f'between cpu and cuda without a tie')
    # both sides' float32 rounding: the U-Net and head from the cpu's
    # fused volume against a float64 copy
    x = cpu.features(to_device(req, 'cpu'))
    ref = copy.deepcopy(cpu).double()
    ref.ImVoxelNeck_0.dtype = torch.float64  # the U-Net's compute dtype
    want = ref.OccHead_0(ref.neck(x.double()))[0]
    err = {name: float((m.OccHead_0(m.neck(x.to(dev)))[0].cpu().double() -
                        want).abs().max())
           for name, m, dev in (('cpu', cpu, 'cpu'), ('cuda', gpu, device))}
    log(f'[parity] {what} cpu vs cuda: {len(rc.conv)} neighbor tables, '
        f'{int(mc.sum())} voxels (z spans {int(z.max() - z.min())} of the '
        f'512 a 9-bit key reaches) identical; logits (max|logit| '
        f'{float(lc[0].abs().max()):.4g}) within atol 1e-4 + rtol 1e-5 '
        f'(worst excess {max(diffs):.3g}); predicted classes identical in '
        f'{pc.numel() - len(flips)} of {pc.numel()} voxels, {len(flips)} '
        f'top-2 ties within the tolerance; U-Net + head from one fused '
        f'volume against float64: cuda max|d| {err["cuda"]:.3g}, cpu '
        f'{err["cpu"]:.3g}')
    return dict(argmax_ties=len(flips), worst_excess=max(diffs),
                float64_err=err)


@torch.no_grad()
def _calibrate_norms(model, batch):
    """A trained model's normalization statistics in place of the identity
    ones: one training-mode pass over ``batch`` with every batch norm's
    momentum at 0 keeps each norm's batch statistics; returns the model in
    eval mode. At identity statistics the random U-Net carries activations
    of ~50 to the logits, where float32 rounding (~2e-6 of that scale, on
    the cpu as on the card) reaches the serving gate's atol."""
    from embodiedscan_torch.models.norm import DenseBatchNorm, MaskedBatchNorm
    norms = [m for m in model.modules()
             if isinstance(m, (DenseBatchNorm, MaskedBatchNorm))]
    for norm in norms:
        norm.MOMENTUM = 0.0
    model.train()(batch, mode='feats')
    for norm in norms:
        del norm.MOMENTUM  # back to the class's
    return model.eval()


def phase_occ_train_parity(device, cfg=None, req=None, what='occupancy'):
    """One train step of the small occupancy model (``cfg``, default
    ``_occ_parity_cfg()``) with the task's lr multipliers on ``device``
    (kernels), then on cpu (plain versions) taking the card's ReLU
    decisions (``_relu_decisions``), from the same weights and batch
    (``req``, default: b = 2, 2.4 m rooms, 2048 padded gt voxels): every
    conv, dgrad and wgrad table identical, each loss within LOSS_RTOL,
    every gradient leaf (after the clip, as the optimizer used it) and
    batch statistic within GRAD_GATE x its max|cpu|."""
    from embodiedscan_torch.configs.base import build_model
    from embodiedscan_torch.ops import pscan as P
    from embodiedscan_torch.ops import sparse as S
    from embodiedscan_torch.train.loop import lr_mult_fn_for
    from embodiedscan_torch.train.state import make_optimizer, train_step
    cfg = cfg or _occ_parity_cfg()
    cpu = build_model(cfg, device='cpu').train()
    gpu = build_model(cfg, device=device).train()
    gpu.load_state_dict(cpu.state_dict())
    if req is None:
        req = make_occ_request(p=6000, v=4, hw=96, seed=8, b=2, n_gt=2048)
    out, follow = {}, None
    for name, model, dev in (('cuda', gpu, device), ('cpu', cpu, 'cpu')):
        opt = make_optimizer(model, cfg, lr_mult_fn_for(cfg.model.task),
                             steps_per_epoch=PHASE_EPOCH)
        with Recorder(S, P) as rec, _relu_decisions(follow) as (dec, flips):
            metrics = train_step(model, opt, to_device(req, dev))
        follow = dec
        out[name] = (rec, {k: float(v) for k, v in metrics.items()},
                     {n: p.grad.cpu() for n, p in model.named_parameters()
                      if p.grad is not None},
                     {n: b.cpu() for n, b in model.named_buffers()}, flips)
    (rg, mg, gg, bg, _), (rc, mc, gc, bc, flips) = out['cuda'], out['cpu']
    kinds = ('conv', 'dgrad', 'wgrad')
    if any(len(getattr(rc, k)) != len(getattr(rg, k)) or not getattr(rc, k)
           for k in kinds):
        raise RuntimeError(f'{what}: cpu and cuda train steps made '
                           'different calls')
    tables = [(a[2], b[2]) for k in kinds
              for a, b in zip(getattr(rc, k), getattr(rg, k))]
    if not all(torch.equal(a, b.cpu()) for a, b in tables):
        raise RuntimeError(f'{what} train step tables differ between cpu '
                           'and cuda')
    loss_err = max(abs(mg[k] - v) / abs(v) for k, v in mc.items())
    if not loss_err <= LOSS_RTOL:
        raise RuntimeError(f'{what} train step losses: {mc} vs {mg}')
    if set(gc) != set(gg):
        raise RuntimeError(f'{what}: cpu and cuda models have gradients for '
                           'different parameters')
    worst = {'grads': _worst(gc, gg), 'batch stats': _worst(bc, bg)}
    for kind, (ratio, key) in worst.items():
        if not np.isfinite(ratio) or ratio > GRAD_GATE:
            raise RuntimeError(f'{what} train step {kind} {key}: '
                               f'max|d|/max|cpu| {ratio} > {GRAD_GATE}')
    log(f'[parity] {what} train step cpu vs cuda: {len(tables)} tables '
        f'identical, losses within {loss_err:.2e} relative (gate '
        f'{LOSS_RTOL}), loss_total {mc["loss_total"]:.6g}; '
        f'{sum(n for _, n, _ in flips)} of the cpu\'s ReLU decisions in '
        f'{len(flips)} calls took the card\'s, each a tie within '
        f'{max([w for _, _, w in flips], default=0):.2e} x max|x| (gate '
        f'{FLIP_ATOL}); worst max|d|/max|cpu| over {len(gc)} gradient '
        f'leaves and the batch statistics: ' +
        ', '.join(f'{k} {v:.2e} ({p})' for k, (v, p) in worst.items()) +
        f' (gate {GRAD_GATE})')
    return dict(worst=worst, flips=flips, loss_rel=loss_err)


# --- the data path and the continuous tasks (cont_det3d, cont_occ) ---

# wrapper calls per request and per step of the continuous paths: a sweep
# pseudo-batch is a batch, so each runs the layers of its multi-view model
CONT_LAUNCHES = {'cont_det3d': EXPECTED_LAUNCHES,
                 'cont_det3d_train': EXPECTED_TRAIN_LAUNCHES,
                 'cont_occ': EXPECTED_OCC_LAUNCHES,
                 'cont_occ_train': EXPECTED_OCC_TRAIN_LAUNCHES}
CONT_DET_PATHS = ('cont_det3d', 'cont_det3d_train')
# input voxels of a 50-sweep cont_det3d request: its calls' most rows
CONT_ROWS = 50 * 98304
CONT_OCC_PATHS = ('cont_occ', 'cont_occ_train')
# the continuous paths' replays (up to 50x the rows of the multi-view
# ones): one warm-up call and two timed ones each
CONT_TIMING = dict(warmup=1, reps=2)
# cont_occ's train step takes remat (recomputation) only if its peak leaves
# less than this much of the card
HEADROOM_GIB = 10.0
# bf16 U-Net, card vs cpu: each side's bf16 logits against its own float32
# logits; the card's error at most twice the cpu's plus this many units of
# max|float32 logit| (one bf16 rounding step, 2^-8)
BF16_SLACK = 2.0**-8
# the synthetic room (data/synthetic.py): 6 x 6 m, floor at z = 0
ROOM_XY = 6.0


def card_name():
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True, check=True)
    return smi.stdout.strip().splitlines()[0]


def _views(scan, ids):
    views = [scan['views'][i] for i in ids]
    return ([v['depth'] for v in views], [v['intrinsic'] for v in views],
            [v['extrinsic'] for v in views])


def phase_data(card):
    """[data]: a full-width synthetic scan (50 views of 480x480, 32 boxes)
    through the port's data path. Its depth maps go through
    ``multiview_world_points`` (10000 points a view) on both backends: the
    native core must build (no numpy fallback); each backend's rows lie on
    the full back-projected set of their view (the two sample different
    rows); host ms per call of each, then of ``pack_sweeps`` at 10 and 50
    sweeps (100k points a sweep, 200 boxes). Returns the scan."""
    from scipy.spatial import cKDTree

    from embodiedscan_torch import native
    from embodiedscan_torch.data import pipeline as pl
    from embodiedscan_torch.data.synthetic import box_visibility, make_scan
    t0 = time.perf_counter()
    scan = make_scan(seed=0, n_views=50, hw=(480, 480), g=32)
    scan_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    if not native.available():
        raise RuntimeError('[data] the native host core did not build')
    build_s = time.perf_counter() - t0
    ids = range(len(scan['views']))
    depths, ks, exts = _views(scan, ids)
    ms, rows = {}, {}
    for backend in ('numpy', 'auto'):
        ms[backend] = []
        for rep in range(3):
            t0 = time.perf_counter()
            rows[backend] = pl.multiview_world_points(
                depths, ks, exts, 10000, np.random.RandomState(rep),
                native=backend)
            ms[backend].append((time.perf_counter() - t0) * 1e3)
    full = pl.aggregate_points_list(
        [pl.rgbd_to_points(d, k) for d, k in zip(depths, ks)], exts)
    dist = {b: max(float(cKDTree(whole).query(r[i])[0].max())
                   for i, whole in enumerate(full))
            for b, r in rows.items()}
    if not max(dist.values()) <= 1e-4:
        raise RuntimeError(f'[data] a sampled row is off its view\'s '
                           f'back-projected set: {dist}')
    if np.array_equal(rows['numpy'][0], rows['auto'][0]):
        raise RuntimeError('[data] the native backend returned the numpy '
                           'rows')
    vis = box_visibility(scan, ids, (480, 480))
    imgs = np.stack([pl.normalize_imgs(v['rgb'][None])[0]
                     for v in scan['views']])
    pack_ms = {}
    for n in (10, 50):
        t0 = time.perf_counter()
        sweeps = pl.pack_sweeps(rows['auto'][:n], vis[:n], imgs[:n], ks[:n],
                                exts[:n], scan['gt_boxes'], scan['gt_labels'],
                                None, 100000, 200, np.random.RandomState(0))
        pack_ms[n] = (time.perf_counter() - t0) * 1e3
        if sweeps['points'].shape != (n, 100000, 3):
            raise RuntimeError(f'[data] pack_sweeps: {sweeps["points"].shape}')
    kept = [len(p) for p in full]
    log(f'[data] synthetic scan of 50 views of 480x480 and 32 boxes in '
        f'{scan_s:.2f} s ({min(kept)}-{max(kept)} depth points a view); '
        f'native core built and loaded in {build_s:.2f} s; '
        f'multiview_world_points (10000 points a view) host ms per call: '
        f'numpy {[round(t, 1) for t in ms["numpy"]]}, native '
        f'{[round(t, 1) for t in ms["auto"]]}; every row within '
        f'{max(dist.values()):.2e} m of its view\'s back-projected set on '
        f'both backends; pack_sweeps host ms: 10 sweeps {pack_ms[10]:.1f}, '
        f'50 sweeps {pack_ms[50]:.1f}; {card}')
    return scan, dict(scan_s=scan_s, native_build_s=build_s,
                      world_points_ms=ms, pack_sweeps_ms=pack_ms,
                      max_row_distance_m=dist)


def occ_sweeps(scan, cfg, n_views, seed, train):
    """The continuous occupancy pseudo-batch of a synthetic scan through the
    port's data path, as ``EmbodiedScanLoader`` builds it for cont_occ:
    views selected, back-projected and sampled (``multiview_world_points``
    on ``cfg.data.native_pipeline``); the scan moved so the room's centre
    in x and y is the range's and its floor lies 8 cm above the range's
    bottom (one translation of every view's points and extrinsic, and of the
    boxes); ``points_range_filter`` per view; in training the rotation,
    scale and translation augmentation (the occupancy tasks take no flip);
    ``pack_sweeps`` with each view's box visibility and its frustum's prior
    grid cells as the view's occupancy visibility (cumulative per sweep).
    ``gt_occ``: the prior-grid cells the views' points occupy, with labels
    drawn from the seed, padded to ``max_occ_voxels`` and tiled per
    sweep."""
    from embodiedscan_torch.data import pipeline as pl
    from embodiedscan_torch.data.synthetic import box_visibility
    m, d = cfg.model, cfg.data
    rng = np.random.RandomState(seed)
    ids = pl.select_views(len(scan['views']), n_views, ordered=not train,
                          rng=rng)
    depths, ks, exts = _views(scan, ids)
    h, w = depths[0].shape
    pcr = np.asarray(m.point_cloud_range, np.float32)
    shift = np.array([(pcr[0] + pcr[3] - ROOM_XY) / 2,
                      (pcr[1] + pcr[4] - ROOM_XY) / 2, pcr[2] + 0.08],
                     np.float32)
    move = np.eye(4, dtype=np.float32)
    move[:3, 3] = -shift  # world = moved - shift
    exts = [ext @ move for ext in exts]
    imgs = np.stack([pl.normalize_imgs(scan['views'][i]['rgb'][None])[0]
                     for i in ids])
    view_pts = pl.multiview_world_points(depths, ks, exts, d.points_per_view,
                                         rng, native=d.native_pipeline)
    filtered = [pl.points_range_filter(p, pcr) for p in view_pts]
    if sum(len(p) for p in filtered) >= 100:
        view_pts = filtered
    boxes = scan['gt_boxes'].copy()
    boxes[:, :3] += shift
    aug = None
    if train:
        sizes = np.cumsum([len(p) for p in view_pts])[:-1]
        points, boxes, aug = pl.global_rot_scale_trans(
            np.concatenate(view_pts), boxes, rng)
        view_pts = np.split(points, sizes)
    nv = np.asarray(m.n_voxels)
    cell = (pcr[3:] - pcr[:3]) / nv
    grid = np.stack(np.meshgrid(*[np.arange(n) for n in nv], indexing='ij'),
                    -1).reshape(-1, 3)
    centres = np.concatenate([pcr[:3] + (grid + 0.5) * cell,
                              np.ones((len(grid), 1))], -1)
    occ_vis = []
    for k, ext in zip(ks, exts):
        cam = centres @ ext.T
        z = np.maximum(cam[:, 2], 1e-6)
        u = cam[:, 0] / z * k[0, 0] + k[0, 2]
        v = cam[:, 1] / z * k[1, 1] + k[1, 2]
        occ_vis.append(((cam[:, 2] > 0.05) & (u >= 0) & (u < w) & (v >= 0) &
                        (v < h)).reshape(tuple(nv)))
    sample = pl.pack_sweeps(view_pts, box_visibility(scan, ids, (h, w)),
                            imgs, ks, exts, boxes, scan['gt_labels'], aug,
                            d.n_points, d.max_boxes, rng,
                            occ_visible=occ_vis)
    cells = np.floor((np.concatenate(view_pts) - pcr[:3]) / cell).astype(
        np.int64)
    cells = np.unique(cells[((cells >= 0) & (cells < nv)).all(1)], axis=0)
    n = min(len(cells), d.max_occ_voxels)
    gt = np.zeros((d.max_occ_voxels, 4), np.float32)
    gt[:n, :3] = cells[:n]
    gt[:n, 3] = rng.randint(1, m.occ_classes, n)
    gm = np.arange(d.max_occ_voxels) < n
    rows = sample['points'].shape[0]
    sample['gt_occ'] = np.tile(gt[None], (rows, 1, 1))
    sample['gt_occ_mask'] = np.tile(gm[None], (rows, 1))
    return sample


def _key_reach(n_rows, voxel):
    """The key layout at ``n_rows`` rows and the metres it reaches from a
    row's minimum at ``voxel``."""
    from embodiedscan_torch.ops.hashing import key_layout
    bits = key_layout(n_rows)
    return bits, tuple(round(2**b * voxel, 2) for b in bits)


def _serve(tag, model, batches, want, check, device):
    """One recorded warm-up request, then one timed request per remaining
    batch (host clock, each ending in a synchronize): its peak memory, its
    launch counts against ``want`` and ``check(batch, out)`` -> a dict of
    numbers to report. Returns (recorder on the host, launch totals,
    latencies ms, peaks GiB, reports)."""
    from embodiedscan_torch.data.loader import to_device
    from embodiedscan_torch.ops import pscan as P
    from embodiedscan_torch.ops import sparse as S
    with Recorder(S, P) as rec:
        t0 = time.perf_counter()
        model(to_device(batches[0], device), mode='predict')
        torch.cuda.synchronize()
    rec.to_host()
    log(f'[{tag}] warm-up request {time.perf_counter() - t0:.2f} s, '
        f'{len(rec.conv)} conv and {len(rec.scan)} join-scan calls recorded')
    lat, mem, reports = [], [], []
    totals = dict.fromkeys(want, 0)
    for i, req in enumerate(batches[1:]):
        batch = to_device(req, device)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(S, P)
        t0 = time.perf_counter()
        out = model(batch, mode='predict')
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
        counts = read_counts(S, P)
        mem.append(torch.cuda.max_memory_allocated() / 2**30)
        check_counts(counts, want, f'{tag} request {i}')
        for name in totals:
            totals[name] += counts[name]
        reports.append(check(batch, out))
        log(f'[{tag}] request {i}: {lat[-1]:.1f} ms, peak {mem[-1]:.2f} GiB, '
            f'{reports[-1]}, launches {counts}')
    return rec, totals, lat, mem, reports


def phase_cont_det3d(card, scan, device='cuda', cfg=None):
    """[cont_det3d]: the preset's detector at full width (the mv_det3d
    widths, class bias 0 so NMS has work) serving its eval shape: 50
    cumulative sweeps of one scan of 50 views of 480x480 from
    ``scan_to_sweeps`` (100k points a sweep, 10000 a view, 200 boxes), a
    pseudo-batch of 50 point rows over one image set. One recorded warm-up
    and three timed requests (peak, kept voxels and detections per row,
    launches), the host ms of each stage once, the idle share of one
    profiled request."""
    from embodiedscan_torch.configs.base import build_model, cont_det3d
    from embodiedscan_torch.data.synthetic import scan_to_sweeps
    from embodiedscan_torch.ops import sparse as S
    from embodiedscan_torch.utils.convert_weights import load_jax_variables
    cfg = cfg or cont_det3d()
    m, d = cfg.model, cfg.data
    t0 = time.perf_counter()
    model = build_model(cfg, device=device)
    load_jax_variables(model, {'bbox_head': {'conv_cls': {'bias': np.zeros(
        m.num_classes, np.float32)}}}, strict=False)
    build_s = time.perf_counter() - t0
    n = d.n_views_test
    t0 = time.perf_counter()
    batches = [scan_to_sweeps(scan, n_views=n, num_points=d.n_points,
                              num_boxes=d.max_boxes, seed=s, train=False,
                              points_per_view=d.points_per_view)
               for s in range(4)]
    pack_s = (time.perf_counter() - t0) / 4
    bits, reach = _key_reach(n, m.voxel_size)
    log(f'[cont_det3d] built on {device} in {build_s:.1f} s; {n} sweeps of one '
        f'scan ({n} views of {d.image_hw[0]}x{d.image_hw[1]}), '
        f'{batches[0]["points_mask"].sum(1).min()}-{d.n_points} points a '
        f'row, scan_to_sweeps {pack_s:.2f} s a request; key layout {bits} '
        f'bits at {n} rows: {reach} m from each row\'s minimum')

    def check(batch, preds):
        for key, val in preds.items():
            if val.is_floating_point() and not torch.isfinite(val).all():
                raise RuntimeError(f'cont_det3d: non-finite {key}')
        if preds['bboxes'].shape != (n, m.max_dets, 9):
            raise RuntimeError(f'bboxes {tuple(preds["bboxes"].shape)}')
        with torch.no_grad():
            st = S.from_points_b(batch['points'], batch['points'],
                                 batch['points_mask'], m.voxel_size,
                                 m.input_capacity)
        kept = st.mask.sum(1).tolist()
        dets = preds['mask'].sum(1).tolist()
        if not min(dets):
            raise RuntimeError('cont_det3d: a sweep kept no detection')
        return dict(kept_voxels=kept, detections=dets)

    # K4 once per sweep row: the head's nms3d runs per row of the batch
    rec, totals, lat, mem, reports = _serve(
        'cont_det3d', model, batches,
        {**CONT_LAUNCHES['cont_det3d'], 'nms_overlap': n}, check, device)
    kept = reports[0]['kept_voxels']
    log(f'[cont_det3d] latency ms per request {[round(t, 3) for t in lat]}, '
        f'peak GiB {max(mem):.3f}; kept voxels per row (request 0) '
        f'{min(kept)}-{max(kept)} of {m.input_capacity}, first rows '
        f'{kept[:5]}, last {kept[-1]}; detections per row '
        f'{min(reports[0]["detections"])}-'
        f'{max(reports[0]["detections"])}; {card}')
    from embodiedscan_torch.data.loader import to_device
    batch = to_device(batches[1], device)
    del batches
    stats = dict(latency_ms=lat, peak_gib=mem, reports=reports,
                 key_layout=bits, key_reach_m=reach, build_s=build_s)
    stats.update(stage_times(model, batch, reps=1, warmup=False))

    @torch.no_grad()
    def profile():
        stats.update(profile_run(lambda: model(batch, mode='predict'),
                                 'cont_det3d request', host=False))

    return rec, totals, stats, profile


def phase_cont_det3d_train(card, device='cuda', cfg=None):
    """[cont_det3d_train]: ``build_train`` of the preset (lr multipliers,
    clip 10, AdamW) on 10 cumulative sweeps of a 10-view scan of 480x480
    (``scan_to_sweeps(train=True)``: flip, rotation, scale and translation)
    with 200 padded gt boxes, visible per sweep; :func:`train_steps`, then
    the idle share of one profiled step."""
    from embodiedscan_torch.configs.base import build_train, cont_det3d
    from embodiedscan_torch.data.loader import to_device
    from embodiedscan_torch.data.synthetic import make_scan, scan_to_sweeps
    from embodiedscan_torch.train.state import train_step
    cfg = cfg or cont_det3d()
    d = cfg.data
    t0 = time.perf_counter()
    model, opt = build_train(cfg, device=device,
                             steps_per_epoch=PHASE_EPOCH)
    scan = make_scan(seed=1, n_views=d.n_views_train, hw=tuple(d.image_hw),
                     g=32)
    batch = to_device(scan_to_sweeps(
        scan, n_views=d.n_views_train, num_points=d.n_points,
        num_boxes=d.max_boxes, seed=0, train=True,
        points_per_view=d.points_per_view), device)
    bits, reach = _key_reach(d.n_views_train, cfg.model.voxel_size)
    log(f'[cont_det3d_train] built cont_det3d and AdamW and the batch in '
        f'{time.perf_counter() - t0:.1f} s: {d.n_views_train} sweeps, '
        f'points per row {batch["points_mask"].sum(1).tolist()}, visible gt '
        f'per sweep {batch["gt_mask"].sum(1).tolist()} of {d.max_boxes}; '
        f'key layout {bits} bits: {reach} m; {card}')
    rec, totals, stats = train_steps('cont_det3d_train', model, opt, batch,
                                     CONT_LAUNCHES['cont_det3d_train'])
    model.zero_grad(set_to_none=True)

    def profile():
        stats.update(profile_run(lambda: train_step(model, opt, batch),
                                 'cont_det3d train step'))
        model.zero_grad(set_to_none=True)

    return rec, totals, stats, profile


def _unet_share(model, batch, stats, train):
    """The U-Net's device time (profiler) in a request (its forward on the
    request's fused volume) or a step (forward and backward), beside the
    profiled run's busy time."""
    with torch.no_grad():
        x = model.features(batch)
    if train:
        x.requires_grad_(True)

        def fwd_bwd():
            sum(f.sum() for f in model.neck(x)).backward()

        n, ms = device_profile(fwd_bwd)
        model.zero_grad(set_to_none=True)
    else:
        with torch.no_grad():
            n, ms = device_profile(lambda: model.neck(x))
    stats.update(unet_launches=n, unet_device_ms=ms,
                 unet_share=ms / stats['device_busy_ms'])
    return ms


def phase_cont_occ(card, device='cuda', cfg=None):
    """[cont_occ]: the preset (mv_occ's widths, the U-Net in bfloat16) at
    full width serving 20 cumulative sweeps (mv_occ's n_views_test) of a
    20-view scan of 480x480 through :func:`occ_sweeps`. One recorded
    warm-up and three timed requests (peak, kept voxels per row, launches),
    the host ms of each stage once, the idle share of one profiled request
    and the U-Net's share of its device time."""
    from embodiedscan_torch.configs.base import build_model, cont_occ
    from embodiedscan_torch.data.loader import to_device
    from embodiedscan_torch.data.synthetic import make_scan
    cfg = cfg or cont_occ()
    m, d = cfg.model, cfg.data
    t0 = time.perf_counter()
    model = build_model(cfg, device=device)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    n = d.n_views_test
    scan = make_scan(seed=2, n_views=n, hw=tuple(d.image_hw), g=32)
    batches = [occ_sweeps(scan, cfg, n, s, train=False) for s in range(4)]
    log(f'[cont_occ] built on {device} in {build_s:.1f} s (U-Net in '
        f'{model.ImVoxelNeck_0.dtype}); {n} sweeps, points per row '
        f'{batches[0]["points_mask"].sum(1).min()}-'
        f'{batches[0]["points_mask"].sum(1).max()}, visible prior cells per '
        f'sweep {batches[0]["visible_mask"].reshape(n, -1).sum(1)[[0, -1]]}'
        f' of {np.prod(m.n_voxels)}, {int(batches[0]["gt_occ_mask"][0].sum())}'
        f' of {d.max_occ_voxels} gt voxels valid; {card}')

    def check(batch, pred):
        if tuple(pred.shape) != (n, *m.n_voxels) or not (
                (pred >= 0) & (pred < m.occ_classes)).all():
            raise RuntimeError(f'cont_occ: shape {tuple(pred.shape)}, '
                               'classes out of range')
        with torch.no_grad():
            kept = model.voxelize(batch).mask.sum(1).tolist()
        return dict(kept_voxels=kept, classes=len(torch.unique(pred)))

    rec, totals, lat, mem, reports = _serve(
        'cont_occ', model, batches, CONT_LAUNCHES['cont_occ'], check,
        device)
    kept = reports[0]['kept_voxels']
    log(f'[cont_occ] latency ms per request {[round(t, 3) for t in lat]}, '
        f'peak GiB {max(mem):.3f}; kept voxels per row {min(kept)}-'
        f'{max(kept)} (the 11-bit key reaches 5.12 m of the 6 m room); '
        f'{card}')
    batch = to_device(batches[1], device)
    del batches
    stats = dict(latency_ms=lat, peak_gib=mem, reports=reports,
                 build_s=build_s)
    stages = occ_parts(model, batch,
                       lambda fn: _host_ms(fn, reps=1, warmup=False))[0]
    log('[breakdown] cont_occ host ms per stage: ' + ', '.join(
        f'{k} {v:.2f}' for k, v in stages.items()))
    stats.update(stages_ms=stages)

    def profile():
        with torch.no_grad():
            stats.update(profile_run(lambda: model(batch, mode='predict'),
                                     'cont_occ request'))
        ms = _unet_share(model, batch, stats, train=False)
        log(f'[breakdown] cont_occ U-Net device time {ms:.2f} ms of '
            f'{stats["device_busy_ms"]:.2f} busy (share '
            f'{stats["unet_share"]:.3f})')

    return rec, totals, stats, profile


def phase_cont_occ_train(card, device='cuda', cfg=None):
    """[cont_occ_train]: ``build_train`` of the preset on 10 cumulative
    sweeps of a 10-view scan (:func:`occ_sweeps`, training); train_steps,
    then the peak against the card's memory (the remat decision), the idle
    share of one profiled step and the U-Net's share of its device time."""
    from embodiedscan_torch.configs.base import build_train, cont_occ
    from embodiedscan_torch.data.loader import to_device
    from embodiedscan_torch.data.synthetic import make_scan
    from embodiedscan_torch.train.state import train_step
    cfg = cfg or cont_occ()
    d = cfg.data
    resident = torch.cuda.memory_allocated() / 2**30
    t0 = time.perf_counter()
    model, opt = build_train(cfg, device=device,
                             steps_per_epoch=PHASE_EPOCH)
    scan = make_scan(seed=3, n_views=d.n_views_train, hw=tuple(d.image_hw),
                     g=32)
    batch = to_device(occ_sweeps(scan, cfg, d.n_views_train, 0, train=True),
                      device)
    log(f'[cont_occ_train] built cont_occ and AdamW and the batch in '
        f'{time.perf_counter() - t0:.1f} s: {d.n_views_train} sweeps, '
        f'points per row {batch["points_mask"].sum(1).tolist()}, '
        f'{int(batch["gt_occ_mask"][0].sum())} of {d.max_occ_voxels} gt '
        f'voxels valid; {card}')
    rec, totals, stats = train_steps('cont_occ_train', model, opt, batch,
                                     CONT_LAUNCHES['cont_occ_train'])
    model.zero_grad(set_to_none=True)
    card_gib = torch.cuda.get_device_properties(0).total_memory / 2**30
    own = max(stats['peak_gib']) - resident
    left = card_gib - own
    stats.update(card_gib=card_gib, own_peak_gib=own, headroom_gib=left,
                 remat_needed=left < HEADROOM_GIB)
    log(f'[cont_occ_train] peak {max(stats["peak_gib"]):.3f} GiB, of which '
        f'{resident:.3f} GiB the earlier phases\' models: {own:.3f} GiB of '
        f'the card\'s {card_gib:.1f} GiB with no other model resident, '
        f'{left:.1f} GiB left, remat '
        f'{"needed" if left < HEADROOM_GIB else "not needed"} (threshold '
        f'{HEADROOM_GIB} GiB); {card}')

    def profile():
        stats.update(profile_run(lambda: train_step(model, opt, batch),
                                 'cont_occ train step'))
        ms = _unet_share(model, batch, stats, train=True)
        model.zero_grad(set_to_none=True)
        log(f'[breakdown] cont_occ train step U-Net forward + backward '
            f'device time {ms:.2f} ms of {stats["device_busy_ms"]:.2f} busy '
            f'(share {stats["unet_share"]:.3f})')

    return rec, totals, stats, profile


@torch.no_grad()
def _bf16_gate(cfg, batch, calib, device):
    """The small occupancy model's U-Net in bfloat16 on ``device`` and on
    cpu, with the float32 model's weights and calibrated statistics: each
    side's bf16 logits against its own float32 logits; the card's error at
    most twice the cpu's plus BF16_SLACK x max|logit|; the classes of the two
    bf16 models identical except where the cpu's top two bf16 logits are
    closer than the larger error (counted)."""
    from embodiedscan_torch.configs.base import build_model
    f32 = _calibrate_norms(build_model(cfg, device='cpu'),
                           to_device(calib, 'cpu'))
    c16 = copy.deepcopy(cfg)
    c16.model.occ_neck_bf16 = True
    logits = {}
    for dev in ('cpu', device):
        b = to_device(batch, dev)
        for name, c in (('f32', cfg), ('bf16', c16)):
            model = build_model(c, device=dev)
            model.load_state_dict(f32.state_dict())
            logits[dev, name] = [t.cpu() for t in model.logits(b)]
    errs = []
    for i, ref in enumerate(logits['cpu', 'f32']):
        e_cpu = float((logits['cpu', 'bf16'][i] - ref).abs().max())
        e_card = float((logits[device, 'bf16'][i] -
                        logits[device, 'f32'][i]).abs().max())
        slack = BF16_SLACK * float(ref.abs().max())
        if not e_card <= 2 * e_cpu + slack:
            raise RuntimeError(f'bf16 U-Net scale {i}: card error {e_card} > '
                               f'2 x cpu error {e_cpu} + {slack}')
        errs.append((e_card, e_cpu, slack))
    top = max(errs[0][:2])
    pc = logits['cpu', 'bf16'][0]
    flips = pc.argmax(-1) != logits[device, 'bf16'][0].argmax(-1)
    top2 = torch.topk(pc, 2).values
    margin = (top2[..., 0] - top2[..., 1])[flips]
    if flips.any() and float(margin.max()) > top:
        raise RuntimeError(f'bf16 U-Net: a class differs at a top-2 margin '
                           f'{float(margin.max())} above the error {top}')
    log(f'[parity] cont_occ bf16 U-Net: max|bf16 - float32 logit| per scale, '
        f'card vs cpu: ' + ', '.join(
            f'{a:.3g} vs {b:.3g} (gate {2 * b + s:.3g})' for a, b, s in errs) +
        f'; classes of the two bf16 models identical in '
        f'{flips.numel() - int(flips.sum())} of {flips.numel()} voxels, '
        f'{int(flips.sum())} at top-2 margins within {top:.3g}')
    return dict(errors=errs, flips=int(flips.sum()))


def phase_cont_parity(device):
    """Both continuous models at a small size on ``device`` (kernels) and on
    cpu (plain versions) with the same weights, on 3-sweep pseudo-batches
    from the port's data path (synthetic scans of 3 views of 96x96): the
    small detector (``_parity_cfg``) serving (``det_parity``) and one train
    step (``phase_train_parity``); the small occupancy model
    (``_occ_parity_cfg``, the U-Net in float32) serving and one train step
    with the multi-view occupancy gates; then its U-Net in bfloat16
    (``_bf16_gate``)."""
    from embodiedscan_torch.configs.base import build_model
    from embodiedscan_torch.data.synthetic import make_scan, scan_to_sweeps
    cfg = _parity_cfg()
    cfg.model.task = 'cont_det3d'
    scan = make_scan(seed=5, n_views=3, hw=(96, 96), g=8,
                     num_classes=cfg.model.num_classes)
    kw = dict(n_views=3, num_points=6000, num_boxes=16, points_per_view=2500)
    cpu = build_model(cfg, device='cpu')
    with torch.no_grad():
        cpu.bbox_head.conv_cls.bias.zero_()
    gpu = build_model(cfg, device=device)
    gpu.load_state_dict(cpu.state_dict())
    det_parity(cpu, gpu, scan_to_sweeps(scan, seed=7, train=False, **kw),
               device, 'cont_det3d (3 sweeps) cpu vs cuda')
    del cpu, gpu
    phase_train_parity(device, cfg, scan_to_sweeps(scan, seed=8, train=True,
                                                   **kw),
                       'cont_det3d train step (3 sweeps)')
    ocfg = _occ_parity_cfg()
    ocfg.model.task = 'cont_occ'
    d = ocfg.data
    d.points_per_view, d.n_points, d.max_occ_voxels, d.max_boxes = \
        2000, 6000, 2048, 16
    oscan = make_scan(seed=6, n_views=3, hw=(96, 96), g=8)
    calib, req = (occ_sweeps(oscan, ocfg, 3, s, train=False) for s in (5, 7))
    phase_occ_parity(device, ocfg, req, calib, 'cont_occ (3 sweeps)')
    phase_occ_train_parity(device, ocfg,
                           occ_sweeps(oscan, ocfg, 3, 8, train=True),
                           'cont_occ (3 sweeps)')
    return _bf16_gate(ocfg, req, calib, device)


def main_cont():
    """``chip_smoke.py --cont``: [data], [cont_det3d], [cont_det3d_train],
    [cont_occ] and [cont_occ_train] (each model kept on the card, with the
    resident memory it starts from printed), the replays of their kernel
    calls, then one profiled request or step of each (the models freed
    after it), and the small continuous models' card-vs-cpu parity. Writes the kernel rows (groups ``(cont_det3d)``
    and ``(cont_occ)``) and the numbers to chiprun_out/chip_smoke_cont.json
    for the parent run's kernels line."""
    from embodiedscan_torch.ops import kernels
    card = card_name()
    kernels.library()
    torch.manual_seed(0)
    t0 = time.perf_counter()
    scan, data_stats = phase_data(card)
    stats, recs, totals, profiles = dict(data=data_stats), {}, {}, []
    took = dict(data=time.perf_counter() - t0)
    for name, phase in (('cont_det3d', lambda: phase_cont_det3d(card, scan)),
                        ('cont_det3d_train',
                         lambda: phase_cont_det3d_train(card)),
                        ('cont_occ', lambda: phase_cont_occ(card)),
                        ('cont_occ_train',
                         lambda: phase_cont_occ_train(card))):
        t0 = time.perf_counter()
        log(f'[cont] {name} starts with '
            f'{torch.cuda.memory_allocated() / 2**30:.3f} GiB of the earlier '
            f'phases\' models and batches on the card')
        recs[name], totals[name], stats[name], profile = phase()
        profiles.append(profile)
        took[name] = time.perf_counter() - t0
    del scan
    # every replay before the first profiler session of this process: a
    # session leaves the host slower per op, and later sessions lose events
    t0 = time.perf_counter()
    calls = phase_kernels([(p, recs[p]) for p in CONT_LAUNCHES],
                          [(p, recs[p]) for p in ('cont_det3d_train',
                                                  'cont_occ_train')],
                          'cuda', CONT_TIMING, release=True)
    took['replays'] = time.perf_counter() - t0
    for path in CONT_LAUNCHES:
        most = {name: max(r.get('m', r.get('r', r.get('n'))) for r in rows
                          if r['path'] == path)
                for name, rows in calls.items()
                if any(r['path'] == path for r in rows)}
        log(f'[kernels] most rows a call of {path} takes: {most}')
    del recs
    t0 = time.perf_counter()
    for profile in profiles:
        profile()
    del profiles
    torch.cuda.empty_cache()
    took['profiles'] = time.perf_counter() - t0
    t0 = time.perf_counter()
    stats['parity'] = phase_cont_parity('cuda')
    took['parity'] = time.perf_counter() - t0
    log('[cont] seconds per part: ' + ', '.join(
        f'{k} {v:.1f}' for k, v in took.items()))
    stats['seconds'] = took

    def add(a, b):
        return {k: a[k] + b[k] for k in a}

    rows = kernel_rows(calls, (
        (' (cont_det3d)', add(*(totals[p] for p in CONT_DET_PATHS)),
         CONT_DET_PATHS),
        (' (cont_occ)', add(*(totals[p] for p in CONT_OCC_PATHS)),
         CONT_OCC_PATHS)))
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, 'chip_smoke_cont.json'), 'w') as f:
        json.dump(dict(card=card, rows=rows, stats=stats, calls=calls), f,
                  indent=1, default=float)
    return 0


def kernel_rows(calls, groups):
    """The kernels line's rows: for each group (suffix, launch totals, its
    paths), the K2 forward, K1, K2 dgrad and K3 rows of its paths (those
    its launch totals name). Launches summed over each group's timed runs,
    every other number from this run's replays (summed over one recorded
    request or step of each path)."""
    rows = []
    conv = ('embodiedscan_torch/csrc/sparse_conv.cu',
            'embodiedscan_tpu/experimental/pallas_conv.py:62')
    # the JAX package computes a sparse conv's gradients in XLA, in the
    # custom VJPs _subm_bwd and _strided_bwd (no Pallas kernel)
    bwd = 'embodiedscan_tpu/ops/sparse.py:354,413'
    wgrad = 'embodiedscan_torch/csrc/sparse_conv_wgrad.cu'
    for suffix, counts, paths in groups:
        def of(name, route=None):
            return [r for r in calls.get(name, []) if r['path'] in paths and
                    (route is None or r['route'] == route)]

        meta = {  # kernel -> (source, replaces, its calls)
            'sparse_conv_tc': (*conv, of('sparse_conv', 'tc')),
            'sparse_conv_simt': (*conv, of('sparse_conv', 'simt')),
            'join_scan': ('embodiedscan_torch/csrc/join_scan.cu',
                          'embodiedscan_tpu/ops/pscan.py:101',
                          of('join_scan')),
            'sparse_dgrad_tc': (conv[0], bwd, of('sparse_dgrad', 'tc')),
            'sparse_wgrad_tc': (wgrad, bwd, of('sparse_wgrad', 'tc')),
            'sparse_wgrad_narrow': (wgrad, bwd,
                                    of('sparse_wgrad', 'narrow')),
            # the bfloat16 variants (the reference's bf16 route)
            'sparse_conv_tc_bf16': (*conv, of('sparse_conv_bf16', 'tc')),
            'sparse_conv_simt_bf16': (*conv,
                                      of('sparse_conv_bf16', 'simt')),
            'sparse_dgrad_tc_bf16': (conv[0], bwd,
                                     of('sparse_dgrad_bf16', 'tc')),
            'sparse_wgrad_tc_bf16': (wgrad, bwd,
                                     of('sparse_wgrad_bf16', 'tc')),
        }
        for name, (source, replaces, rs) in meta.items():
            if name not in counts:  # not a kernel of the group's paths
                continue
            if not rs or not counts[name]:
                raise RuntimeError(f'{name}{suffix}: no call on its main '
                                   'path')
            bound = sum(r['bound_ms'] for r in rs)
            by_bytes = sum(r['bound_ms'] for r in rs
                           if r['bound_by'] == 'bytes')
            rows.append(dict(
                name=name + suffix, route='cuda', source=source,
                replaces=replaces, launches=counts[name],
                max_abs_err=max(r['max_abs_err'] for r in rs),
                ms=sum(r['ms'] for r in rs),
                plain_ms=sum(r['plain_ms'] for r in rs), bound_ms=bound,
                bound_by='bytes' if by_bytes >= bound / 2 else 'operations',
                library_ms=sum(r['library_ms'] for r in rs)))
    return rows


# --- the runtime: the train and eval CLIs on an on-disk dataset ([loop]) ---

# the written dataset: train and val scenes, views a scene, gt boxes a scene
LOOP_SCENES = 4
LOOP_VIEWS = 50
LOOP_BOXES = 32
# the first run's steps: the preset's epoch is 10 (repeat_times 10 over 4
# scenes at b = 4), so 12 reach past its end and past the profiled steps
# 6-10; the resumed run's
LOOP_STEPS = 12
LOOP_RESUME_STEPS = 3
# the loop's replays (calls at b = 4): one warm-up call and two timed ones
LOOP_TIMING = dict(warmup=1, reps=2)


def write_dataset(root, n_train=LOOP_SCENES, n_val=LOOP_SCENES,
                  n_views=LOOP_VIEWS, hw=(480, 480), g=LOOP_BOXES,
                  num_classes=284):
    """An on-disk dataset in the reference layout (the structure of
    tests/conftest.py's fake_data) under ``root``: ``n_train`` and ``n_val``
    synthetic scans (``data/synthetic.py:make_scan``, seeds 0.. and 100..)
    of ``n_views`` views, each an RGB jpg and a uint16 depth png in
    millimetres, its camera-to-global pose and the gt boxes whose centres
    it sees; the train and val info pkls with ``num_classes`` categories.
    Returns the seconds it took."""
    import pickle
    from concurrent.futures import ThreadPoolExecutor

    from PIL import Image

    from embodiedscan_torch.data.synthetic import box_visibility, make_scan
    t0 = time.perf_counter()
    jobs = []

    def scene_info(seed, name):
        scan = make_scan(seed=seed, n_views=n_views, hw=hw, g=g,
                         num_classes=num_classes)
        vis = box_visibility(scan, range(n_views), hw)
        images = []
        for v, view in enumerate(scan['views']):
            stem = f'scannet/{name}/{v:05d}'
            jobs.append((os.path.join(root, stem + '.jpg'), view['rgb']))
            jobs.append((os.path.join(root, stem + '.png'),
                         np.round(view['depth'] * 1000).astype(np.uint16)))
            images.append(dict(
                img_path=stem + '.jpg', depth_path=stem + '.png',
                cam2global=np.linalg.inv(view['extrinsic'].astype(
                    np.float64)),
                visible_instance_ids=vis[v].tolist()))
        k = scan['views'][0]['intrinsic']
        return dict(sample_idx=f'scannet/{name}', axis_align_matrix=np.eye(4),
                    cam2img=k, depth_cam2img=k, images=images,
                    instances=[dict(bbox_3d=b.tolist(), bbox_label_3d=int(c))
                               for b, c in zip(scan['gt_boxes'],
                                               scan['gt_labels'])])

    meta = dict(categories={f'class{i}': i for i in range(num_classes)})
    for split, seeds in (('train', range(n_train)),
                         ('val', range(100, 100 + n_val))):
        infos = []
        for seed in seeds:
            name = f'scene{seed:04d}_00'
            os.makedirs(os.path.join(root, 'scannet', name), exist_ok=True)
            infos.append(scene_info(seed, name))
        with open(os.path.join(root, f'embodiedscan_infos_{split}.pkl'),
                  'wb') as f:
            pickle.dump(dict(data_list=infos, metainfo=meta), f)

    def save(job):
        Image.fromarray(job[1]).save(job[0])

    with ThreadPoolExecutor(8) as pool:
        list(pool.map(save, jobs))
    return time.perf_counter() - t0


def _free_port():
    import socket
    with socket.socket() as sock:
        sock.bind(('localhost', 0))
        return sock.getsockname()[1]


class _Timed:
    """Wall seconds of every call of ``obj.name`` while active."""

    def __init__(self, obj, name):
        self.obj, self.name, self.seconds = obj, name, []

    def __enter__(self):
        fn = self.fn = getattr(self.obj, self.name)

        @functools.wraps(fn)
        def timed(*args, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                self.seconds.append(time.perf_counter() - t0)

        setattr(self.obj, self.name, timed)
        return self

    def __exit__(self, *exc):
        setattr(self.obj, self.name, self.fn)


def trace_busy(path):
    """(device busy ms, window ms) of a chrome trace written by
    torch.profiler: the union of its kernel, memcpy and memset intervals,
    and the span of all its events."""
    with open(path) as f:
        events = [e for e in json.load(f)['traceEvents']
                  if e.get('ph') == 'X' and 'dur' in e]
    spans = sorted((float(e['ts']), float(e['ts']) + float(e['dur']))
                   for e in events
                   if e.get('cat') in ('kernel', 'gpu_memcpy', 'gpu_memset'))
    busy, end = 0.0, -np.inf
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    lo = min(float(e['ts']) for e in events)
    hi = max(float(e['ts']) + float(e['dur']) for e in events)
    return busy / 1e3, (hi - lo) / 1e3


def _loop_small_cfg(root):
    """The small detector of the eval check over the written val scenes:
    ``_parity_cfg``'s, 4 views of 96x96 and 6000 points a scene."""
    cfg = _parity_cfg()
    d = cfg.data
    d.data_root, d.n_views_test, d.image_hw = root, 4, (96, 96)
    d.n_points, d.points_per_view = 6000, 1500
    return cfg


def small_eval(root, work, device):
    """A small checkpoint (``_loop_small_cfg``, class bias 0) in ``work``,
    evaluated by ``train.loop.evaluate`` on ``device`` and on the cpu over
    the val scenes of ``root`` with gt boxes added where its cpu detections
    lie (:func:`add_hit_boxes`): metrics within EVAL_GATE and mAP_0.25 > 0
    on both. Returns (max|d|, the card's mAP_0.25)."""
    from embodiedscan_torch.configs.base import build_model
    from embodiedscan_torch.train import loop as L
    from embodiedscan_torch.train.checkpoint import CheckpointManager
    cfg = _loop_small_cfg(root)
    cfg.work_dir = work
    model = build_model(cfg, 'cpu')
    with torch.no_grad():
        model.bbox_head.conv_cls.bias.zero_()
    n_hit = add_hit_boxes(cfg, model)
    CheckpointManager(work).save(0, model)
    del model
    out = {dev: L.evaluate(cfg, device=dev) for dev in (device, 'cpu')}
    worst = _metrics_diff(out[device], out['cpu'], '[loop] small eval')
    hits = {dev: out[dev]['mAP_0.25'] for dev in out}
    if not all(v > 0 for v in hits.values()):
        raise RuntimeError(f'[loop] small eval: no hit (mAP_0.25 {hits})')
    log(f'[loop] small checkpoint evaluated on {device} and cpu over the '
        f'val scenes ({n_hit} gt boxes added at its cpu detections): '
        f'mAP_0.25 {hits[device]:.4f} mAR_0.25 '
        f'{out[device]["mAR_0.25"]:.4f} mAP_0.50 '
        f'{out[device]["mAP_0.50"]:.4f}; {len(out["cpu"])} metrics, card '
        f'vs cpu max|d| {worst} (gate {EVAL_GATE})')
    return worst, hits[device]


def add_hit_boxes(cfg, model, per_scene=8):
    """Writes ``cfg``'s val split again, as ``embodiedscan_infos_val_hits.pkl``
    beside it, and points ``cfg`` at it: each scene's gt boxes and, as
    ``eval_records`` builds its gt, up to ``per_scene`` of the kept
    detections of ``model`` (on the cpu, over ``cfg``'s val loader) moved
    by N(0, 5 cm), with their labels; the loader draws the same points
    again, since the boxes take no draw. Returns the boxes added."""
    import pickle

    from embodiedscan_torch.train import loop as L
    d = cfg.data
    with open(os.path.join(d.data_root, d.val_ann_file), 'rb') as f:
        val = pickle.load(f)
    rng = np.random.RandomState(300)
    added = 0
    model.eval()
    with torch.no_grad():
        for info, batch in zip(val['data_list'],
                               L.make_dataset(cfg, train=False)):
            preds = model(to_device(batch, 'cpu'), mode='predict')
            keep = preds['mask'][0].numpy()
            boxes = preds['bboxes'][0].numpy()[keep][:per_scene]
            labels = preds['labels'][0].numpy()[keep][:per_scene]
            boxes = boxes + rng.normal(0, 0.05, boxes.shape)
            info['instances'] = info['instances'] + [
                dict(bbox_3d=b.tolist(), bbox_label_3d=int(c))
                for b, c in zip(boxes, labels)]
            added += len(boxes)
    d.val_ann_file = 'embodiedscan_infos_val_hits.pkl'
    with open(os.path.join(d.data_root, d.val_ann_file), 'wb') as f:
        pickle.dump(val, f)
    return added


def _metrics_diff(a, b, what):
    """max|a - b| over two metric dicts (card and cpu) with the same keys,
    strings equal; raises past EVAL_GATE."""
    if set(a) != set(b):
        raise RuntimeError(f'{what}: metric keys differ')
    worst = 0.0
    for k in a:
        if isinstance(a[k], str):
            if a[k] != b[k]:
                raise RuntimeError(f'{what}: {k} differs')
        else:
            worst = max(worst, abs(float(a[k]) - float(b[k])))
    if not worst <= EVAL_GATE:
        raise RuntimeError(f'{what}: card and cpu metrics differ by {worst}')
    return worst


def _loop_cfg(root, overrides=()):
    """The [loop] phase's train overrides and config: the mv_det3d preset
    over the written dataset, every step logged, ``overrides`` (a
    rehearsal's small sizes)."""
    from embodiedscan_torch.configs.base import PRESETS, apply_overrides
    over = [f'data.data_root={root}', 'log_interval=1', *overrides]
    cfg = apply_overrides(PRESETS['mv_det3d'](), over)
    return over, cfg


def loop_step(cfg, device='cuda'):
    """One loop step outside the loop, in the process group already
    joined: ``build_train`` of ``cfg`` with its loader's epoch, the
    loader's first batch through ``train_step`` (recorded for the
    replays), three timed steps, the gradients' all-reduce alone
    (``pmean_`` of the step's gradients, three times), then the loader
    alone. Returns (recorder on the host, stats)."""
    from embodiedscan_torch.configs.base import build_train
    from embodiedscan_torch.data.loader import to_device
    from embodiedscan_torch.ops import pscan as P
    from embodiedscan_torch.ops import sparse as S
    from embodiedscan_torch.train import loop as L
    from embodiedscan_torch.parallel.multihost import pmean_
    from embodiedscan_torch.train.state import train_step
    loader = L.make_dataset(cfg)
    t0 = time.perf_counter()
    model, opt = build_train(cfg, device=device,
                             steps_per_epoch=loader.steps_per_epoch)
    build_s = time.perf_counter() - t0
    it = iter(loader)
    batch = to_device(next(it), device)
    with Recorder(S, P) as rec:
        train_step(model, opt, batch)
        if device == 'cuda':
            torch.cuda.synchronize()
    rec.to_host()
    bare_ms, pmean_ms = [], []
    for _ in range(3):
        if device == 'cuda':
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = train_step(model, opt, batch)
        float(metrics['loss_total'])
        bare_ms.append((time.perf_counter() - t0) * 1e3)
    grads = [p.grad for g in opt.param_groups for p in g['params']]
    grad_mb = sum(t.numel() * t.element_size() for t in grads) / 1e6
    for _ in range(3):
        if device == 'cuda':
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        pmean_(grads)
        if device == 'cuda':
            torch.cuda.synchronize()
        pmean_ms.append((time.perf_counter() - t0) * 1e3)
    del model, opt, batch, metrics, grads
    if device == 'cuda':
        torch.cuda.empty_cache()
    # the prefetch queue's batches first, then the pipeline's own pace
    d = cfg.data
    load_ms = []
    for _ in range(d.prefetch_depth + 5):
        t0 = time.perf_counter()
        next(it)
        load_ms.append((time.perf_counter() - t0) * 1e3)
    del it, loader
    log(f'[loop] one loop batch (b={d.batch_size}) through a bare '
        f'train_step (model built in {build_s:.1f} s): ms '
        f'{[round(t, 1) for t in bare_ms]}; the gradients\' all-reduce '
        f'alone ({grad_mb:.1f} MB, one rank): ms '
        f'{[round(t, 2) for t in pmean_ms]}; {len(rec.conv)} conv, '
        f'{len(rec.dgrad)} dgrad, {len(rec.wgrad)} wgrad and '
        f'{len(rec.scan)} join-scan calls recorded; the loader alone '
        f'(prefetch {d.prefetch_depth}, {d.num_workers} workers) ms per '
        f'batch {[round(t, 1) for t in load_ms]} (median of the last 4 '
        f'{np.median(load_ms[-4:]):.1f})')
    return rec, dict(bare_step_ms=bare_ms, grad_pmean_ms=pmean_ms,
                     grad_mb=grad_mb,
                     build_s=build_s, loader_ms=load_ms)


def phase_loop(card, root, work, device='cuda', overrides=(),
               n_val=LOOP_SCENES):
    """[loop]: the port's CLIs on the dataset at ``root``:
    ``tools.train.main`` for the mv_det3d preset as shipped (b = 4, 20
    views of 480x480, 100k points, 284 classes; ``overrides`` for a
    rehearsal at a small size) in the process group already joined,
    ``LOOP_STEPS`` steps past the first epoch's end with steps 6-10
    profiled, then ``--resume auto`` for ``LOOP_RESUME_STEPS`` more;
    wrapper calls per step against EXPECTED_TRAIN_LAUNCHES;
    ``tools.test.main`` from the last checkpoint over the ``n_val`` val
    scenes (50 views, b = 1); :func:`small_eval`. Returns (launch totals
    of the CLI runs, stats)."""
    import logging

    from embodiedscan_torch.ops import pscan as P
    from embodiedscan_torch.ops import sparse as S
    from embodiedscan_torch.tools import test as test_cli
    from embodiedscan_torch.tools import train as train_cli
    from embodiedscan_torch.train import loop as L
    from embodiedscan_torch.train.checkpoint import CheckpointManager
    lines = []

    class Keep(logging.Handler):
        def emit(self, record):
            lines.append(record.getMessage())

    keep = Keep()
    logging.getLogger('embodiedscan_torch').addHandler(keep)
    try:
        prof_dir = os.path.join(work, 'profile')
        over, cfg = _loop_cfg(root, overrides)
        common = ['mv_det3d', *over, '--work-dir', work, '--device', device]
        d = cfg.data
        # the first run, then the resumed one
        with _Timed(CheckpointManager, 'save') as saves, \
                _Timed(CheckpointManager, 'restore') as restores:
            if device == 'cuda':
                torch.cuda.reset_peak_memory_stats()
            reset_counts(S, P)
            t0 = time.perf_counter()
            model, opt = train_cli.main(
                [common[0], f'profile_dir={prof_dir}', *common[1:],
                 '--multihost', '--max-steps', str(LOOP_STEPS)])
            if device == 'cuda':
                torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated() / 2**30 \
                if device == 'cuda' else 0.0
            counts = read_counts(S, P)
            steps_per_epoch = L.make_dataset(cfg).steps_per_epoch
            del model, opt
            reset_counts(S, P)
            t0 = time.perf_counter()
            model, opt = train_cli.main(
                common + ['--multihost', '--max-steps',
                          str(LOOP_RESUME_STEPS), '--resume', 'auto'])
            resume_run_s = time.perf_counter() - t0
            counts2 = read_counts(S, P)
        steps = LOOP_STEPS + LOOP_RESUME_STEPS
        totals = {k: counts[k] + counts2[k] for k in counts}
        for name, per in EXPECTED_TRAIN_LAUNCHES.items():
            if counts[name] != per * LOOP_STEPS or \
                    counts2[name] != per * LOOP_RESUME_STEPS:
                raise RuntimeError(
                    f'[loop] {name}: {counts[name]} calls in '
                    f'{LOOP_STEPS} steps and {counts2[name]} in '
                    f'{LOOP_RESUME_STEPS}; {per} a step expected ([train])')
        step_lines = [ln for ln in lines if ln.startswith('step ')]
        sec_it = [float(ln.split()[2][:-4]) for ln in step_lines]
        if len(sec_it) != steps:
            raise RuntimeError(f'[loop] {len(sec_it)} step lines: '
                               f'{step_lines}')
        resumed = [ln for ln in lines if ln.startswith('resumed from step')]
        if resumed != [f'resumed from step {LOOP_STEPS}']:
            raise RuntimeError(f'[loop] resume: {resumed}')
        ckpts = CheckpointManager(work).steps()
        want = [steps_per_epoch, LOOP_STEPS, steps]
        if ckpts != want:
            raise RuntimeError(f'[loop] checkpoints {ckpts}, expected {want}')
        ckpt_mb = os.path.getsize(os.path.join(
            work, 'checkpoints', f'{steps}.pt')) / 1e6
        count, lr = opt.param_groups[0]['count'], opt.param_groups[0]['lr']
        if count != steps:
            raise RuntimeError(f'[loop] optimizer count {count} after the '
                               f'resume, expected {steps}')
        del model, opt
        with open(os.path.join(work, 'scalars.jsonl')) as f:
            rows = [json.loads(ln) for ln in f]
        if [r['step'] for r in rows] != list(range(1, steps + 1)) or not all(
                np.isfinite(v) for r in rows for v in r.values()):
            raise RuntimeError('[loop] scalars.jsonl: steps or values wrong')
        busy_ms, window_ms = trace_busy(os.path.join(prof_dir,
                                                     'trace_rank0.json'))
        if device == 'cuda' and not busy_ms > 0:
            raise RuntimeError('[loop] the profiled steps show no device '
                               'time')
        # outside the first run's warm-up step, its profiled steps 6-10 and
        # step 11 (its time holds the trace's export and the epoch's
        # checkpoint)
        loop_ms = float(np.median(sec_it[1:5] + sec_it[11:])) * 1e3
        log(f'[loop] train: {LOOP_STEPS} steps in {run_s:.1f} s (epoch '
            f'{steps_per_epoch} steps), resumed for {LOOP_RESUME_STEPS} in '
            f'{resume_run_s:.1f} s; sec/it from the loop\'s log {sec_it} '
            f'(median {loop_ms:.1f} ms outside steps 1 and 6-11); peak '
            f'{peak:.3f} GiB at b={d.batch_size}; wrapper calls per step '
            f'{({k: v // steps for k, v in totals.items()})} = [train]\'s; '
            f'checkpoints at steps {ckpts}, {ckpt_mb:.1f} MB, save s '
            f'{[round(t, 3) for t in saves.seconds]}, restore s '
            f'{[round(t, 3) for t in restores.seconds]}; after the resume: '
            f'optimizer count {count}, lr {lr}; profiled steps 6-10: device '
            f'busy {busy_ms:.1f} of {window_ms:.1f} ms (idle share '
            f'{1 - busy_ms / window_ms:.3f}); {card}')
        # eval from the last checkpoint over the val scenes
        if device == 'cuda':
            torch.cuda.empty_cache()
        with _Timed(CheckpointManager, 'restore') as restored:
            t0 = time.perf_counter()
            metrics = test_cli.main(common)
            eval_s = time.perf_counter() - t0
        keys = sorted(k for k in metrics if not isinstance(metrics[k], str))
        if not keys or not all(np.isfinite(metrics[k]) for k in keys):
            raise RuntimeError(f'[loop] eval metrics: {metrics}')
        log(f'[loop] eval (tools.test, {d.n_views_test} views, b=1) over '
            f'{n_val} val scenes in {eval_s:.1f} s '
            f'({(eval_s - sum(restored.seconds)) / n_val:.2f} s a scene, '
            f'the model\'s build included; restore '
            f'{sum(restored.seconds):.2f} s); {len(keys)} metrics, keys '
            f'{keys[:6]}...; mAP_0.25 {metrics.get("mAP_0.25")}')
        worst, map25 = small_eval(root, os.path.join(work, 'small'), device)
        return totals, dict(
            run_s=run_s, resume_run_s=resume_run_s, sec_per_iter=sec_it,
            loop_ms=loop_ms, peak_gib=peak, steps_per_epoch=steps_per_epoch,
            counts_first=counts, counts_resumed=counts2, checkpoints=ckpts,
            ckpt_mb=ckpt_mb, save_s=saves.seconds,
            restore_s=restores.seconds, count_after_resume=count,
            lr_after_resume=lr, profiled_busy_ms=busy_ms,
            profiled_window_ms=window_ms, eval_s=eval_s,
            eval_metrics={k: metrics[k] for k in keys},
            small_eval_max_abs_diff=worst, small_eval_map_25=map25)
    finally:
        logging.getLogger('embodiedscan_torch').removeHandler(keep)


def main_loop():
    """``chip_smoke.py --loop``: the dataset written, a one-rank NCCL process group joined, one loop step
    recorded and timed alone (:func:`loop_step`), the replays of its K1, K2
    and K3 calls (before any profiler session of this process), then
    :func:`phase_loop`, then ``--demo`` (:func:`main_demo`) in a process
    of its own over the same dataset and work dir; writes the kernel rows
    (groups ``(loop)`` and ``(channel_mapper)``) and the numbers to
    chiprun_out/chip_smoke_loop.json for the parent run's kernels line."""
    import shutil
    import tempfile

    import torch.distributed as dist

    from embodiedscan_torch.ops import kernels
    from embodiedscan_torch.parallel.multihost import init_distributed
    card = card_name()
    kernels.library()
    torch.manual_seed(0)
    tmp = tempfile.mkdtemp(prefix='chip_smoke_loop_')
    try:
        root, work = os.path.join(tmp, 'data'), os.path.join(tmp, 'work')
        t0 = time.perf_counter()
        write_dataset(root)
        took = dict(dataset=time.perf_counter() - t0)
        _, cfg = _loop_cfg(root)
        d = cfg.data
        log(f'[loop] dataset: written in {took["dataset"]:.1f} s ({LOOP_SCENES} train and {LOOP_SCENES}'
            f' val scenes of {LOOP_VIEWS} views of 480x480); mv_det3d '
            f'b={d.batch_size}, {d.n_views_train} views of '
            f'{d.image_hw[0]}x{d.image_hw[1]}, {d.n_points} points, '
            f'{cfg.model.num_classes} classes; {card}')
        os.environ.update(RANK='0', WORLD_SIZE='1', LOCAL_RANK='0',
                          MASTER_ADDR='localhost',
                          MASTER_PORT=str(_free_port()))
        init_distributed('cuda')
        t0 = time.perf_counter()
        rec, stats = loop_step(cfg)
        took['step'] = time.perf_counter() - t0
        t0 = time.perf_counter()
        calls = phase_kernels([('loop', rec)], [('loop', rec)], 'cuda',
                              LOOP_TIMING)
        took['replays'] = time.perf_counter() - t0
        del rec
        t0 = time.perf_counter()
        totals, loop_stats = phase_loop(card, root, work)
        took['cli'] = time.perf_counter() - t0
        stats.update(loop_stats)
        t0 = time.perf_counter()
        demo = run_child('--demo', root, work)
        took['demo'] = time.perf_counter() - t0
        stats.update(demo=demo['stats'])
        log(f'[loop] the loop\'s median {stats["loop_ms"]:.1f} ms/it against '
            f'the bare step\'s best {min(stats["bare_step_ms"]):.1f} ms: '
            f'loop overhead {stats["loop_ms"] - min(stats["bare_step_ms"]):.1f}'
            f' ms a step')
        dist.destroy_process_group()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log('[loop] seconds per part: ' + ', '.join(
        f'{k} {v:.1f}' for k, v in took.items()))
    stats.update(seconds=took)
    # the loop's kernels: those of a train step (its counts also hold the
    # bf16 variants', which the float32 loop never launches)
    rows = kernel_rows(calls, ((' (loop)', {
        k: totals[k] for k in EXPECTED_TRAIN_LAUNCHES}, ('loop', )), )) + \
        demo['rows']
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, 'chip_smoke_loop.json'), 'w') as f:
        json.dump(dict(card=card, rows=rows, stats=stats, calls=calls), f,
                  indent=1, default=float)
    return 0


# --- the in-the-wild demo on a scan directory ([demo]) ---

# the full-width demo's views (the val scenes', 480x480) and its runs: the
# first in a fresh process, the second warm
DEMO_VIEWS = 50
DEMO_RUNS = 2
# the small checkpoint's card vs cpu demo: views of 96x96
DEMO_SMALL_VIEWS = 4
# wrapper calls of ChannelMapper(kernel_size=3) over MinkResNet-34's four
# levels: a neighbor table (K1) and a conv (K2, tensor cores) a level
EXPECTED_MAPPER_LAUNCHES = {'sparse_conv_tc': 4, 'sparse_conv_simt': 0,
                            'sparse_dgrad_tc': 0, 'sparse_dgrad_simt': 0,
                            'sparse_wgrad_tc': 0, 'sparse_wgrad_narrow': 0,
                            'join_scan': 4}
MAPPER_CHANNELS = 128


def write_demo_scan(path, n_views, hw, seed, num_classes=284):
    """A synthetic scan (``make_scan``, ``LOOP_BOXES`` boxes) written as a
    demo scan directory (``data.synthetic.write_scan_dir``: 4x4 and
    quaternion poses in turn); returns the seconds it took."""
    from embodiedscan_torch.data.synthetic import make_scan, write_scan_dir
    t0 = time.perf_counter()
    write_scan_dir(path, make_scan(seed=seed, n_views=n_views, hw=hw,
                                   g=LOOP_BOXES, num_classes=num_classes))
    return time.perf_counter() - t0


class _DemoRequests:
    """While active, each detector forward (a demo's request) runs with the
    wrapper counts set to 0 just before it and read just after it, and
    keeps its MinkResNet's output levels; the first records its kernel
    calls (``rec``)."""

    def __init__(self, S, P):
        self.S, self.P = S, P
        self.counts, self.levels = [], []
        self.rec = Recorder(S, P)

    def __enter__(self):
        from embodiedscan_torch.models.detector import SparseFusionDetector
        from embodiedscan_torch.models.sparse_nn import MinkResNet
        self.fwd = fwd = SparseFusionDetector.forward

        def forward(model, *args, **kw):
            cuda = next(model.parameters()).is_cuda
            hooks = [m.register_forward_hook(
                lambda mod, inp, out: self.levels.append(out))
                for m in model.modules() if isinstance(m, MinkResNet)]
            if cuda:
                torch.cuda.synchronize()
            reset_counts(self.S, self.P)
            try:
                with self.rec if not self.counts else \
                        contextlib.nullcontext():
                    out = fwd(model, *args, **kw)
                    if cuda:
                        torch.cuda.synchronize()
            finally:
                for h in hooks:
                    h.remove()
            self.counts.append(read_counts(self.S, self.P))
            return out

        SparseFusionDetector.forward = forward
        return self

    def __exit__(self, *exc):
        from embodiedscan_torch.models.detector import SparseFusionDetector
        SparseFusionDetector.forward = self.fwd


def _cfg_overrides(cfg):
    """``cfg``'s model and data fields that differ from the mv_det3d
    preset's, as ``a.b=c`` overrides."""
    import dataclasses

    from embodiedscan_torch.configs.base import mv_det3d
    base, out = mv_det3d(), []
    for part in ('model', 'data'):
        for f in dataclasses.fields(getattr(cfg, part)):
            val = getattr(getattr(cfg, part), f.name)
            if val != getattr(getattr(base, part), f.name):
                text = ','.join(map(str, val)) if isinstance(
                    val, (tuple, list)) else str(val)
                out.append(f'{part}.{f.name}={text}')
    return out


def _check_demo_ply(res, what):
    """The demo's PLY holds its scene points and the kept boxes' 8 corners
    and 12 edges each; returns the kept count."""
    head = []
    with open(res['out']) as f:
        while not head or head[-1] != 'end_header':
            head.append(next(f).strip())
    n, kept = len(res['points']), len(res['boxes'])
    want = f'element vertex {n + 8 * kept}'
    if want not in head or (kept and f'element edge {12 * kept}' not in
                            head):
        raise RuntimeError(f'[demo] {what}: PLY header {head} for {n} '
                           f'points and {kept} boxes')
    if not (np.isfinite(res['boxes']).all() and
            np.isfinite(res['scores']).all()):
        raise RuntimeError(f'[demo] {what}: non-finite detections')
    return kept


def phase_demo(card, root, work, device='cuda', overrides=()):
    """[demo]: ``tools.demo.main`` on a scan directory of ``DEMO_VIEWS``
    views of 480x480 at the shipped preset (``overrides`` for a rehearsal)
    from ``work``'s last checkpoint, ``DEMO_RUNS`` times: the restored step
    is the latest, each request's wrapper calls are [main]'s, the PLY
    holds the kept detections. Then the small checkpoint of
    :func:`small_eval` (``work/small``, class bias 0) through the demo on
    ``device`` and on the cpu over a scan of ``DEMO_SMALL_VIEWS`` views of
    96x96: the same kept labels, boxes within atol 1e-4 + rtol 1e-5.
    Returns (stats, the first request's MinkResNet levels, the recorder of
    its kernel calls)."""
    from embodiedscan_torch.ops import pscan as P
    from embodiedscan_torch.ops import sparse as S
    from embodiedscan_torch.tools import demo
    from embodiedscan_torch.train.checkpoint import CheckpointManager
    scan_dir = os.path.join(root, 'demo_scan')
    write_s = write_demo_scan(scan_dir, DEMO_VIEWS, (480, 480), seed=200)
    last = CheckpointManager(work).latest_step()
    runs = []
    with _DemoRequests(S, P) as req:
        for i in range(DEMO_RUNS):
            res = demo.main(['--dir', scan_dir, '--work-dir', work, '--out',
                             os.path.join(work, f'demo_{i}.ply'),
                             '--device', device, '--n-views',
                             str(DEMO_VIEWS), *overrides])
            if res['step'] != last:
                raise RuntimeError(f'[demo] restored step {res["step"]}, '
                                   f'the last is {last}')
            runs.append(dict(seconds=res['seconds'], points=len(
                res['points']), kept=_check_demo_ply(res, f'run {i}')))
    if len(req.counts) != DEMO_RUNS:
        raise RuntimeError(f'[demo] {len(req.counts)} requests')
    if device == 'cuda':
        for i, counts in enumerate(req.counts):
            check_counts(counts, EXPECTED_LAUNCHES, f'[demo] request {i}')
    for i, r in enumerate(runs):
        log(f'[demo] run {i} ({"a fresh process" if i == 0 else "warm"}): '
            f'{DEMO_VIEWS} views of 480x480, {r["points"]} scene points, '
            f'restored step {last}, kept {r["kept"]} detections, seconds: '
            + ', '.join(f'{k} {v:.3f}' for k, v in r['seconds'].items()) +
            f'; wrapper calls {req.counts[i]}; {card}')
    # the small checkpoint, card vs cpu
    cfg = _loop_small_cfg(root)
    small_dir = os.path.join(root, 'demo_small')
    write_demo_scan(small_dir, DEMO_SMALL_VIEWS, (96, 96), seed=201,
                    num_classes=cfg.model.num_classes)
    small = {}
    for dev in (device, 'cpu'):
        small[dev] = demo.main(
            ['--dir', small_dir, '--work-dir', os.path.join(work, 'small'),
             '--out', os.path.join(work, f'demo_small_{dev}.ply'),
             '--device', dev, '--n-views', str(DEMO_SMALL_VIEWS),
             *_cfg_overrides(cfg)])
        _check_demo_ply(small[dev], f'small on {dev}')
    a, b = small[device], small['cpu']
    if not (a['step'] == b['step'] == 0 and len(b['labels']) > 0 and
            np.array_equal(a['labels'], b['labels']) and np.allclose(
                a['boxes'], b['boxes'], atol=1e-4, rtol=1e-5)):
        raise RuntimeError(f'[demo] small checkpoint: {device} kept '
                           f'{a["labels"]}, cpu {b["labels"]}')
    worst = float(np.abs(a['boxes'] - b['boxes']).max())
    log(f'[demo] small checkpoint ({DEMO_SMALL_VIEWS} views of 96x96) on '
        f'{device} and cpu: {len(b["labels"])} kept, labels identical, '
        f'boxes max|d| {worst:.3g} (atol 1e-4 + rtol 1e-5)')
    return (dict(write_s=write_s, runs=runs, counts=req.counts,
                 small_kept=len(b['labels']), small_max_abs_diff=worst),
            req.levels[0], req.rec)


@torch.no_grad()
def phase_mapper(levels, device='cuda'):
    """``ChannelMapper(kernel_size=3)`` to ``MAPPER_CHANNELS`` channels over
    a request's MinkResNet levels (seeded weights): its wrapper calls
    counted (EXPECTED_MAPPER_LAUNCHES) and recorded, its outputs finite
    with padded rows zero. Returns (counts, recorder)."""
    from embodiedscan_torch.models.detector import init_weights
    from embodiedscan_torch.models.sparse_nn import ChannelMapper
    from embodiedscan_torch.ops import pscan as P
    from embodiedscan_torch.ops import sparse as S
    mapper = ChannelMapper([lv.feats.shape[-1] for lv in levels],
                           MAPPER_CHANNELS, kernel_size=3)
    init_weights(mapper, torch.Generator().manual_seed(0))
    mapper = mapper.to(device).eval()
    if device == 'cuda':
        torch.cuda.synchronize()
    reset_counts(S, P)
    with Recorder(S, P) as rec:
        outs = mapper(levels)
        if device == 'cuda':
            torch.cuda.synchronize()
    counts = read_counts(S, P)
    if device == 'cuda':
        check_counts(counts, EXPECTED_MAPPER_LAUNCHES, '[demo] ChannelMapper')
    for lv, out in zip(levels, outs):
        if out.feats.shape != lv.feats.shape[:2] + (MAPPER_CHANNELS,) or \
                not torch.isfinite(out.feats).all() or \
                bool(out.feats[~lv.mask].any()):
            raise RuntimeError('[demo] ChannelMapper output')
    log(f'[demo] ChannelMapper(kernel_size=3) to {MAPPER_CHANNELS} channels '
        f'over the levels {[tuple(lv.feats.shape) for lv in levels]}: '
        f'wrapper calls {counts}')
    return counts, rec


def main_demo(root, work):
    """``chip_smoke.py --demo ROOT WORK``: :func:`phase_demo` over the
    [loop] run's dataset and work dir in a process of its own (no earlier
    profiler session, a fresh allocator), :func:`phase_mapper` over its
    first request's levels, then the replays of that request's and the
    mapper's K1 and K2 calls; writes their kernel rows (groups ``(demo)``
    and ``(channel_mapper)``) and numbers to chiprun_out/chip_smoke_demo.json
    for the [loop] run."""
    from embodiedscan_torch.ops import kernels
    card = card_name()
    kernels.library()
    t0 = time.perf_counter()
    stats, levels, demo_rec = phase_demo(card, root, work)
    took = dict(demo=time.perf_counter() - t0)
    mapper_counts, mapper_rec = phase_mapper(levels)
    del levels
    t0 = time.perf_counter()
    calls = phase_kernels([('demo', demo_rec), ('channel_mapper', mapper_rec)],
                          [], 'cuda', LOOP_TIMING)
    took['replays'] = time.perf_counter() - t0
    # each group's kernels: those its runs launched, with their totals
    demo_counts = {k: sum(c[k] for c in stats['counts'])
                   for k, n in EXPECTED_LAUNCHES.items() if n}
    mapper_counts = {k: v for k, v in mapper_counts.items()
                     if EXPECTED_MAPPER_LAUNCHES.get(k)}
    rows = kernel_rows(calls, ((' (demo)', demo_counts, ('demo', )),
                               (' (channel_mapper)', mapper_counts,
                                ('channel_mapper', ))))
    log('[demo] seconds per part: ' + ', '.join(
        f'{k} {v:.1f}' for k, v in took.items()))
    stats.update(seconds=took, mapper_counts=mapper_counts)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, 'chip_smoke_demo.json'), 'w') as f:
        json.dump(dict(card=card, rows=rows, stats=stats, calls=calls), f,
                  indent=1, default=float)
    return 0


# --- the head's other box modes, the capacity and overfit tools ([heads],
# [capacity], [quality]) ---

# the parity phase's head variants: (name, bbox_mode, head attributes)
HEAD_VARIANTS = (('yaw7d', 'yaw7d', {}), ('aa6d', 'aa6d', {}),
                 ('cd_mode=l2', 'euler9d', dict(cd_mode='l2')),
                 ('cd_group=g4', 'euler9d', dict(cd_group='g4')),
                 ('decouple_groups=3', 'euler9d', dict(decouple_groups=3)),
                 ('norm_decouple_loss', 'euler9d',
                  dict(norm_decouple_loss=True)),
                 ('undecoupled', 'euler9d', dict(decouple_bbox_loss=False)))
# the overfit tool's detector steps ([quality]; grounding 8/10 of them,
# occupancy 6/10 but at least 40): 60, not the tool's default 100, keeps
# the whole script, which runs the --precision child after it, inside its
# time limit
QUALITY_STEPS = 60


def build_head_model(cfg, device, bbox_mode, **head):
    """``build_model``'s detector of ``cfg`` with the head's ``bbox_mode``
    and attributes ``head`` (loss options the config has no field for, as
    the reference's: the yaw and axis-aligned heads are built directly)."""
    from embodiedscan_torch.configs.base import build_model
    model = build_model(cfg, device, bbox_mode=bbox_mode)
    for key, val in head.items():
        setattr(model.bbox_head, key, val)
    return model


def yaw_batch(batch):
    """A train batch whose gt boxes keep only their yaw (pitch and roll
    zeroed), as the reference's yaw-head tests give it."""
    batch = dict(batch)
    batch['gt_boxes'] = batch['gt_boxes'].copy()
    batch['gt_boxes'][..., 7:9] = 0.0
    return batch


def phase_heads(card, device='cuda'):
    """The 'yaw7d' head at mv_det3d's full width (the trunk and
    capacities as [main]): one warm-up and three requests of [main]'s
    scenes (the class bias zeroed, as [main]), then in training mode, from
    the initial class bias, one warm-up and three steps of [train]'s scene
    with the gt boxes' pitch and roll zeroed (AdamW, clip 10, the 2D
    stem and first stage frozen), its split naming the rotated IoU; then
    the 'aa6d' head's steps on the same scene. Wrapper calls per request
    and step against [main]'s and [train]'s."""
    from embodiedscan_torch.configs.base import mv_det3d
    from embodiedscan_torch.ops import pscan as P
    from embodiedscan_torch.ops import sparse as S
    from embodiedscan_torch.train.loop import lr_mult_fn_for
    from embodiedscan_torch.train.state import make_optimizer
    cfg = mv_det3d()
    d = cfg.data
    stats = {}
    tbatch = to_device(yaw_batch(make_batch(
        1, d.n_points, d.n_views_train, d.image_hw[0], N_GT,
        cfg.model.num_classes)), device)
    for mode in ('yaw7d', 'aa6d'):
        t0 = time.perf_counter()
        model = build_head_model(cfg, device, mode)
        log(f'[heads] built mv_det3d with the {mode} head on {device} in '
            f'{time.perf_counter() - t0:.1f} s: conv_reg '
            f'{tuple(model.bbox_head.conv_reg.weight.shape)}')
        if mode == 'yaw7d':
            prior = model.bbox_head.conv_cls.bias.detach().clone()
            with torch.no_grad():  # a checkpoint's class bias, as [main]
                model.bbox_head.conv_cls.bias.zero_()
            lat, mem, kept = [], [], []
            for i in range(4):
                batch = to_device(make_request(d.n_points, d.n_views_test,
                                               d.image_hw[0], i), device)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                reset_counts(S, P)
                t0 = time.perf_counter()
                with torch.no_grad():
                    preds = model(batch, mode='predict')
                torch.cuda.synchronize()
                took = time.perf_counter() - t0
                counts = read_counts(S, P)
                check_counts(counts, EXPECTED_LAUNCHES, f'{mode} request {i}')
                _det_checks_yaw(preds, cfg, mode)
                if i:  # the first is the warm-up
                    lat.append(took * 1e3)
                    mem.append(torch.cuda.max_memory_allocated() / 2**30)
                    kept.append(int(preds['mask'].sum()))
            log(f'[heads] {mode} request ms {[round(t, 3) for t in lat]}, '
                f'peak GiB {max(mem):.3f}, kept {kept}, launches per '
                f'request {counts}; {card}')
            stats[f'{mode}_request'] = dict(latency_ms=lat, peak_gib=mem,
                                            kept=kept)
            del batch, preds
            with torch.no_grad():  # the initial class bias, as [train]
                model.bbox_head.conv_cls.bias.copy_(prior)
        model.train()
        opt = make_optimizer(model, cfg, lr_mult_fn_for('mv_det3d'),
                             steps_per_epoch=PHASE_EPOCH)
        _, _, st = train_steps(f'heads {mode}', model, opt, tbatch,
                               EXPECTED_TRAIN_LAUNCHES, record=False)
        if not 0 < st['losses'][-1]['loss_bbox'] < 1:
            raise RuntimeError(f'{mode}: loss_bbox {st["losses"][-1]} is '
                               'not 1 - IoU over positive locations')
        stats[f'{mode}_step'] = st
        log(f'[heads] {mode} step ms {[round(t, 3) for t in st["step_ms"]]}, '
            f'peak GiB {max(st["peak_gib"]):.3f}, split ' + ', '.join(
                f'{k} {v:.2f}' for k, v in st['split_ms'].items()) +
            f' ms; {card}')
        del model, opt
        torch.cuda.empty_cache()
    return stats


def _det_checks_yaw(preds, cfg, mode):
    for key, val in preds.items():
        if val.is_floating_point() and not torch.isfinite(val).all():
            raise RuntimeError(f'{mode}: non-finite {key}')
    if preds['bboxes'].shape != (1, cfg.model.max_dets, 9):
        raise RuntimeError(f'bboxes shape {tuple(preds["bboxes"].shape)}')
    if not preds['mask'].any():
        raise RuntimeError(f'{mode}: a request kept no detection')
    if preds['bboxes'][..., 7:9].any():
        raise RuntimeError(f'{mode}: boxes with pitch or roll')


def phase_heads_parity(device='cuda'):
    """The small detector (``_parity_cfg``) with each head variant of
    HEAD_VARIANTS on ``device`` (kernels) and on cpu (plain versions) from
    the same weights: the yaw and axis-aligned heads serving
    (:func:`det_parity`'s gates), and one train step of every variant (its
    tables identical, each loss within LOSS_RTOL, every gradient leaf and
    batch statistic within GRAD_GATE x max|cpu|)."""
    cfg = _parity_cfg()
    out = {}
    for name, mode, head in HEAD_VARIANTS:
        t0 = time.perf_counter()

        def build(c, device, mode=mode, head=head):
            return build_head_model(c, device, mode, **head)

        if not head:
            cpu = build(cfg, 'cpu')
            with torch.no_grad():
                cpu.bbox_head.conv_cls.bias.zero_()
            gpu = build(cfg, device)
            gpu.load_state_dict(cpu.state_dict())
            det_parity(cpu, gpu, make_request(p=6000, v=4, hw=96, seed=7),
                       device, f'{name} head cpu vs cuda')
            del cpu, gpu
        batch = make_batch(1, 6000, 4, 96, 16, cfg.model.num_classes, seed=7)
        if mode != 'euler9d':
            batch = yaw_batch(batch)
        n_tables, mc, mg, worst = train_parity(device, cfg, batch, build)
        gates = dict(losses=LOSS_RTOL, grads=GRAD_GATE,
                     **{'batch stats': GRAD_GATE})
        for kind, (ratio, path) in worst.items():
            if not np.isfinite(ratio) or ratio > gates[kind]:
                raise RuntimeError(f'{name} train step {kind} {path}: '
                                   f'max|d|/max|cpu| {ratio} > {gates[kind]}')
        if not mc['loss_bbox'] > 0:
            raise RuntimeError(f'{name}: no positive location')
        out[name] = dict(worst={k: v for k, (v, _) in worst.items()},
                         loss_bbox=mc['loss_bbox'],
                         seconds=time.perf_counter() - t0)
        log(f'[parity] {name} train step cpu vs cuda: {n_tables} tables '
            f'identical, loss_bbox {mc["loss_bbox"]:.6g} vs '
            f'{mg["loss_bbox"]:.6g}; worst max|d|/max|cpu|: ' +
            ', '.join(f'{k} {v:.2e} ({p})' for k, (v, p) in worst.items()) +
            f' (gates {gates}); {out[name]["seconds"]:.1f} s')
    return out


def phase_capacity(card, device='cuda'):
    """``tools.occupancy_histogram`` at the bench scale on the card and on
    the cpu: every count identical."""
    from embodiedscan_torch.tools import occupancy_histogram as H
    t0 = time.perf_counter()
    on_card = H.main(['--device', device])
    t1 = time.perf_counter()
    on_cpu = H.main(['--device', 'cpu'])
    t2 = time.perf_counter()
    for key in ('bench', 'synthetic'):
        if on_card[key] != on_cpu[key]:
            raise RuntimeError(f'capacity {key}: card {on_card[key]} vs cpu '
                               f'{on_cpu[key]}')
    log(f'[capacity] occupied voxels per level identical on the card and '
        f'the cpu: bench {on_card["bench"]}, synthetic '
        f'{on_card["synthetic"]} (capacities {on_card["capacities"]}); '
        f'{t1 - t0:.1f} s on the card, {t2 - t1:.1f} s on the cpu, {card}')
    return dict(bench=on_card['bench'], synthetic=on_card['synthetic'],
                card_s=t1 - t0, cpu_s=t2 - t1)


def phase_quality(card, device='cuda', steps=QUALITY_STEPS):
    """``tools.quality_smoke --steps QUALITY_STEPS`` on the card (its
    report in chiprun_out/quality_smoke.md); fails on the tool's gate."""
    from embodiedscan_torch.tools import quality_smoke as Q
    os.makedirs(OUT_DIR, exist_ok=True)
    t0 = time.perf_counter()
    report = Q.main(['--device', device, '--steps', str(steps), '--out',
                     os.path.join(OUT_DIR, 'quality_smoke.md')])
    shown = ('mAP_0.25', 'mAP_0.50', 'Overall@0.25', 'Overall@0.5', 'empty',
             'mIoU')
    for task, r in report.items():
        first, last = Q.windows(r['losses'])
        log(f'[quality] {task}: {r["steps"]} steps, loss {first:.4f} -> '
            f'{last:.4f}, ' + ', '.join(
                f'{k} {r["metrics"][k]:.4f}' for k in shown
                if k in r['metrics']) + f'; {r["seconds"]:.1f} s')
    log(f'[quality] passed in {time.perf_counter() - t0:.1f} s, {card}')
    return report


def main_heads():
    """``chip_smoke.py --heads``: [heads], the head variants' parity,
    [capacity] and [quality]; the numbers to chiprun_out/chip_smoke_heads
    .json."""
    from embodiedscan_torch.ops import kernels
    card = card_name()
    kernels.library()
    torch.manual_seed(0)
    took, stats = {}, {}
    for name, phase in (('heads', lambda: phase_heads(card)),
                        ('heads_parity', phase_heads_parity),
                        ('capacity', lambda: phase_capacity(card)),
                        ('quality', lambda: phase_quality(card))):
        t0 = time.perf_counter()
        stats[name] = phase()
        took[name] = time.perf_counter() - t0
    log('[heads] seconds per part: ' + ', '.join(
        f'{k} {v:.1f}' for k, v in took.items()))
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, 'chip_smoke_heads.json'), 'w') as f:
        json.dump(dict(card=card, stats=stats, seconds=took, rows=[]), f,
                  indent=1, default=float)
    return 0


# --- the bf16 sparse-conv route and remat (--precision) -----------------------

# wrapper calls per request under set_conv_compute_dtype(torch.bfloat16):
# K2-bf16 for all 44 convs (the stem's Cin = 3 on its SIMT route), no
# float32 K2
EXPECTED_BF16_LAUNCHES = {**EXPECTED_LAUNCHES, 'sparse_conv_tc': 0,
                          'sparse_conv_simt': 0, 'sparse_conv_tc_bf16': 43,
                          'sparse_conv_simt_bf16': 1,
                          'sparse_dgrad_tc_bf16': 0,
                          'sparse_wgrad_tc_bf16': 0}
# per bf16 train step: K2-bf16 forward for the 44 convs and dgrad for the
# 35 submanifold and 4 strided ones, K3-bf16 for their 39 weight
# gradients; the generic route's 5 convs (the stem, the 4 K = 1
# downsamples) keep the float32 K3 over bfloat16-rounded features (the
# stem's Cy = 3 on the narrow route), as the reference's autodiff does
EXPECTED_BF16_TRAIN_LAUNCHES = {
    'sparse_conv_tc': 0, 'sparse_conv_simt': 0, 'sparse_dgrad_tc': 0,
    'sparse_dgrad_simt': 0, 'sparse_wgrad_tc': 4, 'sparse_wgrad_narrow': 1,
    'join_scan': 12, 'sparse_conv_tc_bf16': 43, 'sparse_conv_simt_bf16': 1,
    'sparse_dgrad_tc_bf16': 39, 'sparse_dgrad_simt_bf16': 0,
    'sparse_wgrad_tc_bf16': 39, 'sparse_wgrad_narrow_bf16': 0,
    'nms_overlap': 0}
BF16_KERNELS = ('sparse_conv_tc_bf16', 'sparse_conv_simt_bf16',
                'sparse_dgrad_tc_bf16', 'sparse_wgrad_tc_bf16')
# CUDA launches of one replayed wrapper call, the weights' bfloat16 copy
# made (bf16_weights): K2-bf16 the cast of feats and the kernel (its split
# reduction folded in, no sc_reduce); its input gradient the kernel alone
# (the backward hands it dout in bfloat16, no transposed weights); K3-bf16
# the memset, the pair pass and the product (chunks folded in, no
# wg_reduce)
BF16_MAX_LAUNCHES = {'sparse_conv_bf16': 2, 'sparse_dgrad_bf16': 1,
                     'sparse_wgrad_bf16': 3}
PRECISION_TIMING = dict(warmup=1, reps=2)
# a bfloat16 rounding step: at most 2^-7 of the value rounded
BF16_STEP = 2.0 ** -7
# the small detector's FPN capacities in the bf16 parity: every child of
# every parent kept (24 -> 192 -> 1536 -> 12288 at most), so no top-k
# choice hangs on a rounding step (tests/test_torch_sparse_bf16.py)
BF16_PARITY_FPN = (12288, 1536, 256, 128)
# the bf16 parity's request: each level's head outputs within this many
# rounding steps of their max. A step of one conv input (at most 2^-7 of
# it) moves the outputs that depend on it by a fraction of a step of
# theirs; the card's float32 parts (cuDNN's algorithm, picked at run time)
# differ from run to run, so where the cpu test holds one step (against
# the reference, both deterministic) the card is held to two
BF16_REQUEST_STEPS = 2
# the bf16 parity's train step: the cpu step against itself after one
# float32 rounding step of every weight, three draws (their distances
# 0.44-0.72 on the cpu: the step is chaotic at float32 rounding); the
# card's distance within BF16_SPREAD_MARGIN x the largest
BF16_ULP_DRAWS = 3
BF16_SPREAD_MARGIN = 1.5
REMAT_MODES = ('none', '2d', '3d', 'all')


@contextlib.contextmanager
def bf16_route(S):
    """The port's sparse convs in bfloat16 while active (the previous
    dtype restored on exit)."""
    before = S.CONV_COMPUTE_DTYPE
    S.set_conv_compute_dtype(torch.bfloat16)
    try:
        yield
    finally:
        S.set_conv_compute_dtype(before)


def phase_sparse_bf16(card, device='cuda', cfg=None):
    """[sparse_bf16]: the full-width mv_det3d (as [main] and [train]) under
    ``set_conv_compute_dtype(torch.bfloat16)``, the reference's
    ``BENCH_SPARSE_BF16=1`` path: a recorded warm-up and three requests of
    [main]'s scenes (latency, peak, kept, wrapper calls against
    EXPECTED_BF16_LAUNCHES), then ``build_train``'s model: a recorded
    warm-up and three steps of [train]'s scene (step, split, peak, calls
    against EXPECTED_BF16_TRAIN_LAUNCHES). Returns the two recorders (on
    the host), the launch totals of the timed runs and the stats."""
    from embodiedscan_torch.configs.base import build_model, build_train, \
        mv_det3d
    from embodiedscan_torch.ops import pscan as P
    from embodiedscan_torch.ops import sparse as S
    cfg = cfg or mv_det3d()
    d = cfg.data
    stats = {}
    totals = dict.fromkeys(EXPECTED_BF16_TRAIN_LAUNCHES, 0)
    with bf16_route(S):
        model = build_model(cfg, device=device)
        with torch.no_grad():  # a checkpoint's class bias, as [main]
            model.bbox_head.conv_cls.bias.zero_()
        requests = [make_request(d.n_points, d.n_views_test, d.image_hw[0],
                                 s) for s in range(4)]
        with Recorder(S, P) as rec, torch.no_grad():
            t0 = time.perf_counter()
            model(to_device(requests[0], device), mode='predict')
            torch.cuda.synchronize()
        rec.to_host()
        log(f'[sparse_bf16] warm-up request {time.perf_counter() - t0:.2f} '
            f's, {len(rec.conv16)} K2-bf16 calls recorded')
        lat, mem, kept = [], [], []
        for i, req in enumerate(requests[1:]):
            batch = to_device(req, device)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_counts(S, P)
            t0 = time.perf_counter()
            with torch.no_grad():
                preds = model(batch, mode='predict')
            torch.cuda.synchronize()
            lat.append((time.perf_counter() - t0) * 1e3)
            counts = read_counts(S, P)
            mem.append(torch.cuda.max_memory_allocated() / 2**30)
            check_counts(counts, EXPECTED_BF16_LAUNCHES, f'bf16 request {i}')
            if preds['bboxes'].shape != (1, cfg.model.max_dets, 9) or not \
                    all(torch.isfinite(v).all() for v in preds.values()
                        if v.is_floating_point()):
                raise RuntimeError(f'bf16 request {i}: bboxes '
                                   f'{tuple(preds["bboxes"].shape)} or a '
                                   'non-finite output')
            kept.append(int(preds['mask'].sum()))
            for name in EXPECTED_BF16_LAUNCHES:
                totals[name] += counts[name]
        if not all(kept):
            raise RuntimeError('a bf16 request kept no detection')
        log(f'[sparse_bf16] request ms {[round(t, 3) for t in lat]}, peak '
            f'GiB {max(mem):.3f}, kept {kept}, launches per request '
            f'{counts}; {card}')
        stats['request'] = dict(latency_ms=lat, peak_gib=mem, kept=kept)
        del model, batch, preds
        torch.cuda.empty_cache()
        tmodel, opt = build_train(cfg, device=device,
                                  steps_per_epoch=PHASE_EPOCH)
        tbatch = to_device(make_batch(1, d.n_points, d.n_views_train,
                                      d.image_hw[0], N_GT,
                                      cfg.model.num_classes), device)
        train_rec, ttotals, st = train_steps(
            'sparse_bf16 train', tmodel, opt, tbatch,
            EXPECTED_BF16_TRAIN_LAUNCHES)
        for name, n in ttotals.items():
            totals[name] += n
        stats['step'] = st
        log(f'[sparse_bf16] step ms {[round(t, 3) for t in st["step_ms"]]}, '
            f'peak GiB {max(st["peak_gib"]):.3f}, split ' + ', '.join(
                f'{k} {v:.2f}' for k, v in st['split_ms'].items()) +
            f' ms; {card}')
        del tmodel, opt, tbatch
        torch.cuda.empty_cache()
    return rec, train_rec, totals, stats


@torch.no_grad()
def phase_kernels_bf16(req_rec, train_rec, device, timing=PRECISION_TIMING):
    """Every K2-bf16 call of the recorded warm-up request and step, and
    every K2-bf16 dgrad and K3-bf16 call of the step, replayed one at a
    time on the card against the plain bf16 versions (within CONV_GATE x
    max|ref|, the same bits twice; K3's pair lists against the plain pair
    pass) and timed beside them and the library call in bfloat16, with the
    bound at the bf16 peak; then each call's CUDA launches and device time
    by the profiler, the launches held to BF16_MAX_LAUNCHES."""
    from embodiedscan_torch.ops import sparse as S
    runs = {
        'sparse_conv_bf16': (
            [('sparse_bf16', a) for a in req_rec.conv16] +
            [('sparse_bf16_train', a) for a in train_rec.conv16],
            lambda a: S.gather_matmul_conv(*a)),
        'sparse_dgrad_bf16': (
            [('sparse_bf16_train', a) for a in train_rec.dgrad16],
            lambda a: S.conv_dgrad(*a[:4], bf16=True, mirror=a[4])),
        'sparse_wgrad_bf16': (
            [('sparse_bf16_train', a) for a in train_rec.wgrad16],
            lambda a: S.conv_wgrad(*a, bf16=True)),
    }
    calls = {name: [] for name in runs}
    with bf16_route(S):
        for name, (recs, run) in runs.items():
            for path, args in recs:
                a = _on(args, device)
                if name == 'sparse_wgrad_bf16':
                    row = _wgrad_call(S, *a, timing, bf16=True)
                elif name == 'sparse_dgrad_bf16':
                    row = _conv_call(S, *a[:4], None, name, lambda: run(a),
                                     timing, bf16=True, mirror=a[4])
                else:
                    row = _conv_call(S, *a, name, lambda: run(a), timing,
                                     bf16=True)
                row['path'] = path
                calls[name].append(row)
        for name, (recs, run) in runs.items():
            for row, (_, args) in zip(calls[name], recs):
                a = _on(args, device)
                row['cuda_launches'], row['device_ms'] = device_profile(
                    lambda: run(a))
                if row['cuda_launches'] > BF16_MAX_LAUNCHES[name]:
                    raise RuntimeError(
                        f'{name} {row["m" if "m" in row else "r"]} rows: '
                        f'{row["cuda_launches"]} CUDA launches, at most '
                        f'{BF16_MAX_LAUNCHES[name]}')
    for name, rows in calls.items():
        for path in sorted({r['path'] for r in rows}):
            rs = [r for r in rows if r['path'] == path]
            log(f'[kernels] {name} ({path}): {len(rs)} main-path calls '
                f'checked, kernel {sum(r["ms"] for r in rs):.3f} ms (device '
                f'{sum(r["device_ms"] for r in rs):.3f}), plain '
                f'{sum(r["plain_ms"] for r in rs):.3f}, library (bf16) '
                f'{sum(r["library_ms"] for r in rs):.3f}, bound (bf16) '
                f'{sum(r["bound_ms"] for r in rs):.3f} ms; max|d|/max|ref| '
                f'{max(r["max_abs_err"] / max(r["max_abs_ref"], 1e-30) for r in rs):.2e}; '
                f'CUDA launches {sum(r["cuda_launches"] for r in rs)}; '
                f'routes {sorted({r["route"] for r in rs})}')
    return calls


def _steps_close(got, want, steps=1):
    """(within ``steps`` bfloat16 rounding steps of max|want|, the error
    over max|want|)."""
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    return err <= steps * BF16_STEP * scale + 1e-6, err / scale


def _grad_distance(got, want):
    """The relative L2 distance of two gradients (every leaf)."""
    num = sum(float(np.square(np.asarray(got[k]) - np.asarray(w)).sum())
              for k, w in want.items())
    den = sum(float(np.square(np.asarray(w)).sum()) for w in want.values())
    return (num / den) ** 0.5


def _one_ulp_(model, seed=0):
    """Every float32 parameter moved by one rounding step, up or down at
    random (in place)."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            up = torch.rand(p.shape, generator=g) < 0.5
            p.copy_(torch.where(up.to(p.device),
                                torch.nextafter(p, torch.full_like(p, np.inf)),
                                torch.nextafter(p, torch.full_like(p,
                                                                   -np.inf))))


def phase_bf16_parity(device='cuda'):
    """The small detector (``_parity_cfg`` with BF16_PARITY_FPN) in bf16
    mode on the card and on the cpu from the same weights. A request: the
    neighbor tables and feature coordinates identical, the head's outputs
    within one bfloat16 rounding step of each level's max. A train step:
    the tables identical, each loss within one step of itself, the batch
    statistics within one step of their max, and the whole gradient within
    BF16_SPREAD_MARGIN x the largest distance the cpu step moves when each
    weight moves by one float32 rounding step (BF16_ULP_DRAWS draws). At
    this size the bf16 step is chaotic at float32 rounding (see
    tests/test_torch_sparse_bf16.py), so that gate is loose: the kernels'
    numbers are held per call by :func:`phase_kernels_bf16`."""
    from embodiedscan_torch.configs.base import build_model
    from embodiedscan_torch.ops import pscan as P
    from embodiedscan_torch.ops import sparse as S
    from embodiedscan_torch.train.state import make_optimizer, train_step
    from embodiedscan_torch.utils.convert_weights import export_jax_tree
    cfg = _parity_cfg()
    cfg.model.fpn_capacities = BF16_PARITY_FPN
    req = make_request(p=6000, v=4, hw=96, seed=7)
    batch = make_batch(1, 6000, 4, 96, 16, cfg.model.num_classes, seed=7)
    t0 = time.perf_counter()
    with bf16_route(S):
        cpu = build_model(cfg, device='cpu')
        gpu = build_model(cfg, device=device)
        gpu.load_state_dict(cpu.state_dict())
        out = {}
        for name, model, dev in (('cpu', cpu, 'cpu'), ('cuda', gpu, device)):
            with Recorder(S, P) as rec, torch.no_grad():
                feats = model(to_device(req, dev), mode='feats')
            out[name] = (rec, feats)
        (rc, fc), (rg, fg) = out['cpu'], out['cuda']
        if len(rc.conv16) != len(rg.conv16) or not rg.conv16 or any(
                not torch.equal(a[2], b[2].cpu())
                for a, b in zip(rc.conv16, rg.conv16)):
            raise RuntimeError('bf16 request: neighbor tables differ')
        for field in ('points', 'masks'):
            for c, g in zip(getattr(fc, field), getattr(fg, field)):
                if not torch.equal(c, g.cpu()):
                    raise RuntimeError(f'bf16 request: {field} differ')
        worst = {}
        for field in ('center', 'reg', 'cls'):
            for c, g in zip(getattr(fc, field), getattr(fg, field)):
                ok, ratio = _steps_close(g.cpu().numpy(), c.numpy(),
                                         BF16_REQUEST_STEPS)
                worst[field] = max(worst.get(field, 0.0), ratio)
                if not ok:
                    raise RuntimeError(f'bf16 request {field}: max|d|/max '
                                       f'{ratio} > {BF16_REQUEST_STEPS} x '
                                       f'{BF16_STEP}')
        log(f'[parity] bf16 small detector request cpu vs cuda: '
            f'{len(rc.conv16)} tables identical, head outputs max|d|/max '
            + ', '.join(f'{k} {v:.2e}' for k, v in worst.items()) +
            f' (gate {BF16_REQUEST_STEPS} bf16 steps, '
            f'{BF16_REQUEST_STEPS * BF16_STEP:.2e})')
        res = {}
        for name, dev, ulp in (('cpu', 'cpu', None), ('cuda', device, None),
                               *((f'cpu_ulp{i}', 'cpu', i)
                                 for i in range(BF16_ULP_DRAWS))):
            model = build_model(cfg, device=dev).train()
            model.load_state_dict(cpu.state_dict())
            if ulp is not None:
                _one_ulp_(model, ulp)
            with Recorder(S, P) as rec:
                metrics = train_step(model, make_optimizer(
                    model, cfg, steps_per_epoch=PHASE_EPOCH),
                    to_device(batch, dev))
            grads = {n: p.grad.detach().cpu().numpy().copy()
                     for n, p in model.named_parameters()
                     if p.grad is not None}
            res[name] = (rec, {k: float(v) for k, v in metrics.items()},
                         grads, export_jax_tree(model, 'buffers'))
    (rc, mc, gc, bc), (rg, mg, gg, bg) = res['cpu'], res['cuda']
    for kind in ('conv16', 'dgrad16', 'wgrad16', 'wgrad'):
        a, b = getattr(rc, kind), getattr(rg, kind)
        if len(a) != len(b) or not b or any(
                not torch.equal(x[2], y[2].cpu()) for x, y in zip(a, b)):
            raise RuntimeError(f'bf16 train step: {kind} tables differ')
    for key, val in mc.items():
        if not abs(mg[key] - val) <= BF16_STEP * abs(val):
            raise RuntimeError(f'bf16 train step {key}: {mg[key]} vs {val}')
    stat_worst = _worst({'/'.join(k): v for k, v in _tree_leaves(bc)},
                        {'/'.join(k): v for k, v in _tree_leaves(bg)})
    if not stat_worst[0] <= BF16_STEP:
        raise RuntimeError(f'bf16 train step statistics {stat_worst}')
    if set(gc) != set(gg):
        raise RuntimeError('bf16 train step: other leaves have gradients')
    dist = _grad_distance(gg, gc)
    spreads = [_grad_distance(res[f'cpu_ulp{i}'][2], gc)
               for i in range(BF16_ULP_DRAWS)]
    if not dist <= BF16_SPREAD_MARGIN * max(spreads):
        raise RuntimeError(f'bf16 train step: gradient distance {dist} > '
                           f'{BF16_SPREAD_MARGIN} x the cpu step\'s one-ulp '
                           f'spreads {spreads}')
    log(f'[parity] bf16 small detector train step cpu vs cuda: tables '
        f'identical, loss_total {mc["loss_total"]:.6g} vs '
        f'{mg["loss_total"]:.6g}, statistics max|d|/max {stat_worst[0]:.2e} '
        f'({stat_worst[1]}), gradient distance {dist:.4f} (the cpu step '
        f'after one-ulp weight moves: '
        f'{", ".join(f"{x:.4f}" for x in spreads)}; gate '
        f'{BF16_SPREAD_MARGIN} x the largest); '
        f'{time.perf_counter() - t0:.1f} s')
    return dict(request_worst=worst, loss_cpu=mc, loss_cuda=mg,
                stat_worst=stat_worst[0], grad_distance=dist,
                grad_spreads=spreads)


def _set_remat(model, mode):
    """Switch a built detector's or occupancy model's remat mode (the
    attributes ``build_model`` sets from ``ModelConfig.remat``)."""
    from embodiedscan_torch.models.occupancy import DenseFusionOccPredictor
    from embodiedscan_torch.models.remat import covers
    from embodiedscan_torch.models.resnet2d import ResNet
    from embodiedscan_torch.models.sparse_nn import MinkResNet
    for mod in model.modules():
        if isinstance(mod, ResNet):
            mod.remat = covers(mode, '2d')
        elif isinstance(mod, MinkResNet):
            mod.remat = covers(mode, '3d')
        elif isinstance(mod, DenseFusionOccPredictor):
            mod.remat_neck = covers(mode, '3d')


def remat_modes(tag, model, opt, batch, modes, card):
    """Each remat mode of ``modes`` on one built model: a warm-up and
    three timed train_steps (step ms, peak, wrapper calls, the same in each
    step); then
    at the last weights one forward and backward per mode from the same
    running statistics, every gradient and statistic against 'none''s
    (bit-identical, or where the card's 'none' step repeated differs in
    its low bits, within GRAD_GATE x max|leaf| and those leaves named)."""
    from embodiedscan_torch.ops import pscan as P
    from embodiedscan_torch.ops import sparse as S
    from embodiedscan_torch.train.state import train_step
    stats = {}
    for mode in modes:
        _set_remat(model, mode)
        step_ms, calls = [], []
        train_step(model, opt, batch)  # warm-up: allocator, cuDNN plans
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for _ in range(3):
            reset_counts(S, P)
            t0 = time.perf_counter()
            metrics = train_step(model, opt, batch)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            calls.append(read_counts(S, P))
        if any(c != calls[0] for c in calls):
            raise RuntimeError(f'{tag} {mode}: wrapper calls differ between '
                               f'steps: {calls}')
        peak = torch.cuda.max_memory_allocated() / 2**30
        loss = float(metrics['loss_total'])
        if not np.isfinite(loss):
            raise RuntimeError(f'{tag} {mode}: loss {loss}')
        stats[mode] = dict(step_ms=step_ms, peak_gib=peak, calls=calls[0],
                           loss_total=loss)
        log(f'[{tag}] {mode}: step ms {[round(t, 3) for t in step_ms]}, '
            f'peak {peak:.3f} GiB, wrapper calls per step '
            f'{ {k: v for k, v in calls[0].items() if v} }; {card}')
    init = [b.detach().clone() for b in model.buffers()]

    def one(mode):
        _set_remat(model, mode)
        with torch.no_grad():
            for b, s in zip(model.buffers(), init):
                b.copy_(s)
        opt.zero_grad(set_to_none=True)
        losses = model(batch, mode='loss')
        sum(losses.values()).backward()
        torch.cuda.synchronize()
        return ({n: p.grad.detach().clone()
                 for n, p in model.named_parameters() if p.grad is not None},
                {n: b.detach().clone() for n, b in model.named_buffers()})

    ref_g, ref_b = one('none')
    again_g, again_b = one('none')
    nondet = sorted(n for n in ref_g if not torch.equal(ref_g[n], again_g[n]))
    nondet += sorted(n for n in ref_b if not torch.equal(ref_b[n],
                                                         again_b[n]))
    del again_g, again_b
    for mode in modes:
        if mode == 'none':
            continue
        g, b = one(mode)
        if set(g) != set(ref_g):
            raise RuntimeError(f'{tag} {mode}: other leaves have gradients')
        differ = [n for n in ref_g if not torch.equal(g[n], ref_g[n])] + \
            [n for n in ref_b if not torch.equal(b[n], ref_b[n])]
        worst = 0.0
        for n in differ:
            a, c = (ref_g[n], g[n]) if n in ref_g else (ref_b[n], b[n])
            worst = max(worst, float((a - c).abs().max()) /
                        max(float(a.abs().max()), 1e-30))
        if differ and not (nondet and worst <= GRAD_GATE):
            raise RuntimeError(f'{tag} {mode}: {len(differ)} leaves differ '
                               f'from none (worst {worst}), the repeated '
                               f'none step in {len(nondet)}: {differ[:5]}')
        stats[mode].update(leaves_differing=len(differ), worst=worst)
        log(f'[{tag}] {mode} against none after one step: '
            + ('every gradient and statistic bit-identical' if not differ
               else f'{len(differ)} of {len(ref_g) + len(ref_b)} leaves '
               f'differ, worst max|d|/max {worst:.2e} (gate {GRAD_GATE}); '
               f'the card\'s none step repeated differs in {len(nondet)}: '
               f'{nondet[:4]}'))
        del g, b
    stats['nondeterministic_leaves'] = nondet
    model.zero_grad(set_to_none=True)
    return stats


def phase_remat(card, device='cuda'):
    """[remat]: the full-width mv_det3d train step at the shipped b = 4
    (four scenes of 20 views of 480x480, 100k points, ``max_boxes`` padded
    gt boxes: [loop]'s batch shapes, built by ``make_batch``) under each of
    'none', '2d', '3d' and 'all' (:func:`remat_modes`), then the cont_occ
    10-sweep step ([cont_occ_train]'s batch) under 'all' (the reference's
    preset) and 'none'."""
    from embodiedscan_torch.configs.base import build_train, cont_occ, \
        mv_det3d
    from embodiedscan_torch.data.synthetic import make_scan
    cfg = mv_det3d()
    d = cfg.data
    t0 = time.perf_counter()
    model, opt = build_train(cfg, device=device, steps_per_epoch=PHASE_EPOCH)
    batch = to_device(make_batch(d.batch_size, d.n_points, d.n_views_train,
                                 d.image_hw[0], d.max_boxes,
                                 cfg.model.num_classes), device)
    log(f'[remat] mv_det3d b={d.batch_size}, {d.n_views_train} views, '
        f'{d.max_boxes} gt boxes; built in {time.perf_counter() - t0:.1f} s')
    stats = {'mv_det3d': remat_modes('remat', model, opt, batch,
                                     REMAT_MODES, card)}
    del model, opt, batch
    torch.cuda.empty_cache()
    cfg = cont_occ()
    d = cfg.data
    t0 = time.perf_counter()
    model, opt = build_train(cfg, device=device, steps_per_epoch=PHASE_EPOCH)
    scan = make_scan(seed=3, n_views=d.n_views_train, hw=tuple(d.image_hw),
                     g=32)
    batch = to_device(occ_sweeps(scan, cfg, d.n_views_train, 0, train=True),
                      device)
    log(f'[remat] cont_occ, {d.n_views_train} sweeps; built in '
        f'{time.perf_counter() - t0:.1f} s')
    stats['cont_occ'] = remat_modes('remat cont_occ', model, opt, batch,
                                    ('all', 'none'), card)
    del model, opt, batch
    torch.cuda.empty_cache()
    return stats


def main_precision():
    """``chip_smoke.py --precision``: the bf16 kernels' edge shapes,
    [sparse_bf16], its replays, the bf16 parity and [remat]; the numbers
    and the kernels line's bf16 rows to chiprun_out/chip_smoke_precision
    .json."""
    from embodiedscan_torch.ops import kernels
    card = card_name()
    kernels.library()
    torch.manual_seed(0)
    took, stats = {}, {}
    t0 = time.perf_counter()
    phase_edges_bf16('cuda')
    took['edges_bf16'] = time.perf_counter() - t0
    t0 = time.perf_counter()
    req_rec, train_rec, totals, stats['sparse_bf16'] = phase_sparse_bf16(card)
    took['sparse_bf16'] = time.perf_counter() - t0
    t0 = time.perf_counter()
    calls = phase_kernels_bf16(req_rec, train_rec, 'cuda')
    took['replays'] = time.perf_counter() - t0
    del req_rec, train_rec
    for name, t in (('bf16_parity', phase_bf16_parity),
                    ('remat', lambda: phase_remat(card))):
        t0 = time.perf_counter()
        stats[name] = t()
        took[name] = time.perf_counter() - t0
    rows = kernel_rows(calls, (('', {k: totals[k] for k in BF16_KERNELS},
                                ('sparse_bf16', 'sparse_bf16_train')), ))
    log('[precision] seconds per part: ' + ', '.join(
        f'{k} {v:.1f}' for k, v in took.items()) + f'; {card}')
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, 'chip_smoke_precision.json'), 'w') as f:
        json.dump(dict(card=card, stats=stats, seconds=took, calls=calls,
                       rows=rows), f, indent=1, default=float)
    return 0


def run_child(flag, *args):
    """Runs ``chip_smoke.py <flag> [args]`` in a process of its own (a fresh
    caching allocator and no earlier profiler session; its output joins
    this one's) and returns what it wrote to
    chiprun_out/chip_smoke_<flag>.json."""
    path = os.path.join(OUT_DIR, f'chip_smoke_{flag.lstrip("-")}.json')
    if os.path.exists(path):
        os.remove(path)
    torch.cuda.empty_cache()
    sys.stdout.flush()
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), flag,
                           *args], timeout=1000)
    if proc.returncode != 0:
        raise RuntimeError(f'chip_smoke.py {flag} exited {proc.returncode}')
    with open(path) as f:
        return json.load(f)


DET_PATHS = ('det', 'grounding', 'train', 'ground_train')
OCC_PATHS = ('occ', 'occ_train')


def main():
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 2
    if sys.argv[1:] == ['--cont']:
        return main_cont()
    if sys.argv[1:] == ['--loop']:
        return main_loop()
    if sys.argv[1:2] == ['--demo']:
        return main_demo(*sys.argv[2:])
    if sys.argv[1:] == ['--heads']:
        return main_heads()
    if sys.argv[1:] == ['--precision']:
        return main_precision()
    if sys.argv[1:2] == ['--ground-gate']:
        return main_ground_gate(*sys.argv[2:])
    t_start = time.perf_counter()
    card = phase_build()
    if sys.argv[1:] == ['--kernels-only']:
        phase_edges('cuda')
        phase_edges_bf16('cuda')
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
    occ_rec, occ_totals, occ_stats, omodel, obatch, occ_served = \
        phase_occ('cuda', card)
    occ_rec.to_host()
    ot_rec, ot_totals, ot_stats, otmodel, otopt, otbatch = \
        phase_occ_train('cuda', card)
    # event timings first, every profiler session after them (see cuda_ms)
    calls = phase_kernels(
        (('det', rec), ('grounding', ground_rec), ('ground_train', gt_rec),
         ('occ', occ_rec), ('occ_train', ot_rec)),
        (('train', train_rec), ('ground_train', gt_rec),
         ('occ_train', ot_rec)), 'cuda')
    with torch.no_grad():
        main_stats.update(profile_run(
            lambda: model(batch, mode='predict'), 'request'))
        ground_stats.update(profile_run(
            lambda: gmodel(gbatch, mode='predict'), 'grounding request'))
        occ_stats.update(profile_run(
            lambda: omodel(obatch, mode='predict'), 'occupancy request'))
    from embodiedscan_torch.train.state import train_step
    train_stats.update(profile_run(lambda: train_step(tmodel, opt, tbatch),
                                   'train step'))
    gt_stats.update(profile_run(lambda: train_step(gtmodel, gtopt, gtbatch),
                                'grounding train step'))
    ot_stats.update(profile_run(lambda: train_step(otmodel, otopt, otbatch),
                                'occupancy train step'))
    occ_unet_share(omodel, obatch, occ_stats, otmodel, otbatch, ot_stats,
                   card)
    del rec, ground_rec, train_rec, gt_rec, model, batch, gmodel, gbatch, \
        tmodel, opt, tbatch, gtmodel, gtopt, gtbatch, occ_rec, ot_rec, \
        omodel, obatch, otmodel, otopt, otbatch
    torch.cuda.empty_cache()
    eval_stats = phase_eval(det_preds, ground_preds, 'cuda')
    occ_eval_stats = phase_occ_eval(occ_served, 'cuda')
    del occ_served
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
                       occ=occ_stats, occ_train=ot_stats,
                       eval=eval_stats, occ_eval=occ_eval_stats,
                       ckpt=ckpt_stats, calls=calls), f, indent=1)
    phase_edges('cuda')
    phase_e2e_parity('cuda')
    phase_ground_parity('cuda')
    phase_converted_parity('cuda', sds['mv_grounding'])
    del sds
    phase_train_parity('cuda')
    phase_ground_train_parity('cuda')
    phase_occ_parity('cuda')
    phase_occ_train_parity('cuda')
    cont = run_child('--cont')
    loop = run_child('--loop')
    run_child('--heads')
    precision = run_child('--precision')
    log(f'[done] {time.perf_counter() - t_start:.1f} s')
    for name, n in ground_totals.items():
        totals[name] += n
    for name, n in train_totals.items():
        if name.startswith(('sparse_dgrad', 'sparse_wgrad')):
            totals[name] = n
    for name, n in gt_totals.items():
        totals[name] += n
    for name, n in ot_totals.items():
        occ_totals[name] += n
    k4 = dict(main_stats['nms']['row'], launches=totals['nms_overlap'])
    rows = kernel_rows(calls, (('', totals, DET_PATHS), )) + [k4] + \
        kernel_rows(calls, ((' (occ)', occ_totals, OCC_PATHS), ))
    print(json.dumps({'kernels': rows + cont['rows'] + loop['rows'] +
                      precision['rows']}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
