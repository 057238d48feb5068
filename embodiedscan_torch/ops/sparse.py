"""Fixed-capacity sparse voxel engine (flat batch mode) and the sparse conv
core (kernel K2).

Port of the flat-mode parts of ``embodiedscan_tpu/ops/sparse.py``. A level is
a batched ``SparseTensor(coords (B, N, 3), feats (B, N, C), mask (B, N))``
with a static capacity N; masked rows are padding. Valid coordinates are
unique and key-sorted within each sample (the engine invariant the merge
join relies on).

:func:`gather_matmul_conv` computes ``sum_k feats[nbr[:, k]] @ W[k]``. On a
CUDA tensor it launches ``csrc/sparse_conv.cu`` by one of two routes that
:func:`conv_plan` picks from the shape: ``tc``, tensor cores in 3xTF32
(each float32 operand split into two TF32 parts, three products summed in
float32, which keeps float32 accuracy), fed by 16-byte ``cp.async`` gathers
and, for shapes with few output tiles, split over the K offsets with a
fixed-order reduction; or ``simt``, float32 FMAs, for rows that are not
16-byte chunks (Cin < 8, as at the stem). On a CPU tensor it runs
:func:`_gather_matmul_conv_plain`.

Training differentiates the conv by three ``torch.autograd.Function`` s, one
per route of ``SparseConv`` (submanifold, strided with its transpose table,
any other table). Their input gradients run through the same kernel K2
(:func:`conv_dgrad`, or ``index_add_`` for the generic route), their weight
gradients through kernel K3 (``csrc/sparse_conv_wgrad.cu``,
:func:`conv_wgrad`).
"""

import functools
from typing import NamedTuple

import numpy as np
import torch

from . import kernels
from .hashing import lookup_merge_b, pack_key32_b, unique_coords_b

# Kernel offset tables. Order is fixed (x-major) and is part of the weight
# layout contract shared with the reference.
OFFSETS_3 = np.array(
    [[dx, dy, dz] for dx in (-1, 0, 1) for dy in (-1, 0, 1)
     for dz in (-1, 0, 1)], dtype=np.int32)  # (27, 3)
OFFSETS_2 = np.array(
    [[dx, dy, dz] for dx in (0, 1) for dy in (0, 1) for dz in (0, 1)],
    dtype=np.int32)  # (8, 3)


class SparseTensor(NamedTuple):
    """One batched sparse level: coords (B, N, 3) int32, feats (B, N, C),
    mask (B, N) bool."""
    coords: torch.Tensor
    feats: torch.Tensor
    mask: torch.Tensor


class DownsampleMap(NamedTuple):
    """Coordinate bookkeeping for a stride-2 reduction (batched).

    Attributes:
        coords: (B, M, 3) coarse coordinates (units of the coarse stride).
        mask: (B, M) coarse validity.
        inverse: (B, N) fine row -> coarse slot (-1 for padding/overflow).
    """
    coords: torch.Tensor
    mask: torch.Tensor
    inverse: torch.Tensor


def _offsets(offsets: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(offsets), device=device)


def from_points_b(points_xyz: torch.Tensor, feats: torch.Tensor,
                  mask: torch.Tensor, voxel_size: float,
                  capacity: int) -> SparseTensor:
    """Voxelize (B, N, 3) points into a stride-1 sparse tensor: coordinates
    are floor(p / voxel_size); duplicate voxels keep the first point's
    features."""
    coords = torch.floor(points_xyz / voxel_size).to(torch.int32)
    uniq = unique_coords_b(coords, mask, capacity)
    c = feats.shape[-1]
    gathered = torch.gather(feats, 1, uniq.rows.long()[..., None].expand(
        -1, -1, c))
    out_feats = torch.where(uniq.mask[..., None], gathered,
                            torch.zeros_like(gathered))
    return SparseTensor(uniq.coords, out_feats, uniq.mask)


def _center_offset(offsets: np.ndarray):
    """Index of the (0,0,0) offset, or None; its table column is identity."""
    center = np.where((np.asarray(offsets) == 0).all(1))[0]
    return int(center[0]) if len(center) == 1 and offsets.shape[0] > 1 \
        else None


def _identity_column(mask: torch.Tensor) -> torch.Tensor:
    n = mask.shape[1]
    ar = torch.arange(n, dtype=torch.int32, device=mask.device)[None]
    return torch.where(mask, ar, torch.full_like(ar, -1))


def neighbor_table_b(st: SparseTensor, offsets: np.ndarray) -> torch.Tensor:
    """(B, N, K) neighbor rows (-1 where absent) via one merge join."""
    b, n = st.coords.shape[:2]
    offsets = np.asarray(offsets)
    c = _center_offset(offsets)
    if c is not None:
        # a valid voxel always contains itself: skip the center queries
        offsets = np.delete(offsets, c, axis=0)
    k = offsets.shape[0]
    queries = (st.coords[:, :, None, :] +
               _offsets(offsets, st.coords.device)[None, None]).reshape(
                   b, n * k, 3)
    qmask = st.mask.repeat_interleave(k, dim=1)
    idx = lookup_merge_b(st.coords, st.mask, queries, qmask).reshape(b, n, k)
    if c is not None:
        idx = torch.cat([idx[..., :c], _identity_column(st.mask)[..., None],
                         idx[..., c:]], dim=-1)
    return idx


def downsample_coords_b(st: SparseTensor, capacity: int) -> DownsampleMap:
    """Coarse coordinates = unique(floor(fine / 2)) (stride-2 striding)."""
    coarse = torch.div(st.coords, 2, rounding_mode='floor')
    uniq = unique_coords_b(coarse, st.mask, capacity)
    return DownsampleMap(uniq.coords, uniq.mask, uniq.inverse)


def _monotone_desc_key(scores: torch.Tensor) -> torch.Tensor:
    """float32 scores -> int64 holding uint32 keys whose ASCENDING order is
    score-descending (IEEE sign-flip trick, then bit inversion)."""
    u = scores.to(torch.float32).view(torch.int32).long() & 0xFFFFFFFF
    asc = torch.where((u >> 31) == 0, u | 0x80000000, (~u) & 0xFFFFFFFF)
    return (~asc) & 0xFFFFFFFF


def topk_rows_b(scores: torch.Tensor, mask: torch.Tensor,
                k: int) -> torch.Tensor:
    """Per-sample top-k row indices over (B, N) scores via one flat sort.

    The key packs the batch id in the high bits and the monotone-mapped
    score, with ceil(log2(B)) low bits truncated, below; ties keep row
    order. Returns (B, k) within-sample rows in score-descending order.
    """
    b, n = scores.shape
    bb = max(0, int(b - 1).bit_length())
    neg = torch.finfo(scores.dtype).min
    masked = torch.where(mask, scores, torch.full_like(scores, neg))
    skey = _monotone_desc_key(masked) >> bb
    if bb:
        skey = skey | (torch.arange(b, dtype=torch.int64,
                                    device=scores.device)[:, None] << (32 - bb))
    skey = (skey - (1 << 31)).to(torch.int32)
    _, sidx = torch.sort(skey.reshape(-1), stable=True)
    rows = sidx.reshape(b, n)[:, :k] - (
        torch.arange(b, device=scores.device) * n)[:, None]
    return rows.to(torch.int32)


def _take_rows(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """take_along_axis over dim 1 for (B, N) or (B, N, C) arrays."""
    idx = idx.long()
    if a.dim() == 2:
        return torch.gather(a, 1, idx)
    return torch.gather(a, 1, idx[..., None].expand(-1, -1, a.shape[-1]))


def topk_select_b(st: SparseTensor, scores: torch.Tensor,
                  k: int) -> SparseTensor:
    """Keep each sample's top-k voxels by score, re-sorted by coordinate key
    (the engine invariant)."""
    b = scores.shape[0]
    sel = topk_rows_b(scores, st.mask, k)
    sel_coords = _take_rows(st.coords, sel)
    keep_mask = _take_rows(st.mask, sel)
    ck = pack_key32_b(sel_coords, keep_mask)
    _, perm = torch.sort(ck.reshape(-1), stable=True)
    perm = perm.reshape(b, k) - (torch.arange(b, device=perm.device) * k)[:, None]
    sel = torch.gather(sel, 1, perm)
    keep_mask = _take_rows(st.mask, sel)
    coords = _take_rows(st.coords, sel)
    feats = _take_rows(st.feats, sel)
    return SparseTensor(coords, torch.where(keep_mask[..., None], feats,
                                            torch.zeros_like(feats)),
                        keep_mask)


def _gather_matmul_conv_plain(feats, mask, nbr, weights, bias=None):
    n, cin = feats.shape
    cout = weights.shape[-1]
    safe = torch.where(mask[:, None], feats, torch.zeros_like(feats))
    padded = torch.cat([safe, safe.new_zeros(1, cin)])
    # any index outside [0, n) reads the zero row, as K2 and the reference
    idx = torch.where((nbr >= 0) & (nbr < n), nbr,
                      torch.full_like(nbr, n)).long()
    out = feats.new_zeros(nbr.shape[0], cout, dtype=torch.float32)
    for j in range(weights.shape[0]):
        out = out + padded[idx[:, j]] @ weights[j]
    if bias is not None:
        out = out + bias
    return out


# H100 SXM: streaming multiprocessors; a grid of fewer 64 x 64 output tiles
# than two waves of them is split over the K offsets
NUM_SMS = 132
SPLIT_BELOW_TILES = 2 * NUM_SMS
OFFSETS_PER_SPLIT = 3            # offsets per group of a split call
TC_BM = 64                       # rows of a block tile
TC_MAX_OFFSETS = 27              # offsets one tensor-core block can take
WIDE_MIN_ROW_TILES = 64          # a split call takes 128-wide tiles from here
WIDE_MAX_REDUCTION = 256 * 256   # an unsplit one below this Cin x Cout


class ConvPlan(NamedTuple):
    """How ``gather_matmul_conv`` runs one shape on the card.

    Attributes:
        route: ``'tc'`` (tensor cores, 3xTF32) or ``'simt'`` (FP32 FMAs).
        bm, bn: the block's output tile (rows x columns).
        splits: the number of K-offset groups computed by separate blocks
            (1 = no split; else partial sums plus a reduction).
        per_split: offsets per group (the last one may hold fewer).
    """
    route: str
    bm: int
    bn: int
    splits: int
    per_split: int


def conv_plan(m: int, k: int, cin: int, cout: int) -> ConvPlan:
    """The route, tile and split for an (M, K, Cin, Cout) call.

    Chosen by shape only, never by a failed launch. The tensor-core route
    stages rows as 16-byte chunks, so it takes Cin >= 8 with Cin and Cout
    multiples of 4 and K <= 27; other shapes (the stem's Cin = 3) take the
    SIMT route.

    With at least two waves of 64 x 64 tiles the call is not split; its
    tiles are 64 x 128 (each gathered row feeds twice the columns) when
    that still gives two waves and Cin x Cout is below 256 x 256, else
    64 x 64: on long reductions the few tiles dense with neighbors set
    the time, and narrower tiles spread them over more blocks. Below two
    waves (the coarse levels, where most tiles have no valid row and the
    few busy ones would each loop over all K offsets) the K offsets are
    split into groups of ``OFFSETS_PER_SPLIT``; the tiles are 64 x 128
    when Cout >= 128 and there are at least ``WIDE_MIN_ROW_TILES`` row
    tiles, else 64 x 64. The split workspace is then at most
    9 x 264 x 64 x 64 floats (37 MiB). The thresholds are the ones the
    main path's calls favoured on an H100 (``kernel_ab.py --plans``).
    """
    if cin < 8 or cin % 4 or cout % 4 or k > TC_MAX_OFFSETS:
        return ConvPlan('simt', 64, 64, 1, k)
    tiles_m = -(-m // TC_BM)
    if tiles_m * -(-cout // 64) >= SPLIT_BELOW_TILES:
        wide = cout >= 128 and cin * cout < WIDE_MAX_REDUCTION and \
            tiles_m * -(-cout // 128) >= SPLIT_BELOW_TILES
        return ConvPlan('tc', TC_BM, 128 if wide else 64, 1, k)
    bn = 128 if cout >= 128 and tiles_m >= WIDE_MIN_ROW_TILES else 64
    per = min(k, OFFSETS_PER_SPLIT)
    return ConvPlan('tc', TC_BM, bn, -(-k // per), per)


def _aligned16(t: torch.Tensor) -> bool:
    return t.data_ptr() % 16 == 0


def cuda_plan(feats, nbr, weights) -> ConvPlan:
    """:func:`conv_plan` for these tensors: a tensor-core plan becomes the
    SIMT one where feats or weights does not start at a 16-byte aligned
    address (a view), since the tensor-core route reads 16-byte chunks."""
    (m, k), cin, cout = nbr.shape, feats.shape[1], weights.shape[-1]
    plan = conv_plan(m, k, cin, cout)
    if plan.route == 'tc' and not (_aligned16(feats) and
                                   _aligned16(weights)):
        plan = ConvPlan('simt', 64, 64, 1, k)
    return plan


def _gather_matmul_conv_cuda(feats, mask, nbr, weights, bias, plan=None):
    n, cin = feats.shape
    m, k = nbr.shape
    cout = weights.shape[-1]
    if plan is None:
        plan = cuda_plan(feats, nbr, weights)
    out = torch.empty((m, cout), dtype=torch.float32, device=feats.device)
    lib = kernels.library()
    common = (feats.data_ptr(), mask.data_ptr(), n, cin, nbr.data_ptr(), m, k,
              weights.data_ptr(), cout,
              None if bias is None else bias.data_ptr(), out.data_ptr())
    stream = kernels.stream_handle(feats.device)
    if plan.route == 'tc':
        ws = None
        if plan.splits > 1:
            ws = torch.empty((plan.splits, m, cout), dtype=torch.float32,
                             device=feats.device)
        err = lib.es_sparse_conv_tc(
            *common, plan.bn, plan.per_split, plan.splits,
            None if ws is None else ws.data_ptr(), stream)
        kernels.check(err, 'es_sparse_conv_tc')
    else:
        err = lib.es_sparse_conv_simt(*common, stream)
        kernels.check(err, 'es_sparse_conv_simt')
    return out


def _check_device(name, tensors):
    """The device the inputs share: raises on mixed devices, on CUDA inputs
    that are not contiguous and on a device that is neither CPU nor CUDA."""
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError(f'{name}: inputs on different devices')
    if dev.type == 'cuda':
        if not all(t.is_contiguous() for t in tensors):
            raise ValueError(f'{name}: the kernel takes contiguous inputs')
    elif dev.type != 'cpu':
        raise ValueError(f'{name}: unsupported device {dev}')
    return dev


def _k2(feats, mask, nbr, weights, bias, launches, name):
    """Checks K2's inputs, then launches it on a CUDA tensor (counting the
    launch by route in ``launches``) or runs its plain version on a CPU
    tensor."""
    if feats.dim() != 2 or mask.shape != feats.shape[:1] or nbr.dim() != 2 \
            or weights.dim() != 3 or weights.shape[:2] != (nbr.shape[1],
                                                           feats.shape[1]):
        raise ValueError(
            f'{name}: shapes feats (N, Cin), mask (N,), nbr (M, K), '
            f'weights (K, Cin, Cout); got {tuple(feats.shape)}, '
            f'{tuple(mask.shape)}, {tuple(nbr.shape)}, {tuple(weights.shape)}')
    if bias is not None and bias.shape != weights.shape[2:]:
        raise ValueError(f'{name}: bias {tuple(bias.shape)}')
    if feats.dtype != torch.float32 or weights.dtype != torch.float32 or \
            mask.dtype != torch.bool or nbr.dtype != torch.int32 or \
            (bias is not None and bias.dtype != torch.float32):
        raise TypeError(f'{name} takes float32 feats/weights/bias, bool mask '
                        'and int32 nbr')
    tensors = [feats, mask, nbr, weights] + ([] if bias is None else [bias])
    if _check_device(name, tensors).type == 'cuda':
        plan = cuda_plan(feats, nbr, weights)
        out = _gather_matmul_conv_cuda(feats, mask, nbr, weights, bias, plan)
        launches[plan.route] += 1
        return out
    return _gather_matmul_conv_plain(feats, mask, nbr, weights, bias)


def gather_matmul_conv(feats: torch.Tensor, mask: torch.Tensor,
                       nbr: torch.Tensor, weights: torch.Tensor,
                       bias: torch.Tensor | None = None) -> torch.Tensor:
    """Sparse convolution core: sum_k feats[nbr[:, k]] @ W[k] (+ bias).

    Args:
        feats: (N, Cin) float32 input features; rows with ``mask`` false
            read as zero.
        mask: (N,) bool input validity.
        nbr: (M, K) int32 gather indices into feats (-1, or any index
            outside [0, N), = absent).
        weights: (K, Cin, Cout) float32.
        bias: optional (Cout,) float32.

    Returns:
        (M, Cout) float32 (the caller masks with the output mask).

    On the card the route, tile and split come from :func:`conv_plan`. The
    tensor-core route computes in 3xTF32 (``a_lo*b_hi + a_hi*b_lo +
    a_hi*b_hi`` with TF32 parts ``x_hi = tf32(x)``, ``x_lo = tf32(x -
    x_hi)``, float32 accumulators): float32 accuracy, within 1e-4 x
    max|out| of the plain version, and the same bits on every call (split
    partial sums are added in a fixed order, no float atomics). It reads
    feats and weights in 16-byte chunks; where either does not start at a
    16-byte aligned address the call takes the SIMT route.
    """
    return _k2(feats, mask, nbr, weights, bias, gather_matmul_conv.launches,
               'gather_matmul_conv')


def conv_dgrad(dout: torch.Tensor, out_mask: torch.Tensor,
               table: torch.Tensor, weights_t: torch.Tensor) -> torch.Tensor:
    """A sparse conv's input gradient through K2's contract:
    ``sum_k dout[table[:, k]] @ weights_t[k]``, the rows of ``dout`` whose
    ``out_mask`` is false read as zero. ``table`` is the mirrored table of a
    submanifold conv (its own, with ``weights_t = W.flip(0)^T``) or the
    transpose table of a strided one (``weights_t = W^T``). The same kernel
    and plain version as :func:`gather_matmul_conv`; launches are counted
    apart in ``conv_dgrad.launches``."""
    return _k2(dout, out_mask, table, weights_t, None, conv_dgrad.launches,
               'conv_dgrad')


# kernel launches by route (CUDA path only)
gather_matmul_conv.launches = {'tc': 0, 'simt': 0}
conv_dgrad.launches = {'tc': 0, 'simt': 0}


# --- K3: the weight gradient ------------------------------------------------

WG_STEP = 32                 # pairs per step of a tensor-core block
WG_MIN_CHUNK = 256           # least pairs of a chunk
WG_WAVES = 6                 # waves of blocks a split call aims for
WG_STAGES = 3                # slots of staged rows of a tensor-core block
WG_MAX_WS_BYTES = 2**27      # the chunk partials' workspace, at most
SMEM_PER_SM = 233472         # bytes of shared memory an SM gives its blocks
SMEM_PER_BLOCK = 1024        # of which each resident block costs the runtime
WN_WIDE, WN_NARROW = 64, 4   # the narrow route's tile of G
WN_BLOCKS_PER_SM = 8         # narrow blocks (256 threads) resident on an SM


class WgradPlan(NamedTuple):
    """How ``conv_wgrad`` runs one shape on the card.

    Attributes:
        route: ``'tc'`` (tensor cores, 3xTF32) or ``'narrow'`` (FP32 FMAs).
        bm, bn: the block's tile of G (x channels x y channels); on the
            narrow route (64, 4) when y is the narrow side, (4, 64) when x
            is.
        chunks: pair chunks per offset (1 = no workspace; else partial sums
            plus a fixed-order reduction).
    """
    route: str
    bm: int
    bn: int
    chunks: int


def wgrad_smem(bm: int, bn: int) -> int:
    """Dynamic shared memory of a tensor-core block with a bm x bn tile of
    G: 1 KB of alignment slack, two buffers of the TF32 hi and lo parts of
    both operands (32 pairs each) and three slots of staged fp32 rows."""
    return 1024 + 4 * (2 * 2 + WG_STAGES) * (bm + bn) * WG_STEP


@functools.lru_cache(maxsize=1024)
def wgrad_plan(r: int, k: int, cx: int, cy: int) -> WgradPlan:
    """The route, tile and pair chunks of an (R, K, Cx, Cy) weight-gradient
    call.

    Chosen by shape only, never by a failed launch. The tensor-core route
    stages rows as 16-byte chunks, so it takes Cx, Cy >= 8 and multiples of
    4; its tile of G is 128 on a side of at least 128 channels, else 64.
    Other shapes (the stem's Cy = 3) take the narrow route, whose tile is
    64 channels of the wider side by 4 of the narrower.

    The pairs of each offset are cut into ``chunks`` only when the tiles
    of G (x K) fill fewer than two waves of the blocks the card keeps
    resident; then into as many as it takes for ``WG_WAVES`` waves, but no
    more than R / ``WG_MIN_CHUNK`` (fuller chunks than an offset can have)
    and no more than ``WG_MAX_WS_BYTES`` of partials allow. The device
    then gives each chunk of offset k an equal share of its n_k pairs
    (:func:`wgrad_chunk_bounds`). The thresholds are the ones the main
    path's calls favoured on an H100 (``kernel_ab.py --train --plans``).
    """
    if min(cx, cy) < 8 or cx % 4 or cy % 4:
        return _narrow_plan(r, k, cx, cy)
    bm, bn = (128 if cx >= 128 else 64), (128 if cy >= 128 else 64)
    per_sm = max(1, SMEM_PER_SM // (wgrad_smem(bm, bn) + SMEM_PER_BLOCK))
    return WgradPlan('tc', bm, bn, _wgrad_chunks(r, k, cx, cy, bm, bn,
                                                 NUM_SMS * per_sm))


def _narrow_plan(r, k, cx, cy) -> WgradPlan:
    bm, bn = (WN_WIDE, WN_NARROW) if cy <= cx else (WN_NARROW, WN_WIDE)
    return WgradPlan('narrow', bm, bn, _wgrad_chunks(
        r, k, cx, cy, bm, bn, NUM_SMS * WN_BLOCKS_PER_SM))


def _wgrad_chunks(r, k, cx, cy, bm, bn, slots):
    tiles = k * -(-cx // bm) * -(-cy // bn)
    if tiles >= 2 * slots:
        return 1
    chunks = -(-WG_WAVES * slots // tiles)
    return max(1, min(chunks, -(-r // WG_MIN_CHUNK),
                      WG_MAX_WS_BYTES // (4 * k * cx * cy), 65535))


def wgrad_chunk_pairs(n: int, chunks: int) -> int:
    """c_k: the pairs of each chunk of an offset with n pairs, n / chunks
    rounded up to a multiple of 32 and at least ``WG_MIN_CHUNK``."""
    per = -(-n // chunks)
    return max(-(-per // WG_STEP) * WG_STEP, WG_MIN_CHUNK)


def wgrad_chunk_bounds(n: int, chunks: int) -> list:
    """The pair ranges [p0, p1) of the chunks z = 0, 1, ... of an offset
    with n pairs that hold pairs (one empty range when n = 0); the blocks of
    later chunks exit. With one range the block writes G itself; else the
    partials are added in this order."""
    c = wgrad_chunk_pairs(n, chunks)
    filled = 1 if n == 0 else -(-n // c)
    return [(min(n, z * c), min(n, (z + 1) * c)) for z in range(filled)]


def cuda_wgrad_plan(x, idx, y) -> WgradPlan:
    """:func:`wgrad_plan` for these tensors: the narrow route where x or y
    does not start at a 16-byte aligned address."""
    r, k = idx.shape
    cx, cy = x.shape[1], y.shape[1]
    plan = wgrad_plan(r, k, cx, cy)
    if plan.route == 'tc' and not (_aligned16(x) and _aligned16(y)):
        plan = _narrow_plan(r, k, cx, cy)
    return plan


def _conv_wgrad_plain(x, x_mask, idx, y, y_mask):
    ny, cy = y.shape
    safe_x = torch.where(x_mask[:, None], x, torch.zeros_like(x))
    safe_y = torch.where(y_mask[:, None], y, torch.zeros_like(y))
    padded = torch.cat([safe_y, safe_y.new_zeros(1, cy)])
    gidx = torch.where((idx >= 0) & (idx < ny), idx,
                       torch.full_like(idx, ny)).long()
    return torch.stack([safe_x.T @ padded[gidx[:, j]]
                        for j in range(idx.shape[1])])


def _wgrad_pairs_plain(x_mask, idx, y_mask):
    """K3's pair lists: for each offset k the pairs (r, idx[r, k]) whose x
    row and y row are both valid, in ascending r. Returns pairs (K, R, 2)
    int32, offset k's first counts[k] rows filled and the rest -1, and
    counts (K,) int32."""
    r, k = idx.shape
    ny = y_mask.shape[0]
    hit = (idx >= 0) & (idx < ny) & x_mask[:, None]
    hit &= y_mask[torch.where(hit, idx, torch.zeros_like(idx)).long()]
    counts = hit.sum(0, dtype=torch.int32)
    pairs = torch.full((k, r, 2), -1, dtype=torch.int32, device=idx.device)
    for j in range(k):
        rows = torch.nonzero(hit[:, j]).flatten()
        pairs[j, :rows.numel(), 0] = rows.to(torch.int32)
        pairs[j, :rows.numel(), 1] = idx[rows, j]
    return pairs, counts


def _wgrad_meta_words(r: int, k: int) -> int:
    """int32 words of K3's per-call scratch: the counts, a ticket, and one
    64-bit status word per offset and 256-row block of the pair pass."""
    return ((k + 2) & ~1) + 2 * k * -(-r // 256)


def _wgrad_cuda(x, x_mask, idx, y, y_mask, plan, lists=False):
    """Launches K3 by ``plan``; returns G, and with ``lists`` also the pair
    lists (K, R, 2) and counts (K,) the call computed."""
    r, cx = x.shape
    k = idx.shape[1]
    ny, cy = y.shape
    dev = x.device
    out = torch.empty((k, cx, cy), dtype=torch.float32, device=dev)
    # one 4-byte buffer: the pair lists, the counts and scratch, then the
    # chunk partials (with more than one chunk)
    n_pairs, n_meta = 2 * k * r, _wgrad_meta_words(r, k)
    n_ws = plan.chunks * k * cx * cy if plan.chunks > 1 else 0
    buf = torch.empty(n_pairs + n_meta + n_ws, dtype=torch.int32, device=dev)
    base = buf.data_ptr()
    if out.numel():
        err = kernels.library().es_sparse_wgrad(
            int(plan.route == 'narrow'), x.data_ptr(), x_mask.data_ptr(), r,
            cx, idx.data_ptr(), k, y.data_ptr(), y_mask.data_ptr(), ny, cy,
            plan.bm, plan.bn, plan.chunks, base, base + 4 * n_pairs,
            base + 4 * (n_pairs + n_meta) if n_ws else None, out.data_ptr(),
            kernels.stream_handle(dev))
        kernels.check(err, 'es_sparse_wgrad')
    if not lists:
        return out
    counts = buf[n_pairs:n_pairs + k]
    return out, buf[:n_pairs].view(k, r, 2), \
        counts if out.numel() else counts.zero_()


def _conv_wgrad_cuda(x, x_mask, idx, y, y_mask, plan=None):
    if plan is None:
        plan = cuda_wgrad_plan(x, idx, y)
    return _wgrad_cuda(x, x_mask, idx, y, y_mask, plan)


def conv_wgrad(x: torch.Tensor, x_mask: torch.Tensor, idx: torch.Tensor,
               y: torch.Tensor, y_mask: torch.Tensor) -> torch.Tensor:
    """Kernel K3: ``G[k] = sum_r x[r]^T @ y[idx[r, k]]``, (K, Cx, Cy).

    Args:
        x: (R, Cx) float32; rows with ``x_mask`` false read as zero.
        x_mask: (R,) bool.
        idx: (R, K) int32 rows of y (-1, or any row outside [0, Ny), =
            absent).
        y: (Ny, Cy) float32; rows with ``y_mask`` false read as zero.
        y_mask: (Ny,) bool.

    Returns:
        (K, Cx, Cy) float32. A sparse conv's weight gradient is
        ``G.flip(0)`` with x = feats, y = dout over a submanifold table,
        ``G`` over a strided conv's transpose table, and
        ``G.transpose(1, 2)`` with x = dout, y = feats over any table.

    On the card (``csrc/sparse_conv_wgrad.cu``) a pair pass first lists
    each offset's hit pairs (:func:`_wgrad_pairs_plain` is its plain
    version); the route, tile and pair chunks come from
    :func:`wgrad_plan`. The tensor-core route computes in 3xTF32 (float32
    accuracy, within 1e-4 x max|G| of the plain version) and a call gives
    the same bits every time (chunks are added in a fixed order). On a CPU
    tensor it runs :func:`_conv_wgrad_plain`.
    """
    if x.dim() != 2 or x_mask.shape != x.shape[:1] or idx.dim() != 2 or \
            idx.shape[0] != x.shape[0] or y.dim() != 2 or \
            y_mask.shape != y.shape[:1]:
        raise ValueError(
            'conv_wgrad: shapes x (R, Cx), x_mask (R,), idx (R, K), '
            f'y (Ny, Cy), y_mask (Ny,); got {tuple(x.shape)}, '
            f'{tuple(x_mask.shape)}, {tuple(idx.shape)}, {tuple(y.shape)}, '
            f'{tuple(y_mask.shape)}')
    if x.dtype != torch.float32 or y.dtype != torch.float32 or \
            x_mask.dtype != torch.bool or y_mask.dtype != torch.bool or \
            idx.dtype != torch.int32:
        raise TypeError('conv_wgrad takes float32 x/y, bool masks and int32 '
                        'idx')
    if _check_device('conv_wgrad', [x, x_mask, idx, y, y_mask]).type == \
            'cuda':
        if x.shape[0] >= 2**31 or idx.shape[1] > 65535:
            raise ValueError('conv_wgrad: the kernel takes R < 2^31 and '
                             'K <= 65535')
        plan = cuda_wgrad_plan(x, idx, y)
        out = _conv_wgrad_cuda(x, x_mask, idx, y, y_mask, plan)
        conv_wgrad.launches[plan.route] += 1
        return out
    return _conv_wgrad_plain(x, x_mask, idx, y, y_mask)


conv_wgrad.launches = {'tc': 0, 'narrow': 0}


# --- autograd: the three routes of SparseConv -------------------------------
#
# Ports of the JAX package's custom VJPs (ops/sparse.py:subm_gather_conv,
# strided_gather_conv) and of XLA's autodiff of gather_matmul_conv. Each
# backward runs dfeats through K2 (or index_add_ for the generic route) and
# dW through K3. The serving path calls gather_matmul_conv directly and
# never builds these.


def _masked_rows(t, mask):
    return torch.where(mask[:, None], t, torch.zeros_like(t))


class _SubmConv(torch.autograd.Function):
    """Submanifold conv: ``nbr`` is the level's own mirror-symmetric
    27-table (OFFSETS_3 is point-symmetric: offset K-1-k is -offset k), so
    ``nbr[m, k] = i <=> nbr[i, K-1-k] = m``."""

    @staticmethod
    def forward(ctx, feats, mask, nbr, weights):
        ctx.save_for_backward(feats, mask, nbr, weights)
        return gather_matmul_conv(feats, mask, nbr, weights)

    @staticmethod
    def backward(ctx, dout):
        feats, mask, nbr, weights = ctx.saved_tensors
        dout = dout.contiguous()
        dfeats = dw = None
        if ctx.needs_input_grad[0]:
            wt = weights.flip(0).transpose(1, 2).contiguous()
            dfeats = _masked_rows(conv_dgrad(dout, mask, nbr, wt), mask)
        if ctx.needs_input_grad[3]:
            dw = conv_wgrad(feats, mask, nbr, dout, mask).flip(0)
        return dfeats, None, None, dw


class _StridedConv(torch.autograd.Function):
    """Strided conv with its transpose table: ``t_nbr[j, k] = m <=>
    nbr[m, k] = j`` (``t_nbr`` indexes the coarse output rows)."""

    @staticmethod
    def forward(ctx, feats, mask, nbr, t_nbr, weights, out_mask):
        ctx.save_for_backward(feats, mask, t_nbr, weights, out_mask)
        return gather_matmul_conv(feats, mask, nbr, weights)

    @staticmethod
    def backward(ctx, dout):
        feats, mask, t_nbr, weights, out_mask = ctx.saved_tensors
        dout = dout.contiguous()
        dfeats = dw = None
        if ctx.needs_input_grad[0]:
            wt = weights.transpose(1, 2).contiguous()
            dfeats = _masked_rows(conv_dgrad(dout, out_mask, t_nbr, wt), mask)
        if ctx.needs_input_grad[4]:
            dw = conv_wgrad(feats, mask, t_nbr, dout, out_mask)
        return dfeats, None, None, None, dw, None


class _GenericConv(torch.autograd.Function):
    """Any other table (the stem, the K = 1 downsamples): dfeats by
    ``index_add_``, as XLA's autodiff of the gather does."""

    @staticmethod
    def forward(ctx, feats, mask, nbr, weights, out_mask):
        ctx.save_for_backward(feats, mask, nbr, weights, out_mask)
        return gather_matmul_conv(feats, mask, nbr, weights)

    @staticmethod
    def backward(ctx, dout):
        feats, mask, nbr, weights, out_mask = ctx.saved_tensors
        dout = dout.contiguous()
        dfeats = dw = None
        if ctx.needs_input_grad[0]:
            n = feats.shape[0]
            acc = feats.new_zeros(n + 1, feats.shape[1])
            for j in range(nbr.shape[1]):
                col = nbr[:, j]
                rows = torch.where((col >= 0) & (col < n), col,
                                   torch.full_like(col, n)).long()
                acc.index_add_(0, rows, dout @ weights[j].T)
            dfeats = _masked_rows(acc[:n], mask)
        if ctx.needs_input_grad[3]:
            dw = conv_wgrad(dout, out_mask, nbr, feats, mask).transpose(1, 2)
        return dfeats, None, None, dw, None


def subm_gather_conv(feats, mask, nbr, weights):
    """:func:`gather_matmul_conv` over a submanifold table, differentiable:
    dfeats by K2 over the mirrored table, dW by K3."""
    return _SubmConv.apply(feats, mask, nbr, weights)


def strided_gather_conv(feats, mask, nbr, t_nbr, weights, out_mask):
    """:func:`gather_matmul_conv` of a strided conv, differentiable through
    its transpose table ``t_nbr`` (N, K): dfeats by K2, dW by K3."""
    return _StridedConv.apply(feats, mask, nbr, t_nbr, weights, out_mask)


def generic_gather_conv(feats, mask, nbr, weights, out_mask):
    """:func:`gather_matmul_conv` over any table, differentiable: dfeats by
    ``index_add_`` (skipped when feats needs no gradient), dW by K3."""
    return _GenericConv.apply(feats, mask, nbr, weights, out_mask)


def center_child_index(st: SparseTensor, dmap: DownsampleMap) -> torch.Tensor:
    """(B, M, 1) row of each parent's (0,0,0)-child, via the dedup inverse.

    The input row at exactly ``2*o`` is the one whose coords are all even
    and whose dedup inverse is ``o``; other rows write the spare slot M.
    """
    b, n = st.mask.shape
    m = dmap.coords.shape[1]
    zero_child = st.mask & (torch.remainder(st.coords, 2) == 0).all(-1) & \
        (dmap.inverse >= 0)
    slot = torch.where(zero_child, dmap.inverse.long(),
                       torch.full_like(dmap.inverse, m, dtype=torch.int64))
    nbr = torch.full((b, m + 1), -1, dtype=torch.int32, device=st.mask.device)
    src = torch.arange(n, dtype=torch.int32,
                       device=st.mask.device)[None].expand(b, n)
    nbr.scatter_(1, slot, src)
    return nbr[:, :m, None].contiguous()


def maxpool2(st: SparseTensor, dmap: DownsampleMap) -> SparseTensor:
    """Max pool kernel 2 stride 2: segment-max of children via the inverse."""
    b, n, c = st.feats.shape
    m = dmap.coords.shape[1]
    slot = torch.where((dmap.inverse >= 0) & st.mask, dmap.inverse.long(),
                       torch.full_like(dmap.inverse, m, dtype=torch.int64))
    neg = torch.finfo(st.feats.dtype).min
    src = torch.where(st.mask[..., None], st.feats,
                      torch.full_like(st.feats, neg))
    pooled = torch.full((b, m + 1, c), neg, dtype=st.feats.dtype,
                        device=st.feats.device)
    pooled.scatter_reduce_(1, slot[..., None].expand(b, n, c), src,
                           reduce='amax', include_self=True)
    pooled = pooled[:, :m]
    zero = torch.zeros_like(pooled)
    pooled = torch.where(dmap.mask[..., None], pooled, zero)
    pooled = torch.where(pooled == neg, zero, pooled)
    return SparseTensor(dmap.coords, pooled, dmap.mask)


def generative_transpose2(st: SparseTensor, weights: torch.Tensor,
                          bias: torch.Tensor | None = None) -> SparseTensor:
    """Generative transposed conv kernel 2 stride 2 (batched).

    Every parent emits its 8 children ``2*c + off``; the slot of child
    ``(p, off)`` is ``p * 8 + code(off)``. One plain matrix product
    (N, Cin) x (Cin, 8*Cout) computes all children.

    Returns:
        the children, a SparseTensor of capacity 8N.
    """
    b, n, cin = st.feats.shape
    cout = weights.shape[-1]
    safe = torch.where(st.mask[..., None], st.feats,
                       torch.zeros_like(st.feats))
    big = safe @ weights.permute(1, 0, 2).reshape(cin, 8 * cout)
    child_feats = big.reshape(b, n * 8, cout)
    offs = _offsets(OFFSETS_2, st.coords.device)
    child_coords = (st.coords[:, :, None, :] * 2 + offs[None, None]).reshape(
        b, n * 8, 3)
    child_mask = st.mask.repeat_interleave(8, dim=1)
    if bias is not None:
        child_feats = child_feats + bias
    child_feats = torch.where(child_mask[..., None], child_feats,
                              torch.zeros_like(child_feats))
    return SparseTensor(child_coords, child_feats.to(st.feats.dtype),
                        child_mask)


def scatter_sum_into(dst: SparseTensor, src: SparseTensor,
                     idx: torch.Tensor) -> SparseTensor:
    """Add ``src`` features into the ``dst`` rows ``idx`` (B, L) points at
    (-1 = dropped). Dropped rows go to a spare row that is sliced off, so
    no real row receives a write it should not."""
    b, n, c = dst.feats.shape
    keep = (idx >= 0) & src.mask
    slot = torch.where(idx >= 0, idx.long(), torch.full_like(idx, n,
                                                             dtype=torch.int64))
    add = torch.where(keep[..., None], src.feats, torch.zeros_like(src.feats))
    feats = torch.cat([dst.feats, dst.feats.new_zeros(b, 1, c)], 1)
    aslot = slot + (torch.arange(b, device=slot.device) * (n + 1))[:, None]
    flat = feats.reshape(b * (n + 1), c)
    flat.index_add_(0, aslot.reshape(-1), add.reshape(-1, c).to(flat.dtype))
    return SparseTensor(dst.coords, flat.reshape(b, n + 1, c)[:, :n],
                        dst.mask)
