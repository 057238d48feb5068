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
"""

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
    idx = torch.where(nbr >= 0, nbr, torch.full_like(nbr, n)).long()
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
    gather_matmul_conv.launches[plan.route] += 1
    return out


def gather_matmul_conv(feats: torch.Tensor, mask: torch.Tensor,
                       nbr: torch.Tensor, weights: torch.Tensor,
                       bias: torch.Tensor | None = None) -> torch.Tensor:
    """Sparse convolution core: sum_k feats[nbr[:, k]] @ W[k] (+ bias).

    Args:
        feats: (N, Cin) float32 input features; rows with ``mask`` false
            read as zero.
        mask: (N,) bool input validity.
        nbr: (M, K) int32 gather indices into feats (-1 = absent).
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
    if feats.dim() != 2 or mask.shape != feats.shape[:1] or nbr.dim() != 2 \
            or weights.dim() != 3 or weights.shape[:2] != (nbr.shape[1],
                                                           feats.shape[1]):
        raise ValueError(
            'gather_matmul_conv: shapes feats (N, Cin), mask (N,), nbr (M, K), '
            f'weights (K, Cin, Cout); got {tuple(feats.shape)}, '
            f'{tuple(mask.shape)}, {tuple(nbr.shape)}, {tuple(weights.shape)}')
    if bias is not None and bias.shape != weights.shape[2:]:
        raise ValueError(f'gather_matmul_conv: bias {tuple(bias.shape)}')
    if feats.dtype != torch.float32 or weights.dtype != torch.float32 or \
            mask.dtype != torch.bool or nbr.dtype != torch.int32 or \
            (bias is not None and bias.dtype != torch.float32):
        raise TypeError('gather_matmul_conv takes float32 feats/weights/bias, '
                        'bool mask and int32 nbr')
    tensors = [feats, mask, nbr, weights] + ([] if bias is None else [bias])
    if any(t.device != feats.device for t in tensors):
        raise ValueError('gather_matmul_conv: inputs on different devices')
    if feats.is_cuda:
        if not all(t.is_contiguous() for t in tensors):
            raise ValueError('gather_matmul_conv: the kernel takes contiguous '
                             'inputs')
        return _gather_matmul_conv_cuda(feats, mask, nbr, weights, bias)
    if feats.device.type != 'cpu':
        raise ValueError(f'gather_matmul_conv: unsupported device '
                         f'{feats.device}')
    return _gather_matmul_conv_plain(feats, mask, nbr, weights, bias)


# kernel launches by route (CUDA path only)
gather_matmul_conv.launches = {'tc': 0, 'simt': 0}


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
