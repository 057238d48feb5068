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

:func:`set_conv_compute_dtype` (``torch.bfloat16``) turns on the reference's
bf16 compute route: every conv then follows one of its three rounding
contracts, launching the kernels' bfloat16 variants K2-bf16 and K3-bf16 on
the card (see :func:`set_conv_compute_dtype`). Features in and out stay
float32.
"""

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..utils.trace import span
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

# The sparse convs' compute dtype (the reference's name and switch): None
# computes in float32; torch.bfloat16 rounds each conv's operands to
# bfloat16 and accumulates in float32. Read when a conv runs (an autograd
# conv keeps its forward's choice for its backward).
CONV_COMPUTE_DTYPE = None


def set_conv_compute_dtype(dtype) -> None:
    """Set the sparse convs' compute dtype: None (float32) or
    ``torch.bfloat16``, the reference's ``set_conv_compute_dtype``.

    Under bfloat16 each conv follows the reference's contract for its
    route, cast for cast:

    - forward (every route): the masked features and the weights rounded
      to bfloat16 (features before the gather, which halves its bytes),
      products and sums in float32 (K2-bf16);
    - submanifold and strided backwards (the reference's custom VJPs): the
      output gradient (masked, for a submanifold conv), the features and
      the weights rounded to bfloat16; dfeats through K2-bf16 and dW
      through K3-bf16, summed and stored in float32;
    - generic backward (the reference's autodiff of the forward: the stem,
      the K = 1 downsamples): the output gradient stays float32; each
      offset's ``dout @ W_bf16^T`` is rounded to bfloat16 and the feature
      gradient summed by bfloat16 adds (``index_add_``); dW is the float32
      K3 over the bfloat16-rounded features and the float32 output
      gradient, rounded to bfloat16.

    The dtype is a module global, as in the reference: set it before the
    model runs, and restore it when done.
    """
    if dtype not in (None, torch.bfloat16):
        raise ValueError(f'conv compute dtype {dtype}: None or '
                         'torch.bfloat16')
    global CONV_COMPUTE_DTYPE
    CONV_COMPUTE_DTYPE = dtype


def _bf16_route() -> bool:
    return CONV_COMPUTE_DTYPE is not None


def _bf16(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bfloat16 (nearest even), as float32."""
    return t.to(torch.bfloat16).to(torch.float32)


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
    are floor(p * r) with r = 1 / voxel_size rounded to float32, as XLA
    computes the reference's ``floor(p / voxel_size)`` under ``jit`` (a
    division by a constant becomes a product with its reciprocal; a point
    within an ulp of a voxel face can land in the other voxel than a true
    division puts it in). Duplicate voxels keep the first point's
    features."""
    recip = float(np.float32(1.0) / np.float32(voxel_size))
    coords = torch.floor(points_xyz * recip).to(torch.int32)
    uniq = unique_coords_b(coords, mask, capacity)
    c = feats.shape[-1]
    gathered = torch.gather(feats, 1, uniq.rows.long()[..., None].expand(
        -1, -1, c))
    out_feats = torch.where(uniq.mask[..., None], gathered,
                            torch.zeros_like(gathered))
    return SparseTensor(uniq.coords, out_feats, uniq.mask)


def from_points_per_sample(points_xyz: torch.Tensor, feats: torch.Tensor,
                           mask: torch.Tensor, voxel_size: float,
                           capacity: int) -> SparseTensor:
    """:func:`from_points_b` one sample at a time, each with the B = 1 key
    layout (11/11/10 coordinate bits), as the reference's
    ``jax.vmap(from_points)``: the flat call would shave bits off the
    coordinates (``hashing.key_layout``) and drop what lies beyond them."""
    levels = [from_points_b(points_xyz[i:i + 1], feats[i:i + 1],
                            mask[i:i + 1], voxel_size, capacity)
              for i in range(points_xyz.shape[0])]
    return SparseTensor(*(torch.cat(t) for t in zip(*levels)))


def to_dense_b(st: SparseTensor, origin: torch.Tensor,
               grid_shape) -> torch.Tensor:
    """Scatter a batched sparse tensor into dense (B, X, Y, Z, C) volumes
    (ME ``.dense()``); ``origin`` (3,) is the lattice coordinate of voxel
    (0, 0, 0). Rows out of the grid or masked are dropped; valid
    coordinates are unique, so each cell takes at most one row."""
    gx, gy, gz = grid_shape
    b, n, c = st.feats.shape
    cells = gx * gy * gz
    rel = (st.coords - origin).long()
    inb = st.mask & (rel >= 0).all(-1) & (rel[..., 0] < gx) & \
        (rel[..., 1] < gy) & (rel[..., 2] < gz)
    flat = (rel[..., 0] * gy + rel[..., 1]) * gz + rel[..., 2] + \
        torch.arange(b, device=rel.device)[:, None] * cells
    # dropped rows land on one spare cell past the volumes
    flat = torch.where(inb, flat, torch.full_like(flat, b * cells))
    vol = st.feats.new_zeros(b * cells + 1, c).index_put(
        (flat.reshape(-1), ), st.feats.reshape(b * n, c))
    return vol[:-1].reshape(b, gx, gy, gz, c)


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


def _gather_matmul_conv_bf16_plain(feats, mask, nbr, weights, bias=None):
    """K2-bf16's plain version: feats and weights rounded to bfloat16, then
    the float32 plain version (a product of two bfloat16 values is exact in
    float32, so this is the contract itself)."""
    return _gather_matmul_conv_plain(_bf16(feats), mask, nbr, _bf16(weights),
                                     bias)


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


def conv_plan(m: int, k: int, cin: int, cout: int, bf16: bool = False
              ) -> ConvPlan:
    """The route, tile and split for an (M, K, Cin, Cout) call (of
    K2-bf16 with ``bf16``: :func:`_bf16_conv_plan`).

    Chosen by shape only, never by a failed launch. The tensor-core route
    stages rows as 16-byte chunks of 4 float32 channels, so it takes Cin
    >= 8 with Cin and Cout multiples of 4 and K <= 27; other shapes (the
    stem's Cin = 3) take the SIMT route.

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
    if bf16:
        return _bf16_conv_plan(m, k, cin, cout)
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


# K2-bf16's tensor-core tiles (rows x columns) and the blocks of each that
# an SM keeps resident (shared memory: 4 ring slots of (rows + columns) x
# 128 bytes and the rows' table, csrc/sparse_conv.cu:KbTile)
BF16_TILES = {(256, 128): 1, (128, 256): 1, (128, 128): 1, (64, 128): 2,
              (64, 64): 3}
BF16_UNSPLIT_WAVES = 0.75        # waves of blocks an unsplit tile needs
BF16_SPLIT_WAVES = 3             # waves a split call fills
BF16_MAX_SPLITS = 9              # offset groups of a split call, at most
BF16_LONG_REDUCTION = 2**17      # Cin x Cout from which a full card splits
BF16_LONG_SPLITS = 3             # into this many offset groups
BF16_MAX_WS_BYTES = 2**27        # the split partials' workspace, at most


def _bf16_conv_plan(m: int, k: int, cin: int, cout: int) -> ConvPlan:
    """K2-bf16's route, tile and split for an (M, K, Cin, Cout) call.

    Its tensor-core route (``wgmma``) lands rows and weights as 16-byte
    chunks of 8 bfloat16 channels: it takes Cin and Cout multiples of 8
    (Cin >= 8) and K <= 27; a step is 64 channels, the tail past Cin
    zero-filled. Other shapes (the stem's Cin = 3) take the SIMT route.

    - A long reduction (Cin x Cout >= ``BF16_LONG_REDUCTION``, Cout > 64)
      whose 256 x 128 tiles fill ``BF16_UNSPLIT_WAVES`` waves of the card
      is split into ``BF16_LONG_SPLITS`` offset groups on those tiles: on
      the sparse levels the valid rows gather in few tiles, and a split
      spreads each busy tile over more blocks (a block with no offset to
      compute writes no partial).
    - Else the first tile that fills ``BF16_UNSPLIT_WAVES`` waves of
      resident blocks, in the order 128 x 256 (Cout >= 256: each gathered
      row feeds every column) or 256 x 128 (Cout 72-128: each slice of W
      feeds 256 rows), then 128 x 128, 64 x 128, 64 x 64 (Cout <= 64:
      only this one).
    - Below that, 64 x 64 tiles with the K offsets split into as few
      groups (at most ``BF16_MAX_SPLITS``) as fill ``BF16_SPLIT_WAVES``
      waves.

    Splits are fewer where the partials' workspace would pass
    ``BF16_MAX_WS_BYTES``; the last block of each output tile adds the
    groups' partials in order. The thresholds are the ones the main
    path's and the continuous paths' calls favoured on an H100
    (``kernel_ab.py --bf16 --plans --cont``).
    """
    if cin < 8 or cin % 8 or cout % 8 or k > TC_MAX_OFFSETS:
        return ConvPlan('simt', 64, 64, 1, k)

    def waves(tile, splits=1):
        blocks = -(-m // tile[0]) * -(-cout // tile[1]) * splits
        return blocks / (NUM_SMS * BF16_TILES[tile])

    def split(tile, groups):
        per = -(-k // groups)
        return ConvPlan('tc', *tile, -(-k // per), per)

    groups = min(k, BF16_MAX_SPLITS,
                 max(1, BF16_MAX_WS_BYTES // max(1, 4 * m * cout)))
    if cin * cout >= BF16_LONG_REDUCTION and cout > 64 and groups > 1 and \
            waves((256, 128)) >= BF16_UNSPLIT_WAVES:
        return split((256, 128), min(groups, BF16_LONG_SPLITS))
    if cout >= 256:
        order = ((128, 256), (128, 128), (64, 128), (64, 64))
    elif cout > 64:
        order = ((256, 128), (128, 128), (64, 128), (64, 64))
    else:
        order = ((64, 64), )
    for tile in order:
        if waves(tile) >= BF16_UNSPLIT_WAVES:
            return ConvPlan('tc', *tile, 1, k)
    return split((64, 64), next((s for s in range(1, groups + 1) if waves(
        (64, 64), s) >= BF16_SPLIT_WAVES), groups))


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


def _launch_k2(feats, mask, nbr, weights, bias, plan, suffix=''):
    """K2 by ``plan`` over float32 feats and weights, or K2-bf16's SIMT
    route (the ``_bf16`` entry point, ``suffix``) over bfloat16 ones."""
    n, cin = feats.shape
    m, k = nbr.shape
    cout = weights.shape[-1]
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
        name = 'es_sparse_conv_tc' + suffix
        err = getattr(lib, name)(
            *common, plan.bn, plan.per_split, plan.splits,
            None if ws is None else ws.data_ptr(), stream)
    else:
        name = 'es_sparse_conv_simt' + suffix
        err = getattr(lib, name)(*common, stream)
    kernels.check(err, name)
    return out


def _gather_matmul_conv_cuda(feats, mask, nbr, weights, bias, plan=None):
    return _launch_k2(feats, mask, nbr, weights, bias,
                      plan or cuda_plan(feats, nbr, weights))


# bumped by drop_bf16_weights(): a copy kept at an older value is stale
_BF16_EPOCH = [0]


def drop_bf16_weights() -> None:
    """Makes every copy that :func:`bf16_weights` kept stale: the next call
    for any tensor casts anew. For writes that bump no version counter:
    through ``.data`` (an alias with a counter of its own), or into the
    tensor's memory by a collective or an extension. The port calls it
    after each of its own such writes (``parallel.mesh.replicate``, the
    checkpoint and weight loaders); code that writes weights through
    ``.data`` calls it too."""
    _BF16_EPOCH[0] += 1


def bf16_weights(weights: torch.Tensor) -> torch.Tensor:
    """``weights`` in bfloat16, cast at most once per version of
    ``weights``: the copy is kept on the tensor with the version counter,
    address, shape, strides and :func:`drop_bf16_weights` count it was
    made from, and made anew when any of them changed. Every in-place
    update through the tensor or a view of it (the optimizer's, ``copy_``,
    ``load_state_dict``) bumps ``weights._version``; a write that does
    not (through ``.data``, a collective) is followed by
    :func:`drop_bf16_weights`. A tensor that keeps no version counter
    (made under ``torch.inference_mode``) is cast on every call. A served
    model then casts its weights once, and a train step once per conv,
    its forward and input gradient sharing the copy."""
    if weights.dtype == torch.bfloat16:
        return weights.contiguous()
    if torch.is_inference(weights):
        return weights.to(torch.bfloat16).contiguous()
    key = (weights._version, _BF16_EPOCH[0], weights.data_ptr(),
           weights.device, tuple(weights.shape), weights.stride())
    kept = getattr(weights, '_bf16_copy', None)
    if kept is not None and kept[0] == key:
        return kept[1]
    copy = weights.detach().to(torch.bfloat16).contiguous()
    weights._bf16_copy = (key, copy)
    return copy


def _as_bf16(t: torch.Tensor) -> torch.Tensor:
    """``t`` in bfloat16: a bfloat16 ``t`` as it is (the backward's copies),
    else its cast (a new, aligned tensor)."""
    return t if t.dtype == torch.bfloat16 else t.to(torch.bfloat16)


# K2-bf16's words of split calls, by (device, stream), two an output tile
# (its arrivals, and the splits that wrote a partial): zeroed once, and
# left at zero by every call (the last block of each tile resets them)
_ARRIVALS = {}


def _arrivals(device, stream: int, n: int) -> torch.Tensor:
    key = (device, stream)
    buf = _ARRIVALS.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 4096), dtype=torch.int32, device=device)
        _ARRIVALS[key] = buf
    return buf


# K2-bf16's modes (csrc/sparse_conv.cu:KbMode): the forward, and the input
# gradient from the forward's own weights over a submanifold conv's table
# (W[K-1-k]^T) or a strided conv's transpose table (W[k]^T)
KB_FORWARD, KB_MIRROR, KB_TRANSPOSE = 0, 1, 2


def _launch_k2_bf16(feats16, mask, nbr, w16, bias, plan, mode):
    """K2-bf16's tensor-core route (``wgmma``) by ``plan`` over bfloat16
    feats and weights (``mode``: KB_FORWARD with w16 (K, Cin, Cout), else
    the input gradient with the forward's w16 (K, Cout, Cin), read
    transposed); one CUDA launch, the split reduction folded in."""
    n, cin = feats16.shape
    m, k = nbr.shape
    cout = w16.shape[2] if mode == KB_FORWARD else w16.shape[1]
    dev = feats16.device
    out = torch.empty((m, cout), dtype=torch.float32, device=dev)
    stream = kernels.stream_handle(dev)
    ws = arrivals = None
    if plan.splits > 1:
        ws = torch.empty((plan.splits, m, cout), dtype=torch.float32,
                         device=dev)
        arrivals = _arrivals(dev, stream, 2 * -(-m // plan.bm) *
                             -(-cout // plan.bn))
    err = kernels.library().es_sparse_conv_wgmma_bf16(
        feats16.data_ptr(), mask.data_ptr(), n, cin, nbr.data_ptr(), m, k,
        w16.data_ptr(), cout, mode,
        None if bias is None else bias.data_ptr(), out.data_ptr(), plan.bm,
        plan.bn, plan.per_split, plan.splits,
        None if ws is None else ws.data_ptr(),
        None if arrivals is None else arrivals.data_ptr(), stream)
    kernels.check(err, 'es_sparse_conv_wgmma_bf16')
    return out


def bf16_plan(nbr, feats, weights) -> ConvPlan:
    """K2-bf16's plan for these inputs (``conv_plan(..., bf16=True)``; the cast
    copies are aligned)."""
    (m, k), cin, cout = nbr.shape, feats.shape[1], weights.shape[-1]
    return conv_plan(m, k, cin, cout, bf16=True)


def _gather_matmul_conv_bf16_cuda(feats, mask, nbr, weights, bias,
                                  plan=None):
    """K2-bf16: feats cast to bfloat16 (a masked row is read as zero by the
    kernel, whatever its bits), the weights' cached bfloat16 copy
    (:func:`bf16_weights`), then the kernel by ``plan``."""
    plan = plan or bf16_plan(nbr, feats, weights)
    feats16, w16 = _as_bf16(feats), bf16_weights(weights)
    if plan.route == 'simt':
        return _launch_k2(feats16, mask, nbr, w16, bias, plan, '_bf16')
    return _launch_k2_bf16(feats16, mask, nbr, w16, bias, plan, KB_FORWARD)


def _dgrad_weights_t(weights, mirror):
    """The input gradient's (K, Cout, Cin) weights from the forward's:
    W[K-1-k]^T (``mirror``) or W[k]^T."""
    return (weights.flip(0) if mirror else weights).transpose(1, 2) \
        .contiguous()


def _conv_dgrad_bf16_plain(dout, out_mask, table, weights, mirror):
    """The plain version of K2-bf16's input gradient from the forward's
    own weights: :func:`_gather_matmul_conv_bf16_plain` over
    :func:`_dgrad_weights_t` (the same bits for a float32 ``dout`` and for
    its bfloat16 copy)."""
    return _gather_matmul_conv_bf16_plain(
        dout, out_mask, table, _dgrad_weights_t(weights, mirror))


def _conv_dgrad_bf16_cuda(dout, out_mask, table, weights, mirror,
                          plan=None):
    """K2-bf16's input gradient on the card: dout in bfloat16 (cast if it
    is float32), the forward's cached bfloat16 weights read transposed by
    the kernel (no transposed copy); a plan on the SIMT route (dout with
    fewer than 8 channels) takes the transposed copy."""
    k, cin, cout = weights.shape
    plan = plan or conv_plan(table.shape[0], k, cout, cin, bf16=True)
    dout16, w16 = _as_bf16(dout), bf16_weights(weights)
    if plan.route == 'simt':
        return _launch_k2(dout16, out_mask, table,
                          _dgrad_weights_t(w16, mirror), None, plan, '_bf16')
    return _launch_k2_bf16(dout16, out_mask, table, w16, None, plan,
                           KB_MIRROR if mirror else KB_TRANSPOSE)


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


def _k2(feats, mask, nbr, weights, bias, launches, name, bf16, mirror=None):
    """Checks K2's inputs, then launches it (K2-bf16 with ``bf16``) on a
    CUDA tensor, counting the launch by route in ``launches`` (``<route>``
    or ``<route>_bf16``), or runs its plain version on a CPU tensor.
    ``mirror`` (the input gradient from the forward's own weights, (K,
    Cout, Cin)): None for weights (K, Cin, Cout) as given; else read as
    W[K-1-k]^T (True) or W[k]^T (False)."""
    cin_at = 1 if mirror is None else 2
    if feats.dim() != 2 or mask.shape != feats.shape[:1] or nbr.dim() != 2 \
            or weights.dim() != 3 or weights.shape[0] != nbr.shape[1] or \
            weights.shape[cin_at] != feats.shape[1]:
        raise ValueError(
            f'{name}: shapes feats (N, Cin), mask (N,), nbr (M, K), '
            f'weights (K, Cin, Cout) (the forward\'s (K, Cout, Cin) with '
            f'mirror); got {tuple(feats.shape)}, {tuple(mask.shape)}, '
            f'{tuple(nbr.shape)}, {tuple(weights.shape)}')
    if bias is not None and (mirror is not None or
                             bias.shape != weights.shape[2:]):
        raise ValueError(f'{name}: bias {tuple(bias.shape)}')
    feats_types = (torch.float32, torch.bfloat16) if bf16 else \
        (torch.float32, )
    if feats.dtype not in feats_types or weights.dtype != torch.float32 or \
            mask.dtype != torch.bool or nbr.dtype != torch.int32 or \
            (bias is not None and bias.dtype != torch.float32):
        raise TypeError(f'{name} takes float32 feats (or bfloat16 ones on '
                        'the bf16 route), float32 weights and bias, bool '
                        'mask and int32 nbr')
    tensors = [feats, mask, nbr, weights] + ([] if bias is None else [bias])
    cuda = _check_device(name, tensors).type == 'cuda'
    if bf16:
        if not cuda:
            if mirror is None:
                return _gather_matmul_conv_bf16_plain(feats, mask, nbr,
                                                      weights, bias)
            return _conv_dgrad_bf16_plain(feats, mask, nbr, weights, mirror)
        if mirror is None:
            plan = bf16_plan(nbr, feats, weights)
            out = _gather_matmul_conv_bf16_cuda(feats, mask, nbr, weights,
                                                bias, plan)
        else:
            plan = conv_plan(nbr.shape[0], nbr.shape[1], feats.shape[1],
                             weights.shape[1], bf16=True)
            out = _conv_dgrad_bf16_cuda(feats, mask, nbr, weights, mirror,
                                        plan)
        launches[plan.route + '_bf16'] += 1
        return out
    if mirror is not None:
        weights = _dgrad_weights_t(weights, mirror)
    if not cuda:
        return _gather_matmul_conv_plain(feats, mask, nbr, weights, bias)
    plan = cuda_plan(feats, nbr, weights)
    out = _gather_matmul_conv_cuda(feats, mask, nbr, weights, bias, plan)
    launches[plan.route] += 1
    return out


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

    Under ``set_conv_compute_dtype(torch.bfloat16)`` the call takes the
    bf16 contract: feats and weights rounded to bfloat16, products and sums
    in float32 (K2-bf16 on the card: ``wgmma`` over the gathered rows as
    they land, the weights' bfloat16 copy made once per version,
    :func:`bf16_weights`; :func:`_gather_matmul_conv_bf16_plain` on the
    CPU).
    """
    with span('es.k2.fwd'):
        return _k2(feats, mask, nbr, weights, bias,
                   gather_matmul_conv.launches, 'gather_matmul_conv',
                   _bf16_route())


def conv_dgrad(dout: torch.Tensor, out_mask: torch.Tensor,
               table: torch.Tensor, weights_t: torch.Tensor,
               bf16: bool = False, *, mirror: bool | None = None
               ) -> torch.Tensor:
    """A sparse conv's input gradient through K2's contract:
    ``sum_k dout[table[:, k]] @ weights_t[k]``, the rows of ``dout`` whose
    ``out_mask`` is false read as zero. ``table`` is the mirrored table of a
    submanifold conv (its own, with ``weights_t = W.flip(0)^T``) or the
    transpose table of a strided one (``weights_t = W^T``). The same kernel
    and plain version as :func:`gather_matmul_conv`; launches are counted
    apart in ``conv_dgrad.launches``. ``bf16``: the bf16 contract
    (K2-bf16), whatever the compute dtype; the autograd routes pass their
    forward's, and ``dout`` may then be bfloat16 already.

    ``mirror``: ``weights_t`` is the forward's own W (K, Cin, Cout), read
    as ``W.flip(0)^T`` (True, a submanifold table) or ``W^T`` (False, a
    transpose table). K2-bf16 then reads W's cached bfloat16 copy
    transposed in the kernel; the float32 route builds the transposed copy
    and runs as above."""
    with span('es.k2.dgrad'):
        return _k2(dout, out_mask, table, weights_t, None,
                   conv_dgrad.launches, 'conv_dgrad', bf16, mirror)


# kernel launches by route (CUDA path only); '_bf16': the bfloat16 variants
gather_matmul_conv.launches = {'tc': 0, 'simt': 0, 'tc_bf16': 0,
                               'simt_bf16': 0}
conv_dgrad.launches = {'tc': 0, 'simt': 0, 'tc_bf16': 0, 'simt_bf16': 0}


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
WB_STEP = 64                 # pairs per step of a K3-bf16 tensor-core block
WB_STAGES = 4                # its ring slots of landed rows


class WgradPlan(NamedTuple):
    """How ``conv_wgrad`` runs one shape on the card.

    Attributes:
        route: ``'tc'`` (tensor cores, 3xTF32, or bfloat16 for K3-bf16) or
            ``'narrow'`` (FP32 FMAs).
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


def wgrad_smem(bm: int, bn: int, bf16: bool = False) -> int:
    """Dynamic shared memory of a tensor-core block with a bm x bn tile of
    G: 1 KB of alignment slack, two buffers of the TF32 hi and lo parts of
    both operands (32 pairs each) and three slots of staged fp32 rows; for
    K3-bf16 only its ring of ``WB_STAGES`` slots of landed bfloat16 rows
    (64 pairs each), which the tensor cores read as they are, and twice as
    many slots of the steps' pair indices."""
    if bf16:
        return 1024 + WB_STAGES * ((bm + bn) * 2 + 2 * 8) * WB_STEP
    return 1024 + 4 * (2 * 2 + WG_STAGES) * (bm + bn) * WG_STEP


@functools.lru_cache(maxsize=1024)
def wgrad_plan(r: int, k: int, cx: int, cy: int,
               bf16: bool = False) -> WgradPlan:
    """The route, tile and pair chunks of an (R, K, Cx, Cy) weight-gradient
    call.

    Chosen by shape only, never by a failed launch. The tensor-core route
    stages rows as 16-byte chunks, so it takes Cx, Cy >= 8 and multiples of
    4; its tile of G is 128 on a side of at least 128 channels, else 64.
    Other shapes (the stem's Cy = 3) take the narrow route, whose tile is
    64 channels of the wider side by 4 of the narrower.

    K3-bf16 (``bf16``) lands 16-byte chunks of 8 bfloat16 channels: its
    tensor-core route takes Cx, Cy >= 8 and multiples of 8; its tiles and
    chunks are its own (:func:`_bf16_wgrad_plan`).

    The pairs of each offset are cut into ``chunks`` only when the tiles
    of G (x K) fill fewer than two waves of the blocks the card keeps
    resident; then into as many as it takes for ``WG_WAVES`` waves, but no
    more than R / ``WG_MIN_CHUNK`` (fuller chunks than an offset can have)
    and no more than ``WG_MAX_WS_BYTES`` of partials allow. The device
    then gives each chunk of offset k an equal share of its n_k pairs
    (:func:`wgrad_chunk_bounds`). The thresholds are the ones the main
    path's calls favoured on an H100 (``kernel_ab.py --train --plans``).
    """
    vec = 8 if bf16 else 4
    if min(cx, cy) < 8 or cx % vec or cy % vec:
        return _narrow_plan(r, k, cx, cy)
    if bf16:
        return _bf16_wgrad_plan(r, k, cx, cy)
    bm, bn = (128 if cx >= 128 else 64), (128 if cy >= 128 else 64)
    per_sm = max(1, SMEM_PER_SM // (wgrad_smem(bm, bn, bf16) +
                                    SMEM_PER_BLOCK))
    return WgradPlan('tc', bm, bn, _wgrad_chunks(r, k, cx, cy, bm, bn,
                                                 NUM_SMS * per_sm))


# K3-bf16's plan: a side of the tile of G is 128 from this many channels
BF16_WG_WIDE = 256
BF16_WG_SPLIT_BELOW = 0.5   # chunks only below this many waves of tiles
BF16_WG_WAVES = 1           # and then as many as fill this many waves


def _bf16_wgrad_plan(r, k, cx, cy) -> WgradPlan:
    """K3-bf16's tile and chunks: the tile's side is 128 where that side
    has at least ``BF16_WG_WIDE`` channels, else 64 (more blocks, and up
    to 3 of them resident on an SM); the pairs are cut into chunks only
    when the tiles (x K) fill less than ``BF16_WG_SPLIT_BELOW`` of a wave
    of resident blocks, and then into as many as fill ``BF16_WG_WAVES``
    waves (within the bounds of :func:`_wgrad_chunks`)."""
    bm = 128 if cx >= BF16_WG_WIDE else 64
    bn = 128 if cy >= BF16_WG_WIDE else 64
    slots = NUM_SMS * max(1, SMEM_PER_SM // (wgrad_smem(bm, bn, True) +
                                             SMEM_PER_BLOCK))
    tiles = k * -(-cx // bm) * -(-cy // bn)
    if tiles >= BF16_WG_SPLIT_BELOW * slots:
        return WgradPlan('tc', bm, bn, 1)
    chunks = -(-BF16_WG_WAVES * slots // tiles)
    return WgradPlan('tc', bm, bn, max(1, min(
        chunks, -(-r // WG_MIN_CHUNK), WG_MAX_WS_BYTES // (4 * k * cx * cy),
        65535)))


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


def _conv_wgrad_bf16_plain(x, x_mask, idx, y, y_mask):
    """K3-bf16's plain version: x and y rounded to bfloat16, then the
    float32 plain version (the products are exact in float32)."""
    return _conv_wgrad_plain(_bf16(x), x_mask, idx, _bf16(y), y_mask)


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


def _wgrad_meta_words(r: int, k: int, arrivals: int = 0) -> int:
    """int32 words of K3's per-call scratch: the counts, a ticket, one
    64-bit status word per offset and 256-row block of the pair pass, and
    ``arrivals`` counters (K3-bf16's folded chunk reduction: K x tiles of
    G with more than one chunk)."""
    return ((k + 2) & ~1) + 2 * k * -(-r // 256) + arrivals


def _wgrad_cuda(x, x_mask, idx, y, y_mask, plan, lists=False):
    """Launches K3 by ``plan`` (K3-bf16 where x and y are bfloat16);
    returns G, and with ``lists`` also the pair lists (K, R, 2) and counts
    (K,) the call computed."""
    r, cx = x.shape
    k = idx.shape[1]
    ny, cy = y.shape
    dev = x.device
    out = torch.empty((k, cx, cy), dtype=torch.float32, device=dev)
    bf16 = x.dtype == torch.bfloat16
    # one 4-byte buffer: the pair lists, the counts and scratch (and
    # K3-bf16's arrival counters), then the chunk partials (with more than
    # one chunk)
    tiles = -(-cx // plan.bm) * -(-cy // plan.bn)
    n_pairs = 2 * k * r
    n_meta = _wgrad_meta_words(r, k, k * tiles if bf16 and plan.chunks > 1
                               else 0)
    if bf16:  # its last blocks read the partials 16 bytes at a time
        n_meta += -(n_pairs + n_meta) % 4
    n_ws = plan.chunks * k * cx * cy if plan.chunks > 1 else 0
    buf = torch.empty(n_pairs + n_meta + n_ws, dtype=torch.int32, device=dev)
    base = buf.data_ptr()
    name = 'es_sparse_wgrad' + ('_bf16' if bf16 else '')
    if out.numel():
        err = getattr(kernels.library(), name)(
            int(plan.route == 'narrow'), x.data_ptr(), x_mask.data_ptr(), r,
            cx, idx.data_ptr(), k, y.data_ptr(), y_mask.data_ptr(), ny, cy,
            plan.bm, plan.bn, plan.chunks, base, base + 4 * n_pairs,
            base + 4 * (n_pairs + n_meta) if n_ws else None, out.data_ptr(),
            kernels.stream_handle(dev))
        kernels.check(err, name)
    if not lists:
        return out
    counts = buf[n_pairs:n_pairs + k]
    return out, buf[:n_pairs].view(k, r, 2), \
        counts if out.numel() else counts.zero_()


def _conv_wgrad_cuda(x, x_mask, idx, y, y_mask, plan=None):
    if plan is None:
        plan = cuda_wgrad_plan(x, idx, y)
    return _wgrad_cuda(x, x_mask, idx, y, y_mask, plan)


def bf16_wgrad_plan(x, idx, y) -> WgradPlan:
    """K3-bf16's plan for these inputs (the bfloat16 operands are
    aligned: :func:`_as_bf16`)."""
    return wgrad_plan(*idx.shape, x.shape[1], y.shape[1], bf16=True)


def _conv_wgrad_bf16_cuda(x, x_mask, idx, y, y_mask, plan=None, lists=False):
    """K3-bf16: x and y in bfloat16 (each cast where it is float32; the
    autograd routes pass the copies their backward made once), then the
    kernel by ``plan`` (see :func:`_wgrad_cuda` for ``lists``)."""
    return _wgrad_cuda(_as_bf16(x), x_mask, idx, _as_bf16(y), y_mask,
                       plan or bf16_wgrad_plan(x, idx, y), lists)


def conv_wgrad(x: torch.Tensor, x_mask: torch.Tensor, idx: torch.Tensor,
               y: torch.Tensor, y_mask: torch.Tensor,
               bf16: bool = False) -> torch.Tensor:
    """Kernel K3: ``G[k] = sum_r x[r]^T @ y[idx[r, k]]``, (K, Cx, Cy).

    Args:
        x: (R, Cx) float32 (or bfloat16 with ``bf16``); rows with
            ``x_mask`` false read as zero.
        x_mask: (R,) bool.
        idx: (R, K) int32 rows of y (-1, or any row outside [0, Ny), =
            absent).
        y: (Ny, Cy) float32 (or bfloat16 with ``bf16``); rows with
            ``y_mask`` false read as zero.
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

    ``bf16``: K3-bf16, the bf16 contract of the reference's custom-VJP
    backwards: x and y rounded to bfloat16, G summed in float32 (``wgmma``
    over the landed rows, no transpose pass, the chunks added by the
    product's own blocks; :func:`_conv_wgrad_bf16_plain` on the CPU, the
    same bits for float32 operands and for their bfloat16 copies).
    Launches count as ``<route>_bf16``.
    """
    if x.dim() != 2 or x_mask.shape != x.shape[:1] or idx.dim() != 2 or \
            idx.shape[0] != x.shape[0] or y.dim() != 2 or \
            y_mask.shape != y.shape[:1]:
        raise ValueError(
            'conv_wgrad: shapes x (R, Cx), x_mask (R,), idx (R, K), '
            f'y (Ny, Cy), y_mask (Ny,); got {tuple(x.shape)}, '
            f'{tuple(x_mask.shape)}, {tuple(idx.shape)}, {tuple(y.shape)}, '
            f'{tuple(y_mask.shape)}')
    types = (torch.float32, torch.bfloat16) if bf16 else (torch.float32, )
    if x.dtype not in types or y.dtype not in types or \
            x_mask.dtype != torch.bool or y_mask.dtype != torch.bool or \
            idx.dtype != torch.int32:
        raise TypeError('conv_wgrad takes float32 x/y (or bfloat16 ones with '
                        'bf16), bool masks and int32 idx')
    with span('es.k3'):
        if _check_device('conv_wgrad', [x, x_mask, idx, y, y_mask]).type == \
                'cuda':
            if x.shape[0] >= 2**31 or idx.shape[1] > 65535:
                raise ValueError('conv_wgrad: the kernel takes R < 2^31 and '
                                 'K <= 65535')
            if bf16:
                plan = bf16_wgrad_plan(x, idx, y)
                out = _conv_wgrad_bf16_cuda(x, x_mask, idx, y, y_mask, plan)
                conv_wgrad.launches[plan.route + '_bf16'] += 1
            else:
                plan = cuda_wgrad_plan(x, idx, y)
                out = _conv_wgrad_cuda(x, x_mask, idx, y, y_mask, plan)
                conv_wgrad.launches[plan.route] += 1
            return out
        if bf16:
            return _conv_wgrad_bf16_plain(x, x_mask, idx, y, y_mask)
        return _conv_wgrad_plain(x, x_mask, idx, y, y_mask)


conv_wgrad.launches = {'tc': 0, 'narrow': 0, 'tc_bf16': 0, 'narrow_bf16': 0}


# --- autograd: the three routes of SparseConv -------------------------------
#
# Ports of the JAX package's custom VJPs (ops/sparse.py:subm_gather_conv,
# strided_gather_conv) and of XLA's autodiff of gather_matmul_conv. Each
# backward runs dfeats through K2 (or index_add_ for the generic route) and
# dW through K3. The serving path calls gather_matmul_conv directly and
# never builds these. Each forward records whether it took the bf16 route,
# and its backward follows that route's contract (set_conv_compute_dtype).


def _masked_rows(t, mask):
    return torch.where(mask[:, None], t, torch.zeros_like(t))


def _backward_operand(ctx, t):
    """An operand of a custom-VJP backward (dout, or feats for dW),
    contiguous; on the bf16 route its bfloat16 copy, made once and shared
    by K2-bf16's input gradient and K3-bf16 (the rounding both contracts
    take first)."""
    t = t.contiguous()
    return t.to(torch.bfloat16) if ctx.bf16 else t


class _SubmConv(torch.autograd.Function):
    """Submanifold conv: ``nbr`` is the level's own mirror-symmetric
    27-table (OFFSETS_3 is point-symmetric: offset K-1-k is -offset k), so
    ``nbr[m, k] = i <=> nbr[i, K-1-k] = m``."""

    @staticmethod
    def forward(ctx, feats, mask, nbr, weights):
        ctx.save_for_backward(feats, mask, nbr, weights)
        ctx.bf16 = _bf16_route()
        return gather_matmul_conv(feats, mask, nbr, weights)

    @staticmethod
    def backward(ctx, dout):
        feats, mask, nbr, weights = ctx.saved_tensors
        dout = _backward_operand(ctx, dout)
        dfeats = dw = None
        if ctx.needs_input_grad[0]:
            dfeats = _masked_rows(conv_dgrad(dout, mask, nbr, weights,
                                             ctx.bf16, mirror=True), mask)
        if ctx.needs_input_grad[3]:
            dw = conv_wgrad(_backward_operand(ctx, feats), mask, nbr, dout,
                            mask, ctx.bf16).flip(0)
        return dfeats, None, None, dw


class _StridedConv(torch.autograd.Function):
    """Strided conv with its transpose table: ``t_nbr[j, k] = m <=>
    nbr[m, k] = j`` (``t_nbr`` indexes the coarse output rows)."""

    @staticmethod
    def forward(ctx, feats, mask, nbr, t_nbr, weights, out_mask):
        ctx.save_for_backward(feats, mask, t_nbr, weights, out_mask)
        ctx.bf16 = _bf16_route()
        return gather_matmul_conv(feats, mask, nbr, weights)

    @staticmethod
    def backward(ctx, dout):
        feats, mask, t_nbr, weights, out_mask = ctx.saved_tensors
        dout = _backward_operand(ctx, dout)
        dfeats = dw = None
        if ctx.needs_input_grad[0]:
            dfeats = _masked_rows(conv_dgrad(
                dout, out_mask, t_nbr, weights, ctx.bf16, mirror=False), mask)
        if ctx.needs_input_grad[4]:
            dw = conv_wgrad(_backward_operand(ctx, feats), mask, t_nbr, dout,
                            out_mask, ctx.bf16)
        return dfeats, None, None, None, dw, None


class _GenericConv(torch.autograd.Function):
    """Any other table (the stem, the K = 1 downsamples): dfeats by
    ``index_add_``, as XLA's autodiff of the gather does; on the bf16 route
    as that autodiff does under the reference's bf16 compute dtype (each
    offset's product rounded to bfloat16 and added in bfloat16, the last
    offset first; dW rounded to bfloat16)."""

    @staticmethod
    def forward(ctx, feats, mask, nbr, weights, out_mask):
        ctx.save_for_backward(feats, mask, nbr, weights, out_mask)
        ctx.bf16 = _bf16_route()
        return gather_matmul_conv(feats, mask, nbr, weights)

    @staticmethod
    def backward(ctx, dout):
        feats, mask, nbr, weights, out_mask = ctx.saved_tensors
        dout = dout.contiguous()
        dfeats = dw = None
        if ctx.needs_input_grad[0]:
            n = feats.shape[0]
            dtype = torch.bfloat16 if ctx.bf16 else feats.dtype
            acc = feats.new_zeros(n + 1, feats.shape[1], dtype=dtype)
            order = range(nbr.shape[1])
            for j in (reversed(order) if ctx.bf16 else order):
                col = nbr[:, j]
                rows = torch.where((col >= 0) & (col < n), col,
                                   torch.full_like(col, n)).long()
                w = _bf16(weights[j]) if ctx.bf16 else weights[j]
                acc.index_add_(0, rows, (dout @ w.T).to(dtype))
            dfeats = _masked_rows(acc[:n].to(feats.dtype), mask)
        if ctx.needs_input_grad[3]:
            x = _bf16(feats) if ctx.bf16 else feats
            dw = conv_wgrad(dout, out_mask, nbr, x, mask).transpose(1, 2)
            if ctx.bf16:
                dw = _bf16(dw)
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
