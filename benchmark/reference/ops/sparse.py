"""Fixed-capacity sparse voxel engine and sparse convolution, in plain
PyTorch.

The benchmark's frozen reference: the flat-batch engine (voxelize, tables,
top-k, pooling) and the sparse convolution ``sum_k feats[nbr[:, k]] @ W[k]``
as one gather and one float32 matrix product per offset. Its gradient is
taken by :class:`_PlainConv`, which saves only the operands and scatters
each offset's input gradient back with ``index_add_``.
"""

import functools
from typing import NamedTuple

import numpy as np
import torch

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



class _PlainConv(torch.autograd.Function):
    """``gather_matmul_conv`` over any table, differentiable. The output
    rows whose ``out_mask`` is false carry no gradient; the input gradient
    of each offset is scattered onto the rows it read (``index_add_``),
    and dW[k] is the gathered rows' transpose times the output gradient."""

    @staticmethod
    def forward(ctx, feats, mask, nbr, weights, out_mask):
        ctx.save_for_backward(feats, mask, nbr, weights, out_mask)
        return _gather_matmul_conv_plain(feats, mask, nbr, weights)

    @staticmethod
    def backward(ctx, dout):
        feats, mask, nbr, weights, out_mask = ctx.saved_tensors
        n, cin = feats.shape
        dout = torch.where(out_mask[:, None], dout, torch.zeros_like(dout))
        safe = torch.where(mask[:, None], feats, torch.zeros_like(feats))
        padded = torch.cat([safe, safe.new_zeros(1, cin)])
        idx = torch.where((nbr >= 0) & (nbr < n), nbr,
                          torch.full_like(nbr, n)).long()
        dfeats = dw = None
        if ctx.needs_input_grad[0]:
            acc = feats.new_zeros(n + 1, cin)
            for j in range(nbr.shape[1]):
                acc.index_add_(0, idx[:, j], dout @ weights[j].T)
            dfeats = torch.where(mask[:, None], acc[:n],
                                 torch.zeros_like(acc[:n]))
        if ctx.needs_input_grad[3]:
            dw = torch.stack([padded[idx[:, j]].T @ dout
                              for j in range(nbr.shape[1])])
        return dfeats, None, None, dw, None


def gather_matmul_conv(feats, mask, nbr, weights, bias=None):
    """``sum_k feats[nbr[:, k]] @ W[k]`` (+ bias); rows with ``mask`` false
    and indices outside [0, N) read as zero."""
    return _gather_matmul_conv_plain(feats, mask, nbr, weights, bias)


def subm_gather_conv(feats, mask, nbr, weights):
    return _PlainConv.apply(feats, mask, nbr, weights, mask)


def strided_gather_conv(feats, mask, nbr, t_nbr, weights, out_mask):
    return _PlainConv.apply(feats, mask, nbr, weights, out_mask)


def generic_gather_conv(feats, mask, nbr, weights, out_mask):
    return _PlainConv.apply(feats, mask, nbr, weights, out_mask)


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
