"""Sparse layers over the voxel engine, the MinkResNet backbone and the
ChannelMapper neck (port of the flat-mode parts of
``embodiedscan_tpu/models/sparse_nn.py``).

Submodules are named after the reference's flax auto-names
(``SparseStage_0``, ``SparseConv_1``, ``MaskedBatchNorm_0``, ...) so weights
carry over by path (``utils/convert_weights.py``).
"""

from typing import Sequence, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from ..ops import sparse as S
from ..ops.hashing import lookup_merge_b, lookup_merge_multi_b
from ..utils.trace import span
from .norm import MaskedBatchNorm, MaskedInstanceNorm
from .remat import checkpointed


class SparseConv(nn.Module):
    """Sparse convolution given a precomputed batched neighbor table."""

    def __init__(self, in_channels: int, features: int, kernel_size: int = 27,
                 use_bias: bool = False):
        super().__init__()
        self.features = features
        self.kernel = nn.Parameter(torch.zeros(kernel_size, in_channels,
                                               features))
        if use_bias:
            self.bias = nn.Parameter(torch.zeros(features))
        else:
            self.register_parameter('bias', None)

    def forward(self, feats, mask, nbr, out_mask=None, t_nbr=None):
        """Conv over a (B, M, K) table into ``out_mask``'s rows (the input
        rows when None). With autograd on, the route follows the
        reference's: a 27-table without ``out_mask`` is submanifold, a
        strided conv given its (B, N, K) transpose table ``t_nbr`` goes
        through it, any other table is generic (see ops/sparse.py)."""
        # the batch is flattened into the row space: tables hold
        # within-sample rows, so absolute rows are nbr + sample * N
        bsz, n, cin = feats.shape
        m = nbr.shape[1]
        ff = feats.reshape(bsz * n, cin).contiguous()
        fm = mask.reshape(bsz * n).contiguous()
        fnbr = _flat_table(nbr, n)
        om = mask if out_mask is None else out_mask
        if not (torch.is_grad_enabled() and (feats.requires_grad or
                                             self.kernel.requires_grad)):
            out = S.gather_matmul_conv(ff, fm, fnbr, self.kernel, self.bias)
        else:
            if out_mask is None and self.kernel.shape[0] == 27:
                out = S.subm_gather_conv(ff, fm, fnbr, self.kernel)
            elif t_nbr is not None:
                # t_nbr indexes the coarse output rows: its offsets use m
                out = S.strided_gather_conv(
                    ff, fm, fnbr, _flat_table(t_nbr, m), self.kernel,
                    om.reshape(-1).contiguous())
            else:
                out = S.generic_gather_conv(ff, fm, fnbr, self.kernel,
                                            om.reshape(-1).contiguous())
            if self.bias is not None:
                out = out + self.bias
        out = out.reshape(bsz, m, self.features)
        return torch.where(om[..., None], out,
                           torch.zeros_like(out)).to(feats.dtype)


def _flat_table(table: torch.Tensor, rows: int) -> torch.Tensor:
    """(B, M, K) within-sample rows of a table with ``rows`` rows per sample
    -> (B * M, K) absolute rows (-1 stays -1)."""
    bsz, m, kk = table.shape
    offs = torch.arange(bsz, dtype=table.dtype, device=table.device)[
        :, None, None] * rows
    return torch.where(table >= 0, table + offs,
                       torch.full_like(table, -1)).reshape(bsz * m,
                                                           kk).contiguous()


def strided_queries(st: S.SparseTensor, dmap: S.DownsampleMap,
                    offsets: np.ndarray) -> torch.Tensor:
    """Neighbor table for stride-2 convs: input rows at 2*o + k. (B, M, K)."""
    b, m = dmap.coords.shape[:2]
    k = offsets.shape[0]
    q = (dmap.coords[:, :, None, :] * 2 +
         torch.as_tensor(offsets, device=dmap.coords.device)[None, None]
         ).reshape(b, m * k, 3)
    qm = dmap.mask.repeat_interleave(k, dim=1)
    return lookup_merge_b(st.coords, st.mask, q, qm).reshape(b, m, k)


def stage_tables(st: S.SparseTensor, dmap: S.DownsampleMap,
                 with_transpose: bool = False):
    """Fused (strided, submanifold[, transpose]) tables of one ResNet stage,
    in one join.

    The strided conv gathers fine rows at ``2*o + k``; every later
    submanifold conv of the stage gathers coarse rows at ``o + k`` (the
    center column is the identity and is not queried); with
    ``with_transpose`` (training) the strided conv's backward gathers the
    coarse row at ``(j - k) / 2`` for each fine row j where that is whole.
    Returns (s_idx (B, M, 27), n_idx (B, M, 27), t_idx (B, N, 27) or None).
    """
    cix = S._center_offset(S.OFFSETS_3)
    dev = st.coords.device
    offs = torch.as_tensor(S.OFFSETS_3, device=dev)
    noffs = torch.as_tensor(np.delete(S.OFFSETS_3, cix, axis=0), device=dev)
    b, n = st.coords.shape[:2]
    m = dmap.coords.shape[1]
    ko = offs.shape[0]
    sq = (dmap.coords[:, :, None, :] * 2 + offs[None, None]).reshape(
        b, m * ko, 3)
    nq = (dmap.coords[:, :, None, :] + noffs[None, None]).reshape(
        b, m * (ko - 1), 3)
    qm = dmap.mask.repeat_interleave(ko, dim=1)
    nqm = dmap.mask.repeat_interleave(ko - 1, dim=1)
    pairs = [(st.coords, st.mask, sq, qm), (dmap.coords, dmap.mask, nq, nqm)]
    if with_transpose:
        tq = st.coords[:, :, None, :] - offs[None, None]  # (B, N, 27, 3)
        even = (torch.remainder(tq, 2) == 0).all(-1).reshape(b, n * ko)
        tqm = st.mask.repeat_interleave(ko, dim=1) & even
        pairs.append((dmap.coords, dmap.mask,
                      torch.div(tq, 2, rounding_mode='floor').reshape(
                          b, n * ko, 3), tqm))
    res = lookup_merge_multi_b(pairs)
    s_idx = res[0].reshape(b, m, ko)
    n26 = res[1].reshape(b, m, ko - 1)
    ident = S._identity_column(dmap.mask)
    n_idx = torch.cat([n26[..., :cix], ident[..., None], n26[..., cix:]], -1)
    t_idx = res[2].reshape(b, n, ko) if with_transpose else None
    return s_idx, n_idx, t_idx


def _fpn_code_tables():
    """Static code tables for the structured FPN lattice arithmetic.

    Child coords are ``2p + b`` (b in OFFSETS_2 order, slot ``p*8+code(b)``),
    so for a child bit b and subm offset o: per axis ``t = b + o``
    decomposes as parent offset ``floor(t/2)`` and child bit ``t mod 2``.
    Returns (po (8, 27) column into the parent 27-table, cb (8, 27)
    child-slot bit code, corner_cols (8,) parent-table columns holding the
    trilinear corners of ``c/2``, tri_w (8, 8) trilinear weights of child
    ci at its parent's 8 corners).
    """
    code3 = {tuple(o): i for i, o in enumerate(S.OFFSETS_3.tolist())}
    po = np.zeros((8, 27), np.int64)
    cb = np.zeros((8, 27), np.int64)
    for ci, bbits in enumerate(S.OFFSETS_2.tolist()):
        for ko, off in enumerate(S.OFFSETS_3.tolist()):
            t = np.asarray(bbits) + np.asarray(off)
            par = np.floor_divide(t, 2)
            bit = t - 2 * par
            po[ci, ko] = code3[tuple(par.tolist())]
            cb[ci, ko] = (bit[0] << 2) | (bit[1] << 1) | bit[2]
    corner_cols = np.array([code3[tuple(d)] for d in S.OFFSETS_2.tolist()],
                           np.int64)
    tri_w = np.zeros((8, 8), np.float32)
    for ci, bbits in enumerate(S.OFFSETS_2.tolist()):
        for j, d in enumerate(S.OFFSETS_2.tolist()):
            w = 1.0
            for a in range(3):
                f = bbits[a] * 0.5
                w *= f if d[a] else (1.0 - f)
            tri_w[ci, j] = w
    return po, cb, corner_cols, tri_w


_FPN_CODES = _fpn_code_tables()


def fpn_tables(parent_nbr: torch.Tensor, pcoords: torch.Tensor,
               pmask: torch.Tensor, lateral: S.SparseTensor):
    """Coordinate tables for one FPN top-down level, derived from the
    coarse level's 27-neighbor table plus one lateral parent lookup.

    The reference selects the table columns with an f32 one-hot matmul
    (exact for row indices < 2^24); here they are integer column indexing.

    Returns:
        (nbr (B, 8P, 27), lateral_idx (B, L), corner_idx (B, P, 8)).
    """
    po, cb, corner_cols, _ = _FPN_CODES
    dev = parent_nbr.device
    b, p = pcoords.shape[:2]
    pn = parent_nbr[..., torch.as_tensor(po.reshape(-1), device=dev)]
    pn = pn.reshape(b, p, 8, 27)
    cbt = torch.as_tensor(cb, dtype=pn.dtype, device=dev)
    nbr = torch.where(pn >= 0, pn * 8 + cbt[None, None],
                      torch.full_like(pn, -1)).reshape(b, p * 8, 27)
    corners = parent_nbr[..., torch.as_tensor(corner_cols, device=dev)]
    lq = torch.div(lateral.coords, 2, rounding_mode='floor')
    bits = lateral.coords - lq * 2
    lcode = (bits[..., 0] << 2) | (bits[..., 1] << 1) | bits[..., 2]
    pidx = lookup_merge_b(pcoords, pmask, lq, lateral.mask)
    lat = torch.where(pidx >= 0, pidx * 8 + lcode, torch.full_like(pidx, -1))
    return nbr, lat, corners


def fpn_prune_scores(pscores: torch.Tensor, pmask: torch.Tensor,
                     corner_idx: torch.Tensor,
                     child_mask: torch.Tensor) -> torch.Tensor:
    """Per-child FPN prune scores (B, 8P) from per-parent corner gathers and
    the static trilinear weights (absent corners contribute zero)."""
    tri_w = torch.as_tensor(_FPN_CODES[3], device=pscores.device)
    b, p = pscores.shape
    safe = torch.where(pmask, pscores, torch.zeros_like(pscores)).reshape(b * p)
    padded = torch.cat([safe, safe.new_zeros(1)])
    aoff = (torch.arange(b, dtype=corner_idx.dtype,
                         device=corner_idx.device) * p)[:, None, None]
    aidx = torch.where(corner_idx >= 0, corner_idx + aoff,
                       torch.full_like(corner_idx, b * p))
    corner_s = padded[aidx.reshape(-1).long()].reshape(b, p, 8)
    child = torch.einsum('bpj,cj->bpc', corner_s, tri_w).reshape(b, p * 8)
    return torch.where(child_mask, child, torch.zeros_like(child))


class SparseBasicBlock(nn.Module):
    """ME ResNet BasicBlock: conv3-BN-ReLU-conv3-BN + identity, ReLU."""

    def __init__(self, features: int):
        super().__init__()
        self.SparseConv_0 = SparseConv(features, features)
        self.MaskedBatchNorm_0 = MaskedBatchNorm(features)
        self.SparseConv_1 = SparseConv(features, features)
        self.MaskedBatchNorm_1 = MaskedBatchNorm(features)

    def forward(self, feats, mask, nbr):
        out = F.relu(self.MaskedBatchNorm_0(self.SparseConv_0(feats, mask, nbr),
                                            mask))
        out = self.MaskedBatchNorm_1(self.SparseConv_1(out, mask, nbr), mask)
        out = F.relu(out + feats)
        return torch.where(mask[..., None], out, torch.zeros_like(out))


class SparseBottleneck(nn.Module):
    """ME ResNet Bottleneck: 1x1-BN-ReLU, conv3-BN-ReLU, 1x1x4-BN + id, ReLU."""

    def __init__(self, features: int):
        super().__init__()
        self.conv1 = nn.Linear(features * 4, features, bias=False)
        self.MaskedBatchNorm_0 = MaskedBatchNorm(features)
        self.SparseConv_0 = SparseConv(features, features)
        self.MaskedBatchNorm_1 = MaskedBatchNorm(features)
        self.conv3 = nn.Linear(features, features * 4, bias=False)
        self.MaskedBatchNorm_2 = MaskedBatchNorm(features * 4)

    def forward(self, feats, mask, nbr):
        out = F.relu(self.MaskedBatchNorm_0(self.conv1(feats), mask))
        out = F.relu(self.MaskedBatchNorm_1(self.SparseConv_0(out, mask, nbr),
                                            mask))
        out = self.MaskedBatchNorm_2(self.conv3(out), mask)
        out = F.relu(out + feats)
        return torch.where(mask[..., None], out, torch.zeros_like(out))


class SparseStage(nn.Module):
    """One MinkResNet stage: strided block then ``blocks - 1`` submanifold
    ones; ``block='bottleneck'`` puts the stride on the middle conv and
    outputs ``4 * features`` channels."""

    def __init__(self, in_channels: int, features: int, blocks: int,
                 capacity: int, block: str = 'basic'):
        super().__init__()
        self.capacity = capacity
        self.block = block
        cout = features * (1 if block == 'basic' else 4)
        if block == 'basic':
            self.SparseConv_0 = SparseConv(in_channels, features)
            self.MaskedBatchNorm_0 = MaskedBatchNorm(features)
            self.SparseConv_1 = SparseConv(features, features)
            self.MaskedBatchNorm_1 = MaskedBatchNorm(features)
            self.SparseConv_2 = SparseConv(in_channels, cout, kernel_size=1)
            self.MaskedBatchNorm_2 = MaskedBatchNorm(cout)
            rest = SparseBasicBlock
        else:
            self.b0_conv1 = nn.Linear(in_channels, features, bias=False)
            self.MaskedBatchNorm_0 = MaskedBatchNorm(features)
            self.SparseConv_0 = SparseConv(features, features)
            self.MaskedBatchNorm_1 = MaskedBatchNorm(features)
            self.b0_conv3 = nn.Linear(features, cout, bias=False)
            self.MaskedBatchNorm_2 = MaskedBatchNorm(cout)
            self.SparseConv_1 = SparseConv(in_channels, cout, kernel_size=1)
            self.MaskedBatchNorm_3 = MaskedBatchNorm(cout)
            rest = SparseBottleneck
        for i in range(blocks - 1):
            self.add_module(f'{rest.__name__}_{i}', rest(features))
        self.n_rest = blocks - 1
        self.rest_name = rest.__name__

    def forward(self, st: S.SparseTensor) -> S.SparseTensor:
        dmap = S.downsample_coords_b(st, self.capacity)
        # the transpose table of the strided conv's backward: training only
        s_nbr, nbr, t_nbr = stage_tables(st, dmap,
                                         with_transpose=self.training)
        om = dmap.mask
        if self.block == 'basic':
            out = self.SparseConv_0(st.feats, st.mask, s_nbr, out_mask=om,
                                    t_nbr=t_nbr)
            out = F.relu(self.MaskedBatchNorm_0(out, om))
            out = self.MaskedBatchNorm_1(self.SparseConv_1(out, om, nbr), om)
            down_conv, down_bn = self.SparseConv_2, self.MaskedBatchNorm_2
        else:
            out = self.MaskedBatchNorm_0(self.b0_conv1(st.feats), st.mask)
            out = F.relu(torch.where(st.mask[..., None], out,
                                     torch.zeros_like(out)))
            out = self.SparseConv_0(out, st.mask, s_nbr, out_mask=om,
                                    t_nbr=t_nbr)
            out = F.relu(self.MaskedBatchNorm_1(out, om))
            out = self.MaskedBatchNorm_2(self.b0_conv3(out), om)
            down_conv, down_bn = self.SparseConv_1, self.MaskedBatchNorm_3
        # downsample branch: 1x1 stride-2 conv + BN via the dedup inverse
        d_nbr = S.center_child_index(st, dmap)
        down = down_bn(down_conv(st.feats, st.mask, d_nbr, out_mask=om), om)
        feats = F.relu(out + down)
        feats = torch.where(om[..., None], feats, torch.zeros_like(feats))
        for i in range(self.n_rest):
            feats = getattr(self, f'{self.rest_name}_{i}')(feats, om, nbr)
        return S.SparseTensor(dmap.coords, feats, om)


class ChannelMapper(nn.Module):
    """Per-level channel unification over sparse tensors (the reference's
    ME ``ChannelMapper``, ``necks/channel_mapper.py:19-94``): one
    conv-BN-ELU block per input level. ``kernel_size=1`` is a pointwise
    ``Linear``; ``kernel_size=3`` a :class:`SparseConv` over the level's
    27-neighbor table (one K1 join and one K2 conv a level on the card).
    Padded rows come out zero."""

    def __init__(self, in_channels: Sequence[int], out_channels: int,
                 kernel_size: int = 1):
        super().__init__()
        if kernel_size not in (1, 3):
            raise ValueError(f'kernel_size {kernel_size}: 1 or 3')
        self.kernel_size = kernel_size
        self.n_levels = len(in_channels)
        for i, cin in enumerate(in_channels):
            self.add_module(f'conv_{i}', nn.Linear(cin, out_channels,
                                                   bias=False)
                            if kernel_size == 1 else
                            SparseConv(cin, out_channels))
            self.add_module(f'bn_{i}', MaskedBatchNorm(out_channels))

    def forward(self, inputs: Sequence[S.SparseTensor]
                ) -> Tuple[S.SparseTensor, ...]:
        outs = []
        for i, st in enumerate(inputs):
            conv = getattr(self, f'conv_{i}')
            if self.kernel_size == 1:
                f = conv(st.feats)
            else:
                f = conv(st.feats, st.mask,
                         S.neighbor_table_b(st, S.OFFSETS_3))
            f = F.elu(getattr(self, f'bn_{i}')(f, st.mask))
            outs.append(S.SparseTensor(
                st.coords, torch.where(st.mask[..., None], f,
                                       torch.zeros_like(f)), st.mask))
        return tuple(outs)


class MinkResNet(nn.Module):
    """Sparse 3D ResNet backbone: conv3 stride-2 stem + InstanceNorm + ReLU +
    maxpool2, then 4 stride-2 stages (BasicBlock for depth 18/34,
    Bottleneck for 50/101/152)."""

    arch = {18: ('basic', (2, 2, 2, 2)), 34: ('basic', (3, 4, 6, 3)),
            50: ('bottleneck', (3, 4, 6, 3)),
            101: ('bottleneck', (3, 4, 23, 3)),
            152: ('bottleneck', (3, 8, 36, 3))}

    def __init__(self, depth: int = 34,
                 capacities=(65536, 32768, 24576, 8192, 4096, 2048),
                 in_channels: int = 3, remat: bool = False):
        super().__init__()
        self.capacities = tuple(capacities)
        # recompute each stage in the backward pass, its tables included
        # (the reference's remat, sparse_nn.py:530-557); names are unchanged
        self.remat = remat
        block, stage_blocks = self.arch[depth]
        self.SparseConv_0 = SparseConv(in_channels, 64)
        self.MaskedInstanceNorm_0 = MaskedInstanceNorm(64)
        cin = 64
        expansion = 1 if block == 'basic' else 4
        self.n_stages = len(stage_blocks)
        for i, blocks in enumerate(stage_blocks):
            self.add_module(f'SparseStage_{i}', SparseStage(
                cin, 64 * 2**i, blocks, self.capacities[2 + i], block))
            cin = 64 * 2**i * expansion

    def forward(self, st: S.SparseTensor):
        with span('es.mink3d'):
            dmap = S.downsample_coords_b(st, self.capacities[0])
            s_nbr = strided_queries(st, dmap, S.OFFSETS_3)
            feats = self.SparseConv_0(st.feats, st.mask, s_nbr,
                                      out_mask=dmap.mask)
            feats = F.relu(self.MaskedInstanceNorm_0(feats, dmap.mask))
            x = S.SparseTensor(dmap.coords, feats, dmap.mask)
            x = S.maxpool2(x, S.downsample_coords_b(x, self.capacities[1]))
            outs = []
            for i in range(self.n_stages):
                stage = getattr(self, f'SparseStage_{i}')
                x = checkpointed(stage, x) if self.remat else stage(x)
                outs.append(x)
            return tuple(outs)
