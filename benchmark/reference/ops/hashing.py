"""Batched coordinate hashing for the sparse voxel engine (flat mode).

Port of the flat (batch id in the key) primitives of
``embodiedscan_tpu/ops/hashing.py``. Integer voxel coordinates are packed
into one order-preserving int32 key per row; every coordinate op is one flat
stable sort over B*N rows plus the masked running-max join
(:func:`.pscan.join_scan`). Keys are assembled in int64 (PyTorch's uint32
support is partial) and mapped to int32 by ``u - 2**31``, the same bit
pattern as the reference's ``(u ^ 0x80000000)`` cast.

The reference builds its compaction and un-permute steps from sorts because
TPU scatters are slow; here they are scatters with unique targets (plus one
spare dump row), which give the same integers.
"""

from typing import NamedTuple

import torch

_BIAS = 1 << 31


def key_layout(n_batch: int) -> tuple:
    """(bits_x, bits_y, bits_z) coordinate bit budget for a given batch size.

    The batch id takes ceil(log2(B)) high bits; the remaining bits are
    shaved from the per-axis extents in z, y, x order. B=1 keeps the full
    (11, 11, 10) layout.
    """
    bb = max(0, int(n_batch - 1).bit_length())
    if bb > 6:
        raise ValueError(f'batch {n_batch} too large for a 32-bit packed key')
    bits = {'x': 11, 'y': 11, 'z': 10}
    for axis in ('z', 'y', 'x', 'z', 'y', 'x')[:bb]:
        bits[axis] -= 1
    return bits['x'], bits['y'], bits['z']


def batch_origin(coords: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """(B, 1, 3) per-sample min valid coordinate (the key origin)."""
    big = torch.full_like(coords, 2**30)
    return torch.where(valid[..., None], coords, big).amin(dim=1, keepdim=True)


def pack_key32_b(coords: torch.Tensor, valid: torch.Tensor,
                 origin: torch.Tensor | None = None) -> torch.Tensor:
    """Batched order-preserving key: (B, N, 3) int32 coords -> (B, N) int32.

    ``origin`` is the (B, 1, 3) key origin shared by a join's table and
    queries; it defaults to this array's own per-sample min. Invalid or
    out-of-range rows get the batch-local sentinel (batch bits | all-ones
    coordinate bits), so they sort to the end of their sample's segment.
    """
    b = coords.shape[0]
    bx, by, bz = key_layout(b)
    if origin is None:
        origin = batch_origin(coords, valid)
    rel = (coords - origin).long()  # int32 difference, as the reference
    in_range = (rel[..., 0] >= 0) & (rel[..., 0] < (1 << bx)) & \
        (rel[..., 1] >= 0) & (rel[..., 1] < (1 << by)) & \
        (rel[..., 2] >= 0) & (rel[..., 2] < (1 << bz))
    ok = valid & in_range
    coord_key = (rel[..., 0] << (by + bz)) | (rel[..., 1] << bz) | rel[..., 2]
    sentinel = (1 << (bx + by + bz)) - 1
    coord_key = torch.where(ok, coord_key,
                            torch.full_like(coord_key, sentinel))
    bid = torch.arange(b, dtype=torch.int64,
                       device=coords.device)[:, None] << (bx + by + bz)
    return ((coord_key | bid) - _BIAS).to(torch.int32)


def _sentinel_bits(n_batch: int) -> int:
    """Low coord-bit mask whose all-ones pattern marks a sentinel key."""
    bx, by, bz = key_layout(n_batch)
    return (1 << (bx + by + bz)) - 1


def _coord_sentinel_mask(key: torch.Tensor, n_batch: int) -> torch.Tensor:
    """True where a batched key is a (batch-local) sentinel."""
    mask = _sentinel_bits(n_batch)
    u = key.long() + _BIAS
    return (u & mask) == mask


def _unpermute(perm: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """out[perm[i]] = vals[i] for a permutation ``perm`` (sort undo)."""
    out = torch.empty_like(vals)
    out[perm.long()] = vals
    return out


def lookup_merge_b(coords: torch.Tensor, mask: torch.Tensor,
                   queries: torch.Tensor, qmask: torch.Tensor) -> torch.Tensor:
    """(B, N, 3) tables x (B, Q, 3) queries -> (B, Q) row index into each
    sample's own table, or -1, via one flat stable sort and one join scan.

    Contract: each sample's valid table rows are unique and key-sorted,
    padding last (the engine invariant).
    """
    from .pscan import join_scan
    b, n = coords.shape[:2]
    q = queries.shape[1]
    origin = batch_origin(coords, mask)
    kt = pack_key32_b(coords, mask, origin)
    kq = pack_key32_b(queries, qmask, origin)
    key = torch.cat([kt.reshape(-1), kq.reshape(-1)])
    skey, perm = torch.sort(key, stable=True)
    saux = perm.to(torch.int32)
    is_table = saux < b * n
    (lkey, lrow), = join_scan(skey, saux, ((0, b * n),),
                              sentinel_bits=_sentinel_bits(b))
    ok = (~is_table) & (lrow >= 0) & (lkey == skey) & \
        ~_coord_sentinel_mask(skey, b)
    res = torch.where(ok, torch.remainder(lrow, n), torch.full_like(lrow, -1))
    return _unpermute(saux, res)[b * n:].reshape(b, q)


def lookup_merge_multi_b(pairs) -> list:
    """K independent batched lookups in one flat stable sort and one join
    scan with K ranges.

    Args:
        pairs: list of (coords (B, Ni, 3), mask, queries (B, Qi, 3), qmask).

    Returns:
        list of (B, Qi) int32 row indices (into each sample's table) or -1.
    """
    from .pscan import join_scan
    b = pairs[0][0].shape[0]
    keys, tstarts, qstarts, tns, origins = [], [], [], [], []
    pos = 0
    for coords, mask, _, _ in pairs:
        origin = batch_origin(coords, mask)
        origins.append(origin)
        keys.append(pack_key32_b(coords, mask, origin).reshape(-1))
        tstarts.append(pos)
        tns.append(coords.shape[1])
        pos += coords.shape[0] * coords.shape[1]
    n_tables = pos
    for i, (_, _, queries, qmask) in enumerate(pairs):
        keys.append(pack_key32_b(queries, qmask, origins[i]).reshape(-1))
        qstarts.append(pos)
        pos += queries.shape[0] * queries.shape[1]
    key = torch.cat(keys)
    skey, perm = torch.sort(key, stable=True)
    saux = perm.to(torch.int32)
    is_table = saux < n_tables
    not_sent = ~_coord_sentinel_mask(skey, b)
    bounds = tstarts[1:] + [n_tables]
    res = torch.full((pos,), -1, dtype=torch.int32, device=key.device)
    scans = join_scan(skey, saux, tuple(zip(tstarts, bounds)),
                      sentinel_bits=_sentinel_bits(b))
    for i in range(len(pairs)):
        lkey_i, lrow_i = scans[i]
        ok = (lrow_i >= 0) & (lkey_i == skey) & not_sent
        q_hi = pos if i == len(pairs) - 1 else qstarts[i + 1]
        mine = (~is_table) & (saux >= qstarts[i]) & (saux < q_hi)
        res = torch.where(mine & ok, torch.remainder(lrow_i - tstarts[i],
                                                     tns[i]), res)
    res_unsorted = _unpermute(saux, res)
    out = []
    for i, (_, _, queries, _) in enumerate(pairs):
        bq = queries.shape[0] * queries.shape[1]
        out.append(res_unsorted[qstarts[i]:qstarts[i] + bq].reshape(
            queries.shape[0], queries.shape[1]))
    return out


class UniqueResult(NamedTuple):
    """Deduplicated coordinates with static capacity (batched).

    Attributes:
        coords: (B, capacity, 3) int32 unique coordinates (sorted key
            order), zero-filled past ``count``.
        mask: (B, capacity) bool validity.
        inverse: (B, N) int32 mapping each input row to its unique slot
            (-1 for masked inputs or rows dropped by capacity overflow).
        count: (B,) int32 number of unique coordinates (pre-clamp).
        rows: (B, capacity) int32 within-sample input row of each slot's
            representative (its FIRST occurrence); 0 past ``count``.
    """
    coords: torch.Tensor
    mask: torch.Tensor
    inverse: torch.Tensor
    count: torch.Tensor
    rows: torch.Tensor


def unique_coords_b(coords: torch.Tensor, mask: torch.Tensor,
                    capacity: int) -> UniqueResult:
    """(B, N, 3) -> per-sample tables of ``capacity`` unique coordinates.

    The representative of each voxel is its first occurrence; with more
    than ``capacity`` unique voxels the largest keys are dropped. Output
    order is key order, padding last (the engine invariant).
    """
    b, n = coords.shape[:2]
    dev = coords.device
    key = pack_key32_b(coords, mask)  # (B, N), batch-local sentinels
    # stable sort == the reference's (key, arange) two-key sort: ties keep
    # input order, so the first occurrence leads its run
    skey, perm = torch.sort(key.reshape(-1), stable=True)
    sk2 = skey.reshape(b, n)
    is_new = torch.ones_like(sk2, dtype=torch.bool)
    is_new[:, 1:] = sk2[:, 1:] != sk2[:, :-1]
    is_new = is_new & ~_coord_sentinel_mask(sk2, b)
    uslot = torch.cumsum(is_new.to(torch.int32), dim=1,
                         dtype=torch.int32) - 1
    count = is_new.sum(dim=1, dtype=torch.int32)

    # compaction: representative's within-sample row per (sample, slot);
    # every real target is written once, the rest land in the dump slot
    in_cap = is_new & (uslot < capacity)
    bidx = torch.arange(b, device=dev)[:, None]
    target = torch.where(in_cap, bidx * capacity + uslot,
                         torch.full_like(uslot, b * capacity, dtype=torch.int64)
                         ).reshape(-1)
    local = (perm - (perm // n) * n).to(torch.int32)
    rows = torch.zeros(b * capacity + 1, dtype=torch.int32, device=dev)
    rows[target] = local
    rows = rows[:-1].reshape(b, capacity)
    out_mask = torch.arange(capacity, device=dev)[None] < count[:, None]
    rows = torch.where(out_mask, rows, torch.zeros_like(rows))
    out_coords = torch.gather(coords, 1, rows.long()[..., None].expand(
        b, capacity, 3))
    out_coords = torch.where(out_mask[..., None], out_coords,
                             torch.zeros_like(out_coords))

    # inverse map: un-permute the per-sorted-row slot
    valid_new = (uslot < capacity) & ~_coord_sentinel_mask(sk2, b)
    inv_sorted = torch.where(valid_new, uslot, torch.full_like(uslot, -1))
    inverse = _unpermute(perm, inv_sorted.reshape(-1)).reshape(b, n)
    return UniqueResult(out_coords, out_mask, inverse, count, rows)
