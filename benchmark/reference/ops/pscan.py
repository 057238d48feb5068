"""Masked running-max scans of the merge join, in plain PyTorch
(``torch.cummax``): the benchmark's frozen reference.
"""

import torch

_IMIN = -2**31
MAX_RANGES = 3


def _join_scan_plain(skey, saux, ranges, sbits):
    not_sent = torch.ones_like(skey, dtype=torch.bool)
    if sbits:
        u = skey ^ _IMIN
        not_sent = (u & sbits) != sbits
    kfill = torch.full_like(skey, _IMIN)
    afill = torch.full_like(saux, -1)
    res = []
    for lo, hi in ranges:
        sel = (saux >= lo) & (saux < hi) & not_sent
        res.append((torch.cummax(torch.where(sel, skey, kfill), 0).values,
                    torch.cummax(torch.where(sel, saux, afill), 0).values))
    return res


def join_scan(skey: torch.Tensor, saux: torch.Tensor, ranges,
              sentinel_bits: int = 0):
    """Masked cummax pairs for the merge join.

    Args:
        skey: (N,) int32 sorted merged keys.
        saux: (N,) int32 merged aux (table rows in their concat ranges).
        ranges: tuple of (lo, hi) — per lookup pair, the half-open aux
            interval holding that pair's table rows (at most 3).
        sentinel_bits: if nonzero, additionally exclude rows whose key has
            ALL of these low bits set (batched-key sentinel rows).

    Returns:
        list of (lkey, lrow) per range: running max of the masked key/aux —
        the last table entry at-or-before each merged position.
    """
    ranges = tuple((int(lo), int(hi)) for lo, hi in ranges)
    # two's-complement wrap: the mask is a bit pattern, not a magnitude
    # (b=1 keys use all 32 bits -> mask 0xFFFFFFFF -> int32 -1)
    sbits = int(sentinel_bits) & 0xFFFFFFFF
    if sbits >= 1 << 31:
        sbits -= 1 << 32
    if skey.dtype != torch.int32 or saux.dtype != torch.int32:
        raise TypeError('join_scan takes int32 keys and aux')
    if skey.dim() != 1 or skey.shape != saux.shape or skey.shape[0] == 0:
        raise ValueError('join_scan takes two non-empty (N,) arrays of one '
                         f'length, got {tuple(skey.shape)}, {tuple(saux.shape)}')
    if not 1 <= len(ranges) <= MAX_RANGES:
        raise ValueError(f'join_scan takes 1..{MAX_RANGES} ranges')
    if skey.device != saux.device:
        raise ValueError('skey and saux lie on different devices')
    return _join_scan_plain(skey, saux, ranges, sbits)
