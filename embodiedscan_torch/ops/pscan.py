"""Masked running-max scans of the merge join (kernel K1).

``join_scan`` is the port of ``embodiedscan_tpu/ops/pscan.py:join_scan``. On
a CUDA tensor it launches the hand-written kernel ``csrc/join_scan.cu``: a
single-pass scan with decoupled look-back, one kernel launch per call, after
one memset of its look-back scratch when the input spans more than one tile.
On a CPU tensor it runs :func:`_join_scan_plain`, the ``torch.cummax``
version of the same function (bit-exact: only integer max is involved).
"""

import functools

import torch

from . import kernels

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


def _join_scan_cuda(skey, saux, ranges, sbits):
    n = skey.shape[0]
    k = len(ranges)
    lib = kernels.library()
    nblocks = -(-n // _tile_rows())
    # look-back status words and the tile ticket; the kernel clears them
    scratch = None
    if nblocks > 1:
        scratch = torch.empty(2 * k * nblocks + 1, dtype=torch.int64,
                              device=skey.device)
    out = torch.empty((2 * k, n), dtype=torch.int32, device=skey.device)
    flat = [v for lohi in ranges for v in lohi]
    flat += [0, 0] * (MAX_RANGES - k)
    err = lib.es_join_scan(skey.data_ptr(), saux.data_ptr(), n, k, *flat,
                           sbits, None if scratch is None else
                           scratch.data_ptr(), out.data_ptr(),
                           kernels.stream_handle(skey.device))
    kernels.check(err, 'es_join_scan')
    join_scan.launches += 1
    rows = out.unbind(0)
    return [(rows[2 * r], rows[2 * r + 1]) for r in range(k)]


@functools.lru_cache(maxsize=None)
def _tile_rows():
    """Rows per tile of the built kernel."""
    return kernels.library().es_join_scan_tile()


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
    if skey.is_cuda:
        if not (skey.is_contiguous() and saux.is_contiguous()):
            raise ValueError('join_scan: the kernel takes contiguous arrays')
        return _join_scan_cuda(skey, saux, ranges, sbits)
    if skey.device.type != 'cpu':
        raise ValueError(f'join_scan: unsupported device {skey.device}')
    return _join_scan_plain(skey, saux, ranges, sbits)


join_scan.launches = 0  # kernel launches (CUDA path only)
