"""Port vs reference: the merge-join scan (kernel K1's plain version) is
bit-exact against ``_join_scan_lax`` and the interpreted Pallas kernel."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from embodiedscan_tpu.ops import pscan as jP
from embodiedscan_torch.ops import pscan as tP

from test_torch_helpers import to_numpy


def _random_case(rng, n, k):
    skey = np.sort(rng.randint(-2**31, 2**31 - 1, n)).astype(np.int32)
    saux = rng.permutation(n).astype(np.int32)
    cuts = sorted(rng.choice(n, 2 * k, replace=False))
    ranges = tuple((int(cuts[2 * i]), int(cuts[2 * i + 1])) for i in range(k))
    return skey, saux, ranges


# the cases of tests/test_pscan.py
PSCAN_CASES = [
    (1000, 1, 0),               # single range, smaller than one block
    (70001, 3, 0),              # multi-block + pad path (odd length)
    (40000, 2, (1 << 30) - 1),  # sentinel-bit exclusion
]


def _port(skey, saux, ranges, sbits):
    return to_numpy(tP.join_scan(torch.from_numpy(skey),
                                 torch.from_numpy(saux), ranges, sbits))


def _assert_equal(want, got):
    assert len(want) == len(got)
    for (wk, wr), (gk, gr) in zip(to_numpy(want), got):
        np.testing.assert_array_equal(gk, wk)
        np.testing.assert_array_equal(gr, wr)


# the card's kernel scans tiles of 2048 rows: one tile, and one tile plus a
# row (the first input that looks back), as chip_smoke.py runs them
TILE_EDGE_CASES = [(2048, 2, 0), (2049, 3, (1 << 20) - 1)]


@pytest.mark.parametrize('n,k,sbits', PSCAN_CASES + TILE_EDGE_CASES)
def test_plain_matches_lax(n, k, sbits):
    skey, saux, ranges = _random_case(np.random.RandomState(n + k), n, k)
    want = jP._join_scan_lax(jnp.asarray(skey), jnp.asarray(saux), ranges,
                             sbits)
    _assert_equal(want, _port(skey, saux, ranges, sbits))


@pytest.mark.parametrize('n,k,sbits', PSCAN_CASES)
def test_plain_matches_pallas_interpret(monkeypatch, n, k, sbits):
    skey, saux, ranges = _random_case(np.random.RandomState(n + k), n, k)
    monkeypatch.setenv('EMBODIEDSCAN_PALLAS_INTERPRET', '1')
    want = jP._join_scan_pallas(jnp.asarray(skey), jnp.asarray(saux), ranges,
                                sbits)
    _assert_equal(want, _port(skey, saux, ranges, sbits))


@pytest.mark.parametrize('bits', [0xFFFFFFFF, (1 << 31) | 0xFFFF])
def test_sentinel_mask_wraps_like_reference(bits):
    # b=1 keys use all 32 bits: the mask 0xFFFFFFFF wraps to int32 -1, and
    # any mask with bit 31 set is a negative int32 pattern
    rng = np.random.RandomState(bits & 0xFF)
    skey, saux, ranges = _random_case(rng, 5000, 1)
    skey[-7:] = 2**31 - 1  # sentinels of the 32-bit layout (u = 0xFFFFFFFF)
    skey[100:103] = np.int32(-1)  # u = 0x7FFFFFFF
    skey = np.sort(skey)
    want = jP.join_scan(jnp.asarray(skey), jnp.asarray(saux), ranges, bits)
    _assert_equal(want, _port(skey, saux, ranges, bits))


def test_rejects_what_the_kernel_does_not_take():
    key = torch.arange(10, dtype=torch.int32)
    with pytest.raises(TypeError):
        tP.join_scan(key.long(), key, ((0, 5),))
    with pytest.raises(ValueError):
        tP.join_scan(key, key[:5], ((0, 5),))
    with pytest.raises(ValueError):
        tP.join_scan(key, key, ((0, 1), (1, 2), (2, 3), (3, 4)))
