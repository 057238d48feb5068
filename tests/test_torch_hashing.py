"""Port vs reference: the flat-mode coordinate engine (integers identical)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from embodiedscan_tpu.ops import hashing as jH
from embodiedscan_tpu.ops import sparse as jS
from embodiedscan_torch.ops import hashing as tH
from embodiedscan_torch.ops import sparse as tS

from test_torch_helpers import flat_engine, to_numpy

# (batch, rows, capacity): capacity below the unique count overflows
CASES = [(1, 600, 512), (2, 600, 256), (2, 300, 400)]


def _coords(rng, b, n):
    """Clustered coords with duplicates, negatives, far outliers, masking."""
    c = rng.randint(-6, 7, (b, n, 3)).astype(np.int32)
    far = rng.rand(b, n) < 0.03
    c[far, 0] += 4000  # beyond every key layout's x extent
    mask = rng.rand(b, n) > 0.1
    return c, mask


def _table(rng, b, n, cap):
    c, m = _coords(rng, b, n)
    u = jH.unique_coords_b(jnp.asarray(c), jnp.asarray(m), cap)
    return np.array(u.coords), np.array(u.mask)


def _assert_same(want, got):
    for w, g in zip(to_numpy(want), to_numpy(got)):
        np.testing.assert_array_equal(g, w)


@pytest.fixture(autouse=True)
def _flat():
    with flat_engine():
        yield


@pytest.mark.parametrize('b,n,cap', CASES)
def test_unique_coords_b(b, n, cap):
    c, m = _coords(np.random.RandomState(n + b), b, n)
    want = jH.unique_coords_b(jnp.asarray(c), jnp.asarray(m), cap)
    got = tH.unique_coords_b(torch.from_numpy(c), torch.from_numpy(m), cap)
    _assert_same(want, got)


@pytest.mark.parametrize('b,n,cap', CASES)
def test_lookup_merge_b(b, n, cap):
    rng = np.random.RandomState(7 + n + b)
    tc, tm = _table(rng, b, n, cap)
    q = tc[:, rng.randint(0, cap, 500)] + rng.randint(-1, 2, (b, 500, 3))
    q = q.astype(np.int32)
    qm = rng.rand(b, 500) > 0.2
    want = jH.lookup_merge_b(*map(jnp.asarray, (tc, tm, q, qm)))
    got = tH.lookup_merge_b(*map(torch.from_numpy, (tc, tm, q, qm)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (np.asarray(want) >= 0).any() and (np.asarray(want) < 0).any()


@pytest.mark.parametrize('b,n,cap', CASES)
def test_lookup_merge_multi_b(b, n, cap):
    rng = np.random.RandomState(11 + n + b)
    pairs_np = []
    for i in range(2):
        tc, tm = _table(rng, b, n, cap // (i + 1))
        q = (tc[:, rng.randint(0, cap // (i + 1), 300)] +
             rng.randint(-1, 2, (b, 300, 3))).astype(np.int32)
        pairs_np.append((tc, tm, q, rng.rand(b, 300) > 0.2))
    want = jH.lookup_merge_multi_b(
        [tuple(map(jnp.asarray, p)) for p in pairs_np])
    got = tH.lookup_merge_multi_b(
        [tuple(map(torch.from_numpy, p)) for p in pairs_np])
    _assert_same(want, got)


@pytest.mark.parametrize('b,n,cap', CASES)
def test_neighbor_table_b(b, n, cap):
    tc, tm = _table(np.random.RandomState(3 + n), b, n, cap)
    want = jS.neighbor_table_b(jS.SparseTensor(jnp.asarray(tc), None,
                                               jnp.asarray(tm)), jS.OFFSETS_3)
    got = tS.neighbor_table_b(tS.SparseTensor(torch.from_numpy(tc), None,
                                              torch.from_numpy(tm)),
                              tS.OFFSETS_3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize('b,n,cap', CASES)
def test_downsample_coords_b(b, n, cap):
    tc, tm = _table(np.random.RandomState(5 + n), b, n, cap)
    want = jS.downsample_coords_b(
        jS.SparseTensor(jnp.asarray(tc), None, jnp.asarray(tm)), cap // 4)
    got = tS.downsample_coords_b(
        tS.SparseTensor(torch.from_numpy(tc), None, torch.from_numpy(tm)),
        cap // 4)
    _assert_same(want, got)


@pytest.mark.parametrize('b', [1, 2, 3])
def test_topk_rows_b_ties(b):
    rng = np.random.RandomState(b)
    scores = rng.randint(-3, 4, (b, 400)).astype(np.float32) * 0.5  # ties
    mask = rng.rand(b, 400) > 0.2
    want = jS.topk_rows_b(jnp.asarray(scores), jnp.asarray(mask), 100)
    got = tS.topk_rows_b(torch.from_numpy(scores), torch.from_numpy(mask), 100)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize('b,n,cap', CASES)
def test_topk_select_b(b, n, cap):
    rng = np.random.RandomState(13 + n)
    tc, tm = _table(rng, b, n, cap)
    feats = rng.randn(b, cap, 4).astype(np.float32)
    scores = rng.randint(0, 6, (b, cap)).astype(np.float32)
    want = jS.topk_select_b(jS.SparseTensor(*map(jnp.asarray, (tc, feats,
                                                                  tm))),
                            jnp.asarray(scores), cap // 3)
    got = tS.topk_select_b(tS.SparseTensor(*map(torch.from_numpy,
                                                (tc, feats, tm))),
                           torch.from_numpy(scores), cap // 3)
    _assert_same(want, got)


def test_key_layout_and_sentinel_match():
    for b in (1, 2, 3, 4, 9, 64):
        assert tH.key_layout(b) == jH.key_layout(b)
        assert tH._sentinel_bits(b) == jH._sentinel_bits(b)
