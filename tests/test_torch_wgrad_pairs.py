"""K3's pair pass and chunk bounds on the CPU.

On the card K3 (``csrc/sparse_conv_wgrad.cu``) first lists, for each offset
k, the pairs (r, idx[r, k]) whose x row and gathered y row are both valid,
in ascending r, with their counts; then block z of offset k takes the pairs
``wgrad_chunk_bounds(n_k, chunks)[z]``. ``_wgrad_pairs_plain`` is the pair
pass's plain version (the card's lists are held identical to it), and
``wgrad_chunk_bounds`` mirrors the kernel's split. Here both are held
against brute force, and the fixed-order sum over the chunks against the
JAX reference's weight gradient (``jax.vjp`` of its ``gather_matmul_conv``).
Integer lists are exact; float sums agree within 1e-6 x max|ref|.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from embodiedscan_tpu.ops import sparse as jS
from embodiedscan_torch.ops import sparse as tS


def _brute_pairs(x_mask, idx, y_mask):
    """Per offset, the list of (r, j) by a plain loop over the rows."""
    r, k = idx.shape
    ny = len(y_mask)
    out = [[] for _ in range(k)]
    for row in range(r):
        for j in range(k):
            col = int(idx[row, j])
            if x_mask[row] and 0 <= col < ny and y_mask[col]:
                out[j].append((row, col))
    return out


def _check_pairs(x_mask, idx, y_mask):
    pairs, counts = tS._wgrad_pairs_plain(*map(torch.from_numpy,
                                               (x_mask, idx, y_mask)))
    want = _brute_pairs(x_mask, idx, y_mask)
    assert pairs.shape == (idx.shape[1], idx.shape[0], 2)
    assert counts.dtype == torch.int32 and pairs.dtype == torch.int32
    for j, lst in enumerate(want):
        n = len(lst)
        assert int(counts[j]) == n
        got = pairs[j].numpy()
        np.testing.assert_array_equal(got[:n], np.array(lst, np.int32)
                                      .reshape(n, 2))
        assert (got[n:] == -1).all()
    return counts.numpy()


def _random_case(rng, r, ny, k, hit):
    x_mask = rng.rand(r) > 0.1
    y_mask = rng.rand(ny) > 0.1
    idx = np.where(rng.rand(r, k) < hit, rng.randint(0, ny, (r, k)),
                   -1).astype(np.int32)
    return x_mask, idx, y_mask


@pytest.mark.parametrize('seed', [0, 1, 2, 3])
def test_pairs_plain_matches_brute_force(seed):
    rng = np.random.RandomState(seed)
    x_mask, idx, y_mask = _random_case(rng, 300 + 37 * seed, 200, 27, 0.3)
    idx[5, 3] = 200  # outside [0, ny): absent, as on the card
    counts = _check_pairs(x_mask, idx, y_mask)
    assert counts.sum() > 0


@pytest.mark.parametrize('case', ['one_offset_empty', 'all_empty',
                                  'counts_1_31_32_33', 'ragged_r', 'r1',
                                  'all_masked_x', 'all_masked_y'])
def test_pairs_plain_edge_cases(case):
    rng = np.random.RandomState(11)
    r, ny, k = {'ragged_r': (77, 50, 27), 'r1': (1, 5, 27)}.get(
        case, (200, 150, 27))
    x_mask, idx, y_mask = _random_case(rng, r, ny, k, 0.3)
    x_mask[:] = True
    y_mask[:] = True
    if case == 'one_offset_empty':
        idx[:, 13] = -1
    elif case == 'all_empty':
        idx[:] = -1
    elif case == 'counts_1_31_32_33':
        idx[:, :4] = -1
        for j, n in enumerate((1, 31, 32, 33)):
            idx[:n, j] = np.arange(n) % ny
    elif case == 'all_masked_x':
        x_mask[:] = False
    elif case == 'all_masked_y':
        y_mask[:] = False
    counts = _check_pairs(x_mask, idx, y_mask)
    if case == 'one_offset_empty':
        assert counts[13] == 0 and counts.sum() > 0
    elif case in ('all_empty', 'all_masked_x', 'all_masked_y'):
        assert counts.sum() == 0
    elif case == 'counts_1_31_32_33':
        assert list(counts[:4]) == [1, 31, 32, 33]


@pytest.mark.parametrize('n', [0, 1, 31, 32, 33, 5000])
@pytest.mark.parametrize('chunks', [1, 3, 10])
def test_chunk_bounds_cover_each_pair_once_in_order(n, chunks):
    bounds = tS.wgrad_chunk_bounds(n, chunks)
    c = tS.wgrad_chunk_pairs(n, chunks)
    assert c % 32 == 0 and c >= tS.WG_MIN_CHUNK
    assert 1 <= len(bounds) <= chunks
    assert bounds[0][0] == 0 and bounds[-1][1] == n
    for (a0, a1), (b0, b1) in zip(bounds, bounds[1:]):
        assert a1 == b0  # contiguous and ascending: each pair once
    for z, (p0, p1) in enumerate(bounds):
        assert p0 == min(n, z * c) and p1 == min(n, p0 + c)
        assert n == 0 or p1 > p0  # only filled chunks write
    # every chunk but the last holds the same number of pairs
    assert len({p1 - p0 for p0, p1 in bounds[:-1]}) <= 1


def test_chunked_pair_sum_matches_the_reference_weight_gradient():
    """G over the compacted pairs, chunk by chunk in order, as the card sums
    it, against the weight gradient of the JAX reference's gather conv."""
    rng = np.random.RandomState(5)
    n, m, k, cin, cout = 2000, 1800, 27, 16, 8
    feats = rng.randn(n, cin).astype(np.float32)
    mask = rng.rand(n) > 0.1
    nbr = np.where(rng.rand(m, k) < 0.3, rng.randint(0, n, (m, k)),
                   -1).astype(np.int32)
    dout = rng.randn(m, cout).astype(np.float32)
    w = rng.randn(k, cin, cout).astype(np.float32)
    _, vjp = jax.vjp(lambda w_: jS.gather_matmul_conv(
        jnp.asarray(feats), jnp.asarray(mask), jnp.asarray(nbr), w_),
        jnp.asarray(w))
    want = np.asarray(vjp(jnp.asarray(dout))[0])
    # the generic route: x = dout (every output row valid), y = feats
    x, y = torch.from_numpy(dout), torch.from_numpy(feats)
    pairs, counts = tS._wgrad_pairs_plain(
        torch.ones(m, dtype=torch.bool), torch.from_numpy(nbr),
        torch.from_numpy(mask))
    chunks = tS.wgrad_plan(m, k, cout, cin).chunks
    g = torch.zeros(k, cout, cin)
    for j in range(k):
        for p0, p1 in tS.wgrad_chunk_bounds(int(counts[j]), chunks):
            rows, cols = pairs[j, p0:p1, 0].long(), pairs[j, p0:p1, 1].long()
            g[j] = g[j] + x[rows].T @ y[cols]
    np.testing.assert_allclose(g.transpose(1, 2).numpy(), want, rtol=0,
                               atol=1e-6 * np.abs(want).max())


def test_kernel_constants_match_the_plan():
    """The chunk split, the pair-pass blocks and the tensor-core block's
    shared memory that ops/sparse.py mirrors are the kernel's own."""
    import re
    from pathlib import Path
    src = (Path(tS.__file__).resolve().parent.parent / 'csrc' /
           'sparse_conv_wgrad.cu').read_text()
    consts = {m[0]: int(m[1]) for m in
              re.findall(r'constexpr int (\w+) = (\d+);', src)}
    assert consts['WG_STEP'] == tS.WG_STEP
    assert consts['WG_MIN_CHUNK'] == tS.WG_MIN_CHUNK
    assert consts['WG_STAGES'] == tS.WG_STAGES
    assert consts['WN_WIDE'] == tS.WN_WIDE
    assert consts['WN_NARROW'] == tS.WN_NARROW
    assert tS._wgrad_meta_words(consts['WP_ROWS'] + 1, 27) == \
        tS._wgrad_meta_words(2 * consts['WP_ROWS'], 27) > \
        tS._wgrad_meta_words(consts['WP_ROWS'], 27)
