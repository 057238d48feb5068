"""Port vs reference: the sparse conv core (kernel K2's plain version)
against ``gather_matmul_conv`` and the interpreted banded Pallas kernel.

Tolerance atol 1e-4, rtol 1e-5: float32 sums of up to K * Cin products
taken in a different order on each side.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from embodiedscan_tpu.experimental import pallas_conv as PC
from embodiedscan_tpu.ops import sparse as jS
from embodiedscan_torch.ops import sparse as tS

TOL = dict(atol=1e-4, rtol=1e-5)


def make_case(rng, n=2048, m=1024, k=27, c=16, cout=8, local=True,
              absent_rows=0):
    """The cases of tests/test_pallas_conv.py: masked tail rows, monotone
    near-diagonal neighbor indices, 30% absent entries."""
    feats = rng.randn(n, c).astype(np.float32)
    mask = np.ones(n, bool)
    mask[n - 50:] = False
    if local:
        base = np.sort(rng.randint(0, n - 200, m))
        nbr = np.minimum(base[:, None] + rng.randint(0, 128, (m, k)), n - 1)
    else:
        nbr = rng.randint(0, n, (m, k))
    nbr = np.where(rng.rand(m, k) < 0.3, -1, nbr).astype(np.int32)
    nbr[:absent_rows] = -1
    w = (rng.randn(k, c, cout) * 0.1).astype(np.float32)
    return feats, mask, nbr, w


def _port(feats, mask, nbr, w, bias=None):
    return tS.gather_matmul_conv(
        torch.from_numpy(feats), torch.from_numpy(mask),
        torch.from_numpy(nbr), torch.from_numpy(w),
        None if bias is None else torch.from_numpy(bias)).numpy()


def _ref(feats, mask, nbr, w, bias=None):
    return np.asarray(jS.gather_matmul_conv(
        jnp.asarray(feats), jnp.asarray(mask), jnp.asarray(nbr),
        jnp.asarray(w), None if bias is None else jnp.asarray(bias)))


CASES = {
    'local': dict(),
    'wild_indices': dict(local=False),
    'k1': dict(k=1, c=32, cout=16),
    'stem_cin3': dict(c=3, cout=64),
    'absent_rows': dict(absent_rows=128),
}


@pytest.mark.parametrize('name', list(CASES))
def test_plain_matches_gather_matmul_conv(name):
    feats, mask, nbr, w = make_case(np.random.RandomState(len(name)),
                                    **CASES[name])
    np.testing.assert_allclose(_port(feats, mask, nbr, w),
                               _ref(feats, mask, nbr, w), **TOL)


def test_bias_and_masked_rows():
    rng = np.random.RandomState(2)
    feats, mask, nbr, w = make_case(rng)
    mask[::7] = False
    bias = rng.randn(w.shape[-1]).astype(np.float32)
    got = _port(feats, mask, nbr, w, bias)
    np.testing.assert_allclose(got, _ref(feats, mask, nbr, w, bias), **TOL)
    # masked input rows read as zero whatever they hold
    feats[~mask] = 1e6
    np.testing.assert_allclose(_port(feats, mask, nbr, w, bias), got, **TOL)


@pytest.mark.parametrize('name', ['local', 'stem_cin3', 'absent_rows'])
def test_plain_matches_banded_pallas_interpret(name):
    feats, mask, nbr, w = make_case(np.random.RandomState(len(name)),
                                    **CASES[name])
    assert bool(PC.band_coverage_ok(jnp.asarray(nbr)))
    safe = np.where(mask[:, None], feats, 0)
    want = PC.banded_conv_pallas(jnp.asarray(safe), jnp.asarray(nbr),
                                 jnp.asarray(w), interpret=True)
    np.testing.assert_allclose(_port(feats, mask, nbr, w), np.asarray(want),
                               **TOL)


def test_all_absent_rows_are_bias_only():
    rng = np.random.RandomState(4)
    feats, mask, nbr, w = make_case(rng, m=64)
    nbr[:] = -1
    bias = rng.randn(w.shape[-1]).astype(np.float32)
    np.testing.assert_array_equal(_port(feats, mask, nbr, w, bias),
                                  np.broadcast_to(bias, (64, w.shape[-1])))


def test_rejects_what_the_kernel_does_not_take():
    feats, mask, nbr, w = make_case(np.random.RandomState(5), m=8)
    args = list(map(torch.from_numpy, (feats, mask, nbr, w)))
    with pytest.raises(TypeError):
        tS.gather_matmul_conv(args[0].double(), *args[1:])
    with pytest.raises(TypeError):
        tS.gather_matmul_conv(args[0], args[1], args[2].long(), args[3])
    with pytest.raises(ValueError):
        tS.gather_matmul_conv(args[0], args[1], args[2], args[3][:, :3])
