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


def _out_of_range(nbr, n):
    """Entries N, N + 5 and -7 in three columns of every third row."""
    bad = nbr.copy()
    bad[0::3, 0] = n
    bad[1::3, 5] = n + 5
    bad[2::3, 9] = -7
    return bad


def test_out_of_range_indices_are_absent():
    # the reference reads every index outside [0, N) through its zero pad
    # row (jnp's gather clamps N + 5 onto N), as K2 does on the card
    rng = np.random.RandomState(6)
    feats, mask, nbr, w = make_case(rng, m=256)
    bias = rng.randn(w.shape[-1]).astype(np.float32)
    bad = _out_of_range(nbr, feats.shape[0])
    got = _port(feats, mask, bad, w, bias)
    np.testing.assert_allclose(got, _ref(feats, mask, bad, w, bias), **TOL)
    absent = np.where((bad >= 0) & (bad < feats.shape[0]), bad, -1)
    np.testing.assert_array_equal(got, _port(feats, mask, absent, w, bias))


def test_rejects_what_the_kernel_does_not_take():
    feats, mask, nbr, w = make_case(np.random.RandomState(5), m=8)
    args = list(map(torch.from_numpy, (feats, mask, nbr, w)))
    with pytest.raises(TypeError):
        tS.gather_matmul_conv(args[0].double(), *args[1:])
    with pytest.raises(TypeError):
        tS.gather_matmul_conv(args[0], args[1], args[2].long(), args[3])
    with pytest.raises(ValueError):
        tS.gather_matmul_conv(args[0], args[1], args[2], args[3][:, :3])


# --- the card's design, checked where the CPU can check it -----------------

GATE = 1e-4  # the card's gate: max|kernel - plain| <= GATE x max|plain|


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> TF32 (10 mantissa bits) rounded to nearest, ties away
    from zero, as ``cvt.rna.tf32.f32``: integer arithmetic on the bits."""
    u = x.contiguous().view(torch.int32)
    return ((u + 0x1000) & ~0x1FFF).view(torch.float32)


def _mma_tf32(a, b, passes):
    """a @ b as the tensor-core route sums it: float32 accumulators, one
    k=8 slice at a time, each slice adding the TF32 products in
    ``passes`` (pairs of (a part, b part), small terms first)."""
    ah, bh = _tf32(a), _tf32(b)
    parts = {'hi': (ah, bh), 'lo': (_tf32(a - ah), _tf32(b - bh))}
    acc = torch.zeros(a.shape[0], b.shape[1], dtype=torch.float32)
    for k0 in range(0, a.shape[1], 8):
        for pa, pb in passes:
            acc = acc + parts[pa][0][:, k0:k0 + 8] @ parts[pb][1][k0:k0 + 8]
    return acc


def test_3xtf32_holds_the_gate_and_1xtf32_fails_it():
    # the path's deepest reduction: K x Cin = 27 x 512 (stage 4, 512->512)
    rng = np.random.RandomState(0)
    a = rng.randn(64, 27 * 512).astype(np.float32)
    b = (rng.randn(27 * 512, 64) / np.sqrt(27 * 512)).astype(np.float32)
    ref = a.astype(np.float64) @ b.astype(np.float64)
    scale = np.abs(ref).max()
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    three = _mma_tf32(ta, tb, (('lo', 'hi'), ('hi', 'lo'), ('hi', 'hi')))
    one = _mma_tf32(ta, tb, (('hi', 'hi'),))
    err3 = np.abs(three.numpy() - ref).max()
    err1 = np.abs(one.numpy() - ref).max()
    assert err3 <= GATE * scale / 20, (err3, scale)  # holds, with margin
    assert err1 > GATE * scale, (err1, scale)        # single TF32 fails


def test_tf32_rounding_is_to_nearest_ties_away():
    x = torch.tensor([1 + 2**-11, 1 + 2**-11 + 2**-20, -(1 + 2**-11),
                      1 + 2**-12, 3.0], dtype=torch.float32)
    want = torch.tensor([1 + 2**-10, 1 + 2**-10, -(1 + 2**-10), 1.0, 3.0])
    assert torch.equal(_tf32(x), want)


# (M, K, Cin, Cout): calls per request of the full-width mv_det3d path
# (MinkResNet-34 at capacities 65536 / 24576, 8192, 4096, 2048; the FCAF3D
# head at FPN capacities 24576, 8192, 4096, 2048 with trunk channels 128,
# 256, 512, 1024)
MAIN_PATH_SHAPES = {
    (65536, 27, 3, 64): 1,                                   # stem
    (24576, 27, 64, 64): 6, (24576, 1, 64, 64): 1,           # stage 1
    (8192, 27, 64, 128): 1, (8192, 27, 128, 128): 7,         # stage 2
    (8192, 1, 64, 128): 1,
    (4096, 27, 128, 256): 1, (4096, 27, 256, 256): 11,       # stage 3
    (4096, 1, 128, 256): 1,
    (2048, 27, 256, 512): 1, (2048, 27, 512, 512): 5,        # stage 4
    (2048, 1, 256, 512): 1,
    (16384, 27, 512, 512): 1, (32768, 27, 256, 256): 1,      # FPN children
    (65536, 27, 128, 128): 1,
    (2048, 27, 1024, 128): 1, (4096, 27, 512, 128): 1,       # head convs
    (8192, 27, 256, 128): 1, (24576, 27, 128, 128): 1,
}


def test_conv_plan_on_the_main_path_shapes():
    assert sum(MAIN_PATH_SHAPES.values()) == 44
    for m, k, cin, cout in MAIN_PATH_SHAPES:
        plan = tS.conv_plan(m, k, cin, cout)
        assert plan.route == ('simt' if cin == 3 else 'tc'), (m, k, cin)
        tiles = -(-m // plan.bm) * -(-cout // plan.bn)
        assert (plan.splits > 1) == (plan.route == 'tc' and k > 1 and
                                     tiles < tS.SPLIT_BELOW_TILES)
        # the groups cover every offset once
        assert (plan.splits - 1) * plan.per_split < k
        assert plan.splits * plan.per_split >= k
        assert plan.per_split <= tS.TC_MAX_OFFSETS or plan.route == 'simt'
        if plan.splits > 1:  # the workspace bound the docstring states
            assert plan.splits * m * cout * 4 <= 9 * 264 * 64 * 64 * 4


# (M, K, Cin, Cout) -> (tile width, splits): unsplit at two waves of 64 x 64
# tiles, 128 wide there only on short reductions; split below, 128 wide from
# 64 row tiles
@pytest.mark.parametrize('shape,bn,splits', [
    ((65536, 27, 128, 128), 128, 1), ((24576, 27, 64, 64), 64, 1),
    ((16384, 27, 512, 512), 64, 1), ((32768, 27, 256, 256), 64, 1),
    ((4096, 27, 256, 256), 128, 9), ((8192, 27, 128, 128), 128, 9),
    ((4096, 27, 512, 128), 128, 9), ((2048, 27, 512, 512), 64, 9),
    ((2048, 1, 256, 512), 64, 1)])
def test_conv_plan_tiles_and_splits(shape, bn, splits):
    plan = tS.conv_plan(*shape)
    assert (plan.route, plan.bn, plan.splits) == ('tc', bn, splits)


@pytest.mark.parametrize('shape,route', [
    ((100, 27, 3, 64), 'simt'), ((100, 27, 6, 64), 'simt'),
    ((100, 27, 64, 6), 'simt'), ((100, 1, 64, 64), 'tc'),
    ((100, 28, 64, 64), 'simt')])
def test_conv_plan_routes_by_shape(shape, route):
    assert tS.conv_plan(*shape).route == route


def _split_and_reduce(feats, mask, nbr, w, bias, plan):
    """The tensor-core route's order: each offset group's partial sum, the
    groups added in order, then the bias."""
    k = nbr.shape[1]
    out = None
    for s in range(plan.splits):
        lo, hi = s * plan.per_split, min(k, (s + 1) * plan.per_split)
        part = tS._gather_matmul_conv_plain(
            feats, mask, nbr[:, lo:hi].contiguous(), w[lo:hi])
        out = part if out is None else out + part
    return out if bias is None else out + bias


@pytest.mark.parametrize('b', [1, 2])
def test_split_and_reduce_matches_plain_on_engine_tables(b):
    rng = np.random.RandomState(10 + b)
    cap, cin, cout = 512, 64, 64
    # a thin slab: fewer voxels than the capacity, most with neighbors
    pts = rng.uniform(0, 1, (b, 400, 3)) * np.array([0.2, 0.2, 0.03])
    pts = pts.astype(np.float32)
    pmask = np.ones((b, 400), bool)
    pmask[-1, 300:] = False
    st = tS.from_points_b(torch.from_numpy(pts), torch.from_numpy(pts),
                          torch.from_numpy(pmask), 0.01, cap)
    nbr = tS.neighbor_table_b(st, tS.OFFSETS_3)
    # the batch flattened into the row space, as SparseConv does
    offs = torch.arange(b, dtype=nbr.dtype)[:, None, None] * cap
    fnbr = torch.where(nbr >= 0, nbr + offs, torch.full_like(nbr, -1)
                       ).reshape(b * cap, 27)
    feats = torch.from_numpy(rng.randn(b * cap, cin).astype(np.float32))
    mask = st.mask.reshape(-1)
    w = torch.from_numpy((rng.randn(27, cin, cout) * 0.1).astype(np.float32))
    bias = torch.from_numpy(rng.randn(cout).astype(np.float32))
    plan = tS.conv_plan(b * cap, 27, cin, cout)
    assert plan.route == 'tc' and plan.splits > 1
    assert 0 < int(mask.sum()) < b * cap and bool((fnbr >= 0).any())
    got = _split_and_reduce(feats, mask, fnbr, w, bias, plan)
    want = tS._gather_matmul_conv_plain(feats, mask, fnbr, w, bias)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
