"""Port vs reference: the sparse conv's three autograd routes (submanifold,
strided with its transpose table, generic) against ``jax.vjp`` of the
reference's ``subm_gather_conv``, ``strided_gather_conv`` and
``gather_matmul_conv``, on real engine tables of a small level at b=2.

On the CPU the routes take the kernels' plain versions (K2's for dfeats,
K3's ``_conv_wgrad_plain`` for dW), so this checks the backward formulas:
the mirror identity, the transpose table with the coarse batch offset, and
the masks. Integer tables are exact. Gradients agree within 1e-5 x max|ref|
plus rtol 1e-5: float32 sums of up to a few hundred rows x K x C products,
taken in another order on each side.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from embodiedscan_tpu.models import sparse_nn as jSN
from embodiedscan_tpu.ops import sparse as jS
from embodiedscan_torch.models import sparse_nn as tSN
from embodiedscan_torch.ops import sparse as tS

from test_torch_helpers import flat_engine, to_numpy

CAP, CCAP = 512, 256  # fine and coarse capacities of the level


def _close(got, want):
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * scale)


@pytest.fixture(scope='module')
def level():
    """A b=2 level of 500 points in a 0.3 x 0.3 x 0.1 m slab at 0.02 m
    (about 40% of the cells occupied, so most voxels have neighbors) with
    its downsample and stage tables on both sides."""
    rng = np.random.RandomState(0)
    pts = (rng.uniform(0, 1, (2, 500, 3)) * [0.3, 0.3, 0.1]).astype(
        np.float32)
    pmask = np.ones((2, 500), bool)
    pmask[1, 400:] = False
    with flat_engine():
        jst = jS.from_points_b(jnp.asarray(pts), jnp.asarray(pts),
                               jnp.asarray(pmask), 0.02, CAP)
        jd = jS.downsample_coords_b(jst, CCAP)
        jt = to_numpy(jSN.stage_tables(jst, jd, with_transpose=True))
        jcc = to_numpy(jax.vmap(jS.center_child_index)(jst, jd))
        jn27 = to_numpy(jS.neighbor_table_b(jst, jS.OFFSETS_3))
    tst = tS.from_points_b(torch.from_numpy(pts), torch.from_numpy(pts),
                           torch.from_numpy(pmask), 0.02, CAP)
    td = tS.downsample_coords_b(tst, CCAP)
    tt = tSN.stage_tables(tst, td, with_transpose=True)
    return dict(jax=(jt, jcc, jn27),
                torch=(to_numpy(tt), to_numpy(tS.center_child_index(tst, td)),
                       to_numpy(tS.neighbor_table_b(tst, tS.OFFSETS_3))),
                mask=to_numpy(tst.mask), cmask=to_numpy(td.mask),
                tables=(*tt, tS.center_child_index(tst, td)))


def test_tables_identical(level):
    (js, jn, jt), jcc, j27 = level['jax']
    (ts, tn, tt), tcc, t27 = level['torch']
    for got, want in ((ts, js), (tn, jn), (tt, jt), (tcc, jcc), (t27, j27)):
        np.testing.assert_array_equal(got, want)
    # every valid fine voxel is gathered by its parent at some offset
    np.testing.assert_array_equal((tt >= 0).any(-1), level['mask'])


def test_transpose_table_is_the_transpose(level):
    # t_nbr[j, k] = m  <=>  s_nbr[m, k] = j, sample by sample
    (ts, _, tt), _, _ = level['torch']
    for b in range(ts.shape[0]):
        fwd = {(int(j), k, m) for m, k in zip(*np.nonzero(ts[b] >= 0))
               for j in [ts[b, m, k]]}
        bwd = {(j, k, int(tt[b, j, k])) for j, k in
               zip(*np.nonzero(tt[b] >= 0))}
        assert fwd == bwd and fwd


def _flat(table, rows):
    return tSN._flat_table(table, rows)


def _inputs(rng, n, cin, m, cout, k):
    feats = rng.randn(n, cin).astype(np.float32)
    w = (rng.randn(k, cin, cout) / np.sqrt(k * cin)).astype(np.float32)
    dout = rng.randn(m, cout).astype(np.float32)
    return feats, w, dout


def _port_grads(fn, feats, w, dout, feats_grad=True):
    f = torch.from_numpy(feats).requires_grad_(feats_grad)
    wt = torch.from_numpy(w).requires_grad_()
    out = fn(f, wt)
    out.backward(torch.from_numpy(dout))
    return (f.grad.numpy() if feats_grad else None), wt.grad.numpy(), \
        out.detach().numpy()


def _jax_grads(fn, feats, w, dout):
    out, vjp = jax.vjp(fn, jnp.asarray(feats), jnp.asarray(w))
    df, dw = vjp(jnp.asarray(dout))
    return np.asarray(df), np.asarray(dw), np.asarray(out)


@pytest.mark.parametrize('c', [(8, 16), (16, 8)])
def test_subm_route(level, c):
    cin, cout = c
    _, tn, _, _ = level['tables']
    nbr = _flat(tn, CCAP)
    mask = level['cmask'].reshape(-1)
    feats, w, dout = _inputs(np.random.RandomState(cin), 2 * CCAP, cin,
                             2 * CCAP, cout, 27)
    jm, jn = jnp.asarray(mask), jnp.asarray(nbr.numpy())
    want = _jax_grads(lambda f, w_: jS.subm_gather_conv(f, jm, jn, w_),
                      feats, w, dout)
    tm = torch.from_numpy(mask)
    got = _port_grads(lambda f, w_: tS.subm_gather_conv(f, tm, nbr, w_),
                      feats, w, dout)
    for g, r in zip(got, want):
        _close(g, r)


@pytest.mark.parametrize('c', [(8, 16), (16, 8)])
def test_strided_route(level, c):
    cin, cout = c
    ts, _, tt, _ = level['tables']
    nbr, t_nbr = _flat(ts, CAP), _flat(tt, CCAP)
    mask = level['mask'].reshape(-1)
    omask = level['cmask'].reshape(-1)
    feats, w, dout = _inputs(np.random.RandomState(cout), 2 * CAP, cin,
                             2 * CCAP, cout, 27)
    jm, jn, jt = (jnp.asarray(a) for a in (mask, nbr.numpy(), t_nbr.numpy()))
    want = _jax_grads(
        lambda f, w_: jS.strided_gather_conv(f, jm, jn, jt, w_), feats, w,
        dout)
    tm, tom = torch.from_numpy(mask), torch.from_numpy(omask)
    got = _port_grads(
        lambda f, w_: tS.strided_gather_conv(f, tm, nbr, t_nbr, w_, tom),
        feats, w, dout)
    for g, r in zip(got, want):
        _close(g, r)


@pytest.mark.parametrize('case', ['k1_downsample', 'k27_cin3_stem'])
def test_generic_route(level, case):
    ts, _, _, tcc = level['tables']
    mask = level['mask'].reshape(-1)
    omask = level['cmask'].reshape(-1)
    if case == 'k1_downsample':
        nbr, k, cin, cout, feats_grad = _flat(tcc, CAP), 1, 16, 32, True
    else:  # the stem: Cin = 3 and an input that needs no gradient
        nbr, k, cin, cout, feats_grad = _flat(ts, CAP), 27, 3, 16, False
    feats, w, dout = _inputs(np.random.RandomState(k), 2 * CAP, cin,
                             2 * CCAP, cout, k)
    jm, jn = jnp.asarray(mask), jnp.asarray(nbr.numpy())
    want = _jax_grads(lambda f, w_: jS.gather_matmul_conv(f, jm, jn, w_),
                      feats, w, dout)
    tm, tom = torch.from_numpy(mask), torch.from_numpy(omask)
    got = _port_grads(
        lambda f, w_: tS.generic_gather_conv(f, tm, nbr, w_, tom), feats, w,
        dout, feats_grad)
    for g, r in zip(got, want):
        if g is not None:
            _close(g, r)


def test_generic_route_out_of_range_indices(level):
    """Indices N, N + 5 and -7 are absent: no output, no input gradient, no
    weight gradient (the reference's gather clamps them onto its zero pad
    row, whose gradient it drops)."""
    ts, _, _, _ = level['tables']
    mask = level['mask'].reshape(-1)
    omask = level['cmask'].reshape(-1)
    nbr = _flat(ts, CAP).numpy().copy()
    n = 2 * CAP
    nbr[0::3, 0] = n
    nbr[1::3, 5] = n + 5
    nbr[2::3, 9] = -7
    feats, w, dout = _inputs(np.random.RandomState(9), n, 8, 2 * CCAP, 16,
                             27)
    jm, jn = jnp.asarray(mask), jnp.asarray(nbr)
    want = _jax_grads(lambda f, w_: jS.gather_matmul_conv(f, jm, jn, w_),
                      feats, w, dout)
    tm, tom, tn = (torch.from_numpy(a) for a in (mask, omask, nbr))
    got = _port_grads(
        lambda f, w_: tS.generic_gather_conv(f, tm, tn, w_, tom), feats, w,
        dout)
    for g, r in zip(got, want):
        _close(g, r)


def _graph_names(t):
    seen, todo = set(), [t.grad_fn]
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        todo.extend(f for f, _ in fn.next_functions)
    return {type(f).__name__ for f in seen}


@pytest.mark.parametrize('route', ['Subm', 'Strided', 'Generic'])
def test_sparse_conv_graph_holds_its_route(route):
    feats = torch.ones(1, 6, 4)
    mask = torch.ones(1, 6, dtype=torch.bool)
    nbr27 = torch.full((1, 6, 27), -1, dtype=torch.int32)
    omask = torch.ones(1, 3, dtype=torch.bool)
    conv = tSN.SparseConv(4, 4, 27 if route != 'Generic' else 1)
    run = {'Subm': lambda: conv(feats, mask, nbr27),
           'Strided': lambda: conv(feats, mask, nbr27[:, :3], omask, nbr27),
           'Generic': lambda: conv(feats, mask, nbr27[:, :3, :1], omask)}
    assert f'_{route}ConvBackward' in _graph_names(run[route]())
    with torch.no_grad():  # the serving path builds no Function
        assert run[route]().grad_fn is None


# --- K3's plain version, its plan and the card's chunked order ---------------


def _dense_wgrad(x, x_mask, idx, y, y_mask):
    """G[k] = sum_r x[r]^T y[idx[r, k]] through a dense one-hot gather, in
    float64."""
    r, k = idx.shape
    onehot = np.zeros((r, k, y.shape[0]))
    rr, kk = np.nonzero(idx >= 0)
    onehot[rr, kk, idx[rr, kk]] = 1.0
    xs = np.where(x_mask[:, None], x, 0).astype(np.float64)
    ys = np.where(y_mask[:, None], y, 0).astype(np.float64)
    return np.einsum('rc,rkn,nd->kcd', xs, onehot, ys)


@pytest.mark.parametrize('shape', [(300, 27, 16, 8), (97, 1, 8, 32),
                                   (250, 27, 64, 3), (64, 27, 3, 3)])
def test_conv_wgrad_plain_matches_dense(shape):
    r, k, cx, cy = shape
    rng = np.random.RandomState(r)
    ny = 200
    x = rng.randn(r, cx).astype(np.float32)
    y = rng.randn(ny, cy).astype(np.float32)
    x_mask, y_mask = rng.rand(r) > 0.1, rng.rand(ny) > 0.1
    idx = np.where(rng.rand(r, k) < 0.3, rng.randint(0, ny, (r, k)),
                   -1).astype(np.int32)
    got = tS.conv_wgrad(*map(torch.from_numpy, (x, x_mask, idx, y, y_mask)))
    _close(got.numpy(), _dense_wgrad(x, x_mask, idx, y, y_mask))


def test_conv_wgrad_out_of_range_rows_are_absent():
    rng = np.random.RandomState(3)
    r, k, ny = 120, 27, 50
    x = rng.randn(r, 8).astype(np.float32)
    y = rng.randn(ny, 16).astype(np.float32)
    x_mask, y_mask = rng.rand(r) > 0.1, rng.rand(ny) > 0.1
    idx = np.where(rng.rand(r, k) < 0.5, rng.randint(0, ny, (r, k)),
                   -1).astype(np.int32)
    idx[0::3, 0], idx[1::3, 5], idx[2::3, 9] = ny, ny + 5, -7
    got = tS.conv_wgrad(*map(torch.from_numpy, (x, x_mask, idx, y, y_mask)))
    _close(got.numpy(), _dense_wgrad(x, x_mask, np.where(idx < ny, idx, -1),
                                     y, y_mask))
    pairs, counts = tS._wgrad_pairs_plain(
        torch.from_numpy(x_mask), torch.from_numpy(idx),
        torch.from_numpy(y_mask))
    hit = pairs[..., 1]
    assert ((hit == -1) | ((hit >= 0) & (hit < ny))).all()
    assert int(counts.sum()) == int((hit >= 0).sum())


def test_conv_wgrad_all_absent_and_all_masked_are_zero():
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(40, 8).astype(np.float32))
    y = torch.from_numpy(rng.randn(30, 8).astype(np.float32))
    ones_x, ones_y = torch.ones(40, dtype=torch.bool), torch.ones(
        30, dtype=torch.bool)
    idx = torch.from_numpy(rng.randint(0, 30, (40, 27)).astype(np.int32))
    absent = torch.full_like(idx, -1)
    assert not tS.conv_wgrad(x, ones_x, absent, y, ones_y).any()
    assert not tS.conv_wgrad(x, ~ones_x, idx, y, ones_y).any()
    assert not tS.conv_wgrad(x, ones_x, idx, y, ~ones_y).any()


def test_conv_wgrad_rejects_what_the_kernel_does_not_take():
    x = torch.zeros(4, 8)
    m = torch.ones(4, dtype=torch.bool)
    idx = torch.zeros(4, 2, dtype=torch.int32)
    with pytest.raises(TypeError):
        tS.conv_wgrad(x.double(), m, idx, x, m)
    with pytest.raises(TypeError):
        tS.conv_wgrad(x, m, idx.long(), x, m)
    with pytest.raises(ValueError):
        tS.conv_wgrad(x, m, idx[:3], x, m)


# (R, K, Cx, Cy) of the full-width train step's K3 calls: subm (x = feats,
# y = dout), strided (x = feats over the transpose table), generic
# (x = dout, y = feats; the stem and the K = 1 downsamples)
TRAIN_WGRAD_SHAPES = {
    (65536, 27, 64, 3): 1,                                   # stem (simt)
    (24576, 27, 64, 64): 5, (32768, 27, 64, 64): 1,          # stage 1
    (24576, 1, 64, 64): 1,
    (24576, 27, 64, 128): 1, (8192, 27, 128, 128): 7,        # stage 2
    (8192, 1, 128, 64): 1,
    (8192, 27, 128, 256): 1, (4096, 27, 256, 256): 11,       # stage 3
    (4096, 1, 256, 128): 1,
    (4096, 27, 256, 512): 1, (2048, 27, 512, 512): 5,        # stage 4
    (2048, 1, 512, 256): 1,
    (16384, 27, 512, 512): 1, (32768, 27, 256, 256): 1,      # FPN children
    (65536, 27, 128, 128): 1,
    (2048, 27, 1024, 128): 1, (4096, 27, 512, 128): 1,       # head convs
    (8192, 27, 256, 128): 1, (24576, 27, 128, 128): 1,
}


def _slots(plan):
    """Blocks of this plan the card keeps resident."""
    if plan.route == 'narrow':
        return tS.NUM_SMS * tS.WN_BLOCKS_PER_SM
    per_sm = tS.SMEM_PER_SM // (tS.wgrad_smem(plan.bm, plan.bn) +
                                tS.SMEM_PER_BLOCK)
    return tS.NUM_SMS * max(1, per_sm)


def test_wgrad_plan_on_the_train_step_shapes():
    assert sum(TRAIN_WGRAD_SHAPES.values()) == 44
    for r, k, cx, cy in TRAIN_WGRAD_SHAPES:
        plan = tS.wgrad_plan(r, k, cx, cy)
        shape = (r, k, cx, cy)
        if cy == 3:  # the stem: 64 x channels by the 3 y channels (of 4)
            assert plan[:3] == ('narrow', 64, 4), shape
        else:
            assert plan[:3] == ('tc', 128 if cx >= 128 else 64,
                                128 if cy >= 128 else 64), shape
        # the 128 x 128 tile of two warpgroups fits the card's 227 KB
        assert tS.wgrad_smem(plan.bm, plan.bn) <= 232448
        # unsplit when the tiles of G fill two waves; else enough chunks for
        # the wave target, unless fuller chunks than an offset can have or
        # the workspace cap stop them first
        tiles = k * -(-cx // plan.bm) * -(-cy // plan.bn)
        assert 1 <= plan.chunks <= max(1, -(-r // tS.WG_MIN_CHUNK)), shape
        assert plan.chunks == 1 or \
            plan.chunks * k * cx * cy * 4 <= tS.WG_MAX_WS_BYTES, shape
        if tiles >= 2 * _slots(plan):
            assert plan.chunks == 1, shape
        else:
            assert tiles * plan.chunks >= tS.WG_WAVES * _slots(plan) or \
                plan.chunks == -(-r // tS.WG_MIN_CHUNK) or \
                (plan.chunks + 1) * k * cx * cy * 4 > tS.WG_MAX_WS_BYTES, \
                shape
    # the two big FPN-child calls are no longer one chunk
    assert tS.wgrad_plan(32768, 27, 256, 256).chunks >= 4
    assert tS.wgrad_plan(65536, 27, 128, 128).chunks >= 4


@pytest.mark.parametrize('shape,tile', [
    ((100, 27, 64, 3), ('narrow', 64, 4)),
    ((100, 27, 3, 64), ('narrow', 4, 64)),
    ((100, 27, 64, 6), ('narrow', 64, 4)),
    ((100, 1, 8, 8), ('tc', 64, 64)),
    ((100, 27, 12, 64), ('tc', 64, 64)),
    ((100, 27, 256, 128), ('tc', 128, 128)),
    ((100, 27, 1024, 64), ('tc', 128, 64))])
def test_wgrad_plan_routes_by_shape(shape, tile):
    assert tS.wgrad_plan(*shape)[:3] == tile


def test_chunked_fixed_order_sum_matches_plain():
    """The card's order: each offset's compacted pairs cut into the plan's
    chunks, each chunk's partial G, the chunks added in order, against the
    plain version within 1e-6 x max|ref|."""
    rng = np.random.RandomState(7)
    r, k, cx, cy, ny = 3000, 27, 16, 16, 2500
    x = torch.from_numpy(rng.randn(r, cx).astype(np.float32))
    y = torch.from_numpy(rng.randn(ny, cy).astype(np.float32))
    xm = torch.from_numpy(rng.rand(r) > 0.1)
    ym = torch.from_numpy(rng.rand(ny) > 0.1)
    idx = torch.from_numpy(np.where(rng.rand(r, k) < 0.3,
                                    rng.randint(0, ny, (r, k)),
                                    -1).astype(np.int32))
    plan = tS.wgrad_plan(r, k, cx, cy)
    pairs, counts = tS._wgrad_pairs_plain(xm, idx, ym)
    total = torch.zeros(k, cx, cy)
    chunked = 0
    for j in range(k):
        bounds = tS.wgrad_chunk_bounds(int(counts[j]), plan.chunks)
        chunked += len(bounds) > 1
        for p0, p1 in bounds:
            rows, cols = pairs[j, p0:p1, 0].long(), pairs[j, p0:p1, 1].long()
            total[j] = total[j] + x[rows].T @ y[cols]
    assert chunked
    ref = tS._conv_wgrad_plain(x, xm, idx, y, ym).numpy()
    np.testing.assert_allclose(total.numpy(), ref, rtol=0,
                               atol=1e-6 * np.abs(ref).max())


def test_wgrad_row_steps_in_3xtf32_hold_the_gate():
    """K3's arithmetic on the CPU: 3xTF32 products over each step of 32
    compacted pairs (float32 accumulators, one k=8 slice at a time), each
    step's partial added into the running sum in float32, over 24576 pairs
    of one offset (a stage-1 call's); within the card's gate of 1e-4 x
    max|ref| with a margin of 20 against a float64 reference."""
    from test_torch_sparse_conv import GATE, _mma_tf32
    rng = np.random.RandomState(3)
    r, ny, cx, cy, n = 48000, 30000, 64, 64, 24576
    x = np.maximum(rng.randn(r, cx), 0).astype(np.float32)  # after a ReLU
    y = rng.randn(ny, cy).astype(np.float32)
    idx = np.where(rng.rand(r, 1) < 0.75, rng.randint(0, ny, (r, 1)),
                   -1).astype(np.int32)
    pairs, counts = tS._wgrad_pairs_plain(
        torch.from_numpy(rng.rand(r) > 0.1), torch.from_numpy(idx),
        torch.from_numpy(rng.rand(ny) > 0.1))
    assert int(counts[0]) >= n
    rows, cols = pairs[0, :n, 0].long(), pairs[0, :n, 1].long()
    xs, ys = torch.from_numpy(x)[rows], torch.from_numpy(y)[cols]
    ref = xs.double().T @ ys.double()
    xt = xs.T.contiguous()
    passes = (('lo', 'hi'), ('hi', 'lo'), ('hi', 'hi'))
    acc = torch.zeros(cx, cy)
    for p0 in range(0, n, tS.WG_STEP):
        acc = acc + _mma_tf32(xt[:, p0:p0 + 32], ys[p0:p0 + 32], passes)
    err = float((acc.double() - ref).abs().max())
    scale = float(ref.abs().max())
    assert err <= GATE * scale / 20, (err, scale)
