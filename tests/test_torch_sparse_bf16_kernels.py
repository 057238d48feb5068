"""K2-bf16 and K3-bf16 around their kernels, on the CPU.

On the card K2-bf16 (``csrc/sparse_conv.cu:sc_wgmma_bf16``) and K3-bf16
(``csrc/sparse_conv_wgrad.cu:wg_wgmma_bf16``) run ``wgmma`` over the rows
they gather, with the plans ``conv_plan(..., bf16=True)`` and ``wgrad_plan(...,
bf16=True)`` pick; the weights' bfloat16 copy is kept per version
(:func:`bf16_weights`); the custom-VJP backwards cast dout and feats once;
split calls add their partials in split (or chunk) order in the last block
of each output tile. What of that runs on the host is held here: the
plans over the main path's and the continuous paths' shapes, the cache, the
backward's bits against the route that casts per call, and the fixed-order
reductions as plain models against the plain bf16 versions (float32 sums
in another order: within 1e-5 x max|ref|).
"""

import numpy as np
import pytest
import torch

from embodiedscan_torch.ops import sparse as tS

from test_torch_sparse_conv import MAIN_PATH_SHAPES

# the continuous paths' calls: the main path's shapes at 10, 20 and 50
# sweeps of a pseudo-batch (cont_det3d's and cont_occ's steps and
# requests; up to 50 x 65,536 = 3.3M rows)
CONT_SHAPES = sorted({(m * b, k, cin, cout) for m, k, cin, cout in
                      MAIN_PATH_SHAPES for b in (10, 20, 50)})
SHAPES = sorted(MAIN_PATH_SHAPES) + CONT_SHAPES
# the 39 dgrad calls of a step are K2-bf16 calls with Cin and Cout swapped
DGRAD_SHAPES = sorted({(m, k, cout, cin) for m, k, cin, cout in SHAPES
                       if k == 27 and cin >= 8})
GATE = 1e-5


@pytest.mark.parametrize('shape', SHAPES + DGRAD_SHAPES)
def test_bf16_conv_plan_is_legal(shape):
    """Each tile is one the kernel instantiates and wgmma takes (a
    warpgroup of 64 rows by a width a multiple of 8 up to 256, at most 4
    warpgroups), the split groups cover every offset once, and the
    workspace stays within the docstring's bound."""
    m, k, cin, cout = shape
    plan = tS.conv_plan(m, k, cin, cout, bf16=True)
    assert plan == tS._bf16_conv_plan(m, k, cin, cout)
    if cin % 8 or cout % 8 or cin < 8:
        assert plan.route == 'simt'
        return
    assert plan.route == 'tc'
    assert (plan.bm, plan.bn) in tS.BF16_TILES
    assert plan.bm % 64 == 0 and plan.bm <= 256
    assert plan.bn % 8 == 0 and plan.bn <= 256
    assert (plan.splits - 1) * plan.per_split < k <= plan.splits * \
        plan.per_split
    assert plan.per_split <= tS.TC_MAX_OFFSETS
    if plan.splits > 1:
        assert plan.splits * m * cout * 4 <= tS.BF16_MAX_WS_BYTES


@pytest.mark.parametrize('shape,route', [
    ((5000, 27, 24, 64), 'tc'), ((5000, 27, 40, 72), 'tc'),
    ((5000, 27, 64, 200), 'tc'), ((5000, 27, 12, 64), 'simt'),
    ((5000, 27, 3, 64), 'simt'), ((5000, 27, 64, 284), 'simt'),
    ((5000, 28, 64, 64), 'simt')])
def test_bf16_conv_plan_routes(shape, route):
    """Channels that fill no whole 128-byte line (24, 40) or a ragged Cout
    (72, 200) stay on the tensor cores; rows that are not 16-byte chunks of
    bfloat16 and K > 27 take the SIMT route."""
    assert tS.conv_plan(*shape, bf16=True).route == route


def test_bf16_plans_of_empty_calls():
    """No rows: legal plans (the kernels then launch nothing)."""
    plan = tS.conv_plan(0, 27, 64, 64, bf16=True)
    assert plan.route == 'tc' and plan.splits * plan.per_split >= 27
    assert tS.wgrad_plan(0, 27, 64, 64, bf16=True).chunks == 1


@pytest.mark.parametrize('shape', SHAPES)
def test_bf16_wgrad_plan_is_legal(shape):
    """K3-bf16 over each (forward) shape: the tile, the chunk count, chunk
    bounds that cover every pair once, and the bounded workspace."""
    m, k, cin, cout = shape
    if k == 1:
        return
    plan = tS.wgrad_plan(m, k, cin, cout, bf16=True)
    if cin % 8 or cout % 8 or min(cin, cout) < 8:
        assert plan.route == 'narrow'
        return
    assert plan.route == 'tc' and plan.bm in (64, 128) and plan.bn in (64,
                                                                      128)
    assert tS.wgrad_smem(plan.bm, plan.bn, bf16=True) <= tS.SMEM_PER_SM - \
        tS.SMEM_PER_BLOCK
    assert 1 <= plan.chunks <= 65535
    if plan.chunks > 1:
        assert plan.chunks * k * cin * cout * 4 <= tS.WG_MAX_WS_BYTES
    for n in (0, 1, 63, 64, 65, m // 4, m):
        bounds = tS.wgrad_chunk_bounds(n, plan.chunks)
        assert bounds[0][0] == 0 and bounds[-1][1] == n
        assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
        assert len(bounds) <= plan.chunks


def test_bf16_weights_cache_follows_the_version():
    w = torch.randn(27, 16, 8)
    a = tS.bf16_weights(w)
    assert a.dtype == torch.bfloat16 and torch.equal(a.float(), tS._bf16(w))
    assert tS.bf16_weights(w) is a  # the same version: the same copy
    w.add_(1.0)  # in place: a new version, a fresh copy
    b = tS.bf16_weights(w)
    assert b is not a and torch.equal(b.float(), tS._bf16(w))
    with torch.no_grad():
        w[3, 2, 1] = 100.0  # through a view: the version counter is shared
    c = tS.bf16_weights(w)
    assert c is not b and float(c[3, 2, 1]) == 100.0
    assert tS.bf16_weights(w.detach()) is not c  # another tensor object
    copy = w.clone()  # another tensor at version 0: its own copy
    assert tS.bf16_weights(copy) is not c
    assert torch.equal(tS.bf16_weights(copy), c)
    bf = torch.randn(4, 8, 8).to(torch.bfloat16)
    assert tS.bf16_weights(bf) is bf


def test_bf16_weights_cache_after_an_optimizer_step():
    conv = torch.nn.Parameter(torch.randn(27, 8, 16))
    opt = torch.optim.AdamW([conv], lr=0.1)
    before = tS.bf16_weights(conv)
    assert tS.bf16_weights(conv) is before
    conv.grad = torch.randn_like(conv)
    opt.step()
    after = tS.bf16_weights(conv)
    assert after is not before
    assert torch.equal(after.float(), tS._bf16(conv.detach()))
    assert not torch.equal(after, before)
    with torch.no_grad():
        conv.copy_(torch.zeros_like(conv))  # as load_state_dict does
    assert not tS.bf16_weights(conv).any()


def test_bf16_weights_after_a_write_through_data():
    w = torch.nn.Parameter(torch.randn(27, 8, 16))
    before = tS.bf16_weights(w)
    w.data.add_(1.0)  # .data has a version counter of its own
    assert w._version == 0 and tS.bf16_weights(w) is before
    tS.drop_bf16_weights()  # what a writer through .data calls after it
    after = tS.bf16_weights(w)
    assert after is not before
    assert torch.equal(after.float(), tS._bf16(w.detach()))
    assert tS.bf16_weights(w) is after


def test_bf16_weights_after_replicate_and_restore(tmp_path):
    import torch.distributed as dist
    from embodiedscan_torch.parallel.mesh import replicate
    from embodiedscan_torch.train.checkpoint import CheckpointManager
    model = torch.nn.Linear(8, 16)
    w = model.weight
    saved = w.detach().clone()
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save(1, model)
    kept = tS.bf16_weights(w)
    w.data.mul_(2.0)  # out of band, as a broadcast writes
    dist.init_process_group('gloo', init_method=f'file://{tmp_path}/store',
                            rank=0, world_size=1)
    try:
        replicate(model)
    finally:
        dist.destroy_process_group()
    fresh = tS.bf16_weights(w)
    assert fresh is not kept
    assert torch.equal(fresh.float(), tS._bf16(2.0 * saved))
    w.data.zero_()
    assert ckpt.restore(model) == 1
    assert torch.equal(tS.bf16_weights(w).float(), tS._bf16(saved))


def test_bf16_weights_inference_tensors_are_cast_each_call():
    with torch.inference_mode():
        w = torch.randn(3, 8, 8)
        a, b = tS.bf16_weights(w), tS.bf16_weights(w)
    assert a is not b and torch.equal(a, b)


def _case(rng, n=600, m=500, k=27, cin=16, cout=24, hit=0.4):
    feats = torch.from_numpy(rng.randn(n, cin).astype(np.float32))
    mask = torch.from_numpy(rng.rand(n) > 0.15)
    nbr = np.where(rng.rand(m, k) < hit, rng.randint(0, n, (m, k)), -1)
    w = torch.from_numpy((rng.randn(k, cin, cout) * 0.2).astype(np.float32))
    return feats, mask, torch.from_numpy(nbr.astype(np.int32)), w


@pytest.mark.parametrize('mirror', [True, False])
def test_dgrad_from_the_forward_weights(mirror):
    """The input gradient from the forward's own W (``mirror``) gives the
    bits of the same call over W's transposed copy, on both routes, and on
    the bf16 route for a float32 dout and for its bfloat16 copy alike."""
    rng = np.random.RandomState(4)
    dout, mask, table, w = _case(rng, cin=24, cout=16)
    w = w.transpose(1, 2).contiguous()  # (K, Cin 16, Cout 24): dout has 24
    wt = (w.flip(0) if mirror else w).transpose(1, 2).contiguous()
    for bf16 in (False, True):
        want = tS.conv_dgrad(dout, mask, table, wt, bf16)
        got = tS.conv_dgrad(dout, mask, table, w, bf16, mirror=mirror)
        assert torch.equal(got, want)
    got16 = tS.conv_dgrad(dout.to(torch.bfloat16), mask, table, w, True,
                          mirror=mirror)
    assert torch.equal(got16, tS.conv_dgrad(dout, mask, table, wt, True))
    with pytest.raises(TypeError):  # bfloat16 dout only on the bf16 route
        tS.conv_dgrad(dout.to(torch.bfloat16), mask, table, w,
                      mirror=mirror)
    with pytest.raises(ValueError):  # W (K, Cout, Cin) as given: 16 != 24
        tS.conv_dgrad(dout, mask, table, w, True)


def _old_backward(route, feats, mask, nbr, w, dout, omask=None, t_nbr=None):
    """The bf16 backward as it was before the cast-once route: a
    transposed W copy, dout and feats cast inside each wrapper."""
    if route == 'subm':
        wt = w.flip(0).transpose(1, 2).contiguous()
        df = tS.conv_dgrad(dout, mask, nbr, wt, True)
        dw = tS.conv_wgrad(feats, mask, nbr, dout, mask, True).flip(0)
        return tS._masked_rows(df, mask), dw
    wt = w.transpose(1, 2).contiguous()
    df = tS.conv_dgrad(dout, omask, t_nbr, wt, True)
    dw = tS.conv_wgrad(feats, mask, t_nbr, dout, omask, True)
    return tS._masked_rows(df, mask), dw


def _transpose_table(nbr, n):
    """t_nbr[j, k] = m <=> nbr[m, k] = j (one m per (j, k) here)."""
    m, k = nbr.shape
    t = torch.full((n, k), -1, dtype=torch.int32)
    for j in range(k):
        rows = torch.nonzero(nbr[:, j] >= 0).flatten()
        t[nbr[rows, j].long(), j] = rows.to(torch.int32)
    return t


@pytest.mark.parametrize('route', ['subm', 'strided'])
def test_cast_once_backward_keeps_the_bits(route):
    """The custom-VJP backwards on the bf16 route (dout and feats cast
    once, W read from the forward's own tensor) give the same dfeats and
    dW bits as the route that casts in every wrapper over a transposed
    copy of W."""
    rng = np.random.RandomState(5 if route == 'subm' else 6)
    n, cin, cout = 400, 16, 24
    feats = torch.from_numpy(rng.randn(n, cin).astype(np.float32))
    mask = torch.from_numpy(rng.rand(n) > 0.15)
    w = torch.from_numpy((rng.randn(27, cin, cout) * 0.2).astype(np.float32))
    if route == 'subm':
        # a mirror-symmetric table: nbr[m, k] = i <=> nbr[i, K-1-k] = m
        nbr = torch.full((n, 27), -1, dtype=torch.int32)
        for k in range(13):
            src = torch.from_numpy(rng.permutation(n)[:n // 3])
            dst = torch.from_numpy(rng.permutation(n)[:n // 3])
            nbr[dst, k] = src.to(torch.int32)
            nbr[src, 26 - k] = dst.to(torch.int32)
        nbr[:, 13] = torch.arange(n, dtype=torch.int32)
        omask = mask
        dout = torch.from_numpy(rng.randn(n, cout).astype(np.float32))
    else:
        m = 150
        omask = torch.from_numpy(rng.rand(m) > 0.1)
        nbr = torch.full((m, 27), -1, dtype=torch.int32)
        for k in range(27):  # each fine row under at most one coarse row
            rows = torch.from_numpy(rng.permutation(m)[:m // 2])
            src = torch.from_numpy(rng.permutation(n)[:m // 2])
            nbr[rows, k] = src.to(torch.int32)
        t_nbr = _transpose_table(nbr, n)
        dout = torch.from_numpy(rng.randn(m, cout).astype(np.float32))
    f = feats.clone().requires_grad_(True)
    wp = w.clone().requires_grad_(True)
    before = tS.CONV_COMPUTE_DTYPE
    tS.set_conv_compute_dtype(torch.bfloat16)
    try:
        if route == 'subm':
            out = tS.subm_gather_conv(f, mask, nbr, wp)
            want = _old_backward(route, feats, mask, nbr, w, dout)
        else:
            out = tS.strided_gather_conv(f, mask, nbr, t_nbr, wp, omask)
            want = _old_backward(route, feats, mask, nbr, w, dout, omask,
                                 t_nbr)
        out.backward(dout)
    finally:
        tS.set_conv_compute_dtype(before)
    assert torch.equal(f.grad, want[0]) and torch.equal(wp.grad, want[1])
    assert f.grad.abs().max() > 0 and wp.grad.abs().max() > 0


@pytest.mark.parametrize('per', [1, 3, 9, 27])
def test_split_order_reduction_model(per):
    """K2-bf16's split call as a plain model: each group of ``per``
    offsets' partial (the plain bf16 version over the group), added in
    split order, then the bias (the folded reduction's order), against the
    unsplit plain version."""
    rng = np.random.RandomState(per)
    feats, mask, nbr, w = _case(rng)
    bias = torch.from_numpy(rng.randn(24).astype(np.float32))
    plan = tS.ConvPlan('tc', 64, 64, -(-27 // per), per)
    out = None
    for z in range(plan.splits):
        lo, hi = z * per, min(27, (z + 1) * per)
        part = tS._gather_matmul_conv_bf16_plain(
            feats, mask, nbr[:, lo:hi].contiguous(), w[lo:hi])
        out = part if out is None else out + part
    out = out + bias
    want = tS._gather_matmul_conv_bf16_plain(feats, mask, nbr, w, bias)
    scale = float(want.abs().max())
    assert float((out - want).abs().max()) <= GATE * scale


@pytest.mark.parametrize('chunks', [2, 5])
def test_chunk_order_reduction_model(chunks):
    """K3-bf16's chunked call as a plain model: each chunk's pairs (the
    device's bounds over the pair lists) summed apart, the chunks added in
    chunk order, against the plain bf16 version."""
    rng = np.random.RandomState(10 + chunks)
    x, xm, idx, _ = _case(rng, n=2000, m=2000, hit=0.5)
    y = torch.from_numpy(rng.randn(2000, 32).astype(np.float32))
    ym = torch.from_numpy(rng.rand(2000) > 0.1)
    pairs, counts = tS._wgrad_pairs_plain(xm, idx, ym)
    x16, y16 = tS._bf16(x), tS._bf16(y)
    got = []
    for k, n in enumerate(counts.tolist()):
        bounds = tS.wgrad_chunk_bounds(n, chunks)
        if n:
            assert len(bounds) > 1  # every offset has more pairs than 256
        g = None
        for p0, p1 in bounds:
            pr = pairs[k, p0:p1].long()
            part = x16[pr[:, 0]].T @ y16[pr[:, 1]]
            g = part if g is None else g + part
        got.append(g)
    got = torch.stack(got)
    want = tS._conv_wgrad_bf16_plain(x, xm, idx, y, ym)
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= GATE * scale


def test_wgrad_bf16_operands_keep_the_bits():
    """conv_wgrad on the bf16 route: bfloat16 copies of x and y give the
    bits of the float32 operands (the plain version rounds them first)."""
    rng = np.random.RandomState(7)
    x, xm, idx, _ = _case(rng)
    x, xm = x[:500], xm[:500]  # R = 500 rows of idx
    y = torch.from_numpy(rng.randn(600, 8).astype(np.float32))
    ym = torch.from_numpy(rng.rand(600) > 0.1)
    want = tS.conv_wgrad(x, xm, idx, y, ym, True)
    got = tS.conv_wgrad(x.to(torch.bfloat16), xm, idx, y.to(torch.bfloat16),
                        ym, True)
    assert torch.equal(got, want)
    with pytest.raises(TypeError):
        tS.conv_wgrad(x.to(torch.bfloat16), xm, idx, y, ym)
