"""Port vs reference: the bf16 sparse-conv compute route.

The same numpy inputs go through the reference with
``set_conv_compute_dtype(jnp.bfloat16)`` and through the port with
``set_conv_compute_dtype(torch.bfloat16)`` (each restored in a ``finally``:
the dtype is a module global on both sides). On the CPU the port runs the
kernels' plain bf16 versions (operands rounded to bfloat16, float32
products and sums), which are the K2-bf16 and K3-bf16 contracts.

Gates:
- Integer tables: identical.
- The forward of every route, and both gradients of the submanifold and
  strided routes (the reference's custom VJPs): the float32 gates of
  ``test_torch_conv_grad`` (1e-5 x max|ref| + rtol 1e-5). Both sides round
  the same float32 inputs to the same bfloat16 values; only the order of
  the float32 sums differs.
- The generic route's gradients (the reference's autodiff: each offset's
  product and dW rounded to bfloat16, dfeats summed by bfloat16 adds):
  BF16_GATE. The two sides' float32 sums differ in their last bits, and
  bfloat16 keeps 8 significant bits: a value that lies within that
  difference of a rounding boundary rounds one step (2^-8 of its binade,
  at most 2^-7 of the value) apart, and a bfloat16 sum of K such terms
  moves by a step of each partial sum.
- The small detector's request and train step end to end: the rounding
  steps of single values above, carried through the network's float32
  layers, with the gates stated at ``_model_close``.
"""

import contextlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import __graft_entry__ as G
import test_torch_conv_grad as cg
from embodiedscan_tpu.ops import sparse as jS
from embodiedscan_torch.models.detector import SparseFusionDetector as TDet
from embodiedscan_torch.ops import sparse as tS
from embodiedscan_torch.utils.convert_weights import (export_jax_tree,
                                                      load_jax_variables)

from test_torch_helpers import (flat_engine, random_variables, to_numpy,
                                to_torch)

level = cg.level  # the b = 2 level and its engine tables (module scope)
CAP, CCAP = cg.CAP, cg.CCAP
# a bfloat16 rounding step: 2^-8 of the value's binade, so at most 2^-7 of
# the value
BF16_STEP = 2.0 ** -7


@contextlib.contextmanager
def bf16_route():
    """Both packages' sparse convs in bfloat16 while active; the previous
    dtypes restored on exit, whatever happens inside."""
    before = jS.CONV_COMPUTE_DTYPE, tS.CONV_COMPUTE_DTYPE
    jS.set_conv_compute_dtype(jnp.bfloat16)
    tS.set_conv_compute_dtype(torch.bfloat16)
    try:
        yield
    finally:
        jS.set_conv_compute_dtype(before[0])
        tS.set_conv_compute_dtype(before[1])


def _bf16_exact(a):
    """Whether every value of ``a`` is a bfloat16 value."""
    t = torch.from_numpy(np.array(a, np.float32))
    return torch.equal(t.to(torch.bfloat16).to(torch.float32), t)


def test_compute_dtype_switch():
    assert tS.CONV_COMPUTE_DTYPE is None  # the default: float32
    with bf16_route():
        assert tS.CONV_COMPUTE_DTYPE is torch.bfloat16
    assert tS.CONV_COMPUTE_DTYPE is None and jS.CONV_COMPUTE_DTYPE is None
    with pytest.raises(ValueError):
        tS.set_conv_compute_dtype(torch.float16)
    with pytest.raises(RuntimeError), bf16_route():
        raise RuntimeError('restored on the way out')
    assert tS.CONV_COMPUTE_DTYPE is None


def test_plain_contract_and_cpu_dispatch():
    """On CPU tensors the wrappers take the plain bf16 versions: the
    forward is exactly ``_gather_matmul_conv_bf16_plain``, the input
    gradient (``bf16=True``) and K3 (``bf16=True``) their plain versions,
    and these are float32 computations over bfloat16-rounded operands
    (float64 sums of the same products agree within float32 rounding)."""
    rng = np.random.RandomState(3)
    feats = torch.from_numpy(rng.randn(300, 16).astype(np.float32))
    mask = torch.from_numpy(rng.rand(300) > 0.2)
    nbr = torch.from_numpy(rng.randint(-1, 300, (200, 27)).astype(np.int32))
    w = torch.from_numpy(rng.randn(27, 16, 8).astype(np.float32))
    with bf16_route():
        got = tS.gather_matmul_conv(feats, mask, nbr, w)
    assert torch.equal(got, tS._gather_matmul_conv_bf16_plain(
        feats, mask, nbr, w))
    assert not torch.equal(got, tS.gather_matmul_conv(feats, mask, nbr, w))
    assert torch.equal(tS.conv_dgrad(feats, mask, nbr, w, bf16=True), got)
    fr = tS._bf16(torch.where(mask[:, None], feats, 0)).double()
    wr = tS._bf16(w).double()
    pad = torch.cat([fr, fr.new_zeros(1, 16)])
    idx = torch.where(nbr >= 0, nbr, 300).long()
    want = sum(pad[idx[:, j]] @ wr[j] for j in range(27))
    torch.testing.assert_close(got.double(), want, rtol=1e-5, atol=1e-5)
    y = torch.from_numpy(rng.randn(300, 8).astype(np.float32))
    g = tS.conv_wgrad(feats[:200], mask[:200], nbr, y, mask, bf16=True)
    assert torch.equal(g, tS._conv_wgrad_plain(
        tS._bf16(feats[:200]), mask[:200], nbr, tS._bf16(y), mask))


def _routes(level, route, c):
    """(reference fn, port fn, feats, w, dout, feats needs a gradient)."""
    ts, tn, tt, tcc = level['tables']
    mask = level['mask'].reshape(-1)
    omask = level['cmask'].reshape(-1)
    tm, tom = torch.from_numpy(mask), torch.from_numpy(omask)
    if route == 'subm':
        cin, cout = c
        nbr = cg._flat(tn, CCAP)
        jm, jn = jnp.asarray(omask), jnp.asarray(nbr.numpy())
        feats, w, dout = cg._inputs(np.random.RandomState(cin), 2 * CCAP,
                                    cin, 2 * CCAP, cout, 27)
        return (lambda f, w_: jS.subm_gather_conv(f, jm, jn, w_),
                lambda f, w_: tS.subm_gather_conv(f, tom, nbr, w_),
                feats, w, dout, True)
    if route == 'strided':
        cin, cout = c
        nbr, t_nbr = cg._flat(ts, CAP), cg._flat(tt, CCAP)
        jm, jn, jt = (jnp.asarray(a) for a in (mask, nbr.numpy(),
                                               t_nbr.numpy()))
        feats, w, dout = cg._inputs(np.random.RandomState(cout), 2 * CAP,
                                    cin, 2 * CCAP, cout, 27)
        return (lambda f, w_: jS.strided_gather_conv(f, jm, jn, jt, w_),
                lambda f, w_: tS.strided_gather_conv(f, tm, nbr, t_nbr, w_,
                                                     tom),
                feats, w, dout, True)
    if c == 'k1_downsample':
        nbr, k, cin, cout, fg = cg._flat(tcc, CAP), 1, 16, 32, True
    elif c == 'k27_cin3_stem':
        nbr, k, cin, cout, fg = cg._flat(ts, CAP), 27, 3, 16, False
    else:  # indices N, N + 5 and -7 read as absent
        nbr = cg._flat(ts, CAP).clone()
        n = 2 * CAP
        nbr[0::3, 0], nbr[1::3, 5], nbr[2::3, 9] = n, n + 5, -7
        k, cin, cout, fg = 27, 8, 16, True
    jm, jn = jnp.asarray(mask), jnp.asarray(nbr.numpy())
    feats, w, dout = cg._inputs(np.random.RandomState(k + cin), 2 * CAP,
                                cin, 2 * CCAP, cout, k)
    return (lambda f, w_: jS.gather_matmul_conv(f, jm, jn, w_),
            lambda f, w_: tS.generic_gather_conv(f, tm, nbr, w_, tom),
            feats, w, dout, fg)


def _bf16_close(got, want, k=1):
    """The generic route's gate: each element within ``k`` rounding steps
    of bfloat16 (BF16_STEP) of the largest value of the array, plus the
    float32 gate."""
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=(k * BF16_STEP + 1e-5) * scale)


@pytest.mark.parametrize('route,c', [
    ('subm', (8, 16)), ('subm', (16, 8)), ('strided', (8, 16)),
    ('strided', (16, 8)), ('generic', 'k1_downsample'),
    ('generic', 'k27_cin3_stem'), ('generic', 'out_of_range')])
def test_route_against_reference(level, route, c):
    """Forward, dfeats and dW of each route in bf16 mode against
    ``jax.vjp`` of the reference's in its bf16 mode."""
    jfn, tfn, feats, w, dout, fg = _routes(level, route, c)
    with bf16_route():
        want = cg._jax_grads(jfn, feats, w, dout)
        got = cg._port_grads(tfn, feats, w, dout, fg)
    (gdf, gdw, gout), (wdf, wdw, wout) = got, want
    cg._close(gout, wout)
    # the rounding is real: float32 gives another forward
    f32 = cg._port_grads(tfn, feats, w, dout, fg)
    assert np.abs(f32[2] - gout).max() > 1e-4 * np.abs(wout).max()
    if route != 'generic':
        cg._close(gdw, wdw)
        cg._close(gdf, wdf)
        return
    # the reference's generic gradients are bfloat16 values; the port's too
    assert _bf16_exact(wdw) and _bf16_exact(gdw)
    _bf16_close(gdw, wdw)
    if fg:
        assert _bf16_exact(wdf) and _bf16_exact(gdf)
        _bf16_close(gdf, wdf, k=w.shape[0])


# --- the small detector in bf16 mode ----------------------------------------

VOXEL = 0.02  # as tests/test_torch_train.py: no top-k ties at the coarse levels
# The FPN's prune keeps the top-k children of each level by a score that
# bfloat16 rounding moves by up to a step; at the tiny model's capacities
# (128, 64, 32, 16) the two sides then keep different children. These
# capacities keep all 8 children of every parent, so no choice depends on
# a rounding step; the prune itself is held to the reference in float32
# (tests/test_torch_train.py, test_torch_detector.py).
FPN = (8192, 1024, 128, 16)
ULP_DRAWS = 3
TINY = dict(num_classes=5, voxel_size=VOXEL, input_capacity=256,
            backbone_capacities=(256, 128, 128, 64, 32, 16),
            fpn_capacities=FPN, max_dets=16, nms_pre=32,
            max_candidates=32, resnet_depth=18, mink_depth=18)


def _leaves(tree, prefix=()):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _leaves(val, prefix + (key, ))
        else:
            yield prefix + (key, ), np.asarray(val)


def _one_ulp(params, seed=0):
    """Every float32 leaf moved by one rounding step, up or down at
    random."""
    rng = np.random.RandomState(seed)

    def move(x):
        x = np.asarray(x, np.float32)
        toward = np.where(rng.rand(*x.shape) < 0.5, np.inf, -np.inf)
        return np.nextafter(x, toward.astype(np.float32))

    return jax.tree_util.tree_map(move, params)


class _PortShapes:
    """Stands in for the reference module in ``random_variables``: its
    abstract init is the port's parameter and statistics tree (the same
    names and shapes; ``jax.eval_shape`` orders them as the reference's
    init does, so the draws are the same), which spares a trace of the
    reference."""

    def __init__(self, model):
        self.tree = {'params': export_jax_tree(model, 'params'),
                     'batch_stats': export_jax_tree(model, 'buffers')}

    def init(self, key):
        return jax.tree_util.tree_map(
            lambda a: jax.ShapeDtypeStruct(np.shape(a), np.float32),
            self.tree)


@pytest.fixture(scope='module')
def model_outputs():
    """The tiny detector (``__graft_entry__._tiny_model`` at 0.02 m) in bf16
    mode on both sides: one request (``mode='feats'``, eval mode) and one
    train step (the loss, its gradients and the batch statistics, training
    mode); the reference's step again with every weight moved by one
    float32 rounding step (ULP_DRAWS draws); the port's request in
    float32.

    Its time goes to tracing the reference twice (the request, the step),
    compiling each once (every draw reuses the step's executable), running
    the step 1 + ULP_DRAWS times, and the port's side. The weights are
    drawn over the port's tree (``_PortShapes``), not a third trace of the
    reference. JAX dispatches each run without waiting for it, so every
    reference run is queued first and the port's side runs while they
    compute; the results are fetched last."""
    batch = {k: np.array(v) for k, v in G._tiny_batch().items()}
    with flat_engine(), bf16_route():
        jm = G._tiny_model().clone(voxel_size=VOXEL, fpn_capacities=FPN)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        tm = TDet(**TINY).eval()
        var = random_variables(_PortShapes(tm), ())

        def request(v, b):
            return jm.apply(v, b, train=False, mode='feats')

        def step(params, stats, b):
            def loss_fn(p):
                v = {'params': p, 'batch_stats': stats}
                outs, mut = jm.apply(v, b, train=True, mode='feats',
                                     mutable=['batch_stats'])
                losses = jm.apply(v, outs, b['gt_boxes'], b['gt_labels'],
                                  b['gt_mask'], method=lambda m, o, *gt:
                                  m.bbox_head.loss(o, *gt))
                return sum(losses.values()), (losses, mut['batch_stats'],
                                              outs.points, outs.masks)

            (_, aux), grads = jax.value_and_grad(loss_fn, has_aux=True)(
                params)
            return aux, grads

        jreq = jax.jit(request)(var, jb)
        jstep = jax.jit(step)
        jout = jstep(var['params'], var['batch_stats'], jb)
        ulps = [jstep(_one_ulp(var['params'], seed), var['batch_stats'], jb)
                for seed in range(ULP_DRAWS)]
        load_jax_variables(tm, var['params'], var['batch_stats'])
        tb = to_torch(batch)
        treq = to_numpy(tm(tb, mode='feats'))
        tm.train()
        seen = []
        hook = tm.bbox_head.register_forward_hook(
            lambda mod, args, out: seen.append(out))
        tlosses = tm(tb, mode='loss')
        hook.remove()
        sum(tlosses.values()).backward()
    f32 = TDet(**TINY).eval()
    load_jax_variables(f32, var['params'], var['batch_stats'])
    treq_f32 = to_numpy(f32(tb, mode='feats'))
    jreq = to_numpy(jreq)
    (jlosses, jstats, jpts, jmasks), jgrads = to_numpy(jout)
    ulp_grads = [to_numpy(u)[1] for u in ulps]
    return dict(
        request=(jreq, treq, treq_f32),
        jax=(jlosses, jstats, jpts, jmasks, jgrads),
        ulp_grads=ulp_grads,
        torch=({k: float(v.detach()) for k, v in tlosses.items()},
               export_jax_tree(tm, 'buffers'), to_numpy(seen[0].points),
               to_numpy(seen[0].masks), export_jax_tree(tm, 'grads')))


def _steps_close(got, want, steps=1):
    """Within ``steps`` bfloat16 rounding steps of the array's largest
    value (plus 1e-6): a rounding step of one conv input on one side moves
    the values that depend on it by a fraction of a step of theirs."""
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    return err <= steps * BF16_STEP * scale + 1e-6, err / scale


def test_request_tables_identical(model_outputs):
    jreq, treq, _ = model_outputs['request']
    for field in ('points', 'masks'):
        for w, g in zip(getattr(jreq, field), getattr(treq, field)):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize('field', ['center', 'reg', 'cls'])
def test_request_outputs(model_outputs, field):
    """Each level's head outputs within one rounding step of their largest
    value; float32 computes another request."""
    jreq, treq, f32 = model_outputs['request']
    moved = 0.0
    for w, g, f in zip(getattr(jreq, field), getattr(treq, field),
                       getattr(f32, field)):
        ok, ratio = _steps_close(g, w)
        assert ok, (field, ratio)
        moved = max(moved, float(np.abs(f - w).max()))
    assert moved > 0


def test_train_step_tables_and_losses(model_outputs):
    """Tables identical; each loss within one rounding step of itself."""
    jl, _, jpts, jmasks, _ = model_outputs['jax']
    tl, _, tpts, tmasks, _ = model_outputs['torch']
    for g, w in zip(tpts + tmasks, jpts + jmasks):
        np.testing.assert_array_equal(g, w)
    assert set(tl) == set(jl)
    for key in jl:
        assert np.isfinite(tl[key]) and tl[key] > 0
        np.testing.assert_allclose(tl[key], jl[key], rtol=BF16_STEP)


def test_train_step_batch_stats(model_outputs):
    """Every running statistic after the step within one rounding step of
    its largest value."""
    _, jstats, _, _, _ = model_outputs['jax']
    _, tstats, _, _, _ = model_outputs['torch']
    want, got = dict(_leaves(jstats)), dict(_leaves(tstats))
    assert set(got) == set(want)
    bad = [('/'.join(p), r) for p, w in want.items()
           for ok, r in [_steps_close(got[p], w)] if not ok]
    assert not bad, bad


def _distance(got, want):
    """Relative L2 distance of two gradients (every leaf, concatenated)."""
    num = sum(float(np.square(got[p] - w).sum()) for p, w in want.items())
    den = sum(float(np.square(w).sum()) for w in want.values())
    return (num / den) ** 0.5


def test_train_step_gradients(model_outputs):
    """The gradients: within the distance the reference itself moves when
    each of its float32 weights moves by one rounding step.

    The bf16 step of this small model is chaotic at float32's rounding
    level: a conv input within float32 noise of a bfloat16 rounding
    boundary rounds a step (up to 2^-7 of itself) to either side, and
    batch statistics over the coarse levels' few dozen voxels and the ReLU
    decisions carry such steps on. Two float32-faithful implementations
    of the same contract then differ by what one float32 step of noise
    does, not by a fixed number of bfloat16 steps per leaf (the reference
    against itself after one weight step: a relative L2 distance of ~8%,
    up to ~60% of a leaf's largest value). The whole gradient is held to
    the largest of ULP_DRAWS such distances."""
    _, _, _, _, jgrads = model_outputs['jax']
    tgrads = model_outputs['torch'][4]
    want = dict(_leaves(jgrads))
    got = dict(_leaves(tgrads))
    assert set(got) == set(want)
    spreads = [_distance(dict(_leaves(u)), want)
               for u in model_outputs['ulp_grads']]
    dist = _distance(got, want)
    print(f'bf16 train step: distance {dist:.4f}, spreads {spreads}')
    assert 0 < dist <= max(spreads), (dist, spreads)
