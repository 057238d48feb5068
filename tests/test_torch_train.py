"""Port vs reference: the train step's pieces and the tiny detector's step.

- ``MaskedBatchNorm`` in training mode against the flax module (batch
  statistics over every valid row, biased variance, momentum 0.9).
- ``multistep_lr`` and the optimizer against optax
  (``clip_by_global_norm(10)`` then ``adamw``) on identical gradients:
  within 1e-6, float32 rounding of the same formulas.
- The tiny detector (``__graft_entry__._tiny_model`` depths: ResNet-18,
  MinkResNet-18, voxel 0.02 m; ``_tiny_batch``: b=2, 4 GT boxes) in
  training mode: the
  engine's integer outputs identical, the loss dict and every gradient leaf
  (exported in the flax layout) and the batch statistics after the step
  within the tolerances stated at ``_close_leaf``.

The JAX side runs the flat batch engine and compiles the detector's
``value_and_grad`` once per module.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import __graft_entry__ as G
from embodiedscan_tpu.models import norm as jN
from embodiedscan_tpu.train import state as jT
from embodiedscan_torch.configs.base import Config, build_train, mv_det3d
from embodiedscan_torch.models import norm as tN
from embodiedscan_torch.models.detector import SparseFusionDetector as TDet
from embodiedscan_torch.train import state as tT
from embodiedscan_torch.utils.convert_weights import (export_jax_tree,
                                                      load_jax_variables)

from test_torch_helpers import (flat_engine, random_variables, to_numpy,
                                to_torch)

# __graft_entry__._tiny_model at voxel 0.02 m: at its 0.05 the two coarsest
# levels hold 1-2 voxels a sample, batch statistics over so few rows make
# the FPN prune scores tie within float rounding, and the top-k keeps
# whichever side the rounding favours (the engine's integers then differ)
VOXEL = 0.02
TINY = dict(num_classes=5, voxel_size=VOXEL, input_capacity=256,
            backbone_capacities=(256, 128, 128, 64, 32, 16),
            fpn_capacities=(128, 64, 32, 16), max_dets=16, nms_pre=32,
            max_candidates=32, resnet_depth=18, mink_depth=18)


def _leaves(tree, prefix=()):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _leaves(val, prefix + (key,))
        else:
            yield prefix + (key,), np.asarray(val)


# --- MaskedBatchNorm in training mode ---------------------------------------


def test_masked_batchnorm_training_mode():
    """Output, its gradients and the running statistics; within 1e-6 x
    max|ref| plus rtol 1e-5 (sums over ~300 rows in another order)."""
    rng = np.random.RandomState(0)
    feats = (rng.randn(2, 150, 8) * 2 + 1).astype(np.float32)
    mask = rng.rand(2, 150) > 0.3
    scale = rng.uniform(0.5, 1.5, 8).astype(np.float32)
    bias = rng.randn(8).astype(np.float32)
    mean0 = rng.randn(8).astype(np.float32) * 0.1
    var0 = rng.uniform(0.5, 2.0, 8).astype(np.float32)
    dout = rng.randn(2, 150, 8).astype(np.float32)
    jm = jN.MaskedBatchNorm()

    def jrun(f, s, b):
        return jm.apply({'params': {'scale': s, 'bias': b},
                         'batch_stats': {'mean': mean0, 'var': var0}}, f,
                        jnp.asarray(mask), use_running_average=False,
                        mutable=['batch_stats'])

    jout, jstats = jrun(feats, scale, bias)
    _, vjp = jax.vjp(lambda f, s, b: jrun(f, s, b)[0], feats, scale, bias)
    jgrads = vjp(jnp.asarray(dout))

    tm = tN.MaskedBatchNorm(8).train()
    load_jax_variables(tm, {'scale': scale, 'bias': bias},
                       {'mean': mean0, 'var': var0})
    tf = torch.from_numpy(feats).requires_grad_()
    tout = tm(tf, torch.from_numpy(mask))
    tout.backward(torch.from_numpy(dout))
    got = [tout.detach(), tf.grad, tm.scale.grad, tm.bias.grad, tm.mean,
           tm.var]
    want = [jout, *jgrads, jstats['batch_stats']['mean'],
            jstats['batch_stats']['var']]
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5,
                                   atol=1e-6 * np.abs(w).max())
    # masked rows stay zero; eval mode reads the updated running statistics
    assert not tout[~torch.from_numpy(mask)].any()
    tm.eval()
    ev = tm(torch.from_numpy(feats), torch.from_numpy(mask))
    jev = jm.apply({'params': {'scale': scale, 'bias': bias},
                    'batch_stats': jstats['batch_stats']}, feats,
                   jnp.asarray(mask), use_running_average=True)
    np.testing.assert_allclose(ev.detach().numpy(), np.asarray(jev),
                               rtol=1e-5,
                               atol=1e-6)


# --- schedule and optimizer -------------------------------------------------


@pytest.mark.parametrize('count', [0, 1, 39, 40, 41, 54, 55, 56, 1000])
def test_multistep_lr_matches_optax(count):
    """Boundaries at epochs 8 and 11 of 5 updates (40, 55): the factor
    applies from the update made after ``boundary`` earlier ones."""
    want = jT.multistep_lr(1e-3, 5)(count)
    got = tT.multistep_lr(1e-3, 5)(count)
    np.testing.assert_allclose(got, float(want), rtol=1e-6)


def test_optimizer_matches_optax_with_clipping():
    """Three updates on identical numpy gradients whose global norm is
    ~30-60 (the clip is active) and a schedule that decays at updates 1 and
    2: the parameters agree within 1e-6 after each."""
    rng = np.random.RandomState(1)
    shapes = {'a': (7, 5), 'b': (5,), 'c': (3, 4, 2)}
    params = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.randn(*s) * (10 + 10 * i)).astype(np.float32)
              for k, s in shapes.items()} for i in range(3)]
    cfg = Config()
    cfg.schedule.milestones = (1, 2)
    sc = cfg.schedule
    tx = jT.make_optimizer(jT.multistep_lr(sc.lr, 1, sc.milestones),
                           sc.weight_decay, sc.clip_norm)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = tx.init(jp)

    module = torch.nn.Module()
    for k, v in params.items():
        module.register_parameter(k, torch.nn.Parameter(torch.from_numpy(
            v.copy())))
    opt = tT.make_optimizer(module, cfg, steps_per_epoch=1)
    for g in grads:
        assert np.sqrt(sum((v.astype(np.float64) ** 2).sum()
                           for v in g.values())) > 10
        upd, jstate = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                jstate, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in module.named_parameters():
            p.grad = torch.from_numpy(g[k].copy())
        opt.step()
        for k, p in module.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]),
                                       rtol=0, atol=1e-6)


def test_optimizer_resumes_schedule_from_state_dict():
    """An optimizer restored with ``load_state_dict`` past a milestone
    takes the decayed rate on its next update, as one that never stopped:
    the parameters of the two agree exactly."""
    rng = np.random.RandomState(3)
    cfg = Config()
    cfg.schedule.milestones = (1, 2)
    grads = [rng.randn(4, 3).astype(np.float32) for _ in range(4)]

    def module():
        m = torch.nn.Module()
        m.w = torch.nn.Parameter(torch.from_numpy(
            np.random.RandomState(4).randn(4, 3).astype(np.float32)))
        return m

    def update(m, opt, g):
        m.w.grad = torch.from_numpy(g.copy())
        opt.step()

    ref = module()
    ref_opt = tT.make_optimizer(ref, cfg, steps_per_epoch=1)
    for g in grads:
        update(ref, ref_opt, g)
    first = module()
    first_opt = tT.make_optimizer(first, cfg, steps_per_epoch=1)
    for g in grads[:2]:
        update(first, first_opt, g)
    resumed = module()
    resumed.load_state_dict(first.state_dict())
    resumed_opt = tT.make_optimizer(resumed, cfg, steps_per_epoch=1)
    resumed_opt.load_state_dict(first_opt.state_dict())
    assert resumed_opt.param_groups[0]['count'] == 2
    for g in grads[2:]:
        update(resumed, resumed_opt, g)
    assert resumed_opt.param_groups[0]['lr'] == pytest.approx(1e-5)
    torch.testing.assert_close(resumed.w, ref.w, rtol=0, atol=0)


def test_clip_is_optax_global_norm():
    """The clip scales by min(1, 10 / norm) with no epsilon, and leaves
    gradients below the norm untouched."""
    module = torch.nn.Linear(3, 2)
    opt = tT.make_optimizer(module, Config(), steps_per_epoch=1)
    for scale, factor in ((100.0, None), (1e-3, 1.0)):
        module.weight.grad = torch.full_like(module.weight, scale)
        module.bias.grad = torch.full_like(module.bias, scale)
        before = [p.grad.clone() for p in module.parameters()]
        norm = opt.clip_grads_()
        want = 10.0 / float(norm) if factor is None else factor
        for b, p in zip(before, module.parameters()):
            np.testing.assert_allclose(p.grad.numpy(), b.numpy() * want,
                                       rtol=1e-6)


# --- the tiny detector's train step -----------------------------------------


@pytest.fixture(scope='module')
def step_outputs():
    batch = {k: np.array(v) for k, v in G._tiny_batch().items()}
    with flat_engine():
        jm = G._tiny_model().clone(voxel_size=VOXEL)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        var = random_variables(jm, (jb,), train=False, mode='feats')

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

        (jlosses, jstats, jpoints, jmasks), jgrads = to_numpy(
            jax.jit(step)(var['params'], var['batch_stats'], jb))

    tm = TDet(**TINY).train()
    load_jax_variables(tm, var['params'], var['batch_stats'])
    seen = []
    hook = tm.bbox_head.register_forward_hook(
        lambda mod, args, out: seen.append(out))
    tb = to_torch(batch)
    tlosses = tm(tb, mode='loss')
    hook.remove()
    sum(tlosses.values()).backward()
    return dict(
        jax=(jlosses, jstats, jpoints, jmasks, jgrads),
        torch=({k: float(v.detach()) for k, v in tlosses.items()},
               export_jax_tree(tm, 'buffers'), to_numpy(seen[0].points),
               to_numpy(seen[0].masks), export_jax_tree(tm, 'grads')),
        model=tm, batch=tb)


def test_train_step_integer_outputs_identical(step_outputs):
    _, _, jpts, jmasks, _ = step_outputs['jax']
    _, _, tpts, tmasks, _ = step_outputs['torch']
    assert sum(m.sum() for m in jmasks) > 0
    for g, w in zip(tpts + tmasks, jpts + jmasks):
        np.testing.assert_array_equal(g, w)


def test_train_step_losses(step_outputs):
    """rtol 1e-5: float32 through ~40 layers in another order."""
    jl = step_outputs['jax'][0]
    tl = step_outputs['torch'][0]
    assert set(tl) == set(jl) == {'loss_center', 'loss_bbox', 'loss_cls'}
    for key in jl:
        assert np.isfinite(tl[key]) and tl[key] > 0
        np.testing.assert_allclose(tl[key], jl[key], rtol=1e-5)


def _close_leaf(got, want, rel):
    """|got - want| <= rel x max|want| over the leaf."""
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    return err <= rel * scale, err / scale


@pytest.mark.parametrize('tree,rel', [('grads', 1e-4), ('stats', 1e-5)])
def test_train_step_leaves(step_outputs, tree, rel):
    """Every gradient leaf within 1e-4 x its max|ref|: float32 sums of
    backward passes through ~40 layers in another order, and the reference
    sends the fusion gather's backward through an f32 prefix difference
    (``ops/segment.py:segment_sum_rows``) where the port accumulates with
    ``index_add_``, which moves the image branch's gradients in the low
    bits. Batch statistics after the step within 1e-5 x max|ref|."""
    _, jstats, _, _, jgrads = step_outputs['jax']
    _, tstats, _, _, tgrads = step_outputs['torch']
    jt, tt = (jgrads, tgrads) if tree == 'grads' else (jstats, tstats)
    want = dict(_leaves(jt))
    got = dict(_leaves(tt))
    assert set(got) == set(want)
    bad = []
    for path, w in want.items():
        ok, r = _close_leaf(got[path], w, rel)
        if not ok:
            bad.append(('/'.join(path), r))
    assert not bad, bad


def test_train_step_entry_point(step_outputs):
    """``train_step``: the same losses from the same parameters (training
    mode normalizes by batch statistics), their sum, and an update."""
    model, batch = step_outputs['model'], step_outputs['batch']
    opt = tT.make_optimizer(model, Config(), steps_per_epoch=1)
    before = model.bbox_head.conv_cls.weight.detach().clone()
    metrics = tT.train_step(model, opt, batch)
    want = step_outputs['torch'][0]
    assert set(metrics) == set(want) | {'loss_total'}
    for key, val in want.items():
        np.testing.assert_allclose(float(metrics[key]), val, rtol=1e-6)
    np.testing.assert_allclose(float(metrics['loss_total']),
                               sum(want.values()), rtol=1e-6)
    assert not torch.equal(model.bbox_head.conv_cls.weight, before)
    assert opt.param_groups[0]['count'] == 1


def test_build_train_entry_point():
    """``build_train`` on the CPU: the full-width architecture at tiny
    capacities, in training mode, takes a finite step."""
    cfg = mv_det3d()
    cfg.model.num_classes = 5
    for key in ('input_capacity', 'backbone_capacities', 'fpn_capacities',
                'max_dets', 'nms_pre', 'max_candidates', 'voxel_size'):
        setattr(cfg.model, key, TINY[key])
    model, opt = build_train(cfg, device='cpu', steps_per_epoch=1)
    assert model.training
    batch = to_torch({k: np.array(v) for k, v in G._tiny_batch().items()})
    metrics = tT.train_step(model, opt, batch)
    assert all(np.isfinite(float(v)) for v in metrics.values())


def test_gather_rows_gradient_matches_reference():
    """The fusion gather's backward (``index_add_`` in the port, the
    reference's sort-based ``segment_sum_rows``) over indices with heavy
    duplicates, as the fusion's out-of-view pairs all read row 0; within
    1e-6 x max|ref| (float32 sums of ~500 rows in another order)."""
    from embodiedscan_tpu.ops import segment as jSeg
    from embodiedscan_torch.ops import segment as tSeg
    rng = np.random.RandomState(2)
    table = rng.randn(300, 16).astype(np.float32)
    idx = np.where(rng.rand(2000) < 0.5, 0, rng.randint(0, 300, 2000))
    dout = rng.randn(2000, 16).astype(np.float32)
    want, vjp = jax.vjp(lambda t: jSeg.gather_rows(t, jnp.asarray(idx)),
                        jnp.asarray(table))
    (jgrad,) = vjp(jnp.asarray(dout))
    tt = torch.from_numpy(table).requires_grad_()
    got = tSeg.gather_rows(tt, torch.from_numpy(idx))
    got.backward(torch.from_numpy(dout))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    np.testing.assert_allclose(tt.grad.numpy(), np.asarray(jgrad), rtol=0,
                               atol=1e-6 * np.abs(np.asarray(jgrad)).max())
