"""Port vs reference: the mv_occ train step and its losses.

- ``occ_multiscale_targets`` at ratios 1, 2 and 4 (colliding labels in a
  coarse cell, masked rows, rows out of the grid on every side, the
  visibility mask) identical to the reference's.
- ``cross_entropy_ignore``, ``geo_scal_loss`` and ``sem_scal_loss``, with
  a class that has no positives and an all-255 target: values within rtol
  1e-5, gradients with respect to the logits within 1e-5 x max|grad|.
- One train step of the small occupancy model (the serving tests' widths,
  8 x 8 x 4 grid, b = 2, 2.4 m tall rooms) against the reference's
  ``value_and_grad`` of ``mode='loss'`` and its optax optimizer with the
  task's lr multipliers: losses within rtol 1e-5, every gradient leaf
  within 1e-4 x its max|ref|, the batch statistics after the step within
  1e-5 x max|ref| (the U-Net's momentum 0.99, the sparse norms' 0.9), the
  frozen 2D stem and first stage unchanged and the update of every other
  leaf within 1e-6 where its gradient's sign is determined (|g| above 1%
  of the leaf's max: AdamW's first update is -lr sign(g) there).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from embodiedscan_tpu.models import losses as jLoss
from embodiedscan_tpu.models import occupancy as jO
from embodiedscan_tpu.train import loop as jL
from embodiedscan_tpu.train import state as jT
from embodiedscan_torch.configs.base import build_train, mv_occ
from embodiedscan_torch.models import losses as tLoss
from embodiedscan_torch.models import occupancy as tO
from embodiedscan_torch.train import loop as tL
from embodiedscan_torch.train import state as tT
from embodiedscan_torch.utils.convert_weights import (export_jax_tree,
                                                      load_jax_variables)

from test_torch_helpers import (flat_engine, occ_batch, random_variables,
                                to_numpy, to_torch)

SMALL = dict(num_classes=5, n_voxels=(8, 8, 4), input_capacity=1024,
             backbone_capacities=(1024, 1024, 1024, 512, 256, 128),
             resnet_depth=18, resnet_base_channels=16, mink_depth=18,
             neck3d_channels=16, fpn_channels=8, pre_neck_channels=12)


def _gt(b=2, m=48, shape=(8, 8, 4), seed=0):
    """Padded gt with collisions at ratio 2 and 4 (neighbouring voxels of
    different labels), masked rows and rows out of the grid."""
    rng = np.random.RandomState(seed)
    xyz = rng.randint(-2, np.asarray(shape) + 2, (b, m, 3))
    xyz[:, 1] = xyz[:, 0] + [1, 0, 1]  # same coarse cell as row 0
    labels = rng.randint(1, 9, (b, m, 1))
    gt = np.concatenate([xyz, labels], -1).astype(np.float32)
    mask = rng.uniform(size=(b, m)) > 0.15
    vis = rng.uniform(size=(b, ) + shape) > 0.25
    vis[:, :shape[0] // 2] = False  # whole cells unseen at every ratio
    return gt, mask, vis


@pytest.mark.parametrize('with_vis', [False, True])
@pytest.mark.parametrize('ratio', [1, 2, 4])
def test_multiscale_targets_identical(ratio, with_vis):
    shape0 = (8, 8, 4)
    gt, mask, vis = _gt()
    shape = tuple(s // ratio for s in shape0)
    vis_r = None
    if with_vis:
        # as OccHead.loss: the visibility max-pooled to the scale
        vis_r = vis.reshape(2, shape[0], ratio, shape[1], ratio, shape[2],
                            ratio).any((2, 4, 6))
    want = np.asarray(jax.vmap(
        jO.occ_multiscale_targets,
        in_axes=(0, 0, None, None, 0 if with_vis else None))(
            jnp.asarray(gt), jnp.asarray(mask), ratio, shape,
            None if vis_r is None else jnp.asarray(vis_r)))
    got = tO.occ_multiscale_targets(
        torch.from_numpy(gt), torch.from_numpy(mask), ratio, shape,
        None if vis_r is None else torch.from_numpy(vis_r)).numpy()
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(want)) > 2
    if with_vis:
        assert (want == 255).any()


def _loss_cases():
    rng = np.random.RandomState(7)
    logits = (rng.randn(2, 6, 5, 3, 6) * 2).astype(np.float32)
    tgt = rng.randint(0, 5, (2, 6, 5, 3))  # class 5 has no positive
    tgt[rng.uniform(size=tgt.shape) < 0.3] = 255
    return {'mixed': (logits, tgt),
            'all_ignored': (logits, np.full_like(tgt, 255)),
            'no_empty': (logits, np.where(tgt == 0, 3, tgt))}


@pytest.mark.parametrize('case', ['mixed', 'all_ignored', 'no_empty'])
@pytest.mark.parametrize('fn', ['cross_entropy_ignore', 'geo_scal_loss',
                                'sem_scal_loss'])
def test_occ_losses(fn, case):
    logits, tgt = _loss_cases()[case]
    jfn = getattr(jLoss if fn == 'cross_entropy_ignore' else jO, fn)
    tfn = getattr(tLoss if fn == 'cross_entropy_ignore' else tO, fn)
    want, wgrad = jax.value_and_grad(lambda x: jfn(x, jnp.asarray(tgt)))(
        jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_(True)
    got = tfn(x, torch.from_numpy(tgt))
    got.backward()
    assert np.isfinite(float(got.detach()))
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5,
                               atol=1e-7 if case == 'all_ignored' else 0)
    wgrad = np.asarray(wgrad)
    np.testing.assert_allclose(x.grad.numpy(), wgrad, rtol=0,
                               atol=1e-5 * max(np.abs(wgrad).max(), 1e-30))


def _leaves(tree, prefix=()):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _leaves(val, prefix + (key, ))
        else:
            yield prefix + (key, ), np.asarray(val)


def _unflat(flat):
    tree = {}
    for path, val in flat.items():
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = val
    return tree


@pytest.fixture(scope='module')
def step_outputs():
    batch = occ_batch(b=2, p=1024, n_voxels=SMALL['n_voxels'], seed=11)
    cfg = mv_occ()
    sc = cfg.schedule
    with flat_engine():
        jm = jO.DenseFusionOccPredictor(**SMALL)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        var = random_variables(jm, (jb, ), train=False, mode='feats')
        tx = jT.make_optimizer(
            jT.multistep_lr(sc.lr, 1000, tuple(sc.milestones)),
            sc.weight_decay, sc.clip_norm,
            lr_mult_fn=jL.lr_mult_fn_for('mv_occ'),
            params_template=var['params'])

        def step(params, stats, b):
            def loss_fn(p):
                losses, mut = jm.apply({'params': p, 'batch_stats': stats},
                                       b, train=True, mode='loss',
                                       mutable=['batch_stats'])
                return sum(losses.values()), (losses, mut['batch_stats'])

            (_, (losses, new_stats)), grads = jax.value_and_grad(
                loss_fn, has_aux=True)(params)
            upd, _ = tx.update(grads, tx.init(params), params)
            return losses, new_stats, grads, optax.apply_updates(params, upd)

        jlosses, jstats, jgrads, jparams = to_numpy(
            jax.jit(step)(var['params'], var['batch_stats'], jb))

    tm = tO.DenseFusionOccPredictor(**SMALL).train()
    load_jax_variables(tm, var['params'], var['batch_stats'])
    losses = tm(to_torch(batch), mode='loss')
    sum(losses.values()).backward()
    no_grad = [n for n, p in tm.named_parameters() if p.grad is None]
    for p in tm.parameters():
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    # copies: on the CPU the exported arrays share the gradients' memory,
    # which the optimizer's clip scales in place
    tgrads = _unflat({k: v.copy()
                      for k, v in _leaves(export_jax_tree(tm, 'grads'))})
    tstats = export_jax_tree(tm, 'buffers')
    # the optimizer after the backward: every gradient was computed above
    opt = tT.make_optimizer(tm, cfg, tL.lr_mult_fn_for('mv_occ'),
                            steps_per_epoch=1000)
    opt.step()
    return dict(jax=(jlosses, jstats, jgrads, jparams, var['params']),
                torch=({k: float(v.detach()) for k, v in losses.items()},
                       tstats, tgrads, export_jax_tree(tm, 'params')),
                no_grad=no_grad)


def test_step_losses(step_outputs):
    jl, tl = step_outputs['jax'][0], step_outputs['torch'][0]
    assert set(tl) == set(jl) == {'loss_occ_0', 'loss_occ_1', 'loss_occ_2'}
    for key in jl:
        assert np.isfinite(tl[key]) and tl[key] > 0
        np.testing.assert_allclose(tl[key], jl[key], rtol=1e-5, err_msg=key)


@pytest.mark.parametrize('tree,rel', [('grads', 1e-4), ('stats', 1e-5)])
def test_step_leaves(step_outputs, tree, rel):
    """Every gradient leaf within 1e-4 x its max|ref|, the batch statistics
    after the step within 1e-5 x max|ref|; the port computes no gradient
    exactly for the FPN outputs the model does not read (zero in the
    reference)."""
    _, jstats, jgrads, _, _ = step_outputs['jax']
    tstats, tgrads = step_outputs['torch'][1:3]
    jt, tt = (jgrads, tgrads) if tree == 'grads' else (jstats, tstats)
    want, got = dict(_leaves(jt)), dict(_leaves(tt))
    assert set(got) == set(want)
    bad = []
    for path, w in want.items():
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(got[path] - w).max())
        if not err <= rel * scale:
            bad.append(('/'.join(path), err / scale))
    assert not bad, bad
    if tree == 'stats':
        neck = jstats['ImVoxelNeck_0']['down_1_0']['BatchNorm_0']['mean']
        assert np.abs(neck).max() > 0
    else:
        no_grad = step_outputs['no_grad']
        assert sorted({n.rsplit('.', 1)[0] for n in no_grad}) == \
            ['FPN_0.fpn1', 'FPN_0.fpn2', 'FPN_0.fpn3']
        for name in no_grad:
            assert not want[tuple(name.split('.')[:-1]) + (
                name.split('.')[-1].replace('weight', 'kernel'), )].any()


def test_step_update_matches_optax(step_outputs):
    _, _, jgrads, jparams, before = step_outputs['jax']
    tparams = step_outputs['torch'][3]
    grads = dict(_leaves(jgrads))
    after_j, after_t = dict(_leaves(jparams)), dict(_leaves(tparams))
    frozen = 0
    for path, b in _leaves(before):
        if jL.lr_mult_fn_for('mv_occ')(path) == 0.0:
            frozen += 1
            np.testing.assert_array_equal(after_t[path], b)
            np.testing.assert_array_equal(after_j[path], b)
            continue
        g = grads[path]
        sure = np.abs(g) > 1e-2 * max(np.abs(g).max(), 1e-30)
        np.testing.assert_allclose(after_t[path][sure], after_j[path][sure],
                                   rtol=0, atol=1e-6, err_msg=str(path))
    assert frozen >= 8


def test_build_train_occ_step():
    """``build_train`` on the CPU: the small model takes two finite steps;
    the 2D stem and first stage stay bit-identical, every other nonzero
    parameter moves (the unread FPN outputs' kernels by weight decay
    alone; their zero biases stay), the U-Net's running statistics move."""
    cfg = mv_occ()
    m = cfg.model
    m.occ_classes, m.n_voxels = SMALL['num_classes'], SMALL['n_voxels']
    m.input_capacity = SMALL['input_capacity']
    m.backbone_capacities = SMALL['backbone_capacities']
    m.resnet_depth, m.mink_depth = 18, 18
    m.occ_fpn_channels, m.occ_pre_neck_channels = 8, 12
    model, opt = build_train(cfg, device='cpu', steps_per_epoch=1)
    assert model.training and len(opt.param_groups) == 1
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    stats = model.ImVoxelNeck_0.BatchNorm_6.mean.clone()
    tb = to_torch(occ_batch(b=1, p=1024, n_voxels=SMALL['n_voxels'],
                            seed=12))
    for _ in range(2):
        metrics = tT.train_step(model, opt, tb)
        assert set(metrics) == {'loss_occ_0', 'loss_occ_1', 'loss_occ_2',
                                'loss_total'}
        assert all(np.isfinite(float(v)) for v in metrics.values())
    frozen = {n for n, p in model.named_parameters() if not p.requires_grad}
    assert any('stem_conv' in n for n in frozen)
    assert any('layer1_' in n for n in frozen)
    for n, p in model.named_parameters():
        if n in frozen:
            assert torch.equal(p, before[n]), n
        elif before[n].any() or not n.startswith('FPN_0.fpn'):
            assert not torch.equal(p, before[n]), n
    assert not torch.equal(model.ImVoxelNeck_0.BatchNorm_6.mean, stats)
