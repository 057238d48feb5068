"""Rematerialization (``ModelConfig.remat``): the reference's modes at its
three sites, against 'none' in the port and against the reference.

- Each mode against 'none' on the small detector (ResNet blocks under
  '2d', MinkResNet stages under '3d', both under 'all') and on the small
  occupancy model (plus its U-Net under '3d'): the losses, every gradient
  and every running statistic after the step bit-identical (the recompute
  repeats the forward's float32 operations on the same values), the
  ``state_dict`` keys identical, and the recompute seen to run.
- A mutation check: with the norms' recompute guard off, the running
  statistics take a second update under '3d' and the comparison fails.
- The small detector and the small occupancy model under 'all' against
  the reference with the same ``remat``: the train-step gates of
  ``test_torch_train.py`` and ``test_torch_occ_train.py`` (losses within
  rtol 1e-5, gradients within 1e-4 x max|ref|, statistics within 1e-5 x
  max|ref|).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import __graft_entry__ as G
from embodiedscan_tpu.models import occupancy as jO
from embodiedscan_torch.configs.base import (apply_overrides, build_model,
                                             cont_occ, mv_det3d, mv_occ)
from embodiedscan_torch.models import norm as tN
from embodiedscan_torch.models import occupancy as tO
from embodiedscan_torch.models import remat as tR
from embodiedscan_torch.models.detector import SparseFusionDetector as TDet
from embodiedscan_torch.models.detector import init_weights
from embodiedscan_torch.utils.convert_weights import (export_jax_tree,
                                                      load_jax_variables)

from test_torch_helpers import (flat_engine, occ_batch, random_variables,
                                to_numpy, to_torch)

VOXEL = 0.02  # tests/test_torch_train.py's tiny detector
TINY = dict(num_classes=5, voxel_size=VOXEL, input_capacity=256,
            backbone_capacities=(256, 128, 128, 64, 32, 16),
            fpn_capacities=(128, 64, 32, 16), max_dets=16, nms_pre=32,
            max_candidates=32, resnet_depth=18, mink_depth=18)
# tests/test_torch_occ_train.py's small occupancy model
SMALL = dict(num_classes=5, n_voxels=(8, 8, 4), input_capacity=1024,
             backbone_capacities=(1024, 1024, 1024, 512, 256, 128),
             resnet_depth=18, resnet_base_channels=16, mink_depth=18,
             neck3d_channels=16, fpn_channels=8, pre_neck_channels=12)


def test_remat_modes():
    assert [tR.remat_mode(v) for v in (True, False, 'none', '2d', '3d',
                                       'all')] == \
        ['all', 'none', 'none', '2d', '3d', 'all']
    for bad in ('true', 'both', None, 1):
        with pytest.raises(ValueError):
            tR.remat_mode(bad)
    assert tR.covers('all', '2d') and tR.covers(True, '3d')
    assert not tR.covers('2d', '3d') and not tR.covers(False, '2d')


def test_config_field_and_cli_override():
    """``remat`` is a model field, 'none' in every preset of the port; the
    reference's CLI override ``model.remat=all`` applies, and build_model
    passes it to the trunk (the occupancy model takes it for cont_occ
    alone, as the reference)."""
    cfg = apply_overrides(mv_det3d(), ['model.remat=all'])
    assert cfg.model.remat == 'all' and mv_det3d().model.remat == 'none'
    for key in ('input_capacity', 'backbone_capacities', 'fpn_capacities',
                'voxel_size', 'num_classes', 'resnet_depth', 'mink_depth'):
        setattr(cfg.model, key, TINY[key])
    model = build_model(cfg, device='cpu')
    assert model.trunk.ResNet_0.remat and model.trunk.MinkResNet_0.remat
    cfg.model.remat = '2d'
    model = build_model(cfg, device='cpu')
    assert model.trunk.ResNet_0.remat and not model.trunk.MinkResNet_0.remat
    for preset, on in ((mv_occ, False), (cont_occ, True)):
        cfg = apply_overrides(preset(), ['model.remat=3d'])
        for key, val in SMALL.items():
            name = {'num_classes': 'occ_classes',
                    'fpn_channels': 'occ_fpn_channels',
                    'pre_neck_channels': 'occ_pre_neck_channels'}.get(key,
                                                                      key)
            if hasattr(cfg.model, name):
                setattr(cfg.model, name, val)
        model = build_model(cfg, device='cpu')
        assert model.remat_neck == on and model.MinkResNet_0.remat == on
        assert not model.ResNet_0.remat
    cfg.model.remat = 'sometimes'
    with pytest.raises(ValueError):
        build_model(cfg, device='cpu')


# --- each mode against 'none' in the port -----------------------------------


def _detector(mode):
    model = TDet(**TINY, remat=mode)
    init_weights(model, torch.Generator().manual_seed(0))
    return model.train()


def _occupancy(mode):
    model = tO.DenseFusionOccPredictor(**SMALL, remat=mode)
    init_weights(model, torch.Generator().manual_seed(0))
    return model.train()


def _det_batch():
    return to_torch({k: np.array(v) for k, v in G._tiny_batch().items()})


def _occ_batch():
    return to_torch(occ_batch(b=2, p=1024, n_voxels=SMALL['n_voxels'],
                              seed=11))


# a module of each site, whose forward calls count its recomputes
SITES = {'detector': {'2d': 'trunk.ResNet_0.layer2_0',
                      '3d': 'trunk.MinkResNet_0.SparseStage_1'},
         'occupancy': {'2d': 'ResNet_0.layer2_0',
                       '3d': 'MinkResNet_0.SparseStage_1',
                       'neck': 'ImVoxelNeck_0'}}


def _step(model, batch, sites):
    """One forward and backward: the losses, the gradients and the
    buffers after it, and the forward calls of each site module."""
    calls = dict.fromkeys(sites, 0)
    hooks = []
    for key, path in sites.items():
        def count(*_, key=key):
            calls[key] += 1
        hooks.append(model.get_submodule(path).register_forward_pre_hook(
            count))
    losses = model(batch, mode='loss')
    sum(losses.values()).backward()
    for h in hooks:
        h.remove()
    return ({k: v.detach() for k, v in losses.items()},
            {n: p.grad for n, p in model.named_parameters()},
            {n: b.clone() for n, b in model.named_buffers()}, calls)


def _mismatches(ref, got):
    """The names of the losses, gradients and buffers that are not
    bit-identical."""
    bad = []
    for kind, a, b in zip(('loss', 'grad', 'buffer'), ref[:3], got[:3]):
        assert set(a) == set(b)
        for name in a:
            x, y = a[name], b[name]
            if (x is None) != (y is None) or (
                    x is not None and not torch.equal(x, y)):
                bad.append(f'{kind} {name}')
    return bad


@pytest.fixture(scope='module')
def references():
    return {'detector': _step(_detector('none'), _det_batch(),
                              SITES['detector']),
            'occupancy': _step(_occupancy('none'), _occ_batch(),
                               SITES['occupancy'])}


@pytest.mark.parametrize('model', ['detector', 'occupancy'])
@pytest.mark.parametrize('mode', ['2d', '3d', 'all'])
def test_mode_bit_identical_to_none(references, model, mode):
    build, batch = {'detector': (_detector, _det_batch),
                    'occupancy': (_occupancy, _occ_batch)}[model]
    ref = references[model]
    m = build(mode)
    assert list(m.state_dict()) == list(build('none').state_dict())
    got = _step(m, batch(), SITES[model])
    assert not _mismatches(ref, got)
    assert ref[3] == dict.fromkeys(SITES[model], 1)
    want = {site: 2 if tR.covers(mode, '3d' if site == 'neck' else site)
            else 1 for site in SITES[model]}
    assert got[3] == want  # the rematerialized sites ran twice
    # the running statistics the comparison holds did move in the step
    fresh = build('none')
    stats = [f'{name}.{s}' for name, mod in fresh.named_modules()
             if isinstance(mod, (tN.MaskedBatchNorm, tN.DenseBatchNorm))
             for s in ('mean', 'var')]
    buffers = dict(fresh.named_buffers())
    assert stats and all(not torch.equal(ref[2][n], buffers[n])
                         for n in stats)


def test_extra_running_update_fails_the_comparison(references,
                                                   monkeypatch):
    """Mutation check: with the recompute guard off, the '3d' recompute
    updates the stages' and the U-Net's running statistics a second time,
    and the comparison against 'none' names them."""
    monkeypatch.setattr(tN, 'recomputing', lambda: False)
    got = _step(_occupancy('3d'), _occ_batch(), SITES['occupancy'])
    bad = _mismatches(references['occupancy'], got)
    assert bad and all(b.startswith('buffer ') for b in bad)
    assert any('ImVoxelNeck_0' in b for b in bad)
    assert any('MinkResNet_0.SparseStage' in b for b in bad)


# --- 'all' against the reference --------------------------------------------


def _leaves(tree, prefix=()):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _leaves(val, prefix + (key, ))
        else:
            yield prefix + (key, ), np.asarray(val)


def _close_leaves(got, want, rel):
    want, got = dict(_leaves(want)), dict(_leaves(got))
    assert set(got) == set(want)
    bad = []
    for path, w in want.items():
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(got[path] - w).max())
        if err > rel * scale:
            bad.append(('/'.join(path), err / scale))
    return bad


def _jax_step(jm, var, jb, loss):
    def step(params, stats, b):
        def loss_fn(p):
            losses, st = loss({'params': p, 'batch_stats': stats}, b)
            return sum(losses.values()), (losses, st)

        (_, aux), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        return aux, grads

    return to_numpy(jax.jit(step)(var['params'], var['batch_stats'], jb))


@pytest.fixture(scope='module')
def detector_all():
    batch = {k: np.array(v) for k, v in G._tiny_batch().items()}
    with flat_engine():
        jm = G._tiny_model().clone(voxel_size=VOXEL, remat='all')
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        var = random_variables(jm, (jb, ), train=False, mode='feats')

        def loss(v, b):
            outs, mut = jm.apply(v, b, train=True, mode='feats',
                                 mutable=['batch_stats'])
            return jm.apply(v, outs, b['gt_boxes'], b['gt_labels'],
                            b['gt_mask'], method=lambda m, o, *gt:
                            m.bbox_head.loss(o, *gt)), mut['batch_stats']

        (jlosses, jstats), jgrads = _jax_step(jm, var, jb, loss)
    tm = TDet(**TINY, remat='all').train()
    load_jax_variables(tm, var['params'], var['batch_stats'])
    losses = tm(to_torch(batch), mode='loss')
    sum(losses.values()).backward()
    return (jlosses, jstats, jgrads), (
        {k: float(v.detach()) for k, v in losses.items()},
        export_jax_tree(tm, 'buffers'), export_jax_tree(tm, 'grads'))


@pytest.fixture(scope='module')
def occupancy_all():
    batch = occ_batch(b=2, p=1024, n_voxels=SMALL['n_voxels'], seed=11)
    with flat_engine():
        jm = jO.DenseFusionOccPredictor(**SMALL, remat='all')
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        var = random_variables(jm, (jb, ), train=False, mode='feats')

        def loss(v, b):
            losses, mut = jm.apply(v, b, train=True, mode='loss',
                                   mutable=['batch_stats'])
            return losses, mut['batch_stats']

        (jlosses, jstats), jgrads = _jax_step(jm, var, jb, loss)
    tm = tO.DenseFusionOccPredictor(**SMALL, remat='all').train()
    load_jax_variables(tm, var['params'], var['batch_stats'])
    losses = tm(to_torch(batch), mode='loss')
    sum(losses.values()).backward()
    for p in tm.parameters():  # the reference's zero leaves
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    return (jlosses, jstats, jgrads), (
        {k: float(v.detach()) for k, v in losses.items()},
        export_jax_tree(tm, 'buffers'), export_jax_tree(tm, 'grads'))


@pytest.mark.parametrize('model', ['detector_all', 'occupancy_all'])
def test_all_against_reference(request, model):
    (jl, jstats, jgrads), (tl, tstats, tgrads) = \
        request.getfixturevalue(model)
    assert set(tl) == set(jl)
    for key in jl:
        assert np.isfinite(tl[key]) and tl[key] > 0
        np.testing.assert_allclose(tl[key], jl[key], rtol=1e-5, err_msg=key)
    assert not _close_leaves(tgrads, jgrads, 1e-4)
    assert not _close_leaves(tstats, jstats, 1e-5)
