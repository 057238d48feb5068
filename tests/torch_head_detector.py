"""Port vs reference: the tiny detector with the yaw or axis-aligned head
(the tests of ``test_torch_head_{yaw,aa}.py``, one file per mode, each
naming its ``MODE``).

``SparseFusionDetector(bbox_mode=MODE)`` at
``tests/test_detector.py:TestYawHead``'s sizes (ResNet-18, MinkResNet-18,
5 classes), from the same random JAX variables carried across
(``load_jax_variables``), on ``__graft_entry__._tiny_batch`` with the gt
boxes' pitch and roll zeroed, as that test does:

- predict (eval mode, the class bias zeroed so candidates clear
  ``score_thr``): labels and keep masks identical, boxes and scores within
  atol 1e-4 plus rtol 1e-5 (``test_torch_detector.py``'s gates); the yaw
  head's boxes keep no pitch or roll, the axis-aligned head's no angle;
- one train step (training mode): the engine's integer outputs identical,
  the losses within rtol 1e-5, and every gradient leaf of the head and the
  gradient that the head sends back into the trunk's fused features within
  1e-4 x its max|ref| (``test_torch_train.py``'s gates).

The reference computes the trunk once per norm mode and differentiates the
head alone (smaller compiles than the whole detector's). The trunk's
backward from the fused features is the rot-mat detector's, whose every
leaf ``test_torch_train.py`` holds against the reference.

Voxel 0.02 m, as ``test_torch_train.py``: at the test's 0.05 m the coarse
levels hold 1-2 voxels a sample, and batch statistics over so few rows tie
the FPN prune scores within float rounding.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import __graft_entry__ as G
from embodiedscan_tpu.models.detector import SparseFusionDetector as JDet
from embodiedscan_tpu.ops.sparse import SparseTensor as JST
from embodiedscan_torch.models.detector import SparseFusionDetector as TDet
from embodiedscan_torch.utils.convert_weights import (export_jax_tree,
                                                      load_jax_variables)

from test_torch_helpers import (flat_engine, random_variables, to_numpy,
                                to_torch)

TOL = dict(atol=1e-4, rtol=1e-5)
TINY = dict(num_classes=5, voxel_size=0.02, input_capacity=512,
            backbone_capacities=(512, 256, 256, 128, 64, 32),
            fpn_capacities=(256, 128, 64, 32), max_dets=16, nms_pre=64,
            max_candidates=64, resnet_depth=18, mink_depth=18)


def _leaves(tree, prefix=()):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _leaves(val, prefix + (key,))
        else:
            yield prefix + (key,), np.asarray(val)


@pytest.fixture(scope='module')
def run(request):
    """The reference's and the port's predictions, losses, head outputs'
    integers and gradients (the head's parameters, the fused features) in
    the test module's ``MODE``."""
    mode = request.module.MODE
    batch = {k: np.array(v) for k, v in G._tiny_batch().items()}
    batch['gt_boxes'][..., 7:9] = 0.0
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    with flat_engine():
        jm = JDet(**TINY, bbox_mode=mode)
        var = random_variables(jm, (jb,), train=False, mode='feats')
        var['params']['bbox_head']['conv_cls']['bias'][:] = 0

        def fused(v, b, train):
            return jm.apply(v, b, method=lambda m, x: m.trunk(
                x, train=train), mutable=['batch_stats'])[0]

        def head(hp, f, train):
            v = {'params': {'bbox_head': hp},
                 'batch_stats': {'bbox_head': var['batch_stats']['bbox_head']}}
            return jm.apply(v, f, method=lambda m, x: m.bbox_head(
                x, train=train), mutable=['batch_stats'])[0], v

        def predict(v, b):
            outs, hv = head(v['params']['bbox_head'], fused(v, b, False),
                            False)
            return jm.apply(hv, outs, method=lambda m, o:
                            m.bbox_head.predict(o))

        def step(hp, fvals, f, b):
            def loss_fn(hp, fvals):
                x = [JST(t.coords, fv, t.mask) for t, fv in zip(f, fvals)]
                outs, v = head(hp, x, True)
                losses = jm.apply(v, outs, b['gt_boxes'], b['gt_labels'],
                                  b['gt_mask'], method=lambda m, o, *gt:
                                  m.bbox_head.loss(o, *gt))
                return sum(losses.values()), (losses, outs.points,
                                              outs.masks)

            return jax.value_and_grad(loss_fn, argnums=(0, 1),
                                      has_aux=True)(hp, fvals)

        jpreds = to_numpy(jax.jit(predict)(var, jb))
        feats = jax.jit(lambda v, b: fused(v, b, True))(var, jb)
        (_, (jlosses, jpoints, jmasks)), (jghead, jgfeats) = to_numpy(
            jax.jit(step)(var['params']['bbox_head'],
                          [t.feats for t in feats], feats, jb))

    tm = TDet(**TINY, bbox_mode=mode).eval()
    load_jax_variables(tm, var['params'], var['batch_stats'])
    tb = to_torch(batch)
    tpreds = to_numpy(tm(tb, mode='predict'))
    tm.train()
    seen, inputs = [], []

    def keep_inputs(mod, args):
        for st in args[0]:
            st.feats.retain_grad()
        inputs.extend(args[0])

    hooks = [tm.bbox_head.register_forward_pre_hook(keep_inputs),
             tm.bbox_head.register_forward_hook(
                 lambda mod, args, out: seen.append(out))]
    tlosses = tm(tb, mode='loss')
    for h in hooks:
        h.remove()
    sum(tlosses.values()).backward()
    return dict(mode=mode, preds=(jpreds, tpreds),
                losses=(jlosses, {k: float(v.detach())
                                  for k, v in tlosses.items()}),
                ints=(list(jpoints) + list(jmasks),
                      to_numpy(seen[0].points) + to_numpy(seen[0].masks)),
                grads=(dict(bbox_head=jghead, fused=dict(enumerate(jgfeats))),
                       dict(bbox_head=export_jax_tree(tm, 'grads')[
                           'bbox_head'],
                            fused={i: st.feats.grad.numpy()
                                   for i, st in enumerate(inputs)})))


def test_predict(run):
    jp, tp = run['preds']
    assert jp['mask'].sum() > 0, 'no detection kept: comparison is vacuous'
    np.testing.assert_array_equal(tp['labels'], jp['labels'])
    np.testing.assert_array_equal(tp['mask'], jp['mask'])
    for field in ('bboxes', 'scores'):
        assert tp[field].shape == jp[field].shape
        np.testing.assert_allclose(tp[field], jp[field], **TOL)
    kept = tp['bboxes'][tp['mask']]
    np.testing.assert_array_equal(kept[:, 7:9], 0.0)
    if run['mode'] == 'aa6d':
        np.testing.assert_array_equal(kept[:, 6], 0.0)
    else:
        assert np.abs(kept[:, 6]).max() > 0


def test_train_step_integer_outputs_identical(run):
    want, got = run['ints']
    assert sum(m.sum() for m in want[len(want) // 2:]) > 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_train_step_losses(run):
    jl, tl = run['losses']
    assert set(tl) == set(jl) == {'loss_center', 'loss_bbox', 'loss_cls'}
    assert 0 < tl['loss_bbox'] < 1  # 1 - IoU over the positive locations
    for key in jl:
        assert np.isfinite(tl[key]) and tl[key] > 0
        np.testing.assert_allclose(tl[key], jl[key], rtol=1e-5)


def test_train_step_gradients(run):
    jg, tg = run['grads']
    want, got = dict(_leaves(jg)), dict(_leaves(tg))
    assert len(want) > 30
    assert set(got) == set(want)
    assert np.abs(got[('bbox_head', 'conv_reg', 'kernel')]).max() > 0
    bad = []
    for path, w in want.items():
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(got[path] - w).max()) / scale
        if not err <= 1e-4:
            bad.append(('/'.join(path), err))
    assert not bad, bad
