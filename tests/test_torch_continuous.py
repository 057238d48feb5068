"""Port vs reference: the continuous tasks on a sweep pseudo-batch.

Each batch comes from the port's own data path: a synthetic scan through
``scan_to_sweeps`` (3 cumulative sweeps sharing one scan's images, the
later sweeps' views hidden from the earlier rows by ``view_mask``, the
ground truth visible up to each sweep). The reference runs the flat
engine; each JAX model compiles once in this file.

- cont_det3d (the tiny detector of ``test_torch_train.py``: ResNet-18,
  MinkResNet-18, voxel 0.02 m; the regression head's rotation bias at the
  identity's 6D vectors, see ``det_outputs``) serving: the head's points
  and masks, the predicted labels and NMS keep identical; boxes, scores
  and the head's floats within atol 1e-4 + rtol 1e-5. One train step:
  losses within rtol 1e-5, every gradient leaf within 1e-4 x its max|ref|,
  batch statistics within 1e-5 x max|ref|.
- cont_occ (the small widths of ``test_torch_occupancy.py``) in float32:
  per-scale logits within atol 1e-4 + rtol 1e-5, classes identical. With
  the U-Net in bfloat16 (the preset's ``occ_neck_bf16``): each package's
  bf16 logits are held against its own float32 logits from the same
  weights; the port's error must be at most twice the reference's plus
  ``BF16_SLACK`` x max|logit|, and the classes the two packages predict
  in bf16 may differ only where the reference's top two bf16 logits are
  closer than the larger of the two errors (such voxels are counted).
- ``_append_scene_results`` for both continuous tasks, record for record.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from embodiedscan_tpu.configs import base as jcfg
from embodiedscan_tpu.models import occupancy as jO
from embodiedscan_tpu.models.detector import SparseFusionDetector as JDet
from embodiedscan_tpu.train.loop import _append_scene_results as j_append
from embodiedscan_tpu.train.loop import _stack_eval_batches as j_stack
from embodiedscan_torch.configs import base as tcfg
from embodiedscan_torch.data import synthetic as tsyn
from embodiedscan_torch.data.loader import to_device
from embodiedscan_torch.models import occupancy as tO
from embodiedscan_torch.models.detector import SparseFusionDetector as TDet
from embodiedscan_torch.train import state as tT
from embodiedscan_torch.train.loop import _append_scene_results as t_append
from embodiedscan_torch.train.loop import _stack_eval_batches as t_stack
from embodiedscan_torch.utils.convert_weights import (export_jax_tree,
                                                      load_jax_variables)

from test_torch_helpers import flat_engine, random_variables, to_numpy

TOL = dict(atol=1e-4, rtol=1e-5)
SWEEPS = 3
DET = dict(num_classes=5, voxel_size=0.02, input_capacity=1024,
           backbone_capacities=(1024, 512, 512, 256, 128, 64),
           fpn_capacities=(256, 128, 64, 32), max_dets=16, nms_pre=32,
           max_candidates=32, resnet_depth=18, mink_depth=18)
OCC = dict(num_classes=5, resnet_depth=18, resnet_base_channels=16,
           mink_depth=18, neck3d_channels=16, fpn_channels=8,
           pre_neck_channels=12, n_voxels=(8, 8, 4), input_capacity=2048,
           backbone_capacities=(2048, 2048, 2048, 1024, 512, 512))
# bf16 gate slack, in units of max|float32 logit|: one bf16 rounding step
# (2^-8) of the largest logit
BF16_SLACK = 2.0**-8
# the rotation prior's weight on every feature channel (see det_outputs)
ROT_PRIOR = 0.05
SERVE = ('points', 'points_mask', 'imgs', 'proj', 'aug_inv', 'view_mask')


def _sweeps(train, occ_shape=None, seed=1):
    """A 3-sweep pseudo-batch of a synthetic 6 m room seen by 3 views of
    32 x 32, 300 points a view and up to 700 a sweep."""
    scan = tsyn.make_scan(seed=0, n_views=SWEEPS, hw=(32, 32), g=6,
                          num_classes=5)
    return tsyn.scan_to_sweeps(scan, SWEEPS, num_points=700, num_boxes=8,
                               seed=seed, train=train, points_per_view=300,
                               occ_shape=occ_shape)


def _leaves(tree, prefix=()):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _leaves(val, prefix + (key, ))
        else:
            yield prefix + (key, ), np.asarray(val)


# --- cont_det3d -------------------------------------------------------------


@pytest.fixture(scope='module')
def det_outputs():
    """The reference's predict and train step on one pseudo-batch (one
    compile), and the port's on the same weights."""
    batch = _sweeps(train=True)
    assert batch['points'].shape[0] == SWEEPS and batch['imgs'].shape[0] == 1
    assert not batch['gt_mask'][0].all() and batch['gt_mask'][-1].sum() > 0
    with flat_engine():
        jm = JDet(**DET)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        var = random_variables(jm, (jb, ), train=False, mode='feats')
        head = var['params']['bbox_head']
        head['conv_cls']['bias'][:] = 0
        # a trained head's rotation prior: the 6D vectors near the identity's
        # (1, 0, 0), (0, 1, 0) (the features, ELUs of batch-normed convs,
        # are positive on average). From
        # random weights a location's two vectors can be near-parallel,
        # where the Gram-Schmidt decode amplifies float rounding ~100x into
        # the box loss's gradient in either package
        head['conv_reg']['kernel'][:, [6, 10]] += ROT_PRIOR

        def run(params, stats, b):
            v = {'params': params, 'batch_stats': stats}
            outs = jm.apply(v, b, train=False, mode='feats')
            preds = jm.apply(v, outs,
                             method=lambda m, o: m.bbox_head.predict(o))

            def loss_fn(p):
                vv = {'params': p, 'batch_stats': stats}
                o, mut = jm.apply(vv, b, train=True, mode='feats',
                                  mutable=['batch_stats'])
                losses = jm.apply(vv, o, b['gt_boxes'], b['gt_labels'],
                                  b['gt_mask'], method=lambda m, oo, *gt:
                                  m.bbox_head.loss(oo, *gt))
                return sum(losses.values()), (losses, mut['batch_stats'])

            (_, aux), grads = jax.value_and_grad(loss_fn, has_aux=True)(
                params)
            return outs, preds, aux, grads

        jouts, jpreds, (jlosses, jstats), jgrads = to_numpy(
            jax.jit(run)(var['params'], var['batch_stats'], jb))
    tm = TDet(**DET).eval()
    load_jax_variables(tm, var['params'], var['batch_stats'])
    tb = to_device(batch, 'cpu')
    touts = to_numpy(tm(tb, mode='feats'))
    tpreds = to_numpy(tm(tb, mode='predict'))
    tm.train()
    tlosses = tm(tb, mode='loss')
    sum(tlosses.values()).backward()
    return dict(
        jax=(jouts, jpreds, jlosses, jstats, jgrads),
        torch=(touts, tpreds, {k: float(v.detach())
                               for k, v in tlosses.items()},
               export_jax_tree(tm, 'buffers'),
               {k: v.copy() for k, v in _leaves(export_jax_tree(tm,
                                                                'grads'))}),
        model=tm, batch=tb)


def test_cont_det3d_head_integers(det_outputs):
    jouts, touts = det_outputs['jax'][0], det_outputs['torch'][0]
    assert all(m.shape[0] == SWEEPS for m in touts.masks)
    # the sweeps hold different points: their rows differ
    assert not np.array_equal(touts.points[0][0], touts.points[0][-1])
    for g, w in zip(touts.points + touts.masks, jouts.points + jouts.masks):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize('field', ['center', 'reg', 'cls'])
def test_cont_det3d_head_floats(det_outputs, field):
    jouts, touts = det_outputs['jax'][0], det_outputs['torch'][0]
    for g, w in zip(getattr(touts, field), getattr(jouts, field)):
        np.testing.assert_allclose(g, w, **TOL)


def test_cont_det3d_predict(det_outputs):
    """One (max_dets,) record per sweep row: labels and NMS keep identical,
    boxes and scores within the tolerance."""
    jp, tp = det_outputs['jax'][1], det_outputs['torch'][1]
    assert tp['bboxes'].shape == (SWEEPS, DET['max_dets'], 9)
    assert jp['mask'].sum(1).min() > 0, 'a sweep kept no detection'
    for key in ('labels', 'mask'):
        np.testing.assert_array_equal(tp[key], jp[key])
    for key in ('bboxes', 'scores'):
        np.testing.assert_allclose(tp[key], jp[key], **TOL)


def test_cont_det3d_train_losses(det_outputs):
    jl, tl = det_outputs['jax'][2], det_outputs['torch'][2]
    assert set(tl) == set(jl) == {'loss_center', 'loss_bbox', 'loss_cls'}
    for key in jl:
        assert np.isfinite(tl[key]) and tl[key] > 0
        np.testing.assert_allclose(tl[key], jl[key], rtol=1e-5)


@pytest.mark.parametrize('tree,rel', [('grads', 1e-4), ('stats', 1e-5)])
def test_cont_det3d_train_leaves(det_outputs, tree, rel):
    _, _, _, jstats, jgrads = det_outputs['jax']
    _, _, _, tstats, tgrads = det_outputs['torch']
    want = dict(_leaves(jgrads if tree == 'grads' else jstats))
    got = tgrads if tree == 'grads' else dict(_leaves(tstats))
    assert set(got) == set(want)
    bad = []
    for path, w in want.items():
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(got[path] - w).max())
        if err > rel * scale:
            bad.append(('/'.join(path), err / scale))
    assert not bad, bad


def test_cont_det3d_build_train_step(det_outputs):
    """``build_train`` of the preset at small capacities takes a finite
    step on the pseudo-batch: one loss over all sweep rows."""
    cfg = tcfg.cont_det3d()
    for key, val in DET.items():
        if hasattr(cfg.model, key):
            setattr(cfg.model, key, val)
    model, opt = tcfg.build_train(cfg, device='cpu', steps_per_epoch=1)
    assert isinstance(model, TDet) and model.training
    metrics = tT.train_step(model, opt, det_outputs['batch'])
    assert all(np.isfinite(float(v)) for v in metrics.values())


# --- cont_occ ---------------------------------------------------------------


@pytest.fixture(scope='module')
def occ_outputs():
    """Per-scale logits and classes of both packages from one random tree:
    the whole model in float32, and the U-Net in bfloat16. The reference
    compiles its float32 model (which also returns the U-Net's input, the
    pre-neck's output) and its bf16 U-Net and head on that input: everything
    before the U-Net computes in float32 in both models. The port runs its
    whole bf16 model."""
    batch = _sweeps(train=False, occ_shape=OCC['n_voxels'], seed=2)
    serve = {k: batch[k] for k in SERVE}
    out = {}
    with flat_engine():
        jb = {k: jnp.asarray(v) for k, v in serve.items()}
        jm = jO.DenseFusionOccPredictor(**OCC)
        var = random_variables(jm, (jb, ), train=False, mode='feats')

        def run(v, b):
            logits, inter = jm.apply(
                v, b, train=False, mode='feats',
                capture_intermediates=lambda mdl, _: mdl.name == 'pre_neck')
            pred = jm.apply(v, b, train=False, mode='predict')
            return logits, pred, inter['intermediates']['pre_neck'][
                '__call__'][0]

        logits, pred, x = jax.jit(run)(var, jb)
        out[('jax', 'f32')] = to_numpy((logits, pred))
        neck = jO.ImVoxelNeck(OCC['pre_neck_channels'],
                              OCC['neck3d_channels'], dtype=jnp.bfloat16)
        head = jO.OccHead(OCC['num_classes'])
        nv = {c: {'params': var['params'][n], 'batch_stats':
                  var['batch_stats'].get(n, {})}
              for c, n in ((neck, 'ImVoxelNeck_0'), (head, 'OccHead_0'))}
        bf16 = jax.jit(lambda x: head.apply(
            {'params': nv[head]['params']},
            neck.apply(nv[neck], x, False)))(x)
        out[('jax', 'bf16')] = to_numpy(
            (bf16, jnp.argmax(bf16[0], axis=-1)))
    tb = to_device(serve, 'cpu')
    for name, dt in (('f32', torch.float32), ('bf16', torch.bfloat16)):
        tm = tO.DenseFusionOccPredictor(**OCC, neck_dtype=dt).eval()
        load_jax_variables(tm, var['params'], var['batch_stats'])
        out[('torch', name)] = to_numpy((tm(tb, mode='feats'),
                                         tm(tb, mode='predict')))
    return out


def test_cont_occ_float32(occ_outputs):
    (jf, jp), (tf, tp) = occ_outputs[('jax', 'f32')], \
        occ_outputs[('torch', 'f32')]
    assert tp.shape == (SWEEPS, *OCC['n_voxels'])
    assert [f.shape[0] for f in tf] == [SWEEPS] * 3
    for g, w in zip(tf, jf):
        np.testing.assert_allclose(g, w, **TOL)
    np.testing.assert_array_equal(tp, jp)
    assert len(np.unique(jp)) > 1
    # the sweeps see different views: the rows differ
    assert not np.array_equal(jf[0][0], jf[0][-1])


def test_cont_occ_bfloat16_gate(occ_outputs):
    """Each package's bf16 logits against its own float32 logits."""
    jf, tf = occ_outputs[('jax', 'f32')][0], occ_outputs[('torch', 'f32')][0]
    (jb, jp), (tb, tp) = occ_outputs[('jax', 'bf16')], \
        occ_outputs[('torch', 'bf16')]
    for i, (a, b) in enumerate(zip(tb, jb)):
        assert a.dtype == b.dtype == np.float32, i
        err_j = float(np.abs(b - jf[i]).max())
        err_t = float(np.abs(a - tf[i]).max())
        slack = BF16_SLACK * float(np.abs(jf[i]).max())
        assert 0 < err_j and err_t <= 2 * err_j + slack, \
            (i, err_t, err_j, slack)
    err = max(float(np.abs(jb[0] - jf[0]).max()),
              float(np.abs(tb[0] - tf[0]).max()))
    top2 = np.sort(jb[0], axis=-1)[..., -2:]
    flips = tp != jp
    assert (top2[..., 1] - top2[..., 0])[flips].max(initial=0) <= err
    assert flips.sum() <= 0.01 * flips.size


# --- fusion over many sweeps ------------------------------------------------


@pytest.mark.parametrize('mode', ['nearest', 'bilinear'])
def test_fusion_in_sweep_chunks(mode, monkeypatch):
    """Sampled a chunk of two sweeps at a time (``fusion.MAX_SAMPLES``
    lowered), the means are the unchunked call's bits; both match the
    reference's within the tolerance."""
    from embodiedscan_tpu.models import fusion as jF
    from embodiedscan_torch.models import fusion as tF
    rng = np.random.RandomState(4)
    bi, s, v, n, c, hw = 1, 5, 4, 60, 8, (32, 40)
    pts = rng.uniform(-1, 1, (bi, s, n, 3)).astype(np.float32)
    args = [pts, rng.uniform(size=(bi, s, n)) > 0.2,
            rng.randn(bi, v, 8, 10, c).astype(np.float32),
            np.tile(np.array([[20.0, 0, 20, 0], [0, 20, 16, 0], [0, 0, 1, 4],
                              [0, 0, 0, 1]], np.float32), (bi, v, 1, 1)),
            np.tile(np.eye(4, dtype=np.float32), (bi, 1, 1))]
    vmask = np.tril(np.ones((s, v), bool))[None]
    want = np.asarray(jF.point_image_sample_batched(
        *(jnp.asarray(a) for a in args), hw, mode, jnp.asarray(vmask)))
    targs = [torch.from_numpy(a) for a in args]
    whole = tF.point_image_sample_batched(*targs, hw, mode,
                                          torch.from_numpy(vmask))
    monkeypatch.setattr(tF, 'MAX_SAMPLES', 2 * v * n * c)
    chunked = tF.point_image_sample_batched(*targs, hw, mode,
                                            torch.from_numpy(vmask))
    assert torch.equal(chunked, whole)
    np.testing.assert_allclose(whole.numpy(), want, **TOL)
    assert (want != 0).any() and (want == 0).any()


# --- eval records -----------------------------------------------------------


@pytest.mark.parametrize('task', ['cont_det3d', 'cont_occ'])
def test_append_scene_results_cont(task):
    """One record per sweep row, the padded rows dropped; two scans'
    pseudo-batches stack along the sweep axis (``_stack_eval_batches``)."""
    rng = np.random.RandomState(3)
    jc, tc = jcfg.PRESETS[task](), tcfg.PRESETS[task]()
    jc.model.n_voxels = tc.model.n_voxels = (4, 4, 2)
    if task == 'cont_det3d':
        batch = _sweeps(train=False)
        d = 6
        preds = dict(bboxes=rng.randn(SWEEPS, d, 9).astype(np.float32),
                     scores=rng.rand(SWEEPS, d).astype(np.float32),
                     labels=rng.randint(0, 5, (SWEEPS, d)).astype(np.int64),
                     mask=rng.rand(SWEEPS, d) > 0.4)
        tpreds = {k: torch.from_numpy(v) for k, v in preds.items()}
    else:
        batch = _sweeps(train=False, occ_shape=(4, 4, 2))
        m = 20
        gt = np.concatenate([rng.randint(-1, 5, (SWEEPS, m, 3)),
                             rng.randint(1, 5, (SWEEPS, m, 1))], -1)
        batch['gt_occ'] = gt.astype(np.float32)
        batch['gt_occ_mask'] = rng.rand(SWEEPS, m) > 0.2
        preds = rng.randint(0, 5, (SWEEPS, 4, 4, 2))
        tpreds = torch.from_numpy(preds)
    jg, jd, tg, td = [], [], [], []
    assert j_append(jc, batch, preds, SWEEPS - 1, jg, jd, 2) == SWEEPS + 1
    assert t_append(tc, to_device(batch, 'cpu'), tpreds, SWEEPS - 1, tg, td,
                    2) == SWEEPS + 1
    assert len(tg) == len(td) == SWEEPS - 1
    if task == 'cont_occ':  # two scans' pseudo-batches, stacked
        again = {k: v[::-1].copy() for k, v in batch.items()}
        want = j_stack([batch, again])
        got = t_stack([batch, again])
        assert set(got) == set(want)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key])
        assert got['points'].shape[0] == 2 * SWEEPS
    for want, got in ((jg, tg), (jd, td)):
        for w, g in zip(want, got):
            if isinstance(w, dict):
                assert set(g) == set(w)
                for key in w:
                    np.testing.assert_array_equal(g[key], w[key])
            else:
                np.testing.assert_array_equal(g, np.asarray(w))
