"""Port vs reference: the whole serving slice (flat engine) on the tiny
detector with MinkResNet-34 and ResNet-50, weights converted leaf by leaf.

Random positive running statistics exercise the BN conversion, and the
class bias is zeroed so candidates clear ``score_thr`` (at the reference's
init bias of -4.6 the tiny model keeps no detection and the comparison
would prove nothing). Integers are exact; floats agree within atol 1e-4
plus rtol 1e-5 (float32 sums in another order through ~70 layers, with
activations up to ~1e2).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from embodiedscan_tpu.models.detector import SparseFusionDetector as JDet
from embodiedscan_torch.configs.base import build_model, mv_det3d
from embodiedscan_torch.models.detector import SparseFusionDetector as TDet
from embodiedscan_torch.utils.convert_weights import load_jax_variables

from test_torch_helpers import (flat_engine, random_variables, tiny_batch,
                                to_numpy, to_torch)

TOL = dict(atol=1e-4, rtol=1e-5)
# __graft_entry__._tiny_model at the shipped depths
TINY = dict(num_classes=5, voxel_size=0.05, input_capacity=256,
            backbone_capacities=(256, 128, 128, 64, 32, 16),
            fpn_capacities=(128, 64, 32, 16), max_dets=16, nms_pre=32,
            max_candidates=32, resnet_depth=50, mink_depth=34)


@pytest.fixture(scope='module')
def slice_outputs():
    batch = tiny_batch()
    with flat_engine():
        jm = JDet(**TINY)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        var = random_variables(jm, (jb,), train=False, mode='feats')
        var['params']['bbox_head']['conv_cls']['bias'][:] = 0

        def run(v, b):
            outs = jm.apply(v, b, train=False, mode='feats')
            return outs, jm.apply(v, outs,
                                  method=lambda m, o: m.bbox_head.predict(o))

        jouts, jpreds = to_numpy(jax.jit(run)(var, jb))
    tm = TDet(**TINY).eval()
    load_jax_variables(tm, var['params'], var['batch_stats'])
    tb = to_torch(batch)
    touts = to_numpy(tm(tb, mode='feats'))
    tpreds = to_numpy(tm(tb, mode='predict'))
    return jouts, touts, jpreds, tpreds


@pytest.mark.parametrize('field', ['points', 'masks'])
def test_feats_integers(slice_outputs, field):
    jouts, touts, _, _ = slice_outputs
    for w, g in zip(getattr(jouts, field), getattr(touts, field)):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize('field', ['center', 'reg', 'cls'])
def test_feats_floats(slice_outputs, field):
    jouts, touts, _, _ = slice_outputs
    for w, g in zip(getattr(jouts, field), getattr(touts, field)):
        np.testing.assert_allclose(g, w, **TOL)


def test_predict_labels_and_mask(slice_outputs):
    _, _, jp, tp = slice_outputs
    assert jp['mask'].sum() > 0, 'no detection kept: comparison is vacuous'
    np.testing.assert_array_equal(tp['labels'], jp['labels'])
    np.testing.assert_array_equal(tp['mask'], jp['mask'])


@pytest.mark.parametrize('field', ['bboxes', 'scores'])
def test_predict_floats(slice_outputs, field):
    _, _, jp, tp = slice_outputs
    assert tp[field].shape == jp[field].shape
    np.testing.assert_allclose(tp[field], jp[field], **TOL)


def test_build_model_entry_point():
    cfg = mv_det3d()
    cfg.model.num_classes = 5
    for key in ('input_capacity', 'backbone_capacities', 'fpn_capacities',
                'max_dets', 'nms_pre', 'max_candidates', 'voxel_size'):
        setattr(cfg.model, key, TINY[key])
    if torch.cuda.is_available():
        pytest.skip('checks the CPU-only behavior of the entry point')
    with pytest.raises(RuntimeError):
        build_model(cfg)  # defaults to cuda
    model = build_model(cfg, device='cpu')
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    preds = model(to_torch(tiny_batch()), mode='predict')
    assert np.isfinite(preds['bboxes'].numpy()).all()
    # mode='loss' with padded ground truth: finite losses with a gradient
    rng = np.random.RandomState(1)
    batch = to_torch(tiny_batch())
    batch.update(to_torch(dict(
        gt_boxes=np.concatenate([rng.uniform(0.3, 1.7, (2, 4, 3)),
                                 rng.uniform(0.2, 0.8, (2, 4, 3)),
                                 rng.uniform(-0.3, 0.3, (2, 4, 3))],
                                -1).astype(np.float32),
        gt_labels=rng.randint(0, 5, (2, 4)).astype(np.int32),
        gt_mask=np.ones((2, 4), bool))))
    losses = model(batch, mode='loss')
    assert set(losses) == {'loss_center', 'loss_bbox', 'loss_cls'}
    for val in losses.values():
        assert val.requires_grad and np.isfinite(float(val.detach()))
