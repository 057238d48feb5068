"""Port vs reference on weights converted from a reference checkpoint:
the tiny detector loaded from ``full_reference_state_dict()`` (all three
groups: torchvision ResNet, ME MinkResNet, FCAF3D head), each package
through its own converters, serves the same batch on the CPU (flat engine
on the JAX side); ``test_torch_reference_ground.py`` does the same for the
grounder.

The port's predictions are held against the independent numpy oracle of
the reference's predict (``oracle_predict_single``, with that test's
tolerances) and against the JAX model: integers (keep masks, labels)
exact, floats within atol 1e-4 plus rtol 1e-5.
"""

import numpy as np
import pytest

import __graft_entry__ as G
import jax
import jax.numpy as jnp

from embodiedscan_tpu.models.detector import SparseFusionDetector as JDet
from embodiedscan_tpu.utils import convert_weights as jC
from embodiedscan_torch.models.detector import SparseFusionDetector as TDet
from embodiedscan_torch.utils import convert_weights as tC

from test_reference_predict_fixture import (full_reference_state_dict,
                                            oracle_predict_single)
from test_torch_convert import DET
from test_torch_helpers import (flat_engine, random_variables, to_numpy,
                                to_torch)

TOL = dict(atol=1e-4, rtol=1e-5)
# every (box, class) candidate of the top nms_pre per level (4 x 8 x 5)
# reaches NMS and every survivor is returned, as the oracle keeps them all
PREDICT_DET = dict(DET, nms_pre=8, max_candidates=160, max_dets=160)


def _n_tensors(model):
    return sum(1 for _ in model.parameters()) + sum(1 for _ in
                                                    model.buffers())


@pytest.fixture(scope='module')
def detector():
    batch = {k: np.array(v) for k, v in
             G._tiny_batch(b=2, p=512, g=4).items() if not k.startswith('gt')}
    sd = full_reference_state_dict()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    with flat_engine():
        jm = JDet(**PREDICT_DET)
        var, _, _ = jC.load_reference_detector(
            random_variables(jm, (jb,), train=False, mode='feats'), sd,
            mink_depth=18, resnet_depth=18)

        def run(v, b):
            outs = jm.apply(v, b, train=False, mode='feats')
            return outs, jm.apply(v, outs,
                                  method=lambda m, o: m.bbox_head.predict(o))

        jouts, jpreds = to_numpy(jax.jit(run)(var, jb))
    tm, n, skipped = tC.load_reference_detector(
        TDet(**PREDICT_DET).eval(), sd, mink_depth=18, resnet_depth=18)
    assert skipped == [] and n == _n_tensors(tm)
    tb = to_torch(batch)
    return jouts, jpreds, to_numpy(tm(tb, mode='feats')), \
        to_numpy(tm(tb, mode='predict'))


def test_detector_predict_matches_numpy_oracle(detector):
    _, _, touts, tpreds = detector
    nms_pre, score_thr, iou_thr = PREDICT_DET['nms_pre'], 0.01, 0.5
    n_dets = 0
    for bi in range(touts.points[0].shape[0]):
        want = oracle_predict_single(
            [c[bi][..., 0] for c in touts.center], [r[bi] for r in touts.reg],
            [c[bi] for c in touts.cls], [p[bi] for p in touts.points],
            [m[bi] for m in touts.masks], nms_pre, score_thr, iou_thr)
        keep = tpreds['mask'][bi]
        got = [(int(tpreds['labels'][bi][i]), float(tpreds['scores'][bi][i]),
                tpreds['bboxes'][bi][i][:7]) for i in np.where(keep)[0]]
        assert len(got) == len(want), (len(got), len(want))
        key = lambda d: (d[0], -d[1])  # noqa: E731
        for gd, wd in zip(sorted(got, key=key), sorted(want, key=key)):
            assert gd[0] == wd[0]
            np.testing.assert_allclose(gd[1], wd[1], rtol=1e-4, atol=1e-6)
            np.testing.assert_allclose(gd[2], wd[2], rtol=1e-3, atol=1e-4)
        n_dets += len(got)
    assert n_dets > 0, 'no detection: the comparison is vacuous'


def test_detector_matches_reference_model(detector):
    jouts, jpreds, touts, tpreds = detector
    for field in ('points', 'masks'):
        for w, g in zip(getattr(jouts, field), getattr(touts, field)):
            np.testing.assert_array_equal(g, w, err_msg=field)
    for field in ('center', 'reg', 'cls'):
        for w, g in zip(getattr(jouts, field), getattr(touts, field)):
            np.testing.assert_allclose(g, w, err_msg=field, **TOL)
    assert jpreds['mask'].sum() > 0
    for field in ('labels', 'mask'):
        np.testing.assert_array_equal(tpreds[field], jpreds[field])
    for field in ('bboxes', 'scores'):
        np.testing.assert_allclose(tpreds[field], jpreds[field],
                                   err_msg=field, **TOL)
