"""Port vs reference: the detection and grounding metrics and the records
they take.

The same annotations go through both packages (the port's IoU on the
CPU): metric dicts have the same keys and values within 1e-6, tables and
submission files are identical, and the known-value cases of
``tests/test_eval.py`` hold for the port too.
"""

import json
import types

import numpy as np
import pytest
import torch

from embodiedscan_tpu.eval import grounding_metric as JG
from embodiedscan_tpu.eval import indoor_eval as JI
from embodiedscan_tpu.train.loop import _append_scene_results as j_append
from embodiedscan_torch.eval import grounding_metric as TG
from embodiedscan_torch.eval import indoor_eval as TI
from embodiedscan_torch.train.loop import _append_scene_results as t_append

ATOL = 1e-6


def _boxes(rng, n):
    return np.concatenate([rng.uniform(0, 6, (n, 3)),
                           rng.uniform(0.3, 1.5, (n, 3)),
                           rng.uniform(-0.4, 0.4, (n, 3))],
                          -1).astype(np.float32)


def _det_scenes(seed, n_scenes=4, n_cls=6):
    """Scenes whose detections are jittered ground truth (some with the
    wrong label), random boxes and exact duplicates."""
    rng = np.random.RandomState(seed)
    gts, dts = [], []
    for _ in range(n_scenes):
        g = rng.randint(1, 8)
        gb = _boxes(rng, g)
        gl = rng.randint(0, n_cls, g)
        near = gb + rng.normal(0, 0.08, gb.shape).astype(np.float32)
        near_l = np.where(rng.rand(g) < 0.8, gl, rng.randint(0, n_cls, g))
        far = _boxes(rng, rng.randint(0, 6))
        db = np.concatenate([near, far, near[:2]])
        dl = np.concatenate([near_l, rng.randint(0, n_cls + 1, len(far)),
                             near_l[:2]])
        gts.append(dict(gt_boxes=gb, gt_labels=gl))
        dts.append(dict(bboxes=db, scores=rng.rand(len(db)), labels=dl))
    return gts, dts


def _close(got, want):
    assert set(got) == set(want)
    for key, val in want.items():
        np.testing.assert_allclose(got[key], val, atol=ATOL, rtol=0,
                                   err_msg=key)


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_indoor_eval_matches_reference(seed, capsys):
    gts, dts = _det_scenes(seed)
    l2c = {i: f'class{i}' for i in range(7)}
    split = ([0, 1], [2, 3], [4, 5, 6])
    kw = dict(iou_thr=(0.25, 0.5), label2cat=l2c, classes_split=split,
              verbose=True)
    want = JI.indoor_eval(gts, dts, **kw)
    want_out = capsys.readouterr().out
    got = TI.indoor_eval(gts, dts, device='cpu', **kw)
    assert capsys.readouterr().out == want_out
    assert 0 < got['mAP_0.25'] < 1
    _close(got, want)


@pytest.mark.parametrize('seed', [0, 1])
def test_ground_eval_matches_reference(seed):
    rng = np.random.RandomState(seed)
    gts, dts = [], []
    for i in range(12):
        gb = _boxes(rng, rng.randint(1, 3))
        q = _boxes(rng, 32)
        q[:i % 3] = gb[0] + rng.normal(0, 0.1, (i % 3, 9))
        dts.append(dict(bboxes=q, scores=rng.rand(32)))
        gts.append(dict(gt_boxes=gb, is_view_dep=bool(rng.rand() < 0.5),
                        is_hard=bool(rng.rand() < 0.5),
                        is_unique=bool(rng.rand() < 0.5)))
    want = JG.ground_eval(gts, dts)
    got = TG.ground_eval(gts, dts, device='cpu')
    assert 0 < got['Overall@0.25'] < 1
    _close(got, want)


def test_format_results_identical(tmp_path):
    rng = np.random.RandomState(0)
    dts = [dict(bboxes=rng.randn(32, 9), scores=rng.rand(32))
           for _ in range(3)]
    want = JG.format_results(dts, str(tmp_path / 'ref'))
    got = TG.format_results(dts, str(tmp_path / 'port'))
    with open(want) as f, open(got) as g:
        assert f.read() == g.read()
    with open(got) as g:
        results = json.load(g)
    assert [len(r['bboxes_3d']) for r in results] == [20, 20, 20]


def box(x, y, z, s=1.0):
    return [x, y, z, s, s, s, 0.0, 0.0, 0.0]


ONE = dict(gt_boxes=np.array([box(0, 0, 0)]), gt_labels=np.array([0]))
TWO = dict(gt_boxes=np.array([box(0, 0, 0), box(5, 5, 5)]),
           gt_labels=np.array([0, 1]))
# tests/test_eval.py's cases: (gts, dts, thresholds, kwargs, expected)
KNOWN = {
    'perfect': ([TWO], [dict(bboxes=TWO['gt_boxes'],
                             scores=np.array([0.9, 0.8]),
                             labels=np.array([0, 1]))], (0.25, 0.5), {},
                {'mAP_0.25': 1.0, 'mAR_0.50': 1.0}),
    'one_miss': ([dict(TWO, gt_labels=np.array([0, 0]))],
                 [dict(bboxes=np.array([box(0, 0, 0)]),
                       scores=np.array([0.9]), labels=np.array([0]))],
                 (0.25,), {}, {'mAP_0.25': 0.5, 'mAR_0.25': 0.5}),
    'low_score_fp': ([ONE], [dict(bboxes=np.array([box(0, 0, 0),
                                                   box(9, 9, 9)]),
                                  scores=np.array([0.9, 0.1]),
                                  labels=np.array([0, 0]))], (0.25,), {},
                     {'mAP_0.25': 1.0}),
    'duplicate_fp': ([ONE], [dict(bboxes=np.array([box(0, 0, 0),
                                                   box(0.05, 0, 0)]),
                                  scores=np.array([0.9, 0.8]),
                                  labels=np.array([0, 0]))], (0.25,), {},
                     {'mAP_0.25': 1.0}),
    'class_without_gt': ([ONE], [dict(bboxes=np.array([box(0, 0, 0),
                                                       box(5, 5, 5)]),
                                      scores=np.array([0.9, 0.95]),
                                      labels=np.array([0, 7]))], (0.25,),
                         {}, {'mAP_0.25': 1.0}),
    'tiny_box': ([ONE], [dict(bboxes=np.array([[0, 0, 0, 1e-6, 1e-6, 1e-6,
                                                0, 0, 0]]),
                              scores=np.array([0.9]),
                              labels=np.array([0]))], (0.25,), {}, {}),
    'splits': ([TWO], [dict(bboxes=np.array([box(0, 0, 0)]),
                            scores=np.array([0.9]), labels=np.array([0]))],
               (0.25,), dict(classes_split=([0], [1], [])),
               {'head_mAP_0.25': 1.0, 'common_mAP_0.25': 0.0}),
}


@pytest.mark.parametrize('case', list(KNOWN))
def test_known_values(case):
    gts, dts, thr, kw, expected = KNOWN[case]
    got = TI.indoor_eval(gts, dts, thr, verbose=False, device='cpu', **kw)
    _close(got, JI.indoor_eval(gts, dts, thr, verbose=False, **kw))
    for key, val in expected.items():
        np.testing.assert_allclose(got[key], val, atol=ATOL)
    assert all(np.isfinite(v) for v in got.values())
    if case == 'class_without_gt':
        assert '7_AP_0.25' not in got


def test_average_precision_and_table():
    for r, p, want in (([0.5, 1.0], [1.0, 1.0], 1.0),
                       ([0.5, 0.5], [1.0, 0.5], 0.5)):
        r, p = np.array(r), np.array(p)
        assert TI.average_precision(r, p)[0] == want
        for mode in ('area', '11points'):
            np.testing.assert_array_equal(TI.average_precision(r, p, mode),
                                          JI.average_precision(r, p, mode))
    gts, dts = _det_scenes(3)
    l2c = {i: f'class{i}' for i in range(7)}
    ret = TI.indoor_eval(gts, dts, (0.25,), label2cat=l2c, verbose=False,
                         device='cpu')
    assert TI.per_class_table(ret, range(7), (0.25,), l2c) == \
        JI.per_class_table(ret, range(7), (0.25,), l2c)


def _predict_batch(seed, task):
    rng = np.random.RandomState(seed)
    b, g, d = 3, 5, 8
    batch = dict(gt_boxes=rng.randn(b, g, 9).astype(np.float32),
                 gt_labels=rng.randint(0, 4, (b, g)).astype(np.int32),
                 gt_mask=rng.rand(b, g) > 0.3)
    preds = dict(bboxes=rng.randn(b, d, 9).astype(np.float32),
                 scores=rng.rand(b, d).astype(np.float32),
                 mask=rng.rand(b, d) > 0.4)
    if task != 'mv_grounding':
        preds['labels'] = rng.randint(0, 4, (b, d)).astype(np.int32)
    else:
        for k in ('is_view_dep', 'is_hard', 'is_unique'):
            batch[k] = rng.rand(b) > 0.5
    return batch, preds


@pytest.mark.parametrize('task', ['mv_det3d', 'mv_grounding', 'cont_det3d'])
def test_append_scene_results_matches_reference(task):
    from embodiedscan_tpu.configs.base import mv_det3d as j_cfg
    from embodiedscan_torch.configs.base import mv_det3d as t_cfg
    jc, tc = j_cfg(), t_cfg()
    jc.model.task = tc.model.task = task
    batch, preds = _predict_batch(0, task)
    jg, jd, tg, td = [], [], [], []
    assert j_append(jc, batch, preds, 2, jg, jd, 4) == 6
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    tpreds = {k: torch.from_numpy(v) for k, v in preds.items()}
    assert t_append(tc, tbatch, tpreds, 2, tg, td, 4) == 6
    for want, got in ((jg, tg), (jd, td)):
        assert len(got) == len(want) == 2
        for w, g in zip(want, got):
            assert set(g) == set(w)
            for key in w:
                np.testing.assert_array_equal(g[key], w[key], err_msg=key)
    if task == 'mv_grounding':
        del tbatch['is_hard']
        with pytest.raises(KeyError):
            t_append(tc, tbatch, tpreds, 2, [], [], 0)
    # every task is ported (the sweep rows of cont_det3d are records of
    # their own); a task the configs do not know raises
    with pytest.raises(ValueError):
        t_append(types.SimpleNamespace(model=types.SimpleNamespace(
            task='no_such_task')), tbatch, tpreds, 2, [], [], 0)
