"""The 2D detection eval against the reference package on the same seeded
inputs: ``iou_2d`` identical (float32 numpy in both), and every entry of
``indoor_eval_2d``'s result equal, as is its printed table; the known
values of the reference's own tests hold too."""

import numpy as np
import pytest

from embodiedscan_tpu.eval import indoor_eval2d as jE
from embodiedscan_torch.eval import indoor_eval2d as tE


def _xyxy(rng, n, jitter_of=None):
    if jitter_of is not None:
        return (jitter_of + rng.normal(0, 3, jitter_of.shape)).astype(
            np.float32)
    lo = rng.uniform(0, 80, (n, 2))
    return np.concatenate([lo, lo + rng.uniform(2, 30, (n, 2))],
                          -1).astype(np.float32)


def _annos(seed, n_images=6, n_classes=4):
    rng = np.random.RandomState(seed)
    gts, dts = [], []
    for i in range(n_images):
        g = 0 if i == 2 else rng.randint(1, 6)
        gb = _xyxy(rng, g)
        gl = rng.randint(0, n_classes, g)
        hit = rng.uniform(size=g) < 0.7
        if i == 4:  # an image without detections
            hit[:] = False
        extra = _xyxy(rng, rng.randint(0, 4) if i != 4 else 0)
        db = np.concatenate([_xyxy(rng, 0, gb[hit]), extra])
        dl = np.concatenate([gl[hit], rng.randint(0, n_classes + 1,
                                                  len(extra))]).astype(
                                                      np.int64)
        dts.append(dict(bboxes=db, labels=dl,
                        scores=rng.uniform(0.05, 1, len(db)).astype(
                            np.float32)))
        gts.append(dict(gt_bboxes=gb, gt_labels=gl))
    return gts, dts


@pytest.mark.parametrize('seed', [0, 1])
def test_iou_2d(seed):
    rng = np.random.RandomState(seed)
    a, b = _xyxy(rng, 17), _xyxy(rng, 9)
    b[0] = [5, 5, 5, 9]  # zero area
    got, want = tE.iou_2d(a, b), jE.iou_2d(a, b)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    for shape in ((0, 4), (3, 4)):
        np.testing.assert_array_equal(tE.iou_2d(np.zeros(shape), b[:0]),
                                      jE.iou_2d(np.zeros(shape), b[:0]))
    p = np.array([[0, 0, 2, 2], [0, 0, 1, 1]], np.float32)
    np.testing.assert_allclose(tE.iou_2d(p, np.array([[1, 1, 3, 3]]))[:, 0],
                               [1 / 7, 0.0], atol=1e-6)


@pytest.mark.parametrize('seed,iou_thr,names', [
    (0, (0.5, ), False), (1, (0.25, 0.5, 0.75), True), (2, (0.5, ), True)])
def test_indoor_eval_2d(capsys, seed, iou_thr, names):
    gts, dts = _annos(seed)
    label2cat = {i: f'cat{i}' for i in range(5)} if names else None
    want = jE.indoor_eval_2d(gts, dts, iou_thr, label2cat)
    want_out = capsys.readouterr().out
    got = tE.indoor_eval_2d(gts, dts, iou_thr, label2cat)
    assert capsys.readouterr().out == want_out
    assert list(got) == list(want)
    for key, val in want.items():
        assert got[key] == val, key
    assert any(v > 0 for k, v in got.items() if k.startswith('mAP'))


def test_indoor_eval_2d_known_values():
    gts = [dict(gt_bboxes=np.array([[0, 0, 2, 2], [5, 5, 6, 6]], np.float32),
                gt_labels=np.array([0, 1]))]
    dts = [dict(bboxes=np.array([[0, 0, 2, 2], [8, 8, 9, 9]], np.float32),
                scores=np.array([0.9, 0.8], np.float32),
                labels=np.array([0, 1]))]
    res = tE.indoor_eval_2d(gts, dts, (0.5, ), verbose=False)
    assert (res['0_AP_0.50'], res['1_AP_0.50']) == (1.0, 0.0)
    np.testing.assert_allclose(res['mAP_0.50'], 0.5)
    dup = [dict(bboxes=np.array([[0, 0, 2, 2]] * 2, np.float32),
                scores=np.array([0.9, 0.8], np.float32),
                labels=np.array([0, 0]))]
    res = tE.indoor_eval_2d(gts[:1], dup, (0.5, ), verbose=False)
    assert res['0_AP_0.50'] == 1.0 and res['0_rec_0.50'] == 1.0
