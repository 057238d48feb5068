"""Port vs reference: ``occupancy_eval`` and the occupancy records of
``_append_scene_results``.

Both packages' metric computes in float64 numpy on the same labels, so the
dicts are identical (keys and values); the records are identical label
grids.
"""

import numpy as np
import pytest
import torch

from embodiedscan_tpu.configs.base import mv_occ as j_mv_occ
from embodiedscan_tpu.eval.occupancy_metric import \
    occupancy_eval as j_occupancy_eval
from embodiedscan_tpu.train.loop import _append_scene_results as j_append
from embodiedscan_torch.configs.base import mv_occ
from embodiedscan_torch.eval.occupancy_metric import occupancy_eval
from embodiedscan_torch.train.loop import _append_scene_results as t_append

from test_torch_helpers import occ_batch

NUM_CLASSES = 8
NAMES = [f'class_{j}' for j in range(1, NUM_CLASSES)]


def _scenes(seed, n=3, shape=(6, 5, 4)):
    """Label grids of classes 0-4 and 6 (gt) and 0-4 and 7 (predictions),
    255 where unseen: class 5 is absent from both, 6 only in the gt, 7
    only in the predictions."""
    rng = np.random.RandomState(seed)
    gts, preds = [], []
    for _ in range(n):
        gt = rng.randint(0, 5, shape)
        gt[rng.uniform(size=shape) < 0.05] = 6
        pred = np.where(rng.uniform(size=shape) < 0.6, gt,
                        rng.randint(0, 5, shape))
        pred[pred == 6] = 7
        gt[rng.uniform(size=shape) < 0.2] = 255
        gts.append(gt.astype(np.int32))
        preds.append(pred.astype(np.int64))
    return gts, preds


@pytest.mark.parametrize('names', [None, NAMES])
@pytest.mark.parametrize('seed', [0, 1])
def test_occupancy_eval_identical(seed, names):
    gts, preds = _scenes(seed)
    want = j_occupancy_eval(gts, preds, NUM_CLASSES, names)
    got = occupancy_eval(gts, preds, NUM_CLASSES, names)
    assert got == want
    key = (lambda j: names[j - 1]) if names else str
    assert key(5) not in got and got[key(6)] == 0.0 and got[key(7)] == 0.0
    assert 0 < got['empty'] < 1 and 0 < got['mIoU'] < 1


def test_occupancy_eval_empty():
    gts = [np.full((2, 2, 2), 255, np.int32)]
    preds = [np.zeros((2, 2, 2), np.int64)]
    assert occupancy_eval(gts, preds, 4) == \
        j_occupancy_eval(gts, preds, 4) == {'mIoU': 0.0}


@pytest.mark.parametrize('with_vis', [False, True])
def test_append_scene_results_occ(with_vis):
    """Two real rows of a three-row batch (the third is tail padding): the
    predictions as they come, the gt as its label grid at the preset's
    40 x 40 x 16, 255 where not visible; records identical to the
    reference's, on top of the rows already collected."""
    jc, tc = j_mv_occ(), mv_occ()
    shape = tuple(tc.model.n_voxels)
    batch = occ_batch(b=3, p=16, v=1, hw=8, n_voxels=shape, num_classes=81,
                      m=400, seed=4)
    if not with_vis:
        del batch['visible_mask']
    preds = np.random.RandomState(5).randint(0, 81, (3, ) + shape)
    jg, jd, tg, td = [0], [0], [0], [0]
    assert j_append(jc, batch, preds, 2, jg, jd, 4) == 6
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    assert t_append(tc, tbatch, torch.from_numpy(preds), 2, tg, td, 4) == 6
    for want, got in ((jg, tg), (jd, td)):
        assert len(got) == len(want) == 3
        for w, g in zip(want[1:], got[1:]):
            np.testing.assert_array_equal(g, w)
    assert (tg[1] == 255).any() == with_vis
    assert len(np.unique(tg[1])) > 3
