"""The traffic generator: the same seed gives the same scenes, another
seed others, and every scene of a kind has the same sizes."""

import pytest
import torch

from benchmark.harness import spec
from benchmark.traffic import generate as G

DET = dict(scene='det_room', batch=2, points=500, views=2, image_hw=32,
           gt_boxes=4, pool=2)
OCC = dict(scene='occ_room', batch=1, points=500, views=2, image_hw=32,
           gt_voxels=64, pool=2)
CONF = dict(model=dict(num_classes=5, occ_classes=81, n_voxels=[40, 40, 16],
                       point_cloud_range=[-3.2, -3.2, -0.78, 3.2, 3.2, 1.78]))


def _same(a, b):
    return all(torch.equal(a[k], b[k]) for k in a)


def test_reproducible_and_seeded():
    for t in (DET, OCC):
        a = G.pool(t, CONF, 2**31 + 5, 'cpu')
        b = G.pool(t, CONF, 2**31 + 5, 'cpu')
        c = G.pool(t, CONF, 2**31 + 6, 'cpu')
        assert all(_same(x, y) for x, y in zip(a, b))
        assert not _same(a[0], c[0])
        assert not _same(a[0], a[1])  # scenes of one pool differ
        assert all(a[0][k].shape == c[1][k].shape for k in a[0])


def test_scene_independent_of_pool_order():
    whole = G.batch(DET, CONF, 7, 1, 'cpu')
    alone = G.scene(DET, CONF, 7, 2, 'cpu')
    assert _same({k: v[0] for k, v in whole.items()}, alone)


def test_det_room_contents():
    s = G.scene(DET, CONF, 11, 0, 'cpu')
    assert s['points'].shape == (500, 3)
    assert s['imgs'].shape == (2, 32, 32, 3)
    assert int(s['gt_labels'].max()) < 5
    assert float(s['points'].min()) > -0.1 and float(s['points'].max()) < 8.1


def test_occ_room_targets():
    s = G.scene(OCC, CONF, 13, 0, 'cpu')
    gt, m = s['gt_occ'], s['gt_occ_mask']
    assert gt.shape == (64, 4) and m.all()  # 500 points fill 64 cells
    assert int(gt[:, 3].min()) >= 1 and int(gt[:, 3].max()) < 81
    assert s['visible_mask'].shape == (40, 40, 16)


def test_arrivals_fixed_rate():
    due = G.arrivals(dict(rate_per_s=2.5), 4.0)
    assert len(due) == 10 and due[1] == 0.4


def test_sub_seed_large_seeds():
    assert spec.sub_seed(2**33, 'a') != spec.sub_seed(2**33, 'b')
    assert 0 <= spec.sub_seed(2**33 + 1, 'a') < 2**63


def test_scene_kind_without_file_fails_naming_it():
    with pytest.raises(FileNotFoundError, match='scenes/no_room.py'):
        G.scene(dict(DET, scene='no_room'), CONF, 1, 0, 'cpu')
    with pytest.raises(FileNotFoundError, match='tasks/no_task.py'):
        spec.task('no_task')
