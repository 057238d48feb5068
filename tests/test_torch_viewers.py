"""The viewers and the explorer against the reference package: the HTML
viewer, the thick-edge box meshes, the continuous playback writers and
``EmbodiedScanExplorer``, on the same seeded numpy inputs.

Every written file (HTML, PLY, PNG, GIF) is byte-identical to the
reference's; returned arrays are identical (integers and colours) or
equal to the last bit (the same numpy float64 and float32 arithmetic).
"""

import os

import numpy as np
import pytest

from embodiedscan_tpu import explorer as jE
from embodiedscan_tpu.data.synthetic import make_scan
from embodiedscan_tpu.vis import continuous as jC
from embodiedscan_tpu.vis import html_viewer as jH
from embodiedscan_torch import explorer as tE
from embodiedscan_torch.vis import continuous as tC
from embodiedscan_torch.vis import html_viewer as tH

SIDES = (('jax', jH, jC, jE), ('torch', tH, tC, tE))


def _boxes(rng, n):
    return np.concatenate([rng.uniform(-2, 2, (n, 3)),
                           rng.uniform(0.2, 1.5, (n, 3)),
                           rng.uniform(-0.6, 0.6, (n, 3))],
                          -1).astype(np.float32)


def _same_files(tmp_path, names):
    for name in names:
        a = (tmp_path / 'jax' / name).read_bytes()
        b = (tmp_path / 'torch' / name).read_bytes()
        assert a == b, name


def _dirs(tmp_path):
    for side, *_ in SIDES:
        os.makedirs(tmp_path / side, exist_ok=True)


# --- the HTML viewer and the line meshes ------------------------------------


@pytest.mark.parametrize('case', ['boxes_names', 'texts', 'bare',
                                  'subsampled', 'colors'])
def test_export_scene_html(tmp_path, case):
    rng = np.random.RandomState(0)
    pts = rng.randn(700, 3).astype(np.float32)
    kw = dict(boxes=_boxes(rng, 3), labels=np.array([1, 3, 12]))
    if case == 'boxes_names':
        kw['class_names'] = ['a', 'b', 'c', 'd']
    elif case == 'texts':
        kw['texts'] = ['x', 'y', 'z']
    elif case == 'bare':
        kw = {}
    elif case == 'subsampled':
        kw = dict(max_points=100)
    else:
        kw['point_colors'] = rng.randint(0, 255, (700, 3)).astype(np.uint8)
        kw['max_points'] = 333
    _dirs(tmp_path)
    for side, H, _, _ in SIDES:
        H.export_scene_html(str(tmp_path / side / 'scene.html'), pts, **kw)
    _same_files(tmp_path, ['scene.html'])


@pytest.mark.parametrize('with_labels', [True, False])
def test_boxes_line_mesh(tmp_path, with_labels):
    rng = np.random.RandomState(1)
    boxes = _boxes(rng, 4)
    boxes[2, 3:6] = [1e-9, 0.5, 0.5]  # degenerate edges are skipped
    labels = np.array([0, 4, 7, 11]) if with_labels else None
    want, got = (H.boxes_line_mesh(boxes, labels, 0.02)
                 for _, H, _, _ in SIDES)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2]
    _dirs(tmp_path)
    for side, H, _, _ in SIDES:
        H.export_boxes_line_mesh_ply(str(tmp_path / side / 'lines.ply'),
                                     boxes, labels)
    _same_files(tmp_path, ['lines.ply'])


# --- the continuous playback writers ----------------------------------------


def _view(seed=0, hw=(24, 24)):
    rng = np.random.RandomState(seed)
    h, w = hw
    depth = rng.uniform(0.5, 3.0, (h, w)).astype(np.float32)
    depth[rng.uniform(size=(h, w)) < 0.1] = 0  # holes
    rgb = rng.randint(0, 255, (h, w, 3)).astype(np.uint8)
    k = np.array([[20.0, 0, w / 2], [0, 20.0, h / 2], [0, 0, 1]])
    ext = np.eye(4)
    ext[:3, 3] = [0.1 * seed, 0, 0]
    return rgb, depth, k, ext


def test_category_color():
    for label in range(284):
        np.testing.assert_array_equal(tC.category_color(label),
                                      jC.category_color(label))


@pytest.mark.parametrize('max_depth', [None, 1.5])
def test_depth_to_colored_points(max_depth):
    rgb, depth, k, _ = _view(3, (20, 28))
    rgb = np.random.RandomState(4).randint(0, 255, (40, 56, 3)).astype(
        np.uint8)  # a larger rgb than the depth map
    t = np.eye(4)
    t[:3, :3] = np.linalg.qr(np.random.RandomState(5).randn(3, 3))[0]
    t[:3, 3] = [1.0, -2.0, 0.5]
    want, got = (C.depth_to_colored_points(rgb, depth, k, t, max_depth)
                 for _, _, C, _ in SIDES)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_scene_writer(tmp_path):
    boxes = np.array([[1.0, 0, 1.5, 0.5, 0.5, 0.5, 0.1, 0, 0],
                      [-1.0, 0, 1.5, 0.5, 0.5, 0.5, 0, 0, 0],
                      [0.0, 0.2, 2.0, 0.4, 0.3, 0.5, 0.3, 0.1, 0]])
    for side, _, C, _ in SIDES:
        writer = C.ContinuousSceneWriter(str(tmp_path / side), downsample=5)
        for i in range(4):
            rgb, depth, k, ext = _view(i)
            k4 = np.eye(4)
            k4[:3, :3] = k
            writer.add_frame(rgb, depth, k, np.linalg.inv(ext), k4 @ ext,
                             boxes, np.array([1, 2, 7]),
                             visible_ids=[i % 3] if i else [])
        assert writer.finish(ms_per_frame=250).endswith('playback.gif')
    _same_files(tmp_path, [f'step_{i:03d}.ply' for i in range(4)] +
                ['playback.gif'])
    empty = tC.ContinuousSceneWriter(str(tmp_path / 'empty'))
    assert empty.finish() is None


def test_occupancy_writer(tmp_path):
    rng = np.random.RandomState(0)
    grids = []
    for _ in range(3):
        occ = rng.randint(0, 6, (8, 10, 4)).astype(np.int32)
        occ[0, 0, 0] = 255  # the ignore label is left out
        occ[1] = 0  # an empty column row
        grids.append(occ)
    for side, _, C, _ in SIDES:
        writer = C.ContinuousOccupancyWriter(str(tmp_path / side),
                                             voxel_size=0.2,
                                             origin=(-1.0, 0.5, 0.0))
        for occ in grids:
            writer.add_frame(occ)
        writer.finish()
    _same_files(tmp_path, [f'occ_{i:03d}.ply' for i in range(3)] +
                ['occupancy.gif'])


def test_render_prediction_video(tmp_path):
    scan = make_scan(seed=0, n_views=3, hw=(32, 32), g=4, num_classes=5)
    preds = dict(bboxes=scan['gt_boxes'],
                 scores=np.array([0.9, 0.1, 0.8, 0.3]),
                 labels=scan['gt_labels'])
    for side, _, C, _ in SIDES:
        C.render_prediction_video(scan, preds, str(tmp_path / side),
                                  score_thr=0.25)
    _same_files(tmp_path, [f'step_{i:03d}.ply' for i in range(3)] +
                ['playback.gif'])


# --- the explorer -----------------------------------------------------------


def test_explorer(tmp_path, fake_data):
    anns = ['embodiedscan_infos_train.pkl', 'embodiedscan_infos_val.pkl']
    rng = np.random.RandomState(2)
    boxes = _boxes(rng, 6) + np.array([1.5, 1.5, 1.0] + [0] * 6, np.float32)
    scores = rng.uniform(0.1, 1.0, 6).astype(np.float32)
    labels = rng.randint(0, 5, 6)
    occ = rng.randint(0, 5, (6, 6, 3))
    seen = []
    _dirs(tmp_path)
    for side, _, _, E in SIDES:
        exp = E.EmbodiedScanExplorer(fake_data, anns)
        scene = exp.list_scenes()[1]
        seen.append((exp.count_scenes(), exp.list_scenes(),
                     exp.list_categories(), exp.scene_info(scene),
                     exp.scene_info('nowhere')))
        out = tmp_path / side
        exp.render_scene(scene, str(out / 's.ply'), n_views=3,
                         max_points_per_view=400)
        exp.render_scene(scene, str(out / 's.html'), n_views=2,
                         max_points_per_view=300)
        exp.render_occupancy(occ, str(out / 'o.ply'), voxel_size=0.1)
        exp.show_image(scene, 1, str(out / 'gt.png'))
        exp.show_image(scene, 2, str(out / 'pred.png'), boxes, labels)
        exp.render_predictions(scene, boxes, scores, labels,
                               str(out / 'p.ply'), score_thr=0.2)
    assert seen[0] == seen[1]
    assert seen[1][0] == 6 and seen[1][3] == dict(n_images=4, n_instances=2)
    _same_files(tmp_path, ['s.ply', 's.html', 'o.ply', 'gt.png', 'pred.png',
                           'p.ply'])
