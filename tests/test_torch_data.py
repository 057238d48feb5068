"""Port vs reference: the data path, byte for byte.

For the same seeds the port's arrays equal the reference package's
exactly (dtype, shape and bits):
- every function of ``data/pipeline.py`` on seeded inputs, each with its
  own ``np.random.RandomState`` stream on both sides;
- the synthetic scans, ``scan_to_batch`` and ``scan_to_sweeps``;
- ``SyntheticLoader`` batches for all seven presets (train and eval), with
  the presets' data and model fields equal to the reference's;
- ``EmbodiedScanLoader`` and ``GroundingLoader`` batches on the
  ``fake_data`` fixture (mv_det3d, cont_det3d, mv_occ, cont_occ, grounding
  with a VG file), including a two-process shard;
- the native host core against the reference's native core, and the two
  backends of ``multiview_world_points`` as point sets;
- ``Prefetcher`` output, and ``to_device`` on the CPU.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from embodiedscan_tpu import native as jnat
from embodiedscan_tpu.configs import base as jcfg
from embodiedscan_tpu.data import dataset as jds
from embodiedscan_tpu.data import loader as jld
from embodiedscan_tpu.data import pipeline as jpl
from embodiedscan_tpu.data import synthetic as jsyn
from embodiedscan_torch import native as tnat
from embodiedscan_torch.configs import base as tcfg
from embodiedscan_torch.data import dataset as tds
from embodiedscan_torch.data import loader as tld
from embodiedscan_torch.data import pipeline as tpl
from embodiedscan_torch.data import synthetic as tsyn
from embodiedscan_torch.train.loop import make_dataset

PRESETS = sorted(jcfg.PRESETS)


def _same(got, want, what=''):
    """Identical dtype, shape and bytes, through dicts, lists and tuples."""
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            _same(got[k], want[k], f'{what}/{k}')
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f'{what}[{i}]')
    else:
        g, w = np.asarray(got), np.asarray(want)
        assert g.dtype == w.dtype and g.shape == w.shape, \
            (what, g.dtype, w.dtype, g.shape, w.shape)
        np.testing.assert_array_equal(g, w, err_msg=what)


def _both(fn_name, *args, seed=None, mod=(jpl, tpl)):
    """(reference, port) results of ``fn_name(*args[, rng])``, each with a
    fresh ``RandomState(seed)`` when ``seed`` is given."""
    out = []
    for m in mod:
        extra = () if seed is None else (np.random.RandomState(seed), )
        out.append(getattr(m, fn_name)(*args, *extra))
    return out


def _views(rng, v=3, hw=(24, 32)):
    """Depth maps with holes, 3x3 intrinsics and extrinsics."""
    h, w = hw
    depths = rng.uniform(0.5, 4.0, (v, h, w)).astype(np.float32)
    depths[rng.uniform(size=depths.shape) < 0.2] = 0
    ks, exts = [], []
    for i in range(v):
        k = np.array([[30.0 + i, 0, w / 2], [0, 31.0, h / 2], [0, 0, 1]],
                     np.float32)
        ks.append(k)
        ang = 0.3 * i
        ext = np.eye(4, dtype=np.float32)
        ext[:3, :3] = [[np.cos(ang), -np.sin(ang), 0],
                       [np.sin(ang), np.cos(ang), 0], [0, 0, 1]]
        ext[:3, 3] = [0.2 * i, -0.1, 1.5]
        exts.append(ext)
    return depths, ks, exts


# --- data/pipeline.py -------------------------------------------------------


@pytest.mark.parametrize('n_total,n_images,ordered', [
    (10, 4, True), (10, 1, True), (3, 5, True), (10, 4, False),
    (3, 5, False)])
def test_select_views(n_total, n_images, ordered):
    j, t = _both('select_views', n_total, n_images, ordered, seed=2)
    _same(t, j)


def test_rgbd_point_sample_and_aggregate():
    depths, ks, exts = _views(np.random.RandomState(0))
    ks[1] = np.pad(ks[1], ((0, 1), (0, 1))) + np.diag([0, 0, 0, 1]).astype(
        np.float32)  # a 4x4 intrinsic
    for i in range(len(depths)):
        j, t = _both('rgbd_to_points', depths[i], ks[i])
        _same(t, j)
        for num in (50, 5000):  # without and with replacement
            _same(*_both('point_sample', j, num, seed=i)[::-1])
    _same(*_both('point_sample', np.zeros((0, 3), np.float32), 8,
                 seed=0)[::-1])
    pts = [jpl.rgbd_to_points(d, k) for d, k in zip(depths, ks)]
    for name in ('aggregate_points_list', 'aggregate_points'):
        _same(*_both(name, pts, exts)[::-1])


@pytest.mark.parametrize('native', ['numpy', 'auto'])
def test_multiview_world_points(native):
    """Each backend gives the reference's backend's bytes; the two
    backends sample the same point set (every native row is a row of the
    full back-projected set)."""
    depths, ks, exts = _views(np.random.RandomState(1))
    args = (list(depths), ks, exts, 300)
    want = jpl.multiview_world_points(*args, np.random.RandomState(3),
                                      native=native)
    got = tpl.multiview_world_points(*args, np.random.RandomState(3),
                                     native=native)
    _same(got, want)
    full = tpl.aggregate_points_list(
        [tpl.rgbd_to_points(d, k) for d, k in zip(depths, ks)], exts)
    for rows, whole in zip(got, full):
        d = np.abs(rows[:, None] - whole[None]).sum(-1).min(1)
        assert rows.shape == (300, 3) and d.max() < 1e-4
    if native == 'auto':
        assert tnat.available()
        numpy_rows = tpl.multiview_world_points(
            *args, np.random.RandomState(3), native='numpy')
        assert not np.array_equal(got[0], numpy_rows[0])


def test_augmentations():
    rng = np.random.RandomState(4)
    pts = rng.randn(200, 3).astype(np.float32)
    boxes = np.concatenate([rng.randn(5, 3), rng.uniform(0.2, 1, (5, 3)),
                            rng.uniform(-0.3, 0.3, (5, 3))],
                           -1).astype(np.float32)
    for seed in range(6):  # every flip combination
        _same(*_both('random_flip', pts, boxes, seed=seed)[::-1])
        _same(*_both('global_rot_scale_trans', pts, boxes,
                     seed=seed)[::-1])
    imgs = rng.randint(0, 255, (2, 5, 6, 3)).astype(np.uint8)
    for bgr in (False, True):
        _same(tpl.normalize_imgs(imgs, bgr), jpl.normalize_imgs(imgs, bgr))
    rng_box = (-1.0, -1.0, -0.5, 1.0, 1.0, 0.5)
    _same(tpl.points_range_filter(pts, rng_box),
          jpl.points_range_filter(pts, rng_box))


@pytest.mark.parametrize('n_boxes', [3, 12])
def test_pack_sample_and_collate(n_boxes):
    rng = np.random.RandomState(5)
    depths, ks, exts = _views(rng)
    pts = rng.randn(700, 3).astype(np.float32)
    imgs = rng.randn(3, 8, 8, 3).astype(np.float32)
    boxes = rng.randn(n_boxes, 9).astype(np.float32)
    labels = rng.randint(0, 9, n_boxes)
    aug = np.diag([1, -1, 1, 1]).astype(np.float32)
    out = []
    for m in (jpl, tpl):
        samples = [m.pack_sample(pts, imgs, ks, exts, boxes, labels, a, 500,
                                 8, np.random.RandomState(6))
                   for a in (None, aug)]
        out.append((samples, m.collate(samples)))
    _same(out[1], out[0])


@pytest.mark.parametrize('visibility', ['none', 'ids', 'ids_and_occ'])
def test_pack_and_collate_sweeps(visibility):
    rng = np.random.RandomState(7)
    _, ks, exts = _views(rng, v=4)
    view_pts = [rng.randn(n, 3).astype(np.float32) for n in (90, 0, 150, 60)]
    imgs = rng.randn(4, 8, 8, 3).astype(np.float32)
    boxes = rng.randn(6, 9).astype(np.float32)
    labels = rng.randint(0, 9, 6)
    vis = None if visibility == 'none' else \
        [np.array([0]), np.array([], np.int64), np.array([2, 9, -1]),
         np.array([1, 5])]
    occ = None if visibility != 'ids_and_occ' else \
        [rng.uniform(size=(4, 3, 2)) > 0.6 for _ in range(4)]
    out = []
    for m in (jpl, tpl):
        scans = [m.pack_sweeps(view_pts, vis, imgs, ks, exts, boxes, labels,
                               None, 200, 8, np.random.RandomState(s),
                               occ_visible=occ) for s in (8, 9)]
        out.append((scans, m.collate_sweeps(scans)))
    _same(out[1], out[0])
    sweeps = out[1][1]
    assert sweeps['points'].shape == (8, 200, 3)
    assert sweeps['imgs'].shape == (2, 4, 8, 8, 3)


# --- data/synthetic.py ------------------------------------------------------


@pytest.fixture(scope='module')
def scans():
    kw = dict(seed=3, n_views=5, hw=(40, 48), g=6, num_classes=9)
    return jsyn.make_scan(**kw), tsyn.make_scan(**kw)


def test_make_scan_and_visibility(scans):
    jscan, tscan = scans
    _same(tscan, jscan)
    _same(tsyn.box_visibility(tscan, [0, 2, 4], (40, 48)),
          jsyn.box_visibility(jscan, [0, 2, 4], (40, 48)))


@pytest.mark.parametrize('train', [True, False])
def test_scan_to_batch(scans, train):
    args = dict(n_views=3, num_points=900, num_boxes=8, seed=5, train=train,
                points_per_view=400)
    _same(tsyn.scan_to_batch(scans[1], **args),
          jsyn.scan_to_batch(scans[0], **args))


@pytest.mark.parametrize('train,occ', [(True, None), (False, None),
                                       (True, (4, 4, 2))])
def test_scan_to_sweeps(scans, train, occ):
    args = dict(n_views=4, num_points=900, num_boxes=8, seed=6, train=train,
                points_per_view=400, occ_shape=occ)
    got = tsyn.scan_to_sweeps(scans[1], **args)
    _same(got, jsyn.scan_to_sweeps(scans[0], **args))
    # later sweeps see every view seen earlier
    assert (got['view_mask'].sum(1) == np.arange(1, 5)).all()


# --- configs and the synthetic loader ---------------------------------------


def _fields(obj):
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


@pytest.mark.parametrize('preset', PRESETS)
def test_preset_fields_match_reference(preset):
    """Every data field of the port is the reference's, with its value;
    every model field the two share holds the same value but ``remat``,
    which the port's presets keep at 'none' (the reference's '2d', and
    'all' for cont_occ, were sized for a 16 GB chip; every preset steps on
    the 80 GB card without recomputation)."""
    jc, tc = jcfg.PRESETS[preset](), tcfg.PRESETS[preset]()
    jd, td = _fields(jc.data), _fields(tc.data)
    assert set(td) <= set(jd)
    assert {k: jd[k] for k in td} == td
    jm, tm = _fields(jc.model), _fields(tc.model)
    shared = [k for k in tm if k in jm and k != 'remat']
    assert {k: jm[k] for k in shared} == {k: tm[k] for k in shared}
    assert (jm['remat'], tm['remat']) == \
        ('all' if preset == 'cont_occ' else '2d', 'none')
    assert (tc.schedule.lr, tc.schedule.weight_decay,
            tuple(tc.schedule.milestones)) == \
        (jc.schedule.lr, jc.schedule.weight_decay,
         tuple(jc.schedule.milestones))


def _synthetic_cfgs(preset):
    out = []
    for mod in (jcfg, tcfg):
        cfg = mod.PRESETS[preset]()
        cfg.data.synthetic = True
        cfg.data.n_points = 3000
        cfg.data.points_per_view = 600
        cfg.data.n_views_train = min(cfg.data.n_views_train, 3)
        cfg.data.n_views_test = 4
        cfg.data.batch_size = 2
        cfg.model.num_classes = 9
        cfg.model.max_text_len = 32
        cfg.model.n_voxels = (8, 8, 4)
        out.append(cfg)
    return out


@pytest.mark.parametrize('preset', PRESETS)
def test_synthetic_loader(preset):
    """The eval loader's first two batches (``make_dataset``) and, from the
    train loader (whose scan draw is seeded from the OS), two samples by
    seed and their collate: identical for every preset."""
    jc, tc = _synthetic_cfgs(preset)
    j_ev = jld.build_loader(jc, train=False)
    t_ev = make_dataset(tc, train=False)
    assert isinstance(t_ev, tld.SyntheticLoader)
    for _, want, got in zip(range(2), j_ev, t_ev):
        _same(got, want)
    j_tr, t_tr = jld.SyntheticLoader(jc, True, n_scans=2), \
        tld.SyntheticLoader(tc, True, n_scans=2)
    js = [j_tr._sample(j_tr._scans[i], 11 + i) for i in range(2)]
    ts = [t_tr._sample(t_tr._scans[i], 11 + i) for i in range(2)]
    cont = preset.startswith('cont')
    _same((ts, (tpl.collate_sweeps if cont else tpl.collate)(ts)),
          (js, (jpl.collate_sweeps if cont else jpl.collate)(js)))
    assert t_tr.steps_per_epoch == j_tr.steps_per_epoch
    batch = next(iter(t_tr))
    assert batch['points'].shape[0] == \
        (2 * tc.data.n_views_train if cont else 2)


# --- the disk loaders on the fake_data fixture ------------------------------


def _disk_cfgs(fake_data, preset, vg=False):
    out = []
    for mod in (jcfg, tcfg):
        cfg = mod.PRESETS[preset]()
        d = cfg.data
        d.data_root = fake_data
        d.batch_size = 2
        d.n_views_train = 3
        d.n_views_test = 2
        d.n_points = 1024
        d.points_per_view = 512
        d.max_boxes = 4
        d.image_hw = (32, 32)
        d.repeat_times = 2
        d.num_workers = 2
        d.prefetch_depth = 0
        d.max_occ_voxels = 96
        d.vg_file = 'vg.json' if vg else ''
        cfg.model.n_voxels = (8, 8, 4)
        cfg.model.max_text_len = 32
        out.append(cfg)
    return out


def _take(loader, n):
    return [b for _, b in zip(range(n), loader)]


@pytest.mark.parametrize('preset', ['mv_det3d', 'cont_det3d', 'mv_occ',
                                    'cont_occ'])
@pytest.mark.parametrize('train', [True, False])
def test_embodiedscan_loader(fake_data, preset, train):
    jc, tc = _disk_cfgs(fake_data, preset)
    jl, tl = jds.EmbodiedScanLoader(jc, train), \
        tds.EmbodiedScanLoader(tc, train)
    assert (tl.steps_per_epoch, tl.label2cat, tl.process_count) == \
        (jl.steps_per_epoch, jl.label2cat, 1)
    _same(_take(tl, 2), _take(jl, 2))


def test_loader_shard_two_processes(fake_data):
    """The rank-strided shard of a two-process run, padded to equal
    lengths, as the reference's."""
    jc, tc = _disk_cfgs(fake_data, 'mv_det3d')
    for rank in (0, 1):
        jl, tl = jds.EmbodiedScanLoader(jc, False), \
            tds.EmbodiedScanLoader(tc, False)
        for ld in (jl, tl):
            ld.process_index, ld.process_count = rank, 2
        idx = np.arange(5)
        _same(tl._shard(idx), jl._shard(idx))
        assert tl.local_real == jl.local_real
    assert tds.process_rank_and_count() == (0, 1)


@pytest.fixture()
def vg_root(fake_data, tmp_path):
    """The fake_data infos with a VG file beside them (links to its
    files)."""
    infos, _ = jds.load_info_pkl(os.path.join(
        fake_data, 'embodiedscan_infos_train.pkl'))
    for name in os.listdir(fake_data):
        os.symlink(os.path.join(fake_data, name), tmp_path / name)
    sid = [info['sample_idx'] for info in infos]
    vg = [dict(scan_id=sid[0], text='find the chair in front of the table',
               target='chair', target_id=0, distractor_ids=[1, 2, 3, 4]),
          dict(scan_id=sid[1], text='the only bed', target='bed',
               target_id=1, distractor_ids=[]),
          dict(scan_id=sid[2], text='both chairs here',
               target='both chairs', target_id=[0, 1], distractor_ids=[1]),
          dict(scan_id=sid[0], text='the lamp on the left',
               tokens_positive=[[4, 8]], target_id=1, distractor_ids=[]),
          dict(scan_id='missing/scene', text='x', target_id=0,
               distractor_ids=[])]
    with open(tmp_path / 'vg.json', 'w') as f:
        json.dump(vg, f)
    return str(tmp_path), infos, vg


@pytest.mark.parametrize('train', [True, False])
def test_grounding_loader(vg_root, train):
    root, infos, vg = vg_root
    _same(tds.join_vg_annotations(infos, vg),
          jds.join_vg_annotations(infos, vg))
    jc, tc = _disk_cfgs(root, 'mv_grounding', vg=True)
    jl, tl = jld.build_loader(jc, train), tld.build_loader(tc, train)
    assert isinstance(tl, tds.GroundingLoader)
    assert tl.steps_per_epoch == jl.steps_per_epoch
    _same(_take(tl, 2), _take(jl, 2))
    assert [tds.is_view_dep(v['text']) for v in vg] == \
        [jds.is_view_dep(v['text']) for v in vg]


def test_dataset_helpers(fake_data):
    infos, meta = tds.load_info_pkl(os.path.join(
        fake_data, 'embodiedscan_infos_train.pkl'))
    _same(meta, jds.load_info_pkl(os.path.join(
        fake_data, 'embodiedscan_infos_train.pkl'))[1])
    for sid in ('scannet/scene0000_00', '3rscan/abc', 'matterport3d/x/r1',
                'arkitscenes/1'):
        assert tds.occ_ann_paths(sid) == jds.occ_ann_paths(sid)
    jscan, tscan = jds.parse_scan(infos[1], fake_data), \
        tds.parse_scan(infos[1], fake_data)
    _same(tscan, jscan)
    _same(tds.load_occupancy_gt(tscan, fake_data, 40),
          jds.load_occupancy_gt(jscan, fake_data, 40))
    _same(tds.load_visible_occupancy(tscan, fake_data, [3, 0]),
          jds.load_visible_occupancy(jscan, fake_data, [3, 0]))
    _same(tds.load_view(tscan['views'][2], 1000.0, (20, 24)),
          jds.load_view(jscan['views'][2], 1000.0, (20, 24)))


# --- the native core, the prefetcher, the move to a device ------------------


def test_native_core_matches_reference():
    assert tnat.available() and jnat.available()
    rng = np.random.RandomState(9)
    depths, ks, exts = _views(rng, v=4)
    for g2e, scale, cap in ((np.stack(exts), 1.0, None),
                            (None, 1000.0, 100)):
        (gp, gn), (wp, wn) = (
            m.multiview_backproject(depths, np.stack(ks), g2e, scale, cap)
            for m in (tnat, jnat))
        _same(gn, wn)  # rows past a view's count are not written
        _same([p[:n] for p, n in zip(gp, gn)], [p[:n] for p, n in zip(wp, wn)])
    for n, num, seed in ((1000, 300, 5), (50, 300, 6), (0, 4, 7),
                         (300, 300, 2**40 + 3)):
        _same(tnat.sample_indices(n, num, seed),
              jnat.sample_indices(n, num, seed))
    pts = rng.randn(60, 3).astype(np.float32)
    idx = rng.randint(0, 60, 100)
    _same(tnat.gather_rows3(pts, idx), jnat.gather_rows3(pts, idx))
    imgs = rng.randint(0, 255, (3, 300, 301, 3)).astype(np.uint8)
    for bgr in (False, True):
        _same(tnat.normalize_imgs_u8(imgs, tpl.IMG_MEAN, tpl.IMG_STD, bgr),
              jnat.normalize_imgs_u8(imgs, jpl.IMG_MEAN, jpl.IMG_STD, bgr))
    raw = rng.randint(0, 65535, (37, 41)).astype(np.uint16)
    _same(tnat.depth_u16_to_f32(raw, 4000.0),
          jnat.depth_u16_to_f32(raw, 4000.0))
    with pytest.raises(IndexError):
        tnat.gather_rows3(pts, np.array([60]))


def test_prefetcher_matches_reference(fake_data):
    """The prefetched batches are the loader's; a producer's exception
    reaches the consumer."""
    jc, tc = _disk_cfgs(fake_data, 'mv_det3d')
    tc.data.prefetch_depth = 2
    pre = tld.build_loader(tc, train=False)
    assert isinstance(pre, tld.Prefetcher)
    assert pre.steps_per_epoch == pre.loader.steps_per_epoch
    got = list(pre)
    _same(got, list(jds.EmbodiedScanLoader(jc, False)))
    assert len(got) == 3  # one eval pass over the three scans

    def broken():
        yield {'a': np.zeros(1)}
        raise ValueError('producer failed')

    with pytest.raises(ValueError, match='producer failed'):
        list(tld.Prefetcher(broken(), depth=1))


def test_to_device_cpu():
    batch = dict(points=np.arange(12, dtype=np.float32).reshape(2, 2, 3),
                 points_mask=np.array([[True, False], [True, True]]),
                 gt_labels=np.array([[1, 2]], np.int32),
                 flipped=np.arange(6, dtype=np.int64)[::-2])
    out = tld.to_device(batch, 'cpu')
    assert set(out) == set(batch)
    for k, v in batch.items():
        assert out[k].device.type == 'cpu'
        assert out[k].dtype == torch.from_numpy(np.ascontiguousarray(v)).dtype
        np.testing.assert_array_equal(out[k].numpy(), v)
