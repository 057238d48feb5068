"""The in-the-wild demo against the reference's ``demo/demo.py``.

- ``load_scan_dir`` and ``quat_to_mat``: identical arrays from the same
  scan directory (written by the port's ``data.synthetic.write_scan_dir``
  from a synthetic scan, poses in both of the layout's forms).
- The whole demo at the tiny detector's size on 3 views of 32 x 32: the
  same weights, from a reference checkpoint in the reference's work dir and
  through ``load_jax_variables`` into a port checkpoint in the port's, go
  through ``demo/demo.py:main`` and ``embodiedscan_torch.tools.demo.main
  --device cpu``. The class bias is 0, so the filter keeps boxes. The scene
  points are identical, the kept labels identical, the kept boxes within
  atol 1e-4 + rtol 1e-5 (float32 network sums in another order); the PLYs
  have the same header and point rows, and box corners within 1e-3 (their
  4-decimal rounding).
- Asked for ``cuda`` without a card, the demo raises before it reads the
  scan or writes anything.
"""

import importlib.util
import pathlib

import numpy as np
import pytest

import jax

from embodiedscan_tpu.configs import base as jcfg
from embodiedscan_tpu.train import loop as jL
from embodiedscan_tpu.train import state as jT
from embodiedscan_tpu.train.checkpoint import CheckpointManager as JCkpt
from embodiedscan_tpu.vis import visualization as jV
from embodiedscan_torch.configs import base as tcfg
from embodiedscan_torch.data.synthetic import (make_scan, mat_to_quat,
                                                write_scan_dir)
from embodiedscan_torch.tools import demo as tdemo
from embodiedscan_torch.train.checkpoint import CheckpointManager
from embodiedscan_torch.utils.convert_weights import load_jax_variables

from test_torch_helpers import TINY_DET, flat_engine, random_variables

ROOT = pathlib.Path(__file__).resolve().parent.parent
TOL = dict(atol=1e-4, rtol=1e-5)
N_VIEWS = 3
TINY = [f'model.{k}=' + (','.join(map(str, v)) if isinstance(v, tuple)
                         else str(v)) for k, v in TINY_DET.items()] + [
    'data.image_hw=32,32', 'data.n_points=1000', 'data.points_per_view=400']
STEP = 7


def _reference_demo():
    spec = importlib.util.spec_from_file_location(
        'reference_demo', ROOT / 'demo' / 'demo.py')
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope='module')
def scan_dir(tmp_path_factory):
    path = tmp_path_factory.mktemp('scan')
    write_scan_dir(str(path), make_scan(seed=3, n_views=4, hw=(32, 32), g=4,
                                        num_classes=5))
    return str(path)


def test_load_scan_dir(scan_dir):
    ref = _reference_demo()
    q = np.random.RandomState(0).randn(4)
    q /= np.linalg.norm(q)
    np.testing.assert_array_equal(tdemo.quat_to_mat(q), ref.quat_to_mat(q))
    np.testing.assert_allclose(tdemo.quat_to_mat(mat_to_quat(
        ref.quat_to_mat(q))), ref.quat_to_mat(q), atol=1e-12)
    lines = open(f'{scan_dir}/poses.txt').read().splitlines()
    assert [len(ln.split()) for ln in lines] == [17, 8, 17, 8]
    want = ref.load_scan_dir(scan_dir, 3, (24, 40))
    got = tdemo.load_scan_dir(scan_dir, 3, (24, 40))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for key in w:
            assert g[key].dtype == w[key].dtype
            np.testing.assert_array_equal(g[key], w[key])


class _Jitted:
    """The reference detector with its predict jitted (the demo calls
    ``model.apply`` eagerly, op by op)."""

    def __init__(self, model):
        self._predict = jax.jit(lambda v, b: model.apply(
            v, b, train=False, mode='predict'))

    def apply(self, variables, batch, train, mode):
        assert (train, mode) == (False, 'predict')
        return self._predict(variables, batch)


def _ply(path):
    lines = open(path).read().splitlines()
    end = lines.index('end_header')
    return lines[:end + 1], lines[end + 1:]


def test_demo_matches_reference(scan_dir, tmp_path, capsys):
    cfg_j = jcfg.apply_overrides(jcfg.mv_det3d(), TINY)
    cfg_t = tcfg.apply_overrides(tcfg.mv_det3d(), TINY)
    _, batch = tdemo.scan_request(
        tdemo.load_scan_dir(scan_dir, N_VIEWS, (32, 32)), cfg_t,
        np.random.RandomState(0))
    jm = jcfg.build_model(cfg_j)
    var = random_variables(jm, (batch, ), train=False, mode='feats')
    var['params']['bbox_head']['conv_cls']['bias'][:] = 0
    tx = jT.make_optimizer(jT.multistep_lr(cfg_j.schedule.lr, 100),
                           lr_mult_fn=jL.lr_mult_fn_for('mv_det3d'),
                           params_template=var['params'])
    jwork, twork = str(tmp_path / 'jax_work'), str(tmp_path / 'torch_work')
    JCkpt(jwork).save(STEP, jT.create_train_state(None, var, tx)._replace(
        step=np.int32(STEP)))
    model = tcfg.build_model(cfg_t, device='cpu')
    load_jax_variables(model, var['params'], var['batch_stats'])
    CheckpointManager(twork).save(STEP, model)
    del model

    # the reference demo: its init replaced by the detector (jitted) and a
    # zeroed template, so only the restore can give it the weights
    zeros = jax.tree_util.tree_map(np.zeros_like, var)
    exported = {}

    def spy(path, points, boxes, labels, **kw):
        exported.update(points=points, boxes=boxes, labels=labels)
        return export_scene_ply(path, points, boxes, labels, **kw)

    export_scene_ply = jV.export_scene_ply
    jout, tout = str(tmp_path / 'jax.ply'), str(tmp_path / 'torch.ply')
    with flat_engine(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(jL, 'init_model', lambda cfg, b: (_Jitted(jm), zeros))
        mp.setattr(jV, 'export_scene_ply', spy)
        mp.setattr('sys.argv', ['demo.py', '--dir', scan_dir, '--work-dir',
                                jwork, '--out', jout, '--n-views',
                                str(N_VIEWS), *TINY])
        _reference_demo().main()
    want_out = capsys.readouterr().out
    got = tdemo.main(['--dir', scan_dir, '--work-dir', twork, '--out', tout,
                      '--device', 'cpu', '--n-views', str(N_VIEWS), *TINY])
    got_out = capsys.readouterr().out
    assert f'loaded checkpoint step {STEP}' in want_out
    assert got_out.startswith(want_out.splitlines()[0])
    assert got['step'] == STEP and got['out'] == tout
    np.testing.assert_array_equal(got['points'], exported['points'])
    assert 0 < len(got['labels']) == len(exported['labels'])
    np.testing.assert_array_equal(got['labels'], exported['labels'])
    np.testing.assert_allclose(got['boxes'], exported['boxes'], **TOL)
    assert set(got['seconds']) == {'load', 'build', 'request', 'export'}
    (jh, jrows), (th, trows) = _ply(jout), _ply(tout)
    assert th == jh and len(trows) == len(jrows)
    n = len(got['points'])
    assert trows[:n] == jrows[:n]
    corners = [np.array([[float(x) for x in r.split()] for r in rows[n:]
                         if len(r.split()) == 6]) for rows in (jrows, trows)]
    assert len(corners[0]) == 8 * len(got['labels'])
    np.testing.assert_allclose(corners[1], corners[0], atol=1e-3, rtol=0)
    assert trows[n + len(corners[0]):] == jrows[n + len(corners[0]):]


def test_demo_raises_without_card(scan_dir, tmp_path):
    out = tmp_path / 'out.ply'
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        tdemo.main(['--dir', scan_dir, '--work-dir', str(tmp_path / 'w'),
                    '--out', str(out), *TINY])
    assert not out.exists() and not (tmp_path / 'w').exists()
