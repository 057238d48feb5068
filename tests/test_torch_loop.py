"""The runtime against the reference package: configs, the train loop,
checkpoints and resume, the metrics writer, evaluate, the visualization
hook and the offline tools.

- Every preset's schedule, data and runtime fields, names and values, and
  its model fields that both packages have, equal the reference's.
- ``train()`` of the tiny detector on the ``fake_data`` scenes (3 steps an
  epoch, milestones at epochs 1 and 3, gamma 0.5): a first run of 4 steps,
  then ``resume='auto'`` to the end of epoch 4. The rate of every update
  equals optax's ``multistep_lr`` with the loader's ``steps_per_epoch``
  and the schedule's gamma; checkpoints at each epoch's end and at each
  run's end, the newest 4 kept; the checkpoint restores the first run's
  model and optimizer ``state_dict``s exactly; ``scalars.jsonl`` holds a
  row for each logged step; the profiler's trace of the second run's last
  steps is written.
- ``MetricsWriter``'s file equals the reference writer's, byte for byte.
- ``evaluate()`` of the port, with the weights of the reference's
  variables, against the reference's ``evaluate(cfg, state)`` over the
  ``fake_data`` val scenes: the records handed to ``indoor_eval``
  (integers identical, floats within atol 1e-4 + rtol 1e-5), the
  metrics within 1e-6, and the PLYs of every ``vis_interval``-th scene.
- ``_vis_hook``'s PLY equals the reference's, byte for byte.
- ``tools.eval_script`` and ``tools.submit_results`` against the reference
  tools on the same files.
"""

import dataclasses
import importlib.util
import json
import os
import pathlib
import pickle
import shutil
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from embodiedscan_tpu.configs import base as jcfg
from embodiedscan_tpu.eval import indoor_eval as jIE
from embodiedscan_tpu.models.detector import SparseFusionDetector as JDet
from embodiedscan_tpu.train import loop as jL
from embodiedscan_tpu.train import state as jT
from embodiedscan_tpu.train.metrics_writer import MetricsWriter as JWriter
from embodiedscan_torch.configs import base as tcfg
from embodiedscan_torch.eval import indoor_eval as tIE
from embodiedscan_torch.tools import eval_script as t_eval_script
from embodiedscan_torch.tools import submit_results as t_submit
from embodiedscan_torch.train import loop as tL
from embodiedscan_torch.train import state as tT
from embodiedscan_torch.train.checkpoint import CheckpointManager
from embodiedscan_torch.train.metrics_writer import MetricsWriter as TWriter
from embodiedscan_torch.utils.convert_weights import load_jax_variables

from test_torch_helpers import TINY_DET, disk_cfg, flat_engine, \
    random_variables

ROOT = pathlib.Path(__file__).resolve().parent.parent
TOL = dict(atol=1e-4, rtol=1e-5)


# --- configs ----------------------------------------------------------------


def _fields(obj):
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)
            if not dataclasses.is_dataclass(getattr(obj, f.name))}


# the reference presets' remat, sized for a 16 GB chip (its configs/base.py:
# '2d' by default, 'all' for cont_occ); the port's presets keep 'none' on
# the 80 GB card
REFERENCE_REMAT = {'cont_occ': 'all'}


@pytest.mark.parametrize('preset', sorted(jcfg.PRESETS))
def test_preset_fields_match_reference(preset):
    """The schedule, data and runtime fields: the same names and values.
    The model fields: every one of the reference's, at the same values but
    ``remat`` (the reference's '2d', or 'all' for cont_occ, the port's
    'none'); the port adds only the grounding loss's weights and the text
    encoder's vocabulary and norm, which the reference fixes at 30522 rows
    and 1e-12 and the mv_grounding presets set to roberta-base's 50265
    and 1e-5."""
    j, t = jcfg.PRESETS[preset](), tcfg.PRESETS[preset]()
    for part in ('schedule', 'data'):
        assert _fields(getattr(t, part)) == _fields(getattr(j, part)), part
    assert _fields(t) == _fields(j)
    jm, tm = _fields(j.model), _fields(t.model)
    assert set(jm) <= set(tm)
    assert set(tm) - set(jm) <= {'iou_cost_capacity', 'cost_cls_weight',
                                 'cost_l1_weight', 'cost_iou_weight',
                                 'decouple_weights', 'text_vocab_size',
                                 'text_ln_eps'}
    assert (tm['text_vocab_size'], tm['text_ln_eps']) == \
        ((50265, 1e-5) if preset.startswith('mv_grounding') else
         (30522, 1e-12))
    assert {k: tm[k] for k in jm if k != 'remat'} == \
        {k: v for k, v in jm.items() if k != 'remat'}
    assert (jm['remat'], tm['remat']) == \
        (REFERENCE_REMAT.get(preset, '2d'), 'none')


def test_overrides_of_the_reference_cli_apply():
    """``a.b=c`` overrides that the reference's CLI takes apply to the
    port's config, each parsed as its field's type."""
    over = ['schedule.max_epochs=3', 'schedule.gamma=0.5', 'work_dir=x',
            'log_backends=jsonl,tensorboard', 'resume=auto',
            'profile_dir=p', 'vis_interval=7', 'schedule.base_batch_size=8',
            'schedule.milestones=1,2']
    t = tcfg.apply_overrides(tcfg.mv_det3d(), over)
    j = jcfg.apply_overrides(jcfg.mv_det3d(), over)
    assert _fields(t) == _fields(j) and _fields(t.schedule) == \
        _fields(j.schedule)
    assert t.schedule.milestones == (1, 2) and t.log_backends == (
        'jsonl', 'tensorboard')


# --- train(): schedule, checkpoints, resume, metrics file ---------------------


EPOCH = 3  # the fake_data scenes at one a step
MILESTONES = (1, 3)
GAMMA = 0.5
EPOCHS = 4
FIRST_STEPS = 4


@pytest.fixture(scope='module')
def trained(fake_data, tmp_path_factory):
    """Two runs of ``train()`` on the CPU, the rate of every update and
    the first run's (model, optimizer); the checkpoints are removed after
    the module's tests."""
    work = tmp_path_factory.mktemp('loop_work')
    cfg = disk_cfg(tcfg, fake_data)
    cfg.work_dir = str(work)
    cfg.log_interval = 2
    cfg.schedule.max_epochs = EPOCHS
    cfg.schedule.milestones = MILESTONES
    cfg.schedule.gamma = GAMMA
    rates = []
    step = tT.ClippedAdamW.step

    def recording(self, closure=None):
        out = step(self, closure)
        rates.append([g['lr'] / g['lr_mult'] for g in self.param_groups])
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tT.ClippedAdamW, 'step', recording)
        first = tL.train(cfg, max_steps=FIRST_STEPS, device='cpu')
        after_first = CheckpointManager(str(work)).steps()
        cfg.resume = 'auto'
        cfg.profile_dir = str(work / 'profile')
        tL.train(cfg, device='cpu')
    yield dict(cfg=cfg, work=work, rates=rates, first=first,
               after_first=after_first)
    shutil.rmtree(work / 'checkpoints', ignore_errors=True)


def test_schedule_matches_optax_across_epochs_and_resume(trained):
    sched = jT.multistep_lr(1e-3, EPOCH, MILESTONES, GAMMA)
    rates = trained['rates']
    assert len(rates) == EPOCH * EPOCHS
    for count, per_group in enumerate(rates):
        for rate in per_group:
            np.testing.assert_allclose(rate, float(sched(count)), rtol=1e-6)
    assert len({round(r[0], 12) for r in rates}) == 3


def test_checkpoints_at_epoch_ends_keep_newest(trained):
    assert trained['after_first'] == [EPOCH, FIRST_STEPS]
    # epoch ends 3, 6, 9, 12 and the first run's end 4; 'det' keeps 4
    assert CheckpointManager(str(trained['work'])).steps() == [4, 6, 9, 12]


def test_resume_restores_model_and_optimizer_exactly(trained, fake_data):
    """The first run's checkpoint (step 4, its last) restores its model's
    and optimizer's state_dicts bit for bit; resuming continues the count."""
    model, opt = trained['first']
    cfg = disk_cfg(tcfg, fake_data)
    fresh, fresh_opt = tcfg.build_train(cfg, device='cpu',
                                        steps_per_epoch=EPOCH)
    assert CheckpointManager(str(trained['work'])).restore(
        fresh, fresh_opt, step=FIRST_STEPS) == FIRST_STEPS
    for key, val in model.state_dict().items():
        assert torch.equal(fresh.state_dict()[key], val), key
    want, got = opt.state_dict(), fresh_opt.state_dict()
    assert want['param_groups'] == got['param_groups']
    assert want['param_groups'][0]['count'] == FIRST_STEPS
    assert set(want['state']) == set(got['state'])
    for idx, state in want['state'].items():
        for key, val in state.items():
            assert torch.equal(got['state'][idx][key], val), (idx, key)


def test_scalars_jsonl_and_trace(trained):
    with open(os.path.join(trained['work'], 'scalars.jsonl')) as f:
        rows = [json.loads(line) for line in f]
    assert [r['step'] for r in rows] == [2, 4, 6, 8, 10, 12]
    for row in rows:
        assert set(row) == {'step', 'train/loss_center', 'train/loss_bbox',
                            'train/loss_cls', 'train/loss_total',
                            'train/sec_per_iter'}
        assert all(np.isfinite(v) for v in row.values())
    # the resumed run's steps 5-10 start at its 6th step (step 10) and the
    # run ends inside the window: the trace is written at its end
    trace = os.path.join(trained['work'], 'profile', 'trace_rank0.json')
    with open(trace) as f:
        assert json.load(f)['traceEvents']


def test_metrics_writer_bytes_match_reference(tmp_path):
    rows = [(1, {'loss': 1.5, 'sec_per_iter': 0.25}, 'train'),
            (2, {'a': np.float32(0.1), 'b': 3}, ''),
            (50, {'loss_total': 1e-9}, 'train')]
    for i, cls in enumerate((JWriter, TWriter)):
        writer = cls(str(tmp_path / str(i)))
        for row in rows:
            writer.write(*row)
        writer.close()
    assert (tmp_path / '0' / 'scalars.jsonl').read_bytes() == \
        (tmp_path / '1' / 'scalars.jsonl').read_bytes()


# --- evaluate() against the reference ----------------------------------------


def test_evaluate_matches_reference(fake_data, tmp_path):
    cfg_t = disk_cfg(tcfg, fake_data)
    cfg_j = disk_cfg(jcfg, fake_data)
    cfg_j.n_devices = 1  # else the mesh takes all 8 virtual devices
    for i, cfg in enumerate((cfg_j, cfg_t)):  # a PLY of scenes 0 and 2
        cfg.vis_dir, cfg.vis_interval = str(tmp_path / f'vis{i}'), 2
    records = {}

    def spy(name, fn):
        def wrapped(gts, dts, *args, **kw):
            records[name] = (gts, dts)
            return fn(gts, dts, *args, **kw)
        return wrapped

    with flat_engine(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(jIE, 'indoor_eval', spy('jax', jIE.indoor_eval))
        mp.setattr(tIE, 'indoor_eval', spy('torch', tIE.indoor_eval))
        # evaluate() reads only the state's params and batch_stats: the
        # reference's init (a jitted forward) is not needed
        mp.setattr(jL, 'init_model',
                   lambda cfg, batch: (jcfg.build_model(cfg), None))
        jm = JDet(**TINY_DET)
        first = next(iter(jL.make_dataset(cfg_j, train=False)))
        var = random_variables(jm, ({k: jnp.asarray(v)
                                     for k, v in first.items()}, ),
                               train=False, mode='feats')
        var['params']['bbox_head']['conv_cls']['bias'][:] = 0
        state = jT.TrainState(jnp.zeros((), jnp.int32), var['params'],
                              var['batch_stats'], None)
        want = jL.evaluate(cfg_j, state)
        model = tcfg.build_model(cfg_t, device='cpu')
        load_jax_variables(model, var['params'], var['batch_stats'])
        got = tL.evaluate(cfg_t, model, device='cpu')
    (jg, jd), (tg, td) = records['jax'], records['torch']
    assert len(jg) == len(tg) == 3
    assert sum(len(d['scores']) for d in td) > 0
    for a, b in zip(jg + jd, tg + td):
        assert set(a) == set(b)
        for key in a:
            if np.asarray(a[key]).dtype.kind in 'iub':
                np.testing.assert_array_equal(b[key], a[key])
            else:
                np.testing.assert_allclose(b[key], a[key], **TOL)
    assert set(got) == set(want)
    for key, val in want.items():
        np.testing.assert_allclose(got[key], val, rtol=0, atol=1e-6)
    plys = [sorted(os.listdir(cfg.vis_dir)) for cfg in (cfg_j, cfg_t)]
    assert plys[0] == plys[1] == ['scene_00000.ply', 'scene_00002.ply']


# --- the visualization hook ---------------------------------------------------


@pytest.mark.parametrize('with_boxes', [True, False])
def test_vis_hook_ply_matches_reference(tmp_path, with_boxes):
    rng = np.random.RandomState(3)
    batch = dict(points=rng.uniform(0, 3, (2, 50, 3)).astype(np.float32),
                 points_mask=rng.uniform(size=(2, 50)) > 0.3)
    boxes = np.concatenate([rng.uniform(0, 3, (2, 6, 3)),
                            rng.uniform(0.2, 1, (2, 6, 3)),
                            rng.uniform(-0.5, 0.5, (2, 6, 3))], -1)
    preds = dict(bboxes=boxes.astype(np.float32),
                 scores=rng.uniform(size=(2, 6)).astype(np.float32),
                 labels=rng.randint(0, 12, (2, 6)),
                 mask=rng.uniform(size=(2, 6)) > 0.2)
    if not with_boxes:
        preds = dict(bboxes=preds['bboxes'], scores=preds['scores'])
    files = []
    for i, (hook, cast) in enumerate(((jL._vis_hook, np.asarray),
                                      (tL._vis_hook, torch.from_numpy))):
        cfg = tcfg.mv_det3d()
        cfg.vis_dir = str(tmp_path / str(i))
        hook(cfg, {k: cast(v) for k, v in batch.items()},
             {k: cast(v) for k, v in preds.items()}, 1, 7)
        files.append((tmp_path / str(i) / 'scene_00007.ply').read_bytes())
    assert files[0] == files[1]
    assert (b'element edge' in files[0]) == with_boxes


# --- the offline tools --------------------------------------------------------


def _reference_tool(name):
    spec = importlib.util.spec_from_file_location(
        f'reference_{name}', ROOT / 'tools' / f'{name}.py')
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _last_json(text):
    """The JSON object a tool prints last (after indoor_eval's tables)."""
    return json.loads(text[text.rindex('{'):])


@pytest.mark.parametrize('grounding', [False, True])
def test_eval_script_matches_reference(fake_data, tmp_path, capsys,
                                       monkeypatch, grounding):
    gt = os.path.join(fake_data, 'embodiedscan_infos_val.pkl')
    with open(gt, 'rb') as f:
        infos = pickle.load(f)['data_list']
    rng = np.random.RandomState(5)
    results = {}
    for info in infos:
        boxes = np.asarray([i['bbox_3d'] for i in info['instances']],
                           np.float32)
        boxes = np.concatenate([boxes + rng.normal(0, 0.05, boxes.shape),
                                rng.uniform(0, 3, (3, 9))]).astype(np.float32)
        results[info['sample_idx']] = dict(
            bboxes_3d=boxes, scores_3d=rng.uniform(size=len(boxes)),
            labels_3d=np.concatenate([[i['bbox_label_3d']
                                       for i in info['instances']],
                                      rng.randint(0, 5, 3)]))
    sub = str(tmp_path / 'sub.pkl')
    with open(sub, 'wb') as f:
        pickle.dump(dict(results=results), f)
    args = ['--submission', sub, '--gt', gt] + \
        (['--grounding'] if grounding else [])
    monkeypatch.setattr(sys, 'argv', ['eval_script.py'] + args)
    _reference_tool('eval_script').main()
    want = _last_json(capsys.readouterr().out)
    metrics = t_eval_script.main(args + ['--device', 'cpu'])
    got = _last_json(capsys.readouterr().out)
    assert set(got) == set(want) and len(want) >= 4
    assert max(want.values()) > 0
    for key, val in want.items():
        assert abs(got[key] - val) <= 1e-5, key
        assert abs(metrics[key] - val) <= 1e-5, key


def test_submit_results_matches_reference(tmp_path, capsys, monkeypatch):
    res = str(tmp_path / 'results.json')
    with open(res, 'w') as f:
        json.dump({'scene0': dict(bboxes_3d=[[0.0] * 9], scores_3d=[0.5])},
                  f)
    args = ['--results', res, '--method', 'm', '--team', 't', '--authors',
            'a,b', '--email', 'e', '--institution', 'i', '--country', 'c']
    out = [str(tmp_path / f'{i}.pkl') for i in range(2)]
    monkeypatch.setattr(sys, 'argv', ['submit_results.py', *args, '--out',
                                      out[0]])
    _reference_tool('submit_results').main()
    t_submit.main([*args, '--out', out[1]])
    assert capsys.readouterr().out.count('(1 entries)') == 2
    with open(out[0], 'rb') as f0, open(out[1], 'rb') as f1:
        assert f0.read() == f1.read()


def test_occupancy_ply_image_and_nms_filter_match_reference(tmp_path):
    """``export_occupancy_ply`` (bytes), ``draw_boxes_on_image`` (pixels)
    and ``nms_filter`` (the kept boxes) against the reference's."""
    from embodiedscan_tpu.vis import visualization as jV
    from embodiedscan_torch.vis import visualization as tV
    rng = np.random.RandomState(7)
    occ = rng.randint(0, 6, (8, 8, 4)).astype(np.uint8)
    occ[0, 0, 0] = 255
    for i, mod in enumerate((jV, tV)):
        mod.export_occupancy_ply(str(tmp_path / f'{i}.ply'), occ, 0.16,
                                 (-3.2, -3.2, -0.78))
    assert (tmp_path / '0.ply').read_bytes() == \
        (tmp_path / '1.ply').read_bytes()
    rgb = rng.randint(0, 255, (64, 80, 3)).astype(np.uint8)
    boxes = np.concatenate([rng.uniform(-1, 1, (5, 2)),
                            rng.uniform(2, 4, (5, 1)),
                            rng.uniform(0.3, 1, (5, 3)),
                            rng.uniform(-0.5, 0.5, (5, 3))], -1)
    proj = np.array([[40.0, 0, 40, 0], [0, 40, 32, 0], [0, 0, 1, 0],
                     [0, 0, 0, 1]])
    labels = rng.randint(0, 20, 5)
    np.testing.assert_array_equal(
        tV.draw_boxes_on_image(rgb, boxes, proj, labels, list('abcde')),
        jV.draw_boxes_on_image(rgb, boxes, proj, labels, list('abcde')))
    boxes = np.concatenate([rng.uniform(0, 2, (40, 3)),
                            rng.uniform(0.5, 1, (40, 3)),
                            np.zeros((40, 3))], -1).astype(np.float32)
    scores = rng.uniform(size=40).astype(np.float32)
    labels = rng.randint(0, 3, 40)
    want = jV.nms_filter(boxes, scores, labels, top_k=10)
    got = tV.nms_filter(boxes, scores, labels, top_k=10)
    assert 0 < len(got[0]) <= 10
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


# --- the CLIs -----------------------------------------------------------------


@pytest.mark.parametrize('preset', sorted(tcfg.PRESETS))
@pytest.mark.parametrize('cli', ['train', 'test'])
def test_cli_defaults_to_the_card(preset, cli):
    """Every preset's train and test CLI runs on the card by default, and
    raises on a machine without one."""
    from embodiedscan_torch.tools import test as test_cli
    from embodiedscan_torch.tools import train as train_cli
    main = train_cli.main if cli == 'train' else test_cli.main
    if torch.cuda.is_available():
        pytest.skip('a card is present')
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        main([preset, '--work-dir', 'unused'])


def test_cli_flags_map_onto_the_config(monkeypatch):
    """The reference CLIs' flags: overrides, --work-dir, --resume,
    --synthetic, --max-steps and --auto-scale-lr (lr x batch x processes /
    base_batch_size) for train; --max-scenes, --format-only and --vis-dir
    for test."""
    from embodiedscan_torch.tools import test as test_cli
    from embodiedscan_torch.tools import train as train_cli
    seen = {}
    monkeypatch.setattr(tL, 'train', lambda cfg, **kw: seen.update(
        train=(cfg, kw)))
    monkeypatch.setattr(tL, 'evaluate', lambda cfg, **kw: seen.update(
        test=(cfg, kw)) or {'mAP_0.25': 0.5, 'table': 'x'})
    train_cli.main(['mv_grounding', 'data.batch_size=6', '--work-dir', 'w',
                    '--resume', 'auto', '--synthetic', '--max-steps', '3',
                    '--auto-scale-lr', '--device', 'cpu'])
    cfg, kw = seen['train']
    assert kw == dict(max_steps=3, device='cpu')
    assert (cfg.work_dir, cfg.resume, cfg.data.synthetic,
            cfg.data.batch_size) == ('w', 'auto', True, 6)
    assert cfg.schedule.lr == pytest.approx(5e-4 * 6 / 96)
    test_cli.main(['mv_grounding', '--max-scenes', '2', '--format-only',
                   '--vis-dir', 'v', '--device', 'cpu'])
    cfg, kw = seen['test']
    assert kw == dict(max_scenes=2, format_only=True, device='cpu')
    assert cfg.vis_dir == 'v'
