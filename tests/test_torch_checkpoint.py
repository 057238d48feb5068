"""The port's checkpoint manager (``train/checkpoint.py``) and convert CLI
(``tools/convert_checkpoint.py``) on the CPU.

A save / restore round trip of the tiny detector and its optimizer after
one train step gives back every tensor bit for bit, and the restored pair
takes the same next step as the original; keep-N pruning and resume from
the latest step; the CLI run in-process on a reference ``.pth`` equals
loading the same state_dict directly (as ``tests/test_convert_cli.py``
does for the JAX package).
"""

import numpy as np
import pytest
import torch
from torch import nn

import __graft_entry__ as G

from embodiedscan_torch.configs.base import (apply_overrides, build_model,
                                             mv_det3d)
from embodiedscan_torch.models.detector import SparseFusionDetector as TDet
from embodiedscan_torch.tools import convert_checkpoint as cli
from embodiedscan_torch.train.checkpoint import CheckpointManager
from embodiedscan_torch.train.loop import lr_mult_fn_for
from embodiedscan_torch.train.state import make_optimizer, train_step
from embodiedscan_torch.utils.convert_weights import load_reference_model

from test_reference_predict_fixture import full_reference_state_dict
from test_torch_helpers import to_torch
from test_torch_train import TINY

# the tiny detector of the JAX package's CLI test, as overrides of mv_det3d
OVERRIDES = [
    'model.num_classes=5', 'model.voxel_size=0.05',
    'model.input_capacity=256',
    'model.backbone_capacities=(256,128,128,64,32,16)',
    'model.fpn_capacities=(128,64,32,16)', 'model.max_dets=16',
    'model.nms_pre=32', 'model.max_candidates=32', 'model.resnet_depth=18',
    'model.mink_depth=18']


def _assert_state_equal(a: dict, b: dict):
    assert a.keys() == b.keys()
    for key in a:
        if isinstance(a[key], torch.Tensor):
            assert torch.equal(a[key], b[key]), key
        elif isinstance(a[key], dict):
            _assert_state_equal(a[key], b[key])
        elif isinstance(a[key], list) and a[key] and \
                isinstance(a[key][0], dict):
            for x, y in zip(a[key], b[key], strict=True):
                _assert_state_equal(x, y)
        else:
            assert a[key] == b[key], key


def _tiny_train(seed):
    model = TDet(**TINY).train()
    torch.manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(torch.randn_like(p) * 0.01)
    return model, make_optimizer(model, mv_det3d())


def test_round_trip_after_a_step(tmp_path):
    batch = to_torch({k: np.array(v) for k, v in G._tiny_batch().items()})
    model, opt = _tiny_train(0)
    train_step(model, opt, batch)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, model, opt)
    fresh, fresh_opt = _tiny_train(1)
    assert mgr.restore(fresh, fresh_opt) == 1
    _assert_state_equal(fresh.state_dict(), model.state_dict())
    _assert_state_equal(fresh_opt.state_dict(), opt.state_dict())
    assert fresh_opt.state_dict()['state'], 'no AdamW moments after a step'
    # the restored pair resumes where the original is: the same next step
    want = train_step(model, opt, batch)
    got = train_step(fresh, fresh_opt, batch)
    for key in want:
        assert torch.equal(got[key], want[key]), key
    _assert_state_equal(fresh.state_dict(), model.state_dict())
    _assert_state_equal(fresh_opt.state_dict(), opt.state_dict())


def test_keeps_the_newest(tmp_path):
    model = nn.Linear(3, 2)
    mgr = CheckpointManager(str(tmp_path), max_keep=2)
    for step in range(6):
        with torch.no_grad():
            model.weight.fill_(step)
        mgr.save(step, model)
    assert mgr.steps() == [4, 5]
    assert sorted(p.name for p in (tmp_path / 'checkpoints').iterdir()) == \
        ['4.pt', '5.pt']
    with pytest.raises(ValueError):
        CheckpointManager(str(tmp_path), max_keep=0)


def test_resume_from_latest(tmp_path):
    model = nn.Linear(3, 2)
    empty = CheckpointManager(str(tmp_path / 'empty'))
    assert empty.latest_step() is None
    assert empty.restore(model) is None
    mgr = CheckpointManager(str(tmp_path))
    for step in (3, 10, 7):
        with torch.no_grad():
            model.weight.fill_(step)
        mgr.save(step, model)
    # a restarted run: a new manager on the same directory
    again = CheckpointManager(str(tmp_path))
    assert again.latest_step() == 10
    restored = nn.Linear(3, 2)
    assert again.restore(restored) == 10
    assert (restored.weight == 10).all()
    assert again.restore(restored, step=3) == 3
    assert (restored.weight == 3).all()
    opt = torch.optim.SGD(restored.parameters(), lr=0.1)
    with pytest.raises(ValueError):  # saved without an optimizer
        again.restore(restored, opt)


def test_cli_equals_direct_load(tmp_path):
    sd = full_reference_state_dict()
    pth = tmp_path / 'ref.pth'
    torch.save({'state_dict': {k: torch.from_numpy(np.asarray(v))
                               for k, v in sd.items()},
                'meta': {'epoch': 12}}, pth)
    work = tmp_path / 'converted'
    model, n, skipped = cli.main(['mv_det3d', str(pth), '--work-dir',
                                  str(work), '--device', 'cpu'] + OVERRIDES)
    assert skipped == []
    cfg = apply_overrides(mv_det3d(), OVERRIDES)
    direct, n_direct, skipped_direct = load_reference_model(cfg, sd,
                                                            device='cpu')
    assert (n, skipped) == (n_direct, skipped_direct)
    restored = build_model(cfg, device='cpu')
    mgr = CheckpointManager(str(work))
    assert mgr.steps() == [0]
    assert mgr.restore(restored) == 0
    _assert_state_equal(restored.state_dict(), direct.state_dict())
    _assert_state_equal(model.state_dict(), direct.state_dict())
    # a resumed run's optimizer (the task's parameter groups) takes the
    # saved one, which holds no moments
    resumed = build_model(cfg, device='cpu')
    opt = make_optimizer(resumed, cfg, lr_mult_fn_for('mv_det3d'))
    assert mgr.restore(resumed, opt) == 0
    assert opt.state_dict()['state'] == {}
    assert [g['count'] for g in opt.param_groups] == [0]


def test_cli_defaults_to_the_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    pth = tmp_path / 'ref.pth'
    torch.save({}, pth)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        cli.main(['mv_det3d', str(pth), '--work-dir', str(tmp_path)] +
                 OVERRIDES)
