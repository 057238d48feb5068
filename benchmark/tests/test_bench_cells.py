"""Every cell run end to end on the CPU at a small size: the program (the
port, on its plain CPU kernels) against the frozen reference, the faults
that ``correct`` has to catch, and the lower-precision control."""

import contextlib
import io

import pytest
import torch

from benchmark import run
from benchmark.tests.tiny import REPO

CELLS = ('mv_det3d.train.b4', 'mv_occ.train.b1', 'mv_det3d.serve.v50',
         'mv_occ.serve.v20')


def _run(tiny, cell, trace=0, seed=2**31 + 17, device='cpu', **kw):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = run.main(['--workload', cell, '--seed', str(seed), '--seconds',
                        '1', '--trace', str(trace)], device=device, root=tiny,
                       **kw)
    return out


@pytest.mark.parametrize('cell', CELLS)
def test_cell_matches_reference(tiny, cell):
    out = _run(tiny, cell)
    assert out['correct'], out['check']
    assert out['attempted'] >= 1 and out['failed'] == 0
    names = set(out['metrics'])
    assert 'setup_s' in names and 'peak_gib' in names
    assert ('train_scenes_per_s' in names) == ('.train.' in cell)


@pytest.mark.parametrize('cell', CELLS[:3:2])
def test_traced_run(tiny, cell):
    out = _run(tiny, cell, trace=1)
    assert out['correct']
    assert 'window_s' in out['device'] and 'breakdown' in out
    assert all(n.endswith(('.train', '.serve')) for n in out['metrics'])


def _unchanged_state(model, opt, batch):
    """A step that returns its state unchanged (the losses of the state as
    it is, no update)."""
    from embodiedscan_torch.train.state import train_step
    saved = {n: p.detach().clone() for n, p in model.named_parameters()}
    out = train_step(model, opt, batch)
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(saved[n])
    return out


def _half_batch(model, opt, batch):
    """Half of the batch left out; the mean taken over the rest."""
    from embodiedscan_torch.train.state import train_step
    b = batch['points'].shape[0]
    return train_step(model, opt, {k: v[:max(1, b // 2)]
                                   for k, v in batch.items()})


def _altered_loss(model, opt, batch):
    """An answer altered where it is produced: the losses off by 1%."""
    from embodiedscan_torch.train.state import train_step
    return {k: v * 1.01 for k, v in train_step(model, opt, batch).items()}


@pytest.mark.parametrize('cell', CELLS[:2])
@pytest.mark.parametrize('fault', [_unchanged_state, _half_batch,
                                   _altered_loss])
def test_train_faults_are_caught(tiny, cell, fault):
    if fault is _half_batch and cell == 'mv_occ.train.b1':
        pytest.skip('the cell serves one scene a step: no half to leave out')
    out = _run(tiny, cell, faults=dict(train_step=fault))
    assert not out['correct'], out['check']


def _altered_det(model, batch_np, device):
    from benchmark.harness.program import request
    out = request(model, batch_np, device)
    out['labels'] = out['labels'].clone()
    out['labels'][0, 0] = (out['labels'][0, 0] + 1) % 5
    return out


def _altered_keep(model, batch_np, device):
    from benchmark.harness.program import request
    out = request(model, batch_np, device)
    out['mask'] = out['mask'].clone()
    out['mask'][0, 1] = ~out['mask'][0, 1]
    return out


def _altered_occ(model, batch_np, device):
    from benchmark.harness.program import request
    out = request(model, batch_np, device).clone()
    out[0, 0, 0, 0] = (out[0, 0, 0, 0] + 1) % 81
    return out


def _altered_coarse_scale(model, batch_np, device):
    """A fault at the coarsest scale's logits, which the served classes
    (the finest scale's argmax) do not show."""
    from benchmark.harness.program import request
    w = model.OccHead_0.occ2.weight
    with torch.no_grad():
        w.mul_(1.01)
    try:
        return request(model, batch_np, device)
    finally:
        with torch.no_grad():
            w.div_(1.01)


def _fewer_det(model, batch_np, device):
    """The last quarter of the candidates dropped (scores zeroed)."""
    from benchmark.harness.program import request
    out = request(model, batch_np, device)
    d = out['scores'].shape[1]
    out['scores'] = out['scores'].clone()
    out['scores'][:, d - d // 4:] = 0
    return out


@pytest.mark.parametrize('cell,fault', [
    ('mv_det3d.serve.v50', _altered_det), ('mv_det3d.serve.v50', _altered_keep),
    ('mv_det3d.serve.v50', _fewer_det), ('mv_occ.serve.v20', _altered_occ),
    ('mv_occ.serve.v20', _altered_coarse_scale)])
def test_serve_faults_are_caught(tiny, cell, fault):
    out = _run(tiny, cell, faults=dict(request=fault))
    assert not out['correct'], out['check']


@pytest.mark.parametrize('cell', CELLS)
def test_control_fails(tiny, cell, request):
    """The port's bf16 sparse-conv route with TF32 on fails the cell's
    comparison at the limits set on the card. In the occupancy request the
    control acts through TF32 in the dense U-Net, which only the card has,
    and small scenes flip no class: there the test needs a card and runs
    the cell at its own size (a few requests)."""
    root, device = tiny, 'cpu'
    if cell == 'mv_occ.serve.v20':
        request.getfixturevalue('card')
        root, device = REPO, None
    out = _run(root, cell, control=True, device=device)
    assert not out['correct'], out['check']


def test_no_card_no_result(tiny, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(SystemExit) as exc:
        run.main(['--workload', CELLS[0], '--seed', '1', '--seconds', '1'],
                 root=tiny)
    assert exc.value.code != 0
    assert capsys.readouterr().out == ''


@pytest.mark.parametrize('cell', CELLS)
def test_cell_on_card(tiny, card, cell):
    """The small cells through the card's kernels against the reference."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = run.main(['--workload', cell, '--seed', '5', '--seconds', '1',
                        '--trace', '0'], root=tiny)
    assert out['correct'], out['check']
    assert out['device']['platform'] == 'gpu'
