"""The port's profiler spans (``embodiedscan_torch/utils/trace.py``).

- With no profiler recording, ``span`` hands back one shared no-op context
  and makes no dispatcher call.
- Under ``torch.profiler``, one step of the runtime tests' tiny detector
  (``test_torch_helpers.TINY_DET`` on one sample of
  ``__graft_entry__._tiny_batch``) holds ``es.fwd``, ``es.bwd`` and
  ``es.optim`` inside ``es.step`` on one thread (on the CPU autograd runs
  the backward on the caller's thread), with the sparse-conv entry spans
  and the layer spans inside them; one ``predict`` holds the NMS's three
  spans inside ``es.predict``.
"""

import json

import numpy as np
import pytest
import torch

import __graft_entry__ as G
from embodiedscan_torch.configs.base import Config
from embodiedscan_torch.models.detector import SparseFusionDetector
from embodiedscan_torch.train.state import make_optimizer, train_step
from embodiedscan_torch.utils import trace

from test_torch_helpers import TINY_DET, to_torch


def test_span_off_is_shared_noop(monkeypatch):
    calls = []
    enter = torch.ops.profiler._record_function_enter_new

    def counted(*a, **k):
        calls.append(a)
        return enter(*a, **k)

    monkeypatch.setattr(torch.ops.profiler, '_record_function_enter_new',
                        counted)
    off = trace.span('es.a')
    assert off is trace.span('es.b')
    with off, trace.span('es.c'):
        pass
    assert calls == []
    with torch.profiler.profile():
        with trace.span('es.on') as on:
            assert isinstance(on, torch.profiler.record_function)
    assert [a[0] for a in calls] == ['es.on']


def _spans(prof, tmp_path):
    """{name: [(start_us, end_us, thread)]} of the trace's ``es.*``
    ranges (read from the exported trace: ``prof.events()`` takes seconds
    on a step's operations)."""
    path = tmp_path / 'trace.json'
    prof.export_chrome_trace(str(path))
    out = {}
    for e in json.loads(path.read_text())['traceEvents']:
        if e.get('cat') == 'user_annotation' and e['name'].startswith('es.'):
            out.setdefault(e['name'], []).append(
                (e['ts'], e['ts'] + e['dur'], e['tid']))
    return out


def _inside(inner, outer):
    return all(any(o[0] <= i[0] and i[1] <= o[1] and i[2] == o[2]
                   for o in outer) for i in inner)


@pytest.fixture(scope='module')
def det():
    torch.manual_seed(0)
    model = SparseFusionDetector(**TINY_DET)
    batch = to_torch({k: np.array(v)
                      for k, v in G._tiny_batch(b=1).items()})
    return model, batch


def test_train_step_phases(det, tmp_path):
    model, batch = det
    model.train()
    opt = make_optimizer(model, Config(), steps_per_epoch=1)
    with torch.profiler.profile() as prof:
        train_step(model, opt, batch)
    spans = _spans(prof, tmp_path)
    step = spans['es.step']
    assert len(step) == 1
    for phase in ('es.fwd', 'es.bwd', 'es.optim'):
        assert len(spans[phase]) == 1 and _inside(spans[phase], step)
    fwd, bwd, opt_ = (spans[p][0] for p in ('es.fwd', 'es.bwd', 'es.optim'))
    assert fwd[1] <= bwd[0] and bwd[1] <= opt_[0]
    for name in ('es.mink3d', 'es.resnet2d', 'es.head', 'es.loss',
                 'es.k2.fwd'):
        assert _inside(spans[name], [fwd]), name
    for name in ('es.k2.dgrad', 'es.k3'):
        assert _inside(spans[name], [bwd]), name


def test_predict_nms_spans(det, tmp_path):
    model, batch = det
    model.eval()
    with torch.profiler.profile() as prof:
        model(batch, mode='predict')
    spans = _spans(prof, tmp_path)
    b = batch['points'].shape[0]
    assert len(spans['es.predict']) == 1
    for name in ('es.nms.iou', 'es.nms.wait', 'es.nms.sweep'):
        assert len(spans[name]) == b and _inside(spans[name],
                                                 spans['es.predict']), name
    assert 'es.step' not in spans and 'es.loss' not in spans
