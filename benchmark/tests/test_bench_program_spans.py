"""The readers of the port's own spans (``metrics/program_spans.py`` and
the metric files that read ``es.*`` spans) on synthetic traces, no model:
chrome-trace events made by hand and parsed by the harness's
``read_trace``, as a traced run parses the profiler's."""

import pytest

from benchmark.harness import spec
from benchmark.harness.trace import busy_us, read_trace
from benchmark.metrics import program_spans as PS

NEW = ('bwd_dev_ms.train', 'optim_dev_ms.train', 'fwd_idle_ms.train',
       'bwd_idle_ms.train', 'optim_idle_ms.train', 'nms_iou_ms.serve',
       'nms_wait_ms.serve', 'nms_sweep_ms.serve', 'mink3d_host_ms.serve',
       'to_device_ms.serve')
STEP, AUTOGRAD = 1, 2


def _span(name, t0, t1, tid=STEP):
    return dict(ph='X', cat='user_annotation', name=name, ts=t0,
                dur=t1 - t0, tid=tid)


def _kernel(corr, launch, t0, t1, tid=STEP):
    """A kernel run over [t0, t1], launched at ``launch`` on ``tid``."""
    return [dict(ph='X', cat='cuda_runtime', name='cudaLaunchKernel',
                 ts=launch, dur=1, tid=tid, args=dict(correlation=corr)),
            dict(ph='X', cat='kernel', name=f'k{corr}', ts=t0, dur=t1 - t0,
                 tid=7, args=dict(correlation=corr))]


def _step_trace(extra_counts=20):
    """One step in a window of [0, 1000] us: the forward, the backward
    launched from autograd's thread, the optimizer; ``extra_counts``
    further ``bench.count`` spans on the autograd thread, so that it
    holds more spans than the step thread."""
    ev = [_span('bench.window', 0, 1000), _span('es.step', 10, 900),
          _span('es.fwd', 10, 300), _span('k2.fwd', 50, 100),
          _span('es.k2.fwd', 55, 95), _span('bench.count', 100, 110),
          _span('es.bwd', 300, 700), _span('es.optim', 700, 900),
          _span('k2.dgrad', 320, 340, AUTOGRAD),
          _span('es.k2.dgrad', 322, 338, AUTOGRAD),
          _span('bench.count', 340, 350, AUTOGRAD)]
    ev += [_span('bench.count', 600 + i, 600.5 + i, AUTOGRAD)
           for i in range(extra_counts)]
    ev += _kernel(1, 60, 60, 120)                  # es.k2.fwd: fwd
    ev += _kernel(2, 105, 120, 125)                # bench.count: none
    ev += _kernel(3, 200, 200, 260)                # es.fwd: fwd
    ev += _kernel(4, 325, 330, 400, AUTOGRAD)      # es.k2.dgrad: bwd
    ev += _kernel(5, 345, 400, 410, AUTOGRAD)      # bench.count: none
    ev += _kernel(6, 450, 450, 500, AUTOGRAD)      # no span open: bwd
    ev += _kernel(7, 710, 720, 800)                # es.optim: optim
    return read_trace(ev)


def _ctx(tr, steps=1):
    return dict(trace=tr, steps=steps)


def test_backward_and_count_rule():
    tr = _step_trace()
    owners = {d[2]: d[3] for d in tr['device']}
    assert owners['k4'] == 'es.k2.dgrad' and owners['k6'] is None
    ops = PS.device_phases(tr)
    assert [p for _, _, p in ops] == ['es.fwd', None, 'es.fwd', 'es.bwd',
                                      None, 'es.bwd', 'es.optim']
    ctx = _ctx(tr)
    ms = {p: PS.device_ms(ctx, p) for p in PS.PHASES}
    assert ms == pytest.approx({'es.fwd': 0.12, 'es.bwd': 0.12,
                                'es.optim': 0.08})
    count = sum(t1 - t0 for t0, t1, p in ops if p is None) * 1e-3
    total = sum(d[1] - d[0] for d in tr['device']) * 1e-3
    assert sum(ms.values()) + count == pytest.approx(total)
    assert spec.metric_reader('bwd_dev_ms.train')(ctx) == pytest.approx(0.12)
    assert spec.metric_reader('optim_dev_ms.train')(_ctx(tr, 2)) == \
        pytest.approx(0.04)


def test_idle_on_the_step_thread():
    tr = _step_trace()
    # the thread with the most spans is autograd's, where the harness's
    # breakdown looks; the gaps belong to the step thread's phases
    assert max(tr['host_spans'], key=lambda t: len(tr['host_spans'][t])) \
        == AUTOGRAD
    assert PS.step_thread(tr) == STEP
    gaps = PS.idle_us(tr)
    assert gaps == {None: 60, 'es.fwd': 75 + 70, 'es.bwd': 40 + 220,
                    'es.optim': 200}
    assert sum(gaps.values()) == 1000 - busy_us(tr)
    ctx = _ctx(tr)
    for name, want in (('fwd_idle_ms.train', 0.145),
                       ('bwd_idle_ms.train', 0.26),
                       ('optim_idle_ms.train', 0.2)):
        assert spec.metric_reader(name)(ctx) == pytest.approx(want), name


def test_name_under_two_phases_follows_device_order():
    ev = [_span('bench.window', 0, 1000), _span('es.step', 0, 900),
          _span('es.fwd', 0, 300), _span('x', 10, 20),
          _span('es.bwd', 300, 700), _span('es.optim', 700, 900),
          _span('x', 720, 730)]
    ev += _kernel(1, 15, 15, 50)                  # x: before a fwd op
    ev += _kernel(2, 100, 100, 120)               # es.fwd
    ev += _kernel(3, 710, 710, 715)               # es.optim
    ev += _kernel(4, 725, 725, 740)               # x: after an optim op
    phases = [p for _, _, p in PS.device_phases(read_trace(ev))]
    assert phases == ['es.fwd', 'es.fwd', 'es.optim', 'es.optim']


def test_serving_spans():
    ev = [_span('bench.window', 0, 1000), _span('es.to_device', 0, 40),
          _span('es.mink3d', 50, 250), _span('es.predict', 300, 900),
          _span('es.nms.iou', 310, 330), _span('es.nms.wait', 330, 600),
          _span('es.nms.sweep', 600, 880)]
    ev += _kernel(1, 315, 400, 560)
    ev += _kernel(2, 320, 560, 590)
    ctx = _ctx(read_trace(ev), steps=2)
    got = {n: spec.metric_reader(n)(ctx) for n in NEW if n.endswith('serve')}
    assert got == pytest.approx({
        'nms_iou_ms.serve': 0.095, 'nms_wait_ms.serve': 0.135,
        'nms_sweep_ms.serve': 0.14, 'mink3d_host_ms.serve': 0.1,
        'to_device_ms.serve': 0.02})


@pytest.mark.parametrize('name', NEW)
def test_none_without_the_program_spans(name):
    """The parent's traces: the benchmark's spans and kernels, no es.*."""
    ev = [_span('bench.window', 0, 1000), _span('mink3d', 10, 200),
          _span('predict', 300, 900), _span('k2.dgrad', 320, 340, AUTOGRAD)]
    ev += _kernel(1, 20, 20, 100) + _kernel(2, 325, 330, 400, AUTOGRAD)
    assert spec.metric_reader(name)(_ctx(read_trace(ev))) is None


@pytest.mark.parametrize('name', NEW[:5])
def test_none_without_device_operations(name):
    """A CPU run's trace: the step's spans, no kernel."""
    ev = [_span('bench.window', 0, 1000), _span('es.step', 0, 900),
          _span('es.fwd', 0, 300), _span('es.bwd', 300, 700),
          _span('es.optim', 700, 900)]
    assert spec.metric_reader(name)(_ctx(read_trace(ev))) is None
