"""The traced run's instrumentation and the reading of its trace.

Spans (``torch.profiler.record_function``) come from the benchmark's own
files, installed only in the traced run: around the submodules and methods
that the configuration file names under ``spans`` and ``methods``, and
around the port's sparse-conv entry points (``ops.sparse.
gather_matmul_conv``, ``conv_dgrad``, ``conv_wgrad``: spans ``k2.fwd``,
``k2.dgrad``, ``k3``). Each entry-point call also has its bytes and
operations counted (``counts.sparse``) from its arguments, in a span of its
own (``bench.count``) that no metric reads. The dense layers' operations
(matrix products and convolutions, forward and backward) are counted in a
step or request of their own by ``torch.utils.flop_counter``
(:func:`dense_flops`), outside the profiled stretch.

A kernel or copy belongs to every span open on its launching thread when it
was launched (the trace's correlation ids), but for the kernels of a
``bench.count`` span, which belong to it alone; a span's device ms is the
sum of its kernels' durations.
"""

import bisect
import collections
import json
import os
import tempfile

import torch
from torch import nn

from ..counts import sparse as CS

DEVICE_CATS = ('kernel', 'gpu_memcpy', 'gpu_memset')


class Spans:
    """Installs and removes the benchmark's spans and counters on a model
    and the port's sparse-conv module."""

    def __init__(self, model: nn.Module, conf: dict, training: bool):
        self.model, self.conf, self.training = model, conf, training
        self.handles, self.patched = [], []
        self.sparse_calls = []    # (span, bytes, flops tensor)
        self.counting = False

    def __enter__(self):
        mods = dict(self.model.named_modules())
        for span, paths in self.conf.get('spans', {}).items():
            for path in paths:
                self._wrap_module(span, mods[path])
        for span, path in self.conf.get('methods', {}).items():
            owner, _, meth = path.rpartition('.')
            self._wrap_method(span, mods[owner], meth)
        import embodiedscan_torch.ops.sparse as S
        for attr, span in (('gather_matmul_conv', 'k2.fwd'),
                           ('conv_dgrad', 'k2.dgrad'), ('conv_wgrad', 'k3')):
            self._wrap_entry(S, attr, span)
        return self

    def __exit__(self, *exc):
        for h in self.handles:
            h.remove()
        for owner, attr, orig in reversed(self.patched):
            if orig is None:
                delattr(owner, attr)
            else:
                setattr(owner, attr, orig)
        return False

    def _wrap_module(self, span, mod):
        state = {}

        def pre(m, args):
            rf = torch.profiler.record_function(span)
            rf.__enter__()
            state.setdefault('open', []).append(rf)

        def post(m, args, out):
            state['open'].pop().__exit__(None, None, None)

        self.handles.append(mod.register_forward_pre_hook(pre))
        self.handles.append(mod.register_forward_hook(post))

    def _wrap_method(self, span, owner, meth):
        orig = getattr(owner, meth)

        def wrapped(*a, **k):
            with torch.profiler.record_function(span):
                return orig(*a, **k)

        self.patched.append((owner, meth, owner.__dict__.get(meth)))
        setattr(owner, meth, wrapped)

    def _wrap_entry(self, S, attr, span):
        orig = getattr(S, attr)
        count = CS.wgrad if attr == 'conv_wgrad' else CS.conv
        calls = self.sparse_calls

        def wrapped(*a, **k):
            with torch.profiler.record_function(span):
                out = orig(*a, **k)
            with torch.profiler.record_function('bench.count'):
                nbytes, flops = count(attr, *a, **k)
            calls.append((span, nbytes, flops))
            return out

        wrapped.launches = orig.launches
        self.patched.append((S, attr, orig))
        setattr(S, attr, wrapped)

    def sparse_totals(self) -> dict:
        """{span: (bytes, flops, calls)} of the counted entry-point calls."""
        out = {}
        for span, nbytes, flops in self.calls_as_floats():
            b, f, n = out.get(span, (0.0, 0.0, 0))
            out[span] = (b + nbytes, f + flops, n + 1)
        return out

    def calls_as_floats(self):
        if not self.sparse_calls:
            return []
        flops = torch.stack([f for _, _, f in self.sparse_calls]).cpu()
        return [(s, b, float(f)) for (s, b, _), f in
                zip(self.sparse_calls, flops.tolist())]


def dense_flops(fn) -> float:
    """Operations of the matrix products and convolutions that ``fn`` runs
    through PyTorch's operators (forward and backward), by
    ``torch.utils.flop_counter.FlopCounterMode``; the port's sparse
    kernels, called outside those operators, are counted at their entry
    points instead."""
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as fc:
        fn()
    return float(fc.get_total_flops())


def profile(fn):
    """Runs ``fn`` under ``torch.profiler`` (CPU and CUDA activity) inside
    a ``bench.window`` span with the device synchronized at both ends;
    returns the parsed trace (:func:`read_trace`)."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as prof
    cuda = torch.cuda.is_available()
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with prof(activities=acts) as p:
        sync()
        with torch.profiler.record_function('bench.window'):
            fn()
            sync()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, 'trace.json')
        p.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)['traceEvents']
    return read_trace(events)


def read_trace(events: list) -> dict:
    """From chrome-trace events: the window (us), the device intervals with
    the innermost span that launched each, and per span name its host time
    and the device time of every kernel launched while it was open on the
    launching thread (a span holds the kernels of the spans nested in it;
    the kernels of ``bench.count`` spans count for no other span)."""
    spans, launches, device = [], {}, []
    for e in events:
        if e.get('ph') != 'X':
            continue
        cat = e.get('cat', '')
        if cat == 'user_annotation':
            spans.append((e['ts'], e['ts'] + e['dur'], e['name'],
                          e.get('tid')))
        elif cat in ('cuda_runtime', 'cuda_driver'):
            corr = e.get('args', {}).get('correlation')
            if corr is not None:
                launches[corr] = (e['ts'], e.get('tid'))
        elif cat in DEVICE_CATS:
            device.append((e['ts'], e['ts'] + e['dur'], e['name'],
                           e.get('args', {}).get('correlation')))
    win = [s for s in spans if s[2] == 'bench.window']
    if not win:
        raise RuntimeError('the trace holds no bench.window span')
    w0, w1 = win[0][0], win[0][1]
    host = collections.defaultdict(list)
    span_host = collections.Counter()
    for s in spans:
        if s[2] != 'bench.window':
            host[s[3]].append(s)
            if w0 <= s[0] <= w1:
                span_host[s[2]] += s[1] - s[0]
    for ss in host.values():
        ss.sort(key=lambda s: (s[0], -s[1]))
    # the chain of open spans at each launch, by a sweep per thread
    by_tid = collections.defaultdict(list)
    for i, (t0, t1, name, corr) in enumerate(device):
        if t1 >= w0 and t0 <= w1 and corr in launches:
            ts, tid = launches[corr]
            by_tid[tid].append((ts, i))
    chains = {}
    for tid, evs in by_tid.items():
        evs.sort()
        ss, j, stack = host.get(tid, []), 0, []
        for ts, i in evs:
            while j < len(ss) and ss[j][0] <= ts:
                while stack and stack[-1][1] < ss[j][0]:
                    stack.pop()
                stack.append(ss[j])
                j += 1
            while stack and stack[-1][1] < ts:
                stack.pop()
            chains[i] = [s[2] for s in stack if s[0] <= ts <= s[1]]
    span_dev = collections.Counter()
    owned = []
    for i, (t0, t1, name, corr) in enumerate(device):
        if t1 < w0 or t0 > w1:
            continue
        chain = chains.get(i, [])
        if 'bench.count' in chain:
            chain = ['bench.count']
        for span in set(chain):
            span_dev[span] += t1 - t0
        owned.append((t0, t1, name, chain[-1] if chain else None))
    return dict(window_us=w1 - w0, w0=w0, w1=w1, device=owned,
                span_device_us=dict(span_dev), span_host_us=dict(span_host),
                host_spans=dict(host))


def busy_us(tr: dict) -> float:
    """Union of the device intervals inside the window."""
    ivs = sorted((max(a, tr['w0']), min(b, tr['w1']))
                 for a, b, _, _ in tr['device'])
    total, end = 0.0, -float('inf')
    start = None
    for a, b in ivs:
        if a > end:
            if start is not None:
                total += end - start
            start, end = a, b
        else:
            end = max(end, b)
    if start is not None:
        total += end - start
    return total


def breakdown(tr: dict, top: int = 10) -> dict:
    """The device operations that took most time, and the idle gaps of the
    device summed by the innermost benchmark span open on the host's main
    thread when each gap began."""
    ops = collections.Counter()
    for a, b, name, _ in tr['device']:
        ops[name[:120]] += (b - a) * 1e-6
    ivs = sorted((max(a, tr['w0']), min(b, tr['w1']))
                 for a, b, _, _ in tr['device'])
    gaps = collections.Counter()
    main = max(tr['host_spans'], key=lambda t: len(tr['host_spans'][t]),
               default=None)
    starts = [s[0] for s in tr['host_spans'].get(main, [])]
    end = tr['w0']
    for a, b in ivs + [(tr['w1'], tr['w1'])]:
        if a > end:
            name = 'outside spans'
            i = bisect.bisect_right(starts, end)
            for s in reversed(tr['host_spans'].get(main, [])[:i]):
                if s[1] >= end:
                    name = s[2]
                    break
            gaps[name] += (a - end) * 1e-6
        end = max(end, b)
    return dict(device_ops=[[k, v] for k, v in ops.most_common(top)],
                idle_gaps=[[k, v] for k, v in gaps.most_common(top)])
