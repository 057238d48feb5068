"""The grounding cell (``mv_grounding.serve.v50``) at a small size on the
CPU: the program against the plain reference grounder, the faults its
comparison has to catch, the lower-precision control, its prompts, and
its files loading without the program."""

import contextlib
import io
import subprocess
import sys

import pytest
import torch

from benchmark import run
from benchmark.harness import spec
from benchmark.tests.tiny import REPO
from benchmark.traffic import generate as G

CELL = 'mv_grounding.serve.v50'


def _run(root, trace=0, **kw):
    with contextlib.redirect_stdout(io.StringIO()):
        return run.main(['--workload', CELL, '--seed', '3000000019',
                         '--seconds', '1', '--trace', str(trace)],
                        device='cpu', root=root, **kw)


@pytest.mark.parametrize('trace', [0, 1])
def test_cell_matches_reference(tiny, trace):
    out = _run(tiny, trace)
    assert out['correct'], out['check']
    assert set(out['check']) == {'query_diff', 'score_gap', 'box_gap',
                                 'logit_gap'}
    if trace:
        assert 'ground_host_ms.serve' in out['metrics']
    else:
        assert {'latency_p50_ms', 'latency_p90_ms', 'setup_s'} <= \
            set(out['metrics'])


def _altered_score(model, batch_np, device):
    """The best query's score off by 1%."""
    from benchmark.harness.program import request
    out = request(model, batch_np, device)
    out['scores'] = out['scores'].clone()
    out['scores'][0, 0] *= 1.01
    return out


def _swapped_query(model, batch_np, device):
    """The last query's neck row swapped for the first row the selection
    left out, the served answer unchanged."""
    from benchmark.harness.program import request
    out = request(model, batch_np, device)
    index = out['query_index'].clone()
    chosen = set(index[0].tolist())
    index[0, -1] = next(r for r in range(index.shape[1] + 1)
                        if r not in chosen)
    out['query_index'] = index
    return out


@pytest.mark.parametrize('fault', [_altered_score, _swapped_query])
def test_faults_are_caught(tiny, fault):
    out = _run(tiny, faults=dict(request=fault))
    assert not out['correct'], out['check']


def test_control_fails(tiny):
    """The bf16 sparse-conv route (TF32 acts only on the card) moves the
    neck's features, and with them every logit, past the limits."""
    out = _run(tiny, control=True)
    assert not out['correct'], out['check']


def test_prompts():
    conf = spec.config('mv_grounding')
    t = dict(spec.traffic('ground_serve_v50'), points=500, views=1,
             image_hw=32)
    lengths = set()
    for i in range(24):
        s = G.scene(t, conf, 2**31 + 99, i, 'cpu')
        ids, mask = s['text_ids'], s['text_mask']
        n = int(mask.sum())
        lengths.add(n)
        assert ids.shape == mask.shape == (256, )
        assert bool(mask[:n].all()) and not mask[n:].any()
        assert (int(ids[0]), int(ids[n - 1])) == (0, 2)
        assert bool((ids[n:] == 1).all())
        assert 3 <= int(ids[1:n - 1].min()) and int(ids.max()) < 50265
        assert s['points'].shape == (500, 3)
    assert min(lengths) >= 12 and max(lengths) <= 48 and len(lengths) > 8
    again = G.scene(t, conf, 2**31 + 99, 23, 'cpu')
    assert torch.equal(again['text_ids'], s['text_ids'])


LOADS = '''
import sys
sys.path.insert(0, %r)
from benchmark.harness import spec
spec.task('mv_grounding')
spec.load_file('scene', spec.BENCH_DIR / 'traffic' / 'scenes' /
               'ground_room.py')
from benchmark.reference.models import grounding, text, attention
tops = {m.split('.')[0] for m in sys.modules}
print(','.join(sorted(tops & {'embodiedscan_torch', 'embodiedscan_tpu',
                              'jax', 'jaxlib', 'flax'})))
'''


def test_task_scene_and_reference_load_without_the_program():
    out = subprocess.run([sys.executable, '-c', LOADS % str(REPO)],
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == ''
