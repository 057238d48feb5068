"""A configuration, a cell, a traffic mix and a per-layer metric added as
new files and entries alone, found and run by the harness with no edit to
its code."""

import contextlib
import io
import json
import shutil

from benchmark import run
from benchmark.harness import spec

METRIC = '''"""Sparse-conv entry-point calls per step."""


def read(ctx):
    calls = ctx['spans'].calls_as_floats()
    return len(calls) / ctx['steps'] if calls else None
'''


def test_new_files_only(tiny, tmp_path):
    root = tmp_path / 'copy'
    shutil.copytree(tiny, root)
    b = root / 'benchmark'
    conf = json.loads((b / 'configs' / 'mv_det3d.json').read_text())
    conf['name'] = 'mv_det3d_small'
    conf['model']['num_classes'] = 3
    (b / 'configs' / 'mv_det3d_small.json').write_text(json.dumps(conf))
    traffic = json.loads((b / 'traffic' / 'det_train_b4_v20.json')
                         .read_text())
    traffic.update(batch=1, views=1)
    (b / 'traffic' / 'det_train_b1_v1.json').write_text(json.dumps(traffic))
    work = json.loads((b / 'workloads' / 'mv_det3d.train.b4.json')
                      .read_text())
    (b / 'workloads' / 'mv_det3d_small.train.b1.json').write_text(
        json.dumps(work))
    (b / 'metrics' / 'k2_calls.train.py').write_text(METRIC)
    bench = json.loads((root / 'BENCHMARK.json').read_text())
    bench['configs'].append(dict(
        name='mv_det3d_small', source='https://example.org/a-config',
        file='benchmark/configs/mv_det3d_small.json', reduced=[],
        why='a test'))
    bench['workloads'].append(dict(
        name='mv_det3d_small.train.b1', config='mv_det3d_small',
        traffic='det_train_b1_v1', chips=1, why='a test'))
    for m in bench['end_to_end'] + bench['per_layer']:
        if 'mv_det3d.train.b4' in m.get('workloads', []):
            m['workloads'].append('mv_det3d_small.train.b1')
    bench['per_layer'].append(dict(
        name='k2_calls.train', unit='calls', better='lower',
        source='program_counter', layer='kernels: K2 (csrc/sparse_conv.cu)',
        moves='train_scenes_per_s', workloads=['mv_det3d_small.train.b1']))
    (root / 'BENCHMARK.json').write_text(json.dumps(bench))

    cell = spec.cell('mv_det3d_small.train.b1', spec.benchmark(root), b)
    assert cell['conf']['model']['num_classes'] == 3
    assert cell['traffic']['batch'] == 1
    assert 'k2_calls.train' in {m['name'] for m in cell['per_layer']}
    with contextlib.redirect_stdout(io.StringIO()):
        out = run.main(['--workload', 'mv_det3d_small.train.b1', '--seed',
                        '9', '--seconds', '1', '--trace', '1'],
                       device='cpu', root=root)
    assert out['correct'], out['check']
    assert out['metrics']['k2_calls.train']['value'] > 0
