"""A configuration, a cell, a traffic mix, a per-layer metric, a task and a
scene kind added as new files and entries alone, found and run by the
harness with no edit to its code."""

import contextlib
import io
import json
import shutil

import pytest

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


def _run(root, cell, trace=0):
    with contextlib.redirect_stdout(io.StringIO()):
        return run.main(['--workload', cell, '--seed', '2147483711',
                         '--seconds', '1', '--trace', str(trace)],
                        device='cpu', root=root)


@pytest.mark.parametrize('path', ['tasks/mv_occ.py',
                                  'traffic/scenes/occ_room.py'])
def test_task_and_scene_found_by_file(tiny, tmp_path, path):
    """A cell whose task or scene kind has no file fails naming the file;
    with the file written back, the cell runs correct."""
    root = tmp_path / 'copy'
    shutil.copytree(tiny, root)
    f = root / 'benchmark' / path
    text = f.read_text()
    f.unlink()
    with pytest.raises(FileNotFoundError, match=path):
        _run(root, 'mv_occ.serve.v20')
    f.write_text(text)
    out = _run(root, 'mv_occ.serve.v20')
    assert out['correct'], out['check']


def test_new_scene_kind(tiny, tmp_path):
    """A scene kind added as a new file, with a traffic file and a cell
    that use it, and nothing else."""
    root = tmp_path / 'copy'
    shutil.copytree(tiny, root)
    b = root / 'benchmark'
    shutil.copy(b / 'traffic' / 'scenes' / 'det_room.py',
                b / 'traffic' / 'scenes' / 'det_room_copy.py')
    traffic = json.loads((b / 'traffic' / 'det_serve_v50.json').read_text())
    traffic['scene'] = 'det_room_copy'
    (b / 'traffic' / 'det_serve_copy.json').write_text(json.dumps(traffic))
    shutil.copy(b / 'workloads' / 'mv_det3d.serve.v50.json',
                b / 'workloads' / 'mv_det3d.serve.copy.json')
    bench = json.loads((root / 'BENCHMARK.json').read_text())
    bench['workloads'].append(dict(
        name='mv_det3d.serve.copy', config='mv_det3d',
        traffic='det_serve_copy', chips=1, why='a test'))
    for m in bench['end_to_end'] + bench['per_layer']:
        if 'mv_det3d.serve.v50' in m.get('workloads', []):
            m['workloads'].append('mv_det3d.serve.copy')
    (root / 'BENCHMARK.json').write_text(json.dumps(bench))
    out = _run(root, 'mv_det3d.serve.copy')
    assert out['correct'], out['check']
    assert 'latency_p90_ms' in out['metrics']


WATCH = '''

import contextlib


@contextlib.contextmanager
def watch_train(model):
    calls = dict(head=0)

    def count(mod, args, out):
        calls['head'] += 1

    handle = model.bbox_head.register_forward_hook(count)
    try:
        yield calls
    finally:
        handle.remove()


def compare_train(prog, ref):
    return dict(head_calls=(abs(prog['head'] - ref['head']),
                            f"{prog['head']} / {ref['head']}"))
'''


def test_task_adds_training_numbers(tiny, tmp_path):
    """A task file's ``watch_train`` and ``compare_train`` add a number to
    the training comparison, checked against the cell's limit for it."""
    root = tmp_path / 'copy'
    shutil.copytree(tiny, root)
    b = root / 'benchmark'
    with open(b / 'tasks' / 'mv_det3d.py', 'a') as f:
        f.write(WATCH)
    path = b / 'workloads' / 'mv_det3d.train.b4.json'
    work = json.loads(path.read_text())
    work['limits']['head_calls'] = 0
    path.write_text(json.dumps(work))
    out = _run(root, 'mv_det3d.train.b4')
    assert out['correct'], out['check']
    assert out['check']['head_calls']['value'] == 0
    assert list(out['check'])[:3] == ['loss_gap', 'grad_gap', 'update_gap']
