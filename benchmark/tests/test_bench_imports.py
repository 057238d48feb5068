"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the program."""

import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

HARNESS = '''
import sys
sys.path.insert(0, %r)
from benchmark import run
from benchmark.harness import cells, check, program, readers, spec, trace
from benchmark.harness import weights
import embodiedscan_torch.configs.base, embodiedscan_torch.train.state
import embodiedscan_torch.data.loader, embodiedscan_torch.ops.sparse
for m in spec.benchmark()['per_layer']:
    spec.metric_reader(m['name'])
for path in sorted((spec.BENCH_DIR / 'tasks').glob('*.py')):
    spec.task(path.stem)
for path in sorted((spec.BENCH_DIR / 'traffic' / 'scenes').glob('*.py')):
    spec.load_file('scene', path)
print(','.join(run.forbidden_modules()))
'''

REFERENCE = '''
import sys
sys.path.insert(0, %r)
from benchmark.reference import build
from benchmark.reference.models import detector, occupancy
from benchmark.reference.geometry import nms
tops = {m.split('.')[0] for m in sys.modules}
print(','.join(sorted(tops & {'embodiedscan_torch', 'embodiedscan_tpu',
                              'jax', 'jaxlib', 'flax'})))
'''


def _run(code):
    out = subprocess.run([sys.executable, '-c', code % str(REPO)],
                         capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[-1] if out.stdout.strip() else ''


def test_harness_loads_no_jax():
    assert _run(HARNESS) == ''


def test_reference_loads_nothing_of_the_program():
    assert _run(REFERENCE) == ''


def test_forbidden_names_compared_whole():
    import types
    from benchmark import run
    fakes = ('jaxfoo', 'embodiedscan_tpu_like', 'flax.core')
    for name in fakes:
        sys.modules[name] = types.ModuleType(name)
    try:
        found = run.forbidden_modules()
        assert 'flax' in found
        assert 'jaxfoo' not in found and 'embodiedscan_tpu_like' not in found
    finally:
        for name in fakes:
            del sys.modules[name]
