"""The port imports no JAX stack and nothing of the reference package."""

import ast
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'transformers',
             'tokenizers', 'regex', 'embodiedscan_tpu')
FILES = sorted((ROOT / 'embodiedscan_torch').rglob('*.py')) + \
    [ROOT / 'chip_smoke.py', ROOT / 'kernel_ab.py']


def _imported(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize('path', FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_reference_imports(path):
    bad = [m for m in _imported(path) if m.split('.')[0] in FORBIDDEN]
    assert not bad, f'{path.name} imports {bad}'


@pytest.mark.parametrize('module', [
    'embodiedscan_torch.train.state', 'embodiedscan_torch.models.losses',
    'embodiedscan_torch.models.detector', 'embodiedscan_torch.ops.sparse',
    'embodiedscan_torch.models.text', 'embodiedscan_torch.models.attention',
    'embodiedscan_torch.models.grounding',
    'embodiedscan_torch.models.match_costs',
    'embodiedscan_torch.ops.hungarian',
    'embodiedscan_torch.eval.indoor_eval',
    'embodiedscan_torch.eval.grounding_metric',
    'embodiedscan_torch.train.loop', 'embodiedscan_torch.train.checkpoint',
    'embodiedscan_torch.utils.convert_weights',
    'embodiedscan_torch.tools.convert_checkpoint',
    'embodiedscan_torch.models.occupancy', 'embodiedscan_torch.models.fpn',
    'embodiedscan_torch.models.anchors',
    'embodiedscan_torch.eval.occupancy_metric',
    'embodiedscan_torch.configs.base',
    'embodiedscan_torch.geometry.np_boxes',
    'embodiedscan_torch.native',
    'embodiedscan_torch.data.pipeline', 'embodiedscan_torch.data.synthetic',
    'embodiedscan_torch.data.loader', 'embodiedscan_torch.data.dataset',
    'embodiedscan_torch.train.metrics_writer',
    'embodiedscan_torch.parallel.multihost',
    'embodiedscan_torch.parallel.mesh',
    'embodiedscan_torch.vis.visualization',
    'embodiedscan_torch.tools.train', 'embodiedscan_torch.tools.test',
    'embodiedscan_torch.tools.eval_script',
    'embodiedscan_torch.tools.submit_results',
    'embodiedscan_torch.explorer', 'embodiedscan_torch.converters',
    'embodiedscan_torch.vis.html_viewer', 'embodiedscan_torch.vis.continuous',
    'embodiedscan_torch.geometry.modes',
    'embodiedscan_torch.geometry.points_ops',
    'embodiedscan_torch.eval.indoor_eval2d',
    'embodiedscan_torch.tools.demo'])
def test_module_is_checked_and_imports(module):
    """The training, grounding, checkpoint, occupancy, data, runtime, demo,
    viewer, converter and frame-conversion modules are among the files
    checked above and import on a machine without JAX, transformers,
    tokenizers or regex."""
    path = ROOT / (module.replace('.', '/') + '.py')
    if not path.exists():  # a package
        path = ROOT / module.replace('.', '/') / '__init__.py'

    assert path in FILES
    code = (f'import sys; sys.modules.update(dict.fromkeys({FORBIDDEN!r}));'
            f' import {module}')
    subprocess.run([sys.executable, '-c', code], cwd=ROOT, check=True)
