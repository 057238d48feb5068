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
    'embodiedscan_torch.tools.convert_checkpoint'])
def test_module_is_checked_and_imports(module):
    """The training, grounding and checkpoint slices' modules are among
    the files checked above and import on a machine without JAX,
    transformers, tokenizers or regex."""
    path = ROOT / (module.replace('.', '/') + '.py')
    assert path in FILES
    code = (f'import sys; sys.modules.update(dict.fromkeys({FORBIDDEN!r}));'
            f' import {module}')
    subprocess.run([sys.executable, '-c', code], cwd=ROOT, check=True)
