import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


@pytest.fixture
def card():
    """The CUDA device, or a skip where this machine has none."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the benchmark measures only there')
    return 'cuda'


@pytest.fixture(scope='session')
def tiny(tmp_path_factory):
    from benchmark.tests.tiny import tiny_root
    return tiny_root(tmp_path_factory.mktemp('bench'))
