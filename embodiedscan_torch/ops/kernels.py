"""Build and bind the package's hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into an object file, all
sources at once in parallel processes, and the objects are linked into ONE
shared library with a plain C interface, loaded with ``ctypes``. The build
runs at first use, into ``embodiedscan_torch/_build/`` (git-ignored), under a
name keyed by the sha256 of the sources and flags, so a stale library is
never loaded. Nothing here runs at import time: the CPU tests import every
module of the package on machines without ``nvcc``.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / 'csrc'
BUILD_DIR = _PKG / '_build'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-Xcompiler', '-fPIC', '-Xptxas', '-v')

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
_CONV_SIMT = [_P, _P, _L, _I, _P, _L, _I, _P, _I, _P, _P, _P]
_CONV_TC = [_P, _P, _L, _I, _P, _L, _I, _P, _I, _P, _P, _I, _I, _I, _P, _P]
_CONV_WGMMA = [_P, _P, _L, _I, _P, _L, _I, _P, _I, _I, _P, _P, _I, _I, _I, _I,
               _P, _P, _P]
_WGRAD = [_I, _P, _P, _L, _I, _P, _I, _P, _P, _L, _I, _I, _I, _I, _P, _P, _P,
          _P, _P]
# C entry points: name -> argtypes (every one returns a cudaError_t as int);
# the _bf16 ones are the bfloat16 variants of K2 and K3; es_nms_overlap is
# K4, the rotated NMS's suppression matrix
_SIGNATURES = {
    'es_join_scan_tile': [],
    'es_join_scan': [_P, _P, _L, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P],
    'es_sparse_conv_simt': _CONV_SIMT,
    'es_sparse_conv_tc': _CONV_TC,
    'es_sparse_conv_simt_bf16': _CONV_SIMT,
    'es_sparse_conv_wgmma_bf16': _CONV_WGMMA,
    'es_sparse_wgrad': _WGRAD,
    'es_sparse_wgrad_bf16': _WGRAD,
    'es_nms_overlap': [_P, _P, _I, ctypes.c_float, _P, _P, _P],
}

# seconds the last build took (0.0 when a cached library was loaded)
build_seconds = 0.0
build_log = ''


def _nvcc() -> str:
    for cand in (os.environ.get('CUDA_HOME', ''), '/usr/local/cuda'):
        path = os.path.join(cand, 'bin', 'nvcc') if cand else ''
        if path and os.path.exists(path):
            return path
    found = shutil.which('nvcc')
    if found is None:
        raise RuntimeError('nvcc not found: the CUDA kernels of '
                           'embodiedscan_torch are built on a CUDA machine')
    return found


def _sources():
    return sorted(CSRC.glob('*.cu'))


def _digest(sources) -> str:
    h = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for src in sources + sorted(CSRC.glob('*.cuh')):  # headers count too
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _build(sources, target: Path) -> str:
    """Compile every source in parallel, link into ``target``; return log."""
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    log = []
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in sources:
            obj = Path(tmp) / (src.stem + '.o')
            objs.append(obj)
            procs.append((src, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, '-c', str(src), '-o', str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for src, proc in procs:
            out, _ = proc.communicate()
            log.append(f'== {src.name}\n{out}')
            if proc.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError(f'nvcc failed for {failed}:\n' + '\n'.join(log))
        tmp_so = Path(tmp) / target.name
        res = subprocess.run(
            [nvcc, *NVCC_FLAGS[:2], '-shared', *map(str, objs), '-o',
             str(tmp_so)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
        log.append(f'== link\n{res.stdout}')
        if res.returncode != 0:
            raise RuntimeError('nvcc link failed:\n' + '\n'.join(log))
        os.replace(tmp_so, target)  # atomic: readers never see a partial .so
    return '\n'.join(log)


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built from ``csrc/`` on first use."""
    global build_seconds, build_log
    sources = _sources()
    target = BUILD_DIR / f'libembodiedscan_kernels_{_digest(sources)}.so'
    if not target.exists():
        t0 = time.perf_counter()
        build_log = _build(sources, target)
        build_seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(str(target))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(err: int, name: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f'{name}: CUDA error {err}')


def stream_handle(device) -> int:
    """The raw handle of PyTorch's current stream on ``device`` (a CUDA
    device with an index, as a CUDA tensor's ``.device`` is). This is the
    binding ``torch.cuda.current_stream(device).cuda_stream`` ends in,
    without building a Stream object on every launch."""
    return torch._C._cuda_getCurrentRawStream(device.index)
