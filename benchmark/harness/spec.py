"""Finds the benchmark's parts by name: ``BENCHMARK.json`` at the root of
the checkout, ``configs/<config>.json``, ``workloads/<cell>.json``,
``traffic/<traffic>.json`` and one reader per per-layer metric,
``metrics/<metric>.py``. A later change adds a configuration, a cell, a
traffic mix or a metric by adding such files and entries, never code here.
"""

import hashlib
import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return read_json(root / 'BENCHMARK.json')


def config(name: str, bench_dir: Path = BENCH_DIR) -> dict:
    return read_json(bench_dir / 'configs' / f'{name}.json')


def workload(name: str, bench_dir: Path = BENCH_DIR) -> dict:
    return read_json(bench_dir / 'workloads' / f'{name}.json')


def traffic(name: str, bench_dir: Path = BENCH_DIR) -> dict:
    return read_json(bench_dir / 'traffic' / f'{name}.json')


def metric_reader(name: str, bench_dir: Path = BENCH_DIR):
    """The ``read(ctx)`` function of ``metrics/<name>.py``."""
    path = bench_dir / 'metrics' / f'{name}.py'
    spec = importlib.util.spec_from_file_location(
        'benchmark_metric_' + name.replace('.', '_').replace('-', '_'), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell(name: str, bench: dict, bench_dir: Path = BENCH_DIR) -> dict:
    """Everything one run of the cell ``name`` needs: its entry in
    ``BENCHMARK.json``, its workload file, its configuration and traffic
    files, and the names of the end-to-end and per-layer metrics it
    reports."""
    entry = next((w for w in bench['workloads'] if w['name'] == name), None)
    if entry is None:
        raise KeyError(f'no workload {name!r} in BENCHMARK.json')
    conf_entry = next(c for c in bench['configs']
                      if c['name'] == entry['config'])

    def reported(metrics):
        return [m for m in metrics
                if name in m.get('workloads', [name])]

    return dict(
        name=name, entry=entry, chips=entry['chips'],
        work=workload(name, bench_dir),
        conf=read_json(bench_dir.parent / conf_entry['file']),
        traffic=traffic(entry['traffic'], bench_dir),
        end_to_end=reported(bench['end_to_end']),
        per_layer=reported(bench['per_layer']),
    )


def sub_seed(seed: int, *tags) -> int:
    """A 63-bit seed for one stream (weights, one scene, the sample)
    derived from the run's ``--seed``: the same seed and tags give the
    same stream on every run."""
    text = ':'.join(str(t) for t in (seed, ) + tags)
    return int.from_bytes(hashlib.sha256(text.encode()).digest()[:8],
                          'little') >> 1
