"""Finds the benchmark's parts by name: ``BENCHMARK.json`` at the root of
the checkout, ``configs/<config>.json``, ``workloads/<cell>.json``,
``traffic/<traffic>.json``, one reader per per-layer metric,
``metrics/<metric>.py``, one file per task, ``tasks/<task>.py`` (the
configuration's ``model.task``), and one per scene kind,
``traffic/scenes/<scene>.py`` (read by ``traffic/generate.py``). A later
change adds a configuration, a cell, a traffic mix, a metric, a task or a
scene kind by adding such files and entries, never code here.
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


def load_file(kind: str, path: Path):
    """The module of the Python file ``path``, loaded by path (so that a
    checkout other than this one can bring its own); fails naming the file
    where there is none."""
    if not path.is_file():
        raise FileNotFoundError(f'no {kind} file {path}')
    name = f'benchmark_{kind}_' + path.stem.replace('.', '_').replace('-', '_')
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, bench_dir: Path = BENCH_DIR):
    """The ``read(ctx)`` function of ``metrics/<name>.py``."""
    return load_file('metric', bench_dir / 'metrics' / f'{name}.py').read


def task(name: str, bench_dir: Path = BENCH_DIR):
    """The module ``tasks/<name>.py``: all that the harness does
    differently for one task. It defines

    - ``build(model, serve=False)``: the plain reference's model of a
      configuration's ``model`` section, on the current default device,
      with its constructed weights; ``serve``: as the serving check runs it;
    - ``trained(name)``: whether the parameter ``name`` is trained;
    - ``predict(model, batch)``: the reference's served outputs of a batch;
    - ``compare_serve(outs, logits, refs, work, device)``: {number: (value,
      where)} of a serving cell: ``outs`` [(scene, the program's outputs)]
      of every request, ``logits`` [(request, scene, per-scale logits)] of
      the sampled requests (``_Logits`` in ``cells.py``), ``refs`` scene ->
      :func:`predict`'s outputs, ``work`` the cell's file;

    and where it needs them

    - ``weight_rules(ref)``: {parameter: ('normal', std) or ('const',
      fill)} over the generic rule of ``weights.py``, for the model that
      ``build`` made (on the meta device);
    - ``watch_train(model)``: a context manager, entered around the checked
      training steps of the program and of the reference, that yields a dict
      it fills; and ``compare_train(prog, ref)``: {number: (value, where)}
      from the two dicts, beside the generic training numbers."""
    return load_file('task', bench_dir / 'tasks' / f'{name}.py')


def cell(name: str, bench: dict, bench_dir: Path = BENCH_DIR) -> dict:
    """Everything one run of the cell ``name`` needs: its entry in
    ``BENCHMARK.json``, its workload file, its configuration and traffic
    files, its configuration's task file, the folder they were read from,
    and the names of the end-to-end and per-layer metrics it reports."""
    entry = next((w for w in bench['workloads'] if w['name'] == name), None)
    if entry is None:
        raise KeyError(f'no workload {name!r} in BENCHMARK.json')
    conf_entry = next(c for c in bench['configs']
                      if c['name'] == entry['config'])

    def reported(metrics):
        return [m for m in metrics
                if name in m.get('workloads', [name])]

    conf = read_json(bench_dir.parent / conf_entry['file'])
    return dict(
        name=name, entry=entry, chips=entry['chips'],
        work=workload(name, bench_dir), conf=conf,
        task=task(conf['model']['task'], bench_dir), bench_dir=bench_dir,
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
