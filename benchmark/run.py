"""Runs one cell of the benchmark once and prints its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

``--trace 0`` measures the cell's end-to-end metrics over a window of
``--seconds``; ``--trace 1`` profiles a short steady stretch and reports
its per-layer metrics. Either run then compares what the timed path
produced with the plain reference and prints each number beside its limit.
The last line of standard output is the result as JSON. Runs only on a
machine with enough CUDA devices for the cell.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = ('jax', 'jaxlib', 'flax', 'embodiedscan_tpu')
GIB = 2.0 ** 30


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``."""
    return sorted({m.split('.')[0] for m in list(sys.modules)} &
                  set(FORBIDDEN))


def fail(msg: str, code: int = 2):
    print(f'benchmark: {msg}', file=sys.stderr, flush=True)
    sys.exit(code)


def main(argv=None, device=None, faults=None, control=False,
         root=None) -> dict:
    """One run; returns the result (also printed). ``device``, ``faults``
    and ``control`` are for the benchmark's own tests and calibration: a
    device other than the card skips the look for one; ``faults``
    replaces the timed call (``train_step`` or ``request``); ``control``
    runs the program in the lower-precision control; ``root``: a checkout
    other than this one whose ``BENCHMARK.json`` and ``benchmark/`` data
    files to read."""
    ap = argparse.ArgumentParser()
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    os.environ.setdefault('USE_FLAX', '0')
    os.environ.setdefault('USE_JAX', '0')
    import torch
    from benchmark.harness import cells, check, spec
    root = Path(root) if root else ROOT
    bench_dir = root / 'benchmark'
    bench = spec.benchmark(root)
    cell = spec.cell(args.workload, bench, bench_dir)
    if device is None:
        if not torch.cuda.is_available():
            fail('no CUDA device: the benchmark runs only on the card')
        if torch.cuda.device_count() < cell['chips']:
            fail(f'{cell["chips"]} CUDA devices needed, '
                 f'{torch.cuda.device_count()} present')
        device = 'cuda'
    mode = cell['work']['mode']
    runner = cells.run_train if mode == 'train' else cells.run_serve
    res = runner(cell, args.seed, args.seconds, bool(args.trace), device,
                 T_START, control=control, faults=faults)
    metrics = {}
    if args.trace:
        ctx = res['ctx']
        for m in cell['per_layer']:
            val = spec.metric_reader(m['name'], bench_dir)(ctx)
            if val is not None:
                metrics[m['name']] = dict(value=val, unit=m['unit'])
    else:
        res['metrics']['peak_gib'] = res['peak'] / GIB
        res['metrics']['setup_s'] = res['setup_s']
        for m in cell['end_to_end']:
            if m['name'] not in res['metrics']:
                fail(f'the run did not measure {m["name"]}', 3)
            metrics[m['name']] = dict(value=res['metrics'][m['name']],
                                      unit=m['unit'])
    limits = cell['work']['limits']
    correct, lines = check.verdict(res['numbers'], limits)
    for line in lines:
        print('check: ' + line, file=sys.stderr, flush=True)
    loaded = forbidden_modules()
    if loaded:
        fail('modules of JAX or of the JAX package were loaded: ' +
             ', '.join(loaded), 4)
    dev = dict(platform='gpu' if device == 'cuda' else str(device),
               kind=torch.cuda.get_device_name() if device == 'cuda'
               else str(device),
               count=cell['chips'], memory_peak_bytes=res['peak'])
    if args.trace:
        dev.update(busy_s=res['busy_s'], window_s=res['window_s'])
    out = dict(correct=bool(correct), attempted=int(res['attempted']),
               failed=int(res['failed']), metrics=metrics, device=dev)
    if args.trace:
        out['breakdown'] = res['breakdown']
    out['check'] = {name: dict(value=(v if math.isfinite(v) else str(v)),
                               limit=limits[name])
                    for name, (v, _) in res['numbers'].items()}
    print(json.dumps(out), flush=True)
    return out


if __name__ == '__main__':
    main()
