"""Readings that the limits of a cell's correctness numbers are set from:
the program's own runs on a dozen seeds or more (the lower readings) and
its lower-precision control on three or more (the upper readings), in one
process, each a run of the cell with a short window.

    python3 benchmark/calibrate.py --workload <cell> --seconds <s> \
        --seeds 1,2,... --control-seeds 7,8,9 [--out FILE]

The control is the port's own bf16 sparse-conv route with TF32 on
(``harness.program.set_control``). Prints one JSON line per run and a
summary: each number's largest sound reading and least control reading.
"""

import argparse
import contextlib
import io
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seconds', type=float, default=3)
    ap.add_argument('--seeds', default='')
    ap.add_argument('--control-seeds', default='')
    ap.add_argument('--trace', type=int, default=0)
    ap.add_argument('--fault', default='',
                    help='a fault of the CPU tests (test_bench_cells.py, '
                         'without its underscore) in place of the timed call')
    ap.add_argument('--out', default='')
    args = ap.parse_args(argv)
    from benchmark import run
    faults = None
    if args.fault:
        from benchmark.tests import test_bench_cells as tc
        fn = getattr(tc, '_' + args.fault)
        faults = dict(train_step=fn, request=fn)
    rows = []
    for control, seeds in ((False, args.seeds), (True, args.control_seeds)):
        for seed in [int(s) for s in seeds.split(',') if s]:
            buf = io.StringIO()
            try:
                with contextlib.redirect_stdout(buf):
                    out = run.main(['--workload', args.workload, '--seed',
                                    str(seed), '--seconds', str(args.seconds),
                                    '--trace', str(args.trace)],
                                   control=control, faults=faults)
                row = dict(seed=seed, control=control,
                           check={k: v['value']
                                  for k, v in out['check'].items()},
                           metrics={k: v['value']
                                    for k, v in out['metrics'].items()})
            except Exception as exc:  # a control that crashes has failed
                row = dict(seed=seed, control=control, error=repr(exc))
            rows.append(row)
            print(json.dumps(row), flush=True)
    summary = {}
    for row in rows:
        for k, v in row.get('check', {}).items():
            s = summary.setdefault(k, dict(lower=None, upper=None))
            v = float(v)
            if row['control']:
                s['upper'] = v if s['upper'] is None else min(s['upper'], v)
            else:
                s['lower'] = v if s['lower'] is None else max(s['lower'], v)
    print('summary ' + json.dumps(summary), flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps(dict(rows=rows,
                                                  summary=summary)))


if __name__ == '__main__':
    main()
