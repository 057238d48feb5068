"""Finds a serving cell's capacity: serves its traffic at each of a few
fixed rates in one process and prints, for each, the median and p90
latency, the rate achieved and how late the last requests started (a
backlog that grows through the window means the rate is above capacity).

    python3 benchmark/sweep.py --workload <cell> --seed <n> \
        --seconds <s> --rates 2.0,2.5,3.0,3.5
"""

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--rates', required=True)
    args = ap.parse_args(argv)
    from benchmark.harness import cells, program, spec
    from benchmark.traffic import generate as G
    cell = spec.cell(args.workload, spec.benchmark())
    model, pool_np, _ = cells.serve_setup(cell, args.seed, 'cuda')
    for i in range(cell['work']['warmup_requests']):
        program.request(model, pool_np[i % len(pool_np)][1], 'cuda')
    rows = []
    for rate in [float(r) for r in args.rates.split(',')]:
        t = dict(cell['traffic'], rate_per_s=rate)
        # above capacity the backlog grows: serve what fits in twice the
        # window and no more
        due = G.arrivals(t, args.seconds)
        cap = int(2 * args.seconds / 0.05)
        lat, late, _, el = cells._requests(
            model, pool_np, 'cuda', due[:cap], program.request,
            stop_after=2 * args.seconds)
        ms = sorted(x * 1e3 for x in lat)
        n = len(ms)
        row = dict(rate=rate, requests=n, achieved=n / el,
                   p50_ms=statistics.median(ms),
                   p90_ms=statistics.quantiles(ms, n=10,
                                               method='inclusive')[8],
                   late_last_ms=late[-1] * 1e3,
                   late_max_ms=max(late) * 1e3,
                   service_ms=statistics.median(
                       [x - y for x, y in zip(lat, late)]) * 1e3)
        rows.append(row)
        print(json.dumps(row), flush=True)
        time.sleep(1.0)
    return rows


if __name__ == '__main__':
    main()
