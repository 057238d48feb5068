"""Occupied voxels of each level against the configured capacities (the
reference package's ``tools/occupancy_histogram.py``).

Runs the coordinate chain of the sparse engine (voxelize -> stem s2 ->
pool s4 -> stages s8 ... s64) over two inputs, with measuring capacities
that no level can fill (a level holds at most as many voxels as the one
before it, and the input at most one per point; a count that reaches its
capacity raises), the bench fixture (100k surface points at 0.01 m, as the reference
benchmark draws them) and a train batch of the synthetic dataset (drawn
from the preset's seed, where the reference draws a fresh one), and prints
per level the largest occupied count of a sample beside the mv_det3d
preset's capacity, their ratio, and a suggested capacity: the count times a
margin, rounded up to a multiple of 2048. Writes a file only where
``--out`` names one.

Usage:
    python -m embodiedscan_torch.tools.occupancy_histogram [--device cuda]
        [--margin 1.25] [--out PATH]
"""

import argparse
import math

import numpy as np
import torch

LEVELS = ('s1 (input)', 's2 (stem)', 's4 (pool)', 's8 (stage1/FPN0)',
          's16 (stage2/FPN1)', 's32 (stage3/FPN2)', 's64 (stage4/FPN3)')
# measuring capacities, one per level: every level at the input's, above
# either input's points per sample. (The reference tool halves them from
# s2 on, and its s4 count at the bench scale is its cap, 65536: truncated.)
MEASURE_CAPS = (262144,) * 7
# the bench fixture's points (one sample)
BENCH_POINTS = 100_000


def bench_points(b: int, p: int, seed: int = 0) -> np.ndarray:
    """(b, p, 3) float32: the reference benchmark's surface cloud
    (``bench.py:make_batch``'s first draws from the same seed): points on
    the floor and two walls of an 8 m room, 1 cm of noise."""
    rng = np.random.RandomState(seed)
    u = rng.uniform(0, 8, (p, 2)).astype(np.float32)
    which = rng.randint(0, 3, p)
    pts = np.zeros((p, 3), np.float32)
    pts[which == 0] = np.stack([u[which == 0, 0], u[which == 0, 1],
                                np.zeros((which == 0).sum())], -1)
    pts[which == 1] = np.stack([u[which == 1, 0],
                                np.zeros((which == 1).sum()),
                                u[which == 1, 1] * 3 / 8], -1)
    pts[which == 2] = np.stack([np.zeros((which == 2).sum()),
                                u[which == 2, 0],
                                u[which == 2, 1] * 3 / 8], -1)
    return np.tile(pts[None], (b, 1, 1)) + rng.randn(b, p, 3).astype(
        np.float32) * 0.01


def chain_counts(points: torch.Tensor, mask: torch.Tensor, voxel_size: float,
                 caps) -> list:
    """The largest occupied count of a sample at stride 1, 2, 4 ... (one
    level per capacity in ``caps``) for one (B, N, 3) batch."""
    from ..ops import sparse as S
    counts = []
    with torch.no_grad():
        feats = torch.ones(points.shape[:2] + (1,), device=points.device)
        st = S.from_points_b(points, feats, mask, voxel_size, caps[0])
        counts.append(st.mask.sum(-1))
        for cap in caps[1:]:
            dmap = S.downsample_coords_b(st, cap)
            st = S.SparseTensor(dmap.coords, None, dmap.mask)
            counts.append(dmap.mask.sum(-1))
    return [int(c.max()) for c in counts]


def measure(points: torch.Tensor, mask: torch.Tensor,
            voxel_size: float) -> list:
    """:func:`chain_counts` at ``MEASURE_CAPS``; raises where a count
    reaches its capacity, since the voxels past it were cut."""
    if points.shape[1] >= MEASURE_CAPS[0]:
        raise ValueError(f'{points.shape[1]} points per sample may fill the '
                         f'measuring capacity {MEASURE_CAPS[0]}')
    counts = chain_counts(points, mask, voxel_size, MEASURE_CAPS)
    full = [(name, c) for name, c, cap in zip(LEVELS, counts, MEASURE_CAPS)
            if c >= cap]
    if full:
        raise RuntimeError(f'levels at their measuring capacity: {full}')
    return counts


def suggest(count: int, margin: float, lane: int = 2048) -> int:
    """``count * margin`` rounded up to a lane multiple (at least one)."""
    return max(lane, int(math.ceil(count * margin / lane)) * lane)


def table(counts, caps, margin) -> list:
    """The lines of one table: level, occupied, capacity, util, suggest."""
    lines = ['```', f'{"level":20s} {"occupied":>9s} {"capacity":>9s} '
                    f'{"util":>6s} {"suggest":>8s}']
    for name, c, cap in zip(LEVELS, counts, caps):
        lines.append(f'{name:20s} {c:9d} {cap:9d} {c / cap:6.2f} '
                     f'{suggest(c, margin):8d}')
    return lines + ['```']


def main(argv=None) -> dict:
    """Measures as ``argv`` (default: the command line) asks, prints both
    tables and returns {'bench': counts, 'synthetic': counts, 'capacities':
    the preset's, 'lines': the printed lines}."""
    parser = argparse.ArgumentParser()
    parser.add_argument('--device', default='cuda',
                        help="'cuda' (default) or 'cpu'")
    parser.add_argument('--margin', type=float, default=1.25)
    parser.add_argument('--out', default='',
                        help='also write the tables to this markdown file')
    args = parser.parse_args(argv)
    device = torch.device(args.device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --device cpu")
    from ..configs.base import PRESETS
    from ..data.loader import SyntheticLoader

    cfg = PRESETS['mv_det3d']()
    caps = [cfg.model.input_capacity] + list(cfg.model.backbone_capacities)
    lines = [f'Occupied voxels per level against the mv_det3d capacities; '
             f'"suggest" is the count x {args.margin} rounded up to a '
             f'multiple of 2048.', '',
             '## bench fixture (100k surface points, 0.01 m)', '']
    pts = torch.from_numpy(bench_points(1, BENCH_POINTS)).to(device)
    bench = measure(pts, torch.ones(pts.shape[:2], dtype=torch.bool,
                                    device=device), 0.01)
    lines += table(bench, caps, args.margin)
    lines += ['', '## synthetic dataset batch (data/synthetic.py, '
                  'mv_det3d)', '']
    cfg.data.batch_size = 2
    # the first train batch drawn from the config's seed
    batch = next(iter(SyntheticLoader(cfg, True, seed=cfg.seed)))
    synth = measure(torch.from_numpy(batch['points']).to(device),
                    torch.from_numpy(batch['points_mask']).to(device),
                    cfg.model.voxel_size)
    lines += table(synth, caps, args.margin)
    print('\n'.join(lines))
    if args.out:
        with open(args.out, 'w') as f:
            f.write('\n'.join(lines) + '\n')
        print(f'wrote {args.out}')
    return dict(bench=bench, synthetic=synth, capacities=caps, lines=lines)


if __name__ == '__main__':
    main()
