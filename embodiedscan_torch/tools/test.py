"""Eval CLI (the reference package's ``tools/test.py``: its flags, its
JSON print; ``--device`` in place of its ``--platform``).

Usage:
    python -m embodiedscan_torch.tools.test mv_det3d [key=value ...] \\
        [--work-dir DIR] [--max-scenes N] [--synthetic] [--format-only] \\
        [--vis-dir DIR] [--device cuda|cpu]

Evaluates the latest checkpoint of the work dir.
"""

import argparse
import json

from ..configs.base import PRESETS, apply_overrides


def main(argv=None) -> dict:
    """Evaluates as ``argv`` (default: the command line) asks, prints the
    metrics as JSON and returns them."""
    parser = argparse.ArgumentParser(
        description='Evaluate an EmbodiedScan model on the port')
    parser.add_argument('config', help='preset: ' + '|'.join(PRESETS))
    parser.add_argument('overrides', nargs='*')
    parser.add_argument('--work-dir', default=None)
    parser.add_argument('--max-scenes', type=int, default=None)
    parser.add_argument('--device', default='cuda',
                        help="'cuda' (default; raises without a card) or "
                             "'cpu'")
    parser.add_argument('--synthetic', action='store_true')
    parser.add_argument('--format-only', action='store_true',
                        help='skip metrics; dump the grounding challenge '
                             'submission json (top-20 boxes per sample)')
    parser.add_argument('--vis-dir', default='',
                        help='export prediction PLYs into this directory')
    args = parser.parse_args(argv)

    cfg = apply_overrides(PRESETS[args.config](), args.overrides)
    if args.work_dir:
        cfg.work_dir = args.work_dir
    if args.synthetic:
        cfg.data.synthetic = True
    if args.vis_dir:
        cfg.vis_dir = args.vis_dir

    from ..train.loop import evaluate
    metrics = evaluate(cfg, max_scenes=args.max_scenes,
                       format_only=args.format_only, device=args.device)
    print(json.dumps({
        k: (round(float(v), 5) if not isinstance(v, str) else v)
        for k, v in metrics.items()
    }, indent=1))
    return metrics


if __name__ == '__main__':
    main()
