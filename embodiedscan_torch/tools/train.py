"""Train CLI (the reference package's ``tools/train.py``: its flags and
``a.b=c`` overrides; ``--device`` in place of its ``--platform``).

Usage:
    python -m embodiedscan_torch.tools.train mv_det3d [key.subkey=value ...] \\
        [--work-dir DIR] [--resume auto] [--max-steps N] [--synthetic] \\
        [--auto-scale-lr] [--multihost] [--device cuda|cpu]

``--multihost`` joins the ``torch.distributed`` group that a launcher
describes (``torchrun --nproc-per-node N -m embodiedscan_torch.tools.train
... --multihost``): one process per card.
"""

import argparse

from ..configs.base import PRESETS, apply_overrides


def main(argv=None):
    """Trains as ``argv`` (default: the command line) asks; returns the
    trained (model, optimizer)."""
    parser = argparse.ArgumentParser(
        description='Train an EmbodiedScan model on the port')
    parser.add_argument('config', help='preset: ' + '|'.join(PRESETS))
    parser.add_argument('overrides', nargs='*',
                        help='dot-path config overrides, e.g. '
                             'data.batch_size=2')
    parser.add_argument('--work-dir', default=None)
    parser.add_argument('--resume', default='',
                        help="'' | 'auto' | a checkpoint step")
    parser.add_argument('--max-steps', type=int, default=None,
                        help='cap the steps of this run (smoke runs)')
    parser.add_argument('--device', default='cuda',
                        help="'cuda' (default; raises without a card) or "
                             "'cpu'")
    parser.add_argument('--synthetic', action='store_true',
                        help='use the synthetic fixture dataset')
    parser.add_argument('--auto-scale-lr', action='store_true',
                        help='scale lr by global batch / '
                             'schedule.base_batch_size (the reference '
                             'tools/train.py:98-109, mmengine '
                             'auto_scale_lr)')
    parser.add_argument('--multihost', action='store_true',
                        help='join the torch.distributed group of the '
                             'launcher\'s environment (RANK, WORLD_SIZE, '
                             'LOCAL_RANK, MASTER_ADDR, MASTER_PORT)')
    args = parser.parse_args(argv)

    from ..parallel import multihost
    if args.multihost:
        active = multihost.init_distributed(args.device)
        print(f'multihost: active={active} process '
              f'{multihost.process_index()}/{multihost.process_count()}, '
              f'{multihost.local_device_count()} local devices')

    cfg = apply_overrides(PRESETS[args.config](), args.overrides)
    if args.work_dir:
        cfg.work_dir = args.work_dir
    if args.resume:
        cfg.resume = args.resume
    if args.synthetic:
        cfg.data.synthetic = True
    if args.auto_scale_lr:
        global_batch = multihost.global_batch_size(cfg.data.batch_size)
        cfg.schedule.lr = cfg.schedule.lr * (
            global_batch / cfg.schedule.base_batch_size)
        print(f'auto-scale-lr: global_batch={global_batch} '
              f'base={cfg.schedule.base_batch_size} -> lr={cfg.schedule.lr}')

    from ..train.loop import train
    return train(cfg, max_steps=args.max_steps, device=args.device)


if __name__ == '__main__':
    import torch.distributed as dist
    main()
    if dist.is_initialized():
        dist.destroy_process_group()
