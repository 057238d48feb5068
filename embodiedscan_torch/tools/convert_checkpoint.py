"""Convert a reference EmbodiedScan ``.pth`` into a checkpoint of the port.

The published detector and grounder checkpoints (mmengine files of
``SparseFeatureFusionSingleStage3DDetector`` and
``SparseFeatureFusion3DGrounder``) go through the port's converters
(``utils.convert_weights``) into the preset's model, which is saved as
step 0 with a fresh optimizer (no moments) by ``train.checkpoint``; serve
it with ``CheckpointManager(work_dir).restore(build_model(cfg))``.

Usage:
    python -m embodiedscan_torch.tools.convert_checkpoint mv_det3d ckpt.pth \
        --work-dir out/ [key.subkey=value ...] [--flip] [--device cuda]
"""

import argparse

from ..configs.base import PRESETS, apply_overrides
from ..train.checkpoint import CheckpointManager
from ..train.loop import lr_mult_fn_for
from ..train.state import make_optimizer
from ..utils.convert_weights import load_reference_model, load_torch_checkpoint


def main(argv=None):
    """Runs the conversion of ``argv`` (default: the command line);
    returns (model, n_loaded, skipped)."""
    parser = argparse.ArgumentParser(
        description='reference .pth -> checkpoint of the port')
    parser.add_argument('config', help='preset: mv_det3d | mv_grounding')
    parser.add_argument('checkpoint', help='path to the reference .pth')
    parser.add_argument('overrides', nargs='*',
                        help='dot-path config overrides (key.subkey=value)')
    parser.add_argument('--work-dir', required=True,
                        help='output dir (checkpoints/ is created inside)')
    parser.add_argument('--device', default='cuda',
                        help="'cuda' (default) or 'cpu'")
    parser.add_argument('--flip', action='store_true',
                        help='mirror the ME kernel offsets (see '
                             'convert_weights.me_kernel_permutation)')
    args = parser.parse_args(argv)

    cfg = apply_overrides(PRESETS[args.config](), args.overrides)
    model, n, skipped = load_reference_model(
        cfg, load_torch_checkpoint(args.checkpoint), flip=args.flip,
        device=args.device)
    # what a resumed run's optimizer loads: the task's parameter groups,
    # no moments
    opt = make_optimizer(model, cfg, lr_mult_fn_for(cfg.model.task))
    CheckpointManager(args.work_dir).save(0, model, opt)
    print(f'loaded {n} tensors from {args.checkpoint}')
    if skipped:
        print(f'skipped {len(skipped)} (first 10): {skipped[:10]}')
    print(f'checkpoint written under {args.work_dir}/checkpoints')
    return model, n, skipped


if __name__ == '__main__':
    main()
