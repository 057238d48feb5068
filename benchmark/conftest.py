"""The small sizes at which the benchmark's CPU tests run the
configurations added after ``tests/tiny.py``, which shrinks each
configuration by its task: entered into its table here, where pytest reads
them before any test under ``benchmark/``.

A stopgap for a limit of the harness: ``tiny.TINY_MODEL`` is keyed by
task, so a configuration cannot bring its small sizes in its own files.
Its replacement lets each ``configs/*.json`` carry its small sizes and
the tiny fixture read them there; this file then goes."""

from benchmark.tests import tiny

# the port's grounding parity size (tests/test_torch_grounding.py's tiny
# grounder) at the published text vocabulary and norm, with the detector's
# small trunk
tiny.TINY_MODEL.setdefault('mv_grounding', dict(
    voxel_size=0.02, input_capacity=1024,
    backbone_capacities=[1024, 512, 512, 256, 128, 64],
    fpn_capacities=[64, 64, 32, 32], resnet_depth=18, mink_depth=18,
    num_queries=16, max_text_len=64, text_layers=2, text_hidden=32,
    text_heads=4))
