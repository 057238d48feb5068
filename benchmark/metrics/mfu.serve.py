"""The step's or request's model operations as a share of the chip's float32-accurate peak."""

from benchmark.harness import readers as R


def read(ctx):
    return R.mfu(ctx)
