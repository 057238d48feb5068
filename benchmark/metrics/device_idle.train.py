"""Share of the profiled stretch in which the device ran nothing."""

from benchmark.harness import readers as R


def read(ctx):
    return R.device_idle(ctx)
