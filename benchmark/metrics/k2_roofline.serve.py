"""K2's least time over its device time, forward and input-gradient calls."""

from benchmark.harness import readers as R


def read(ctx):
    return R.roofline(ctx, ('k2.fwd', 'k2.dgrad'))
