"""K3's least time over its device time."""

from benchmark.harness import readers as R


def read(ctx):
    return R.roofline(ctx, ('k3', ))
