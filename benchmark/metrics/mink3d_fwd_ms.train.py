"""Device ms of the 3D backbone's forward (MinkResNet span)."""

from benchmark.harness import readers as R


def read(ctx):
    return R.device_ms(ctx, ('mink3d', ))
