"""Device ms of the 2D backbone's forward (ResNet span, and FPN where the model has one)."""

from benchmark.harness import readers as R


def read(ctx):
    return R.device_ms(ctx, ('resnet2d', ))
