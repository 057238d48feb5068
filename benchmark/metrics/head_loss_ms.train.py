"""Device ms of the FCAF3D head's forward and its loss (targets included)."""

from benchmark.harness import readers as R


def read(ctx):
    return R.device_ms(ctx, ('head', 'head_loss'))
