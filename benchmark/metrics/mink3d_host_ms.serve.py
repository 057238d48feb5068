"""Host ms per request inside the 3D backbone's forward (es.mink3d, MinkResNet.forward)."""

from benchmark.harness import readers as R


def read(ctx):
    return R.host_ms(ctx, 'es.mink3d')
