"""Host ms per request in the NMS's greedy sweep and the keep mask's copy back (es.nms.sweep)."""

from benchmark.harness import readers as R


def read(ctx):
    return R.host_ms(ctx, 'es.nms.sweep')
