"""Host ms per request in the NMS's two copies to the host (es.nms.wait), which wait for the device."""

from benchmark.harness import readers as R


def read(ctx):
    return R.host_ms(ctx, 'es.nms.wait')
