"""Host ms per request in the copy of the request to the device (es.to_device, data/loader.py:to_device)."""

from benchmark.harness import readers as R


def read(ctx):
    return R.host_ms(ctx, 'es.to_device')
