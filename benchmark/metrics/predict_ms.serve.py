"""Host ms of the head's predict, from decoding to the NMS keep mask on the device."""

from benchmark.harness import readers as R


def read(ctx):
    return R.host_ms(ctx, 'predict')
