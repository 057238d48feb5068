"""Device ms per step of the operations launched inside es.optim: missing gradients zeroed, the clip, AdamW, the losses stacked."""

from benchmark.metrics import program_spans as PS


def read(ctx):
    return PS.device_ms(ctx, 'es.optim')
