"""Device ms per step of the backward's operations: those launched off the step thread, by autograd, or inside es.bwd."""

from benchmark.metrics import program_spans as PS


def read(ctx):
    return PS.device_ms(ctx, 'es.bwd')
