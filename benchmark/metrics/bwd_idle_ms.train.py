"""Device idle ms per step whose gap began while es.bwd was open on the thread holding es.step."""

from benchmark.metrics import program_spans as PS


def read(ctx):
    return PS.idle_ms(ctx, 'es.bwd')
