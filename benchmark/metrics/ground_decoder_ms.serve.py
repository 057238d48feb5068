"""Device ms per request of the grounder's query selection and 6-layer decoder (es.select and es.decoder, models/grounding.py)."""

from benchmark.harness import readers as R


def read(ctx):
    return R.device_ms(ctx, ('es.select', 'es.decoder'))
