"""Device ms per request of the grounder's text encoder, RoBERTa and its projection (es.text, models/text.py:TextEncoder.forward)."""

from benchmark.harness import readers as R


def read(ctx):
    return R.device_ms(ctx, ('es.text', ))
