"""Device ms per request of the grounder's sparse FPN neck (es.neck, models/grounding.py:MinkNeck.forward)."""

from benchmark.harness import readers as R


def read(ctx):
    return R.device_ms(ctx, ('es.neck', ))
