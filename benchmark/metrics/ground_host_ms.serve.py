"""Host ms per request in the grounder's own stages: es.neck, es.text, es.select and es.decoder (models/grounding.py, models/text.py)."""

from benchmark.harness import readers as R

SPANS = ('es.neck', 'es.text', 'es.select', 'es.decoder')


def read(ctx):
    ms = [R.host_ms(ctx, s) for s in SPANS]
    ms = [m for m in ms if m is not None]
    return sum(ms) if ms else None
