"""Named spans of the port's own layers in a profiler trace.

``with span('es.fwd'): ...`` marks a stretch of host code in whatever
``torch.profiler`` (or autograd profiler) trace is recording at the time, as
a ``record_function`` range: it lands in the trace on the profiler's clock,
beside the device operations it launched. With no profiler recording,
``span`` reads one module flag and returns a shared no-op context: no
dispatcher call, no allocation.

The port keeps no timer, buffer or exporter of its own. Its span names
start with ``es.`` so that they never collide with a caller's spans.
"""

import contextlib

import torch
from torch.autograd import profiler as _profiler

_OFF = contextlib.nullcontext()


def span(name: str):
    """A ``record_function(name)`` context while a profiler records, else
    the shared no-op context."""
    if _profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _OFF
