"""What the per-layer metric files (``metrics/<name>.py``) read from a
traced run. Each returns None where the run has nothing to read, and the
harness then leaves the metric out."""

from ..counts.peaks import FP32_ACCURATE_FLOPS, least_seconds


def mfu(ctx):
    """The model's operations per step or request (the dense layers', from
    a step or request of their own, and the sparse convs' over the
    profiled stretch) over the untraced
    stretch's seconds per step or request, as a share (%) of the chip's
    float32-accurate peak."""
    sparse = sum(f for _, _, f in ctx['spans'].calls_as_floats())
    flops = ctx['dense_flops'] + sparse / ctx['steps']
    if flops <= 0:
        return None
    return 100.0 * flops / (ctx['sec_per_step'] * FP32_ACCURATE_FLOPS)


def device_idle(ctx):
    """Share (%) of the profiled stretch that no kernel or copy covers."""
    return 100.0 * (1.0 - ctx['busy_us'] / ctx['trace']['window_us'])


def roofline(ctx, spans):
    """Sum over the calls in ``spans`` of each call's least time (bytes at
    the memory rate against operations at the float32-accurate peak), over
    the device time of those spans, in %."""
    calls = [c for c in ctx['spans'].calls_as_floats() if c[0] in spans]
    dev_us = sum(ctx['trace']['span_device_us'].get(s, 0.0) for s in spans)
    if not calls or dev_us <= 0:
        return None
    least = sum(least_seconds(b, f) for _, b, f in calls)
    return 100.0 * least / (dev_us * 1e-6)


def device_ms(ctx, spans):
    """Device ms per step or request of the kernels launched inside
    ``spans``."""
    dev = ctx['trace']['span_device_us']
    if not any(s in dev for s in spans):
        return None
    return sum(dev.get(s, 0.0) for s in spans) * 1e-3 / ctx['steps']


def host_ms(ctx, span):
    """Host ms per step or request that ``span`` was open."""
    host = ctx['trace']['span_host_us']
    if span not in host:
        return None
    return host[span] * 1e-3 / ctx['steps']
