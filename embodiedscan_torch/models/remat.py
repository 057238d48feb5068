"""Rematerialization (the reference's ``remat`` model option): recompute a
module's activations in the backward pass instead of keeping them, trading
step time for device memory.

The modes are the reference's (``embodiedscan_tpu/models/trunk.py:44-48``):
'none', '2d' (each block of the 2D ResNet), '3d' (each MinkResNet stage
and, in the occupancy model, the whole U-Net) and 'all' (both); True means
'all' and False 'none'. :func:`checkpointed` wraps a call in
``torch.utils.checkpoint`` inside the owning module's ``forward``, so no
module is wrapped and the parameter names are the same in every mode.

A norm layer keeps its running statistics in place. The recompute runs the
forward a second time, in the backward pass; :func:`recomputing` is true
there, and the norms skip their running update, so it is applied once per
step, as flax's remat does.
"""

import contextlib
import threading

import torch
from torch.utils.checkpoint import checkpoint

MODES = ('none', '2d', '3d', 'all')

_state = threading.local()


def remat_mode(value) -> str:
    """The mode of a ``remat`` value: one of MODES, True ('all') or False
    ('none'); raises on anything else."""
    mode = {True: 'all', False: 'none'}.get(value, value) \
        if isinstance(value, bool) else value
    if mode not in MODES:
        raise ValueError(f'remat={value!r}: one of {MODES}, True or False')
    return mode


def covers(value, which: str) -> bool:
    """Whether the ``remat`` value rematerializes ``which`` ('2d' or
    '3d')."""
    return remat_mode(value) in ('all', which)


def recomputing() -> bool:
    """True while a checkpointed call is being recomputed (in the backward
    pass, on the thread that runs it)."""
    return getattr(_state, 'depth', 0) > 0


@contextlib.contextmanager
def _recompute():
    _state.depth = getattr(_state, 'depth', 0) + 1
    try:
        yield
    finally:
        _state.depth -= 1


def _contexts():
    return contextlib.nullcontext(), _recompute()


def checkpointed(fn, *args):
    """``fn(*args)``, its activations recomputed in the backward pass when
    autograd records this call (else a plain call)."""
    if not torch.is_grad_enabled():
        return fn(*args)
    return checkpoint(fn, *args, use_reentrant=False, context_fn=_contexts)
