"""Scalar training curves: JSONL always, TensorBoard on request (port of
``embodiedscan_tpu/train/metrics_writer.py``).

Every run appends ``{"step": N, ...}`` rows to ``scalars.jsonl`` under the
work dir; ``'tensorboard'`` in ``cfg.log_backends`` also streams the same
scalars to event files through ``torch.utils.tensorboard`` where it imports
(a missing TensorBoard is a warning, never an error).
"""

import json
import logging
import os
from typing import Mapping, Sequence

log = logging.getLogger('embodiedscan_torch')


class MetricsWriter:
    """Fan-out scalar writer: call :meth:`write` at each logging step and
    :meth:`close` at the end."""

    def __init__(self, log_dir: str,
                 backends: Sequence[str] = ('jsonl', )) -> None:
        self.log_dir = log_dir
        self._jsonl = None
        self._tb = None
        os.makedirs(log_dir, exist_ok=True)
        if 'jsonl' in backends:
            self._jsonl = open(os.path.join(log_dir, 'scalars.jsonl'), 'a')
        if 'tensorboard' in backends:
            try:
                from torch.utils.tensorboard import SummaryWriter
                self._tb = SummaryWriter(os.path.join(log_dir, 'tb'))
            except ImportError as e:
                log.warning('tensorboard backend unavailable (%s); '
                            'scalars.jsonl still written', e)

    def write(self, step: int, scalars: Mapping[str, float],
              prefix: str = '') -> None:
        named = {(f'{prefix}/{k}' if prefix else k): float(v)
                 for k, v in scalars.items()}
        if self._jsonl is not None:
            self._jsonl.write(json.dumps({'step': int(step), **named}) + '\n')
            self._jsonl.flush()
        if self._tb is not None:
            for k, v in named.items():
                self._tb.add_scalar(k, v, int(step))

    def close(self) -> None:
        if self._jsonl is not None:
            self._jsonl.close()
            self._jsonl = None
        if self._tb is not None:
            self._tb.close()
            self._tb = None
