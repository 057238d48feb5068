"""Step-stamped checkpoints with keep-N and resume (port of
``embodiedscan_tpu/train/checkpoint.py``, which wraps orbax).

Each checkpoint is one ``torch.save`` of ``{'step', 'model', 'optimizer'}``
(the model's and the optimizer's ``state_dict``, the optimizer's ``None``
when there is none) at ``work_dir/checkpoints/<step>.pt``, written under a
temporary name and renamed, so a reader never sees half a file. The newest
``max_keep`` are kept; :meth:`CheckpointManager.latest_step` is where a
restarted run resumes.
"""

import os

import torch
from torch import nn

from ..ops.sparse import drop_bf16_weights


class CheckpointManager:
    """Saves and restores ``(model, optimizer)`` under ``work_dir``."""

    def __init__(self, work_dir: str, max_keep: int = 4):
        if max_keep < 1:
            raise ValueError(f'max_keep {max_keep} < 1')
        self.path = os.path.abspath(os.path.join(work_dir, 'checkpoints'))
        self.max_keep = max_keep
        os.makedirs(self.path, exist_ok=True)

    def _file(self, step: int) -> str:
        return os.path.join(self.path, f'{step}.pt')

    def steps(self) -> list:
        """The saved steps, ascending."""
        names = (n[:-3] for n in os.listdir(self.path) if n.endswith('.pt'))
        return sorted(int(n) for n in names if n.isdigit())

    def latest_step(self) -> int | None:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, step: int, model: nn.Module,
             optimizer: torch.optim.Optimizer | None = None) -> str:
        """Writes step ``step``, then removes all but the newest
        ``max_keep`` checkpoints; returns the file's path."""
        path = self._file(step)
        tmp = f'{path}.tmp'
        torch.save({'step': int(step), 'model': model.state_dict(),
                    'optimizer': None if optimizer is None
                    else optimizer.state_dict()}, tmp)
        os.replace(tmp, path)
        for old in self.steps()[:-self.max_keep]:
            os.remove(self._file(old))
        return path

    def restore(self, model: nn.Module,
                optimizer: torch.optim.Optimizer | None = None,
                step: int | None = None) -> int | None:
        """Loads step ``step`` (default: the latest) into ``model`` (every
        tensor, on the model's device) and, when given, ``optimizer``;
        returns the step, or None when there is no checkpoint."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        device = next(model.parameters()).device
        ckpt = torch.load(self._file(step), map_location=device,
                          weights_only=True)
        model.load_state_dict(ckpt['model'])
        drop_bf16_weights()
        if optimizer is not None:
            if ckpt['optimizer'] is None:
                raise ValueError(f'checkpoint {step} holds no optimizer')
            optimizer.load_state_dict(ckpt['optimizer'])
        return ckpt['step']
