"""Optimizer, learning-rate schedule and the train step (port of
``embodiedscan_tpu/train/state.py``: ``multistep_lr``, ``make_optimizer``
without per-parameter lr multipliers, ``make_train_step``).

The reference chains optax's ``clip_by_global_norm(10)`` and ``adamw(lr,
weight_decay=1e-4)`` under a step schedule; here one ``torch.optim.AdamW``
subclass clips, sets the scheduled rate and steps, with the same formulas.
"""

import torch
from torch import nn


def multistep_lr(base_lr: float, steps_per_epoch: int, milestones=(8, 11),
                 gamma: float = 0.1):
    """Epoch-based MultiStepLR as a function of the update count.

    As optax's ``piecewise_constant_schedule`` with boundaries
    ``milestone * steps_per_epoch``: the update made after ``count`` earlier
    updates takes ``gamma`` once per boundary <= ``count``, i.e. a factor
    applies once the boundary is strictly below the number of this update
    (``torch.optim.lr_scheduler.MultiStepLR`` changes the rate one update
    earlier).
    """
    bounds = [m * steps_per_epoch for m in milestones]

    def schedule(count: int) -> float:
        lr = base_lr
        for bound in bounds:
            if count >= bound:
                lr = lr * gamma
        return lr

    return schedule


class ClippedAdamW(torch.optim.AdamW):
    """AdamW (betas 0.9 / 0.999, eps 1e-8, decoupled weight decay on every
    parameter, as ``optax.adamw``) after a global-norm clip, at the rate
    ``schedule(count)`` for the update made after ``count`` earlier ones.

    Each parameter group keeps ``count`` (as optax's schedule state counts
    updates), so ``state_dict`` / ``load_state_dict`` resume the schedule
    where it was."""

    def __init__(self, params, schedule, weight_decay: float,
                 clip_norm: float):
        super().__init__(params, lr=schedule(0), betas=(0.9, 0.999),
                         eps=1e-8, weight_decay=weight_decay)
        self.schedule = schedule
        self.clip_norm = clip_norm
        for group in self.param_groups:
            group['count'] = 0

    @torch.no_grad()
    def clip_grads_(self) -> torch.Tensor:
        """Scale the gradients by ``min(1, clip_norm / norm)`` with norm the
        global norm of all of them (optax's clip, no epsilon); returns the
        norm before the clip."""
        grads = [p.grad for g in self.param_groups for p in g['params']
                 if p.grad is not None]
        norm = torch.linalg.vector_norm(torch.stack(
            torch._foreach_norm(grads)))
        torch._foreach_mul_(grads, torch.clamp(self.clip_norm / norm,
                                               max=1.0))
        return norm

    def step(self, closure=None):
        self.clip_grads_()
        for group in self.param_groups:
            group['lr'] = self.schedule(group['count'])
            group['count'] += 1
        return super().step(closure)


def make_optimizer(model: nn.Module, cfg) -> ClippedAdamW:
    """The optimizer of ``cfg.schedule`` over every parameter of ``model``;
    an epoch is ``cfg.schedule.steps_per_epoch`` updates."""
    sc = cfg.schedule
    return ClippedAdamW(model.parameters(),
                        multistep_lr(sc.lr, sc.steps_per_epoch,
                                     sc.milestones),
                        weight_decay=sc.weight_decay, clip_norm=sc.clip_norm)


def train_step(model: nn.Module, optimizer: ClippedAdamW,
               batch: dict) -> dict:
    """One update: zero the gradients, ``model(batch, mode='loss')``, sum
    the losses, backward, clip, AdamW. Returns the losses and
    ``loss_total`` (detached tensors on the model's device)."""
    optimizer.zero_grad(set_to_none=True)
    losses = model(batch, mode='loss')
    total = sum(losses.values())
    total.backward()
    optimizer.step()
    return {k: v.detach() for k, v in dict(losses, loss_total=total).items()}
