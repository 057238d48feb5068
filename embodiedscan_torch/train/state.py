"""Optimizer, learning-rate schedule and the train step (port of
``embodiedscan_tpu/train/state.py``: ``multistep_lr``, ``make_optimizer``
with its per-parameter lr multipliers, ``make_train_step`` and, over
``torch.distributed``, ``make_train_step_sharded``, both in
``train_step``).

The reference chains optax's ``clip_by_global_norm(10)`` and ``adamw(lr,
weight_decay=1e-4)`` under a step schedule; here one ``torch.optim.AdamW``
subclass clips, sets the scheduled rate and steps, with the same formulas.
With multipliers the reference runs that chain once per group of equal
multiplier (``optax.multi_transform``), scaled by the multiplier, and
``set_to_zero`` for the multiplier 0; here each group is a parameter
group, clipped on its own, and the frozen parameters leave the optimizer.
"""

from typing import Callable

import torch
from torch import nn

from ..utils.trace import span


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
    parameter, as ``optax.adamw``) after a global-norm clip of each
    parameter group's gradients, at the rate ``schedule(count)`` times the
    group's ``lr_mult`` (default 1) for the update made after ``count``
    earlier ones. A parameter the loss does not reach gets a zero gradient,
    as optax sees it: AdamW still decays it.

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
            group.setdefault('lr_mult', 1.0)

    @torch.no_grad()
    def clip_grads_(self) -> torch.Tensor:
        """Scale each group's gradients by ``min(1, clip_norm / norm)`` with
        norm the global norm of that group's gradients (optax's clip, no
        epsilon); returns the norms before the clip, one per group."""
        norms = []
        for group in self.param_groups:
            grads = [p.grad for p in group['params'] if p.grad is not None]
            norm = torch.linalg.vector_norm(torch.stack(
                torch._foreach_norm(grads)))
            torch._foreach_mul_(grads, torch.clamp(self.clip_norm / norm,
                                                   max=1.0))
            norms.append(norm)
        return torch.stack(norms)

    def step(self, closure=None):
        for group in self.param_groups:
            for p in group['params']:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
        self.clip_grads_()
        for group in self.param_groups:
            group['lr'] = self.schedule(group['count']) * group['lr_mult']
            group['count'] += 1
        return super().step(closure)


def make_optimizer(model: nn.Module, cfg,
                   lr_mult_fn: Callable[[tuple], float] | None = None, *,
                   steps_per_epoch: int) -> ClippedAdamW:
    """The optimizer of ``cfg.schedule`` over the parameters of ``model``;
    an epoch is ``steps_per_epoch`` updates (``train.loop.train`` passes
    its loader's, as the reference's ``train()`` does).

    ``lr_mult_fn`` (``train.loop.lr_mult_fn_for``) maps a parameter's name,
    split at the dots, to its multiplier: one parameter group per distinct
    multiplier, and a parameter at 0 leaves the optimizer and stops
    requiring a gradient (no update, no decay, outside every clip norm; no
    backward runs for it). Without it every parameter is in one group.
    """
    sc = cfg.schedule
    if lr_mult_fn is None:
        groups = [dict(params=list(model.parameters()))]
    else:
        by_mult = {}
        for name, p in model.named_parameters():
            mult = float(lr_mult_fn(tuple(name.split('.'))))
            if mult == 0.0:
                p.requires_grad_(False)
            else:
                by_mult.setdefault(mult, []).append(p)
        groups = [dict(params=ps, lr_mult=m) for m, ps in by_mult.items()]
    return ClippedAdamW(groups,
                        multistep_lr(sc.lr, steps_per_epoch, sc.milestones,
                                     sc.gamma),
                        weight_decay=sc.weight_decay, clip_norm=sc.clip_norm)


def train_step(model: nn.Module, optimizer: ClippedAdamW,
               batch: dict, mesh=None) -> dict:
    """One update: zero the gradients, ``model(batch, mode='loss')``, sum
    the losses, backward, clip, AdamW. Returns the losses and
    ``loss_total`` (detached tensors on the model's device).

    In a ``torch.distributed`` group each process computes its loss on its
    own batch rows with its own normalizers, as the reference's
    ``make_train_step_sharded``, then takes the mean over the processes
    (``parallel.multihost.pmean_``, one flat all-reduce each; nothing
    outside a group) of the gradients, before the clip and AdamW, which
    every process then applies alike; of the norms' running statistics,
    after the update; and of the losses returned. A parameter of the
    optimizer that the loss does not reach counts as a zero gradient on
    every process; frozen parameters are outside the optimizer and the
    reduction.

    With a ``mesh`` (``parallel.mesh.make_mesh``) whose view axis splits
    the batch's views (``shard_batch``; the model pointed at it by
    ``use_mesh``), the gradients of the 2D branch (the ``view_branch`` of
    each module with one), each of its own views, are first summed over
    the view axis, and every mean is taken over the data axis alone (the
    processes of a view group hold the same rows).

    Under a profiler the step is the span ``es.step`` around its phases
    ``es.fwd`` (the losses and their sum), ``es.bwd`` and ``es.optim``
    (the reductions, the clip and AdamW, the losses stacked;
    ``utils.trace``)."""
    from ..parallel.multihost import pmean_, psum_
    group = None if mesh is None else mesh.data_group
    with span('es.step'):
        optimizer.zero_grad(set_to_none=True)
        with span('es.fwd'):
            losses = model(batch, mode='loss')
            total = sum(losses.values())
        with span('es.bwd'):
            total.backward()
        with span('es.optim'):
            params = [p for g in optimizer.param_groups for p in g['params']]
            for p in params:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            if mesh is not None and mesh.view_group is not None:
                ids = {id(p) for p in params}
                view = [p.grad for mod in model.modules()
                        for sub in getattr(mod, 'view_branch', ())
                        for p in sub.parameters() if id(p) in ids]
                psum_(view, mesh.view_group)
            pmean_([p.grad for p in params], group)
            optimizer.step()
            with torch.no_grad():
                pmean_([b for b in model.buffers() if b.is_floating_point()],
                       group)
            metrics = dict(losses, loss_total=total)
            vals = torch.stack([v.detach() for v in metrics.values()])
            pmean_([vals], group)
    return dict(zip(metrics, vals.unbind()))
