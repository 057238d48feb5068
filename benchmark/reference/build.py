"""The benchmark's plain reference: the training step's loss, clip and
AdamW in plain tensor operations, over a model of this folder's frozen
modules that the cell's task file (``benchmark/tasks/<task>.py``) builds.
Imports nothing of the program."""

import torch


def plain_float32():
    """Matrix products and convolutions in float32 (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class PlainAdamW:
    """Per-group global-norm clip, then AdamW (betas 0.9 / 0.999, eps 1e-8,
    decoupled weight decay), in plain tensor operations. A trained
    parameter the loss does not reach takes a zero gradient."""

    def __init__(self, named_params, lr, weight_decay, clip_norm,
                 betas=(0.9, 0.999), eps=1e-8):
        self.params = [(n, p) for n, p in named_params]
        self.lr, self.wd, self.clip = lr, weight_decay, clip_norm
        self.b1, self.b2 = betas
        self.eps = eps
        self.count = 0
        self.m = {n: torch.zeros_like(p) for n, p in self.params}
        self.v = {n: torch.zeros_like(p) for n, p in self.params}

    @torch.no_grad()
    def clipped_grads(self) -> dict:
        grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
                 for n, p in self.params}
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in
                              grads.values())).float()
        scale = torch.clamp(self.clip / norm, max=1.0)
        return {n: g * scale for n, g in grads.items()}

    @torch.no_grad()
    def step(self, grads: dict) -> None:
        self.count += 1
        c1 = 1 - self.b1 ** self.count
        c2 = 1 - self.b2 ** self.count
        for n, p in self.params:
            g = grads[n]
            m, v = self.m[n], self.v[n]
            m.mul_(self.b1).add_(g * (1 - self.b1))
            v.mul_(self.b2).add_(g * g * (1 - self.b2))
            upd = (m / c1) / (torch.sqrt(v / c2) + self.eps)
            p.sub_(self.lr * (upd + self.wd * p))


def train_step(model, opt: PlainAdamW, batch: dict):
    """One step: the loss terms, backward, clip, AdamW. Returns (the loss
    terms as floats, the clipped gradients)."""
    for _, p in opt.params:
        p.grad = None
    losses = model(batch, mode='loss')
    sum(losses.values()).backward()
    grads = opt.clipped_grads()
    opt.step(grads)
    return {k: float(v.detach()) for k, v in losses.items()}, grads
