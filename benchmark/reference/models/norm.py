"""Masked normalization layers for sparse voxel features, the frozen 2D
BatchNorm (port of ``embodiedscan_tpu/models/norm.py``) and flax's dense
BatchNorm of the occupancy U-Net (``DenseBatchNorm``).

Parameter and buffer names (``scale``, ``bias``, ``mean``, ``var``) follow the
reference's flax leaves, so weights carry over leaf for leaf.
``MaskedBatchNorm`` normalizes with batch statistics in training mode and
with its running statistics in eval mode; ``FrozenBatchNorm`` always uses
its loaded statistics, while its ``scale`` and ``bias`` are parameters that
a train step updates, as in the reference.
"""

import torch
from torch import nn

from .remat import recomputing


def _running_update(norm: nn.Module, mean: torch.Tensor,
                    var: torch.Tensor) -> None:
    """The running statistics' momentum update, once per forward: a
    rematerialized forward's recompute (``remat.recomputing``) skips it."""
    if recomputing():
        return
    with torch.no_grad():
        norm.mean.mul_(norm.MOMENTUM).add_((1 - norm.MOMENTUM) * mean)
        norm.var.mul_(norm.MOMENTUM).add_((1 - norm.MOMENTUM) * var)


class MaskedBatchNorm(nn.Module):
    """BatchNorm over (B, N, C) masked features: batch statistics over the
    valid rows in training mode (updating the running ones), the running
    statistics in eval mode."""

    MOMENTUM = 0.9  # flax's: running <- 0.9 * running + 0.1 * batch

    def __init__(self, channels: int, epsilon: float = 1e-5):
        super().__init__()
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer('mean', torch.zeros(channels))
        self.register_buffer('var', torch.ones(channels))

    def forward(self, feats: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        mean, var = self.mean, self.var
        if self.training:
            # batch statistics over every valid row of the (B, N, C) tensor,
            # biased variance; the running update is flax's momentum 0.9
            m = mask[..., None].to(torch.float32)
            cnt = torch.clamp(m.sum(), min=1.0)
            f32 = feats.to(torch.float32)
            dims = tuple(range(f32.dim() - 1))
            mean = (f32 * m).sum(dim=dims) / cnt
            var = (torch.square(f32 - mean) * m).sum(dim=dims) / cnt
            _running_update(self, mean, var)
        out = (feats - mean) * torch.rsqrt(var + self.epsilon)
        out = out * self.scale + self.bias
        return torch.where(mask[..., None], out,
                           torch.zeros_like(out)).to(feats.dtype)


class MaskedInstanceNorm(nn.Module):
    """Per-sample, per-channel normalization over the valid voxels."""

    def __init__(self, channels: int, epsilon: float = 1e-5):
        super().__init__()
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, feats: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        m = mask[..., None].to(torch.float32)
        f32 = feats.to(torch.float32)
        cnt = torch.clamp(m.sum(dim=-2, keepdim=True), min=1.0)
        mean = (f32 * m).sum(dim=-2, keepdim=True) / cnt
        var = (torch.square(f32 - mean) * m).sum(dim=-2, keepdim=True) / cnt
        out = (f32 - mean) * torch.rsqrt(var + self.epsilon)
        out = out * self.scale + self.bias
        return torch.where(mask[..., None], out,
                           torch.zeros_like(out)).to(feats.dtype)


class DenseBatchNorm(nn.Module):
    """flax's default ``nn.BatchNorm`` over (N, C, ...) volumes: in training
    mode the batch statistics over every axis but C, with the variance as
    max(0, E[x^2] - E[x]^2) (``use_fast_variance``, biased) and the running
    update at momentum 0.99; the running statistics in eval mode.
    (``torch.nn.BatchNorm3d`` updates at 0.9 with the unbiased variance.)
    A bfloat16 input is normalized as flax's ``BatchNorm(dtype=bfloat16)``:
    statistics and arithmetic in float32, the result rounded to bfloat16."""

    MOMENTUM = 0.99

    def __init__(self, channels: int, epsilon: float = 1e-5):
        super().__init__()
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer('mean', torch.zeros(channels))
        self.register_buffer('var', torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = (1, -1) + (1, ) * (x.dim() - 2)
        mean, var = self.mean, self.var
        if self.training:
            dims = (0, ) + tuple(range(2, x.dim()))
            xf = x.to(torch.float32)
            mean = xf.mean(dim=dims)
            var = torch.maximum(xf.square().mean(dim=dims) - mean.square(),
                                torch.zeros_like(mean))
            _running_update(self, mean, var)
        mul = torch.rsqrt(var + self.epsilon) * self.scale
        out = (x - mean.view(shape)) * mul.view(shape) + self.bias.view(shape)
        return out.to(x.dtype)


class FrozenBatchNorm(nn.Module):
    """Inference BatchNorm with loaded statistics over NCHW maps; computes in
    float32 and returns the input's dtype."""

    def __init__(self, channels: int, epsilon: float = 1e-5):
        super().__init__()
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer('mean', torch.zeros(channels))
        self.register_buffer('var', torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = (1, -1, 1, 1)
        out = (x.float() - self.mean.view(shape)) * torch.rsqrt(
            self.var.view(shape) + self.epsilon)
        return (out * self.scale.view(shape) +
                self.bias.view(shape)).to(x.dtype)
