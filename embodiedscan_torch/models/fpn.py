"""2D FPN (mmdet.FPN) of the occupancy image branch (port of
``embodiedscan_tpu/models/fpn.py``).

Takes and returns NHWC maps, as the port's ResNet gives them; the convs run
on their NCHW views. Submodules keep the flax names ``lateral{i}`` and
``fpn{i}``.
"""

from typing import Sequence

import torch
from torch import nn
from torch.nn import functional as F

from ..utils.trace import span


class FPN(nn.Module):
    """Lateral 1x1 convs + top-down nearest upsampling + 3x3 output convs."""

    def __init__(self, in_channels: Sequence[int], out_channels: int = 256):
        super().__init__()
        for i, c in enumerate(in_channels):
            self.add_module(f'lateral{i}', nn.Conv2d(c, out_channels, 1))
            self.add_module(f'fpn{i}', nn.Conv2d(out_channels, out_channels,
                                                 3, padding=1))

    def forward(self, inputs: Sequence[torch.Tensor], levels: int = None):
        """(N, Hi, Wi, Ci) maps, finest first -> the first ``levels``
        (default: all) (N, Hi, Wi, out_channels) outputs. The occupancy
        model reads only the finest; the reference computes all four and
        leaves the unread ones to XLA's dead-code elimination."""
        with span('es.resnet2d'):
            laterals = [getattr(self, f'lateral{i}')(x.permute(0, 3, 1, 2))
                        for i, x in enumerate(inputs)]
            for i in range(len(laterals) - 1, 0, -1):
                # half-pixel centres, as jax.image.resize(method='nearest')
                up = F.interpolate(laterals[i],
                                   size=laterals[i - 1].shape[2:],
                                   mode='nearest-exact')
                laterals[i - 1] = laterals[i - 1] + up
            return tuple(getattr(self, f'fpn{i}')(laterals[i]).permute(
                0, 2, 3, 1) for i in range(levels or len(laterals)))
