"""2D image backbone: mmdet-style ResNet with frozen BN (port of
``embodiedscan_tpu/models/resnet2d.py``).

The public :class:`ResNet` takes and returns NHWC tensors like the reference;
inside, convolutions run on the NCHW view of channels-last memory, so the
layout changes cost no copy. Submodule names follow the flax auto-names
(``stem_conv``, ``layer1_0``, ``Conv_0``, ``FrozenBatchNorm_0``, ...).
"""

import torch
from torch import nn
from torch.nn import functional as F

from ..utils.trace import span
from .norm import FrozenBatchNorm
from .remat import checkpointed


def _conv(cin, cout, k, stride=1):
    # flax 'SAME'/explicit padding of the reference == (k - 1) // 2 here
    return nn.Conv2d(cin, cout, k, stride=stride, padding=(k - 1) // 2,
                     bias=False)


class Bottleneck(nn.Module):
    """ResNet Bottleneck ('pytorch' style: stride on the 3x3 conv)."""

    expansion = 4

    def __init__(self, cin: int, planes: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        cout = planes * self.expansion
        self.Conv_0 = _conv(cin, planes, 1)
        self.FrozenBatchNorm_0 = FrozenBatchNorm(planes)
        self.Conv_1 = _conv(planes, planes, 3, stride)
        self.FrozenBatchNorm_1 = FrozenBatchNorm(planes)
        self.Conv_2 = _conv(planes, cout, 1)
        self.FrozenBatchNorm_2 = FrozenBatchNorm(cout)
        self.has_down = stride != 1 or cin != cout
        if self.has_down:
            self.Conv_3 = _conv(cin, cout, 1, stride)
            self.FrozenBatchNorm_3 = FrozenBatchNorm(cout)

    def forward(self, x):
        out = F.relu(self.FrozenBatchNorm_0(_run(self.Conv_0, x, self.dtype)))
        out = F.relu(self.FrozenBatchNorm_1(_run(self.Conv_1, out, self.dtype)))
        out = self.FrozenBatchNorm_2(_run(self.Conv_2, out, self.dtype))
        identity = x
        if self.has_down:
            identity = self.FrozenBatchNorm_3(_run(self.Conv_3, x, self.dtype))
        return F.relu(out + identity)


class BasicBlock2d(nn.Module):
    """ResNet BasicBlock for depth 18/34."""

    expansion = 1

    def __init__(self, cin: int, planes: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.Conv_0 = _conv(cin, planes, 3, stride)
        self.FrozenBatchNorm_0 = FrozenBatchNorm(planes)
        self.Conv_1 = _conv(planes, planes, 3)
        self.FrozenBatchNorm_1 = FrozenBatchNorm(planes)
        self.has_down = stride != 1 or cin != planes
        if self.has_down:
            self.Conv_2 = _conv(cin, planes, 1, stride)
            self.FrozenBatchNorm_2 = FrozenBatchNorm(planes)

    def forward(self, x):
        out = F.relu(self.FrozenBatchNorm_0(_run(self.Conv_0, x, self.dtype)))
        out = self.FrozenBatchNorm_1(_run(self.Conv_1, out, self.dtype))
        identity = x
        if self.has_down:
            identity = self.FrozenBatchNorm_2(_run(self.Conv_2, x, self.dtype))
        return F.relu(out + identity)


def _run(conv: nn.Conv2d, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Convolution in the image branch's compute dtype (weights cast too)."""
    return F.conv2d(x.to(dtype), conv.weight.to(dtype), None, conv.stride,
                    conv.padding)


class ResNet(nn.Module):
    """mmdet-style ResNet returning multi-scale NHWC features."""

    arch = {
        18: (BasicBlock2d, (2, 2, 2, 2)),
        34: (BasicBlock2d, (3, 4, 6, 3)),
        50: (Bottleneck, (3, 4, 6, 3)),
        101: (Bottleneck, (3, 4, 23, 3)),
    }

    def __init__(self, depth: int = 50, base_channels: int = 16,
                 out_indices=(0, 1, 2, 3), dtype: torch.dtype = torch.float32,
                 remat: bool = False):
        super().__init__()
        block, stage_blocks = self.arch[depth]
        self.dtype = dtype
        # recompute each block's activations in the backward pass (the
        # reference's remat, resnet2d.py:177-194); names are unchanged
        self.remat = remat
        self.out_indices = tuple(out_indices)
        self.stage_blocks = stage_blocks
        self.stem_conv = nn.Conv2d(3, base_channels, 7, stride=2, padding=3,
                                   bias=False)
        self.stem_bn = FrozenBatchNorm(base_channels)
        cin = base_channels
        for i, blocks in enumerate(stage_blocks):
            planes = base_channels * 2**i
            for j in range(blocks):
                stride = 2 if (i > 0 and j == 0) else 1
                self.add_module(f'layer{i + 1}_{j}',
                                block(cin, planes, stride, dtype))
                cin = planes * block.expansion

    def forward(self, x: torch.Tensor):
        """(N, H, W, 3) -> tuple of (N, Hs, Ws, Cs) maps at strides 4..32."""
        with span('es.resnet2d'):
            x = x.permute(0, 3, 1, 2).contiguous(
                memory_format=torch.channels_last)
            x = F.relu(self.stem_bn(_run(self.stem_conv, x, self.dtype)))
            x = F.max_pool2d(x, 3, 2, 1)
            outs = []
            for i, blocks in enumerate(self.stage_blocks):
                for j in range(blocks):
                    block = getattr(self, f'layer{i + 1}_{j}')
                    x = checkpointed(block, x) if self.remat else block(x)
                if i in self.out_indices:
                    outs.append(x.permute(0, 2, 3, 1))
            return tuple(outs)
