"""Multi-view sparse-fusion 3D detector (port of
``embodiedscan_tpu/models/detector.py``).

Batch layout (static shapes, tensors on the model's device):
    points:      (B, P, 3) world-frame xyz (also the input features)
    points_mask: (B, P) bool
    imgs:        (B, V, H, W, 3) normalized images
    proj:        (B, V, 4, 4) intrinsic @ extrinsic per view
    aug_inv:     (B, 4, 4) inverse 3D augmentation (identity at test time)
    gt_boxes/gt_labels/gt_mask: (B, G, 9)/(B, G)/(B, G) padded ground
                 truth (mode='loss' only)
"""

import math

import torch
from torch import nn

from .fcaf3d import _CLS_BIAS, FCAF3DHead
from .grounding import MinkNeck, RegBranch
from .sparse_nn import SparseConv
from .trunk import STRIDES, SparseFusionTrunk


class SparseFusionDetector(nn.Module):
    """Embodied Perceptron: multi-view 3D detection variant."""

    def __init__(self, num_classes: int = 284, voxel_size: float = 0.01,
                 input_capacity: int = 98304,
                 backbone_capacities=(65536, 32768, 24576, 8192, 4096, 2048),
                 fpn_capacities=(24576, 8192, 4096, 2048), max_dets: int = 256,
                 nms_pre: int = 1000, max_candidates: int = 1024,
                 resnet_depth: int = 50, mink_depth: int = 34,
                 img_dtype: torch.dtype = torch.float32,
                 bbox_mode: str = 'euler9d',
                 predict_protocol: str = 'reference',
                 remat: bool | str = 'none'):
        super().__init__()
        self.trunk = SparseFusionTrunk(
            voxel_size=voxel_size, input_capacity=input_capacity,
            backbone_capacities=tuple(backbone_capacities),
            resnet_depth=resnet_depth, mink_depth=mink_depth,
            img_dtype=img_dtype, remat=remat)
        self.bbox_head = FCAF3DHead(
            num_classes=num_classes, in_channels=self.trunk.out_channels,
            voxel_size=voxel_size, strides=STRIDES,
            fpn_capacities=tuple(fpn_capacities), nms_pre=nms_pre,
            max_candidates=max_candidates, max_dets=max_dets,
            bbox_mode=bbox_mode, predict_protocol=predict_protocol)

    def forward(self, batch: dict, mode: str = 'predict'):
        """``'loss'`` (with autograd; needs gt_boxes, gt_labels, gt_mask)
        returns {loss_center, loss_bbox, loss_cls}; ``'feats'`` and
        ``'predict'`` run without autograd."""
        if mode == 'loss':
            outs = self.bbox_head(self.trunk(batch))
            return self.bbox_head.loss(outs, batch['gt_boxes'],
                                       batch['gt_labels'], batch['gt_mask'])
        if mode not in ('feats', 'predict'):
            raise ValueError(f'unknown mode {mode!r}')
        with torch.no_grad():
            outs = self.bbox_head(self.trunk(batch))
            if mode == 'feats':
                return outs
            return self.bbox_head.predict(outs)


def _normal_(t: torch.Tensor, std: float, g: torch.Generator) -> None:
    with torch.no_grad():
        t.copy_(torch.randn(t.shape, generator=g) * std)


def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded initialization in the reference's spirit (He fan-out normal for
    sparse kernels, sparse 1x1 layers and dense layers, zero dense biases
    as flax's, LeCun normal with zero biases for the 2D and 3D convs and
    transposed convs, N(0, 0.02) embeddings as
    HF RoBERTa's, N(0, 0.01) head projections with the prior-probability
    class bias, the grounder's box branch at zero weights and bias
    [0, 0, -2, ...]). Norm layers keep their identity statistics. Runs on
    CPU tensors."""
    for mod in model.modules():
        if isinstance(mod, SparseConv):
            k, _, cout = mod.kernel.shape
            _normal_(mod.kernel, math.sqrt(2.0 / (k * cout)), generator)
        elif isinstance(mod, nn.Linear):
            _normal_(mod.weight, math.sqrt(2.0 / mod.out_features), generator)
            if mod.bias is not None:
                nn.init.zeros_(mod.bias)
        elif isinstance(mod, (nn.Conv2d, nn.Conv3d, nn.ConvTranspose3d)):
            # fan-in over (in, kernel): a ConvTranspose3d keeps (in, out,
            # kernel), a conv (out, in, kernel)
            w = mod.weight
            fan_in = w.shape[0] * w[0, 0].numel() if isinstance(
                mod, nn.ConvTranspose3d) else w[0].numel()
            _normal_(w, math.sqrt(1.0 / fan_in), generator)
            if mod.bias is not None:
                nn.init.zeros_(mod.bias)
        elif isinstance(mod, nn.Embedding):
            _normal_(mod.weight, 0.02, generator)
        for name, p in mod.named_parameters(recurse=False):
            if name.endswith('_tconv'):
                _normal_(p, math.sqrt(2.0 / (8 * p.shape[-1])), generator)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, FCAF3DHead):
                for lin in (mod.conv_center, mod.conv_reg, mod.conv_cls):
                    _normal_(lin.weight, 0.01, generator)
                mod.conv_cls.bias.fill_(_CLS_BIAS)
            elif isinstance(mod, MinkNeck):
                _normal_(mod.conv_cls.weight, 0.01, generator)
                mod.conv_cls.bias.fill_(_CLS_BIAS)
            elif isinstance(mod, RegBranch):
                mod.out.weight.zero_()
                mod.out.bias.fill_(-2.0)
                mod.out.bias[:2] = 0.0
    return model
