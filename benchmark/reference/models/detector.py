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
