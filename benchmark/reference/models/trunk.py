"""Shared multi-modal trunk: points + images -> fused multi-scale sparse
features (port of ``embodiedscan_tpu/models/trunk.py``)."""

import torch
from torch import nn

from ..ops import sparse as S
from .fusion import point_image_sample_batched
from .remat import covers
from .resnet2d import ResNet
from .sparse_nn import MinkResNet

STRIDES = (8, 16, 32, 64)


def mink_channels(depth: int) -> tuple:
    """Per-stage output channels of MinkResNet (x4 for Bottleneck depths)."""
    expansion = 4 if depth >= 50 else 1
    return tuple(64 * 2**i * expansion for i in range(4))


def resnet2d_channels(depth: int) -> tuple:
    expansion = 4 if depth >= 50 else 1
    return tuple(16 * 2**i * expansion for i in range(4))


class SparseFusionTrunk(nn.Module):
    """Voxelize points, run the 3D and 2D backbones, fuse image features per
    voxel. ``view_group``: the process group over which the batch's views
    are split (``parallel.mesh.use_mesh``), else None; ``view_branch``: the
    submodules upstream of the sum over views, each process's gradients of
    which are of its own views alone. ``remat``: 'none', '2d' (the ResNet's
    blocks), '3d' (the MinkResNet's stages) or 'all' (``models.remat``)."""

    def __init__(self, voxel_size: float = 0.01, input_capacity: int = 98304,
                 backbone_capacities=(65536, 32768, 24576, 8192, 4096, 2048),
                 resnet_depth: int = 50, mink_depth: int = 34,
                 img_dtype: torch.dtype = torch.float32,
                 remat: bool | str = 'none'):
        super().__init__()
        self.voxel_size = voxel_size
        self.input_capacity = input_capacity
        self.img_dtype = img_dtype
        self.view_group = None
        self.MinkResNet_0 = MinkResNet(depth=mink_depth,
                                       capacities=tuple(backbone_capacities),
                                       remat=covers(remat, '3d'))
        self.ResNet_0 = ResNet(depth=resnet_depth, base_channels=16,
                               dtype=img_dtype, remat=covers(remat, '2d'))
        self.view_branch = (self.ResNet_0,)
        self.out_channels = tuple(
            c3 + c2 for c3, c2 in zip(mink_channels(mink_depth),
                                      resnet2d_channels(resnet_depth)))

    def forward(self, batch: dict):
        pts = batch['points']
        pmask = batch['points_mask']
        # xyz are also the input features (use_xyz_feat)
        st = S.from_points_b(pts, pts, pmask, self.voxel_size,
                             self.input_capacity)
        levels = self.MinkResNet_0(st)

        imgs = batch['imgs'].to(self.img_dtype)
        bi, v, h, w, _ = imgs.shape
        b = pts.shape[0]
        if b % bi:
            raise ValueError(f'points batch {b} is not a multiple of the '
                             f'image batch {bi}')
        s = b // bi
        feats2d = self.ResNet_0(imgs.reshape(bi * v, h, w, 3))
        view_mask = batch.get('view_mask')
        if view_mask is None:
            view_mask = torch.ones((b, v), dtype=torch.bool, device=pts.device)
        fused = []
        for i, lvl in enumerate(levels):
            f2d = feats2d[i]
            hf, wf, c2 = f2d.shape[1:]
            f2d = f2d.reshape(bi, v, hf, wf, c2)
            world = lvl.coords.to(torch.float32) * (STRIDES[i] *
                                                    self.voxel_size)
            n = world.shape[1]
            img_feat = point_image_sample_batched(
                world.reshape(bi, s, n, 3), lvl.mask.reshape(bi, s, n), f2d,
                batch['proj'], batch['aug_inv'], (h, w), 'nearest',
                view_mask.reshape(bi, s, v), self.view_group)
            img_feat = img_feat.reshape(b, n, -1)
            fused.append(S.SparseTensor(
                lvl.coords, torch.cat([lvl.feats, img_feat], dim=-1),
                lvl.mask))
        return fused
