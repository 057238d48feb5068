"""Semantic occupancy, multi-view and continuous (port of
``embodiedscan_tpu/models/occupancy.py``).

- ``ImVoxelNeck``: the reference's 3-scale dense 3D residual U-Net
  (IndoorImVoxelNeck), ``nn.Conv3d`` / ``nn.ConvTranspose3d`` (cuDNN on the
  card) with flax's BatchNorm (``norm.DenseBatchNorm``).
- ``OccHead``: a 1x1x1 classifier per scale; the loss sums cross-entropy
  and the geometric and semantic scene-class affinity losses over three
  scales at weights 0.5^i; predict is the argmax at the finest scale.
- ``DenseFusionOccPredictor``: image features sampled at the prior
  voxel-centre grid, concatenated with the sparse point branch
  (MinkResNet on kernels K1 and K2, densified at stride 64). The
  continuous variant (cont_occ) is the same network over a sweep
  pseudo-batch (``data.pipeline.pack_sweeps``), its U-Net in bfloat16
  (``neck_dtype``).

Volumes enter and leave as (B, X, Y, Z, C), as the reference's; inside the
U-Net they are (B, C, X, Y, Z), so X, Y and Z are ``Conv3d``'s D, H and W.
Submodules keep the flax names (``down_{i}_{j}``, ``up_{i}_t``,
``up_{i}_c``, ``out_{i}_c``, ``Conv_k`` / ``BatchNorm_k`` in call order).
"""

from typing import Sequence, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from ..ops import sparse as S
from ..utils.trace import span
from .anchors import AlignedAnchor3DRangeGenerator
from .fpn import FPN
from .fusion import point_image_sample_batched
from .losses import cross_entropy_ignore
from .norm import DenseBatchNorm
from .remat import checkpointed, covers
from .resnet2d import ResNet
from .sparse_nn import MinkResNet
from .trunk import mink_channels


def _conv3(cin, cout, stride=1):
    return nn.Conv3d(cin, cout, 3, stride=stride, padding=1, bias=False)


def _conv(mod, x):
    """``mod(x)`` (a bias-free ``nn.Conv3d`` or ``nn.ConvTranspose3d``)
    computed in ``x``'s dtype: the float32 weight is cast to it, as flax's
    ``Conv(dtype=...)``."""
    w = mod.weight.to(x.dtype)
    if isinstance(mod, nn.ConvTranspose3d):
        return F.conv_transpose3d(x, w, None, mod.stride, mod.padding,
                                  mod.output_padding, mod.groups,
                                  mod.dilation)
    return F.conv3d(x, w, None, mod.stride, mod.padding, mod.dilation,
                    mod.groups)


class ResBlock3D(nn.Module):
    """Conv3d-BN-ReLU-Conv3d-BN + identity (a strided 1x1x1 conv and BN
    where the shape changes), ReLU (imvoxel_neck.py:111-144), in the
    input's dtype."""

    def __init__(self, in_channels: int, features: int, stride: int = 1):
        super().__init__()
        self.Conv_0 = _conv3(in_channels, features, stride)
        self.BatchNorm_0 = DenseBatchNorm(features)
        self.Conv_1 = _conv3(features, features)
        self.BatchNorm_1 = DenseBatchNorm(features)
        self.has_down = stride != 1 or in_channels != features
        if self.has_down:
            self.Conv_2 = nn.Conv3d(in_channels, features, 1, stride=stride,
                                    bias=False)
            self.BatchNorm_2 = DenseBatchNorm(features)

    def forward(self, x):
        out = F.relu(self.BatchNorm_0(_conv(self.Conv_0, x)))
        out = self.BatchNorm_1(_conv(self.Conv_1, out))
        identity = self.BatchNorm_2(_conv(self.Conv_2, x)) \
            if self.has_down else x
        return F.relu(out + identity)


class ImVoxelNeck(nn.Module):
    """Dense 3D encoder-decoder U-Net (reference IndoorImVoxelNeck): each
    scale past the first halves the grid and doubles the channels; the
    decoder goes back up by a k2 s2 transposed conv + BN + ReLU + conv3 +
    BN + ReLU and adds the encoder's output; each scale ends in conv3 + BN
    + ReLU to ``out_channels``. Returns the scales finest first, in the
    input's dtype.

    ``dtype`` is the compute dtype (flax's ``dtype=``): the input is cast to
    it, the convs run in it on float32 weights, the batch norms compute in
    float32 and round to it (``norm.DenseBatchNorm``)."""

    def __init__(self, in_channels: int, out_channels: int = 128,
                 n_blocks: Sequence[int] = (1, 1, 1),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.n_blocks = tuple(n_blocks)
        chans, c = [], in_channels
        for i, blocks in enumerate(self.n_blocks):
            for j in range(blocks):
                stride = 2 if (i > 0 and j == 0) else 1
                self.add_module(f'down_{i}_{j}',
                                ResBlock3D(c, c * stride, stride))
                c *= stride
            chans.append(c)
        # flax numbers the neck's own BatchNorms in call order: out_2, then
        # up_2_t, up_2_c, out_1, then up_1_t, up_1_c, out_0
        k = 0
        for i in range(len(self.n_blocks) - 1, -1, -1):
            if i < len(self.n_blocks) - 1:
                self.add_module(f'up_{i + 1}_t', nn.ConvTranspose3d(
                    chans[i + 1], chans[i], 2, stride=2, bias=False))
                self.add_module(f'BatchNorm_{k}', DenseBatchNorm(chans[i]))
                self.add_module(f'up_{i + 1}_c', _conv3(chans[i], chans[i]))
                self.add_module(f'BatchNorm_{k + 1}',
                                DenseBatchNorm(chans[i]))
                k += 2
            self.add_module(f'out_{i}_c', _conv3(chans[i], out_channels))
            self.add_module(f'BatchNorm_{k}', DenseBatchNorm(out_channels))
            k += 1

    def forward(self, x: torch.Tensor):
        with span('es.unet'):
            out_dtype = x.dtype
            x = x.to(self.dtype)
            down = []
            for i, blocks in enumerate(self.n_blocks):
                for j in range(blocks):
                    x = getattr(self, f'down_{i}_{j}')(x)
                down.append(x)
            outs, k = [], 0
            for i in range(len(self.n_blocks) - 1, -1, -1):
                if i < len(self.n_blocks) - 1:
                    x = _conv(getattr(self, f'up_{i + 1}_t'), x)
                    x = F.relu(getattr(self, f'BatchNorm_{k}')(x))
                    x = _conv(getattr(self, f'up_{i + 1}_c'), x)
                    x = F.relu(getattr(self, f'BatchNorm_{k + 1}')(x))
                    x = down[i] + x
                    k += 2
                out = _conv(getattr(self, f'out_{i}_c'), x)
                outs.append(F.relu(getattr(self, f'BatchNorm_{k}')(out)).to(
                    out_dtype))
                k += 1
            return outs[::-1]


def occ_multiscale_targets(gt_occ: torch.Tensor, gt_mask: torch.Tensor,
                           ratio: int, shape: Tuple[int, int, int],
                           visible_mask: torch.Tensor | None = None
                           ) -> torch.Tensor:
    """Scatter padded sparse (B, M, 4) xyz + label ground truth into
    (B, X, Y, Z) label grids at 1/``ratio`` (occ_loss.py:7): 0 = empty,
    255 = not visible. Where several voxels fall into one cell the largest
    label wins; masked and out-of-grid rows are dropped."""
    gx, gy, gz = shape
    b, m = gt_mask.shape
    cells = gx * gy * gz
    coords = torch.div(gt_occ[..., :3].to(torch.int32), ratio,
                       rounding_mode='floor').long()
    labels = gt_occ[..., 3].to(torch.int32)
    inb = gt_mask & (coords >= 0).all(-1) & (coords[..., 0] < gx) & \
        (coords[..., 1] < gy) & (coords[..., 2] < gz)
    flat = (coords[..., 0] * gy + coords[..., 1]) * gz + coords[..., 2] + \
        torch.arange(b, device=coords.device)[:, None] * cells
    flat = torch.where(inb, flat, torch.full_like(flat, b * cells))
    grid = torch.zeros(b * cells + 1, dtype=torch.int32,
                       device=coords.device).scatter_reduce(
        0, flat.reshape(-1),
        torch.where(inb, labels, torch.zeros_like(labels)).reshape(-1),
        'amax')
    grid = grid[:-1].reshape(b, gx, gy, gz)
    if visible_mask is not None:
        grid = torch.where(visible_mask, grid, torch.full_like(grid, 255))
    return grid


def _bce_scalar(p):
    """BCE(p, 1) of a probability: -log(clip(p, 1e-6, 1)); minimum and
    maximum split a gradient at a tie, as ``jnp.clip``."""
    return -torch.log(torch.minimum(torch.maximum(p, p.new_tensor(1e-6)),
                                    p.new_tensor(1.0)))


def geo_scal_loss(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Geometric scene-class affinity loss (occ_loss.py:39-80): precision,
    recall and specificity of occupied-vs-empty over the known voxels."""
    probs = torch.softmax(logits, dim=-1)
    empty = probs[..., 0]
    nonempty = 1 - empty
    zero = torch.zeros_like(empty)
    known = target != 255
    tgt_nonempty = (target != 0) & known
    eps = 1e-6
    inter = torch.where(tgt_nonempty, nonempty, zero).sum()
    precision = inter / (torch.where(known, nonempty, zero).sum() + eps)
    recall = inter / (tgt_nonempty.sum() + eps)
    tgt_empty = (target == 0) & known
    spec = torch.where(tgt_empty, empty, zero).sum() / (tgt_empty.sum() + eps)
    return _bce_scalar(precision) + _bce_scalar(recall) + _bce_scalar(spec)


def sem_scal_loss(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Semantic scene-class affinity loss (occ_loss.py:82-139) over the
    known voxels, averaged over the classes with positives."""
    c = logits.shape[-1]
    flatp = torch.softmax(logits, dim=-1).reshape(-1, c)
    flatt = target.reshape(-1)
    flatk = (flatt != 255)
    onehot = (flatt[:, None] == torch.arange(c, device=flatt.device)) & \
        flatk[:, None]
    p = torch.where(flatk[:, None], flatp, torch.zeros_like(flatp))
    cnt_pos = onehot.sum(0).to(torch.float32)
    nominator = (p * onehot).sum(0)
    sum_p = p.sum(0)
    cnt_neg = flatk.sum() - cnt_pos
    tiny = p.new_tensor(1e-12)
    precision = nominator / torch.maximum(sum_p, tiny)
    recall = nominator / torch.maximum(cnt_pos, tiny)
    spec = ((1 - p) * (~onehot & flatk[:, None])).sum(0) / \
        torch.maximum(cnt_neg, tiny)
    zero = torch.zeros_like(sum_p)
    loss_c = torch.where(sum_p > 0, _bce_scalar(precision), zero) + \
        torch.where(cnt_pos > 0, _bce_scalar(recall), zero) + \
        torch.where(cnt_neg > 0, _bce_scalar(spec), zero)
    active = cnt_pos > 0
    return torch.where(active, loss_c, zero).sum() / torch.clamp(
        active.sum(), min=1)


class OccHead(nn.Module):
    """Per-scale 1x1x1 occupancy classifier (reference ImVoxelOccHead)."""

    def __init__(self, in_channels: int, num_classes: int = 81,
                 n_scales: int = 3):
        super().__init__()
        self.n_scales = n_scales
        for i in range(n_scales):
            self.add_module(f'occ{i}', nn.Linear(in_channels, num_classes,
                                                 bias=False))

    def forward(self, mlvl_feats):
        return [getattr(self, f'occ{i}')(f) for i, f in enumerate(mlvl_feats)]

    def loss(self, occ_preds, gt_occ, gt_occ_mask, visible_masks=None):
        """{loss_occ_i}: CE + semantic + geometric affinity at scale 2^i
        (imvoxel_occ_head.py:110-185), weighted 0.5^i; the visibility is
        max-pooled to each scale."""
        losses = {}
        for i, pred in enumerate(occ_preds):
            ratio = 2**i
            vis = visible_masks
            if vis is not None and ratio > 1:
                vis = F.max_pool3d(vis[:, None].to(torch.float32),
                                   ratio)[:, 0] > 0
            tgt = occ_multiscale_targets(gt_occ, gt_occ_mask, ratio,
                                         tuple(pred.shape[1:4]), vis)
            loss_i = cross_entropy_ignore(pred, tgt, 255) + \
                sem_scal_loss(pred, tgt) + geo_scal_loss(pred, tgt)
            losses[f'loss_occ_{i}'] = loss_i * (0.5**i)
        return losses

    @staticmethod
    def predict(occ_preds):
        """Argmax at the finest scale (imvoxel_occ_head.py:90-108): (B, X,
        Y, Z) class ids; ties go to the lowest id, as ``jnp.argmax``."""
        return torch.argmax(occ_preds[0], dim=-1)


class DenseFusionOccPredictor(nn.Module):
    """Embodied Perceptron, multi-view semantic occupancy variant.

    Batch: the detector's keys (``points``, ``points_mask``, ``imgs``,
    ``proj``, ``aug_inv``, optional ``view_mask``); ``mode='loss'`` also
    ``gt_occ`` (B, M, 4) xyz + label in prior-grid cells, ``gt_occ_mask``
    (B, M) and optional ``visible_mask`` (B, X, Y, Z) bool.
    """

    def __init__(self, num_classes: int = 81,
                 n_voxels: Tuple[int, int, int] = (40, 40, 16),
                 point_cloud_range=(-3.2, -3.2, -0.78, 3.2, 3.2, 1.78),
                 prior_range=(-3.2, -3.2, -1.28, 3.2, 3.2, 1.28),
                 prior_origin=(0.0, 0.0, 0.5), input_capacity: int = 65536,
                 backbone_capacities=(49152, 32768, 24576, 8192, 4096, 2048),
                 resnet_depth: int = 50, resnet_base_channels: int = 64,
                 mink_depth: int = 34, neck3d_channels: int = 128,
                 fpn_channels: int = 256, pre_neck_channels: int = 0,
                 neck_dtype: torch.dtype = torch.float32,
                 remat: bool | str = 'none'):
        super().__init__()
        self.n_voxels = tuple(n_voxels)
        self.point_cloud_range = tuple(point_cloud_range)
        self.input_capacity = input_capacity
        # prior range / n_voxels / the MinkResNet's total stride 2^6
        # (dense_fusion_occ.py:88-97): its stride-64 level is the prior grid
        self.voxel_size = (prior_range[3] - prior_range[0]) / n_voxels[0] / 64
        # the process group over which the views are split
        # (parallel.mesh.use_mesh), else None; view_branch (below) is
        # upstream of the sum over views
        self.view_group = None
        self.prior = _prior_points(prior_range, self.n_voxels, prior_origin)
        # remat (models.remat): '2d' the ResNet's blocks, '3d' the
        # MinkResNet's stages and the whole U-Net (occupancy.py:260-345)
        self.remat_neck = covers(remat, '3d')
        self.ResNet_0 = ResNet(depth=resnet_depth,
                               base_channels=resnet_base_channels,
                               remat=covers(remat, '2d'))
        expansion = 4 if resnet_depth >= 50 else 1
        self.FPN_0 = FPN([resnet_base_channels * 2**i * expansion
                          for i in range(4)], fpn_channels)
        self.view_branch = (self.ResNet_0, self.FPN_0)
        self.MinkResNet_0 = MinkResNet(depth=mink_depth,
                                       capacities=tuple(backbone_capacities),
                                       remat=self.remat_neck)
        c = fpn_channels + mink_channels(mink_depth)[-1]
        if pre_neck_channels:
            self.pre_neck = nn.Linear(c, pre_neck_channels)
            c = pre_neck_channels
        self.ImVoxelNeck_0 = ImVoxelNeck(c, neck3d_channels,
                                         dtype=neck_dtype)
        self.OccHead_0 = OccHead(neck3d_channels, num_classes)

    def image_maps(self, imgs: torch.Tensor) -> torch.Tensor:
        """(BI, V, H, W, 3) images -> the FPN's finest (BI * V, H/4, W/4,
        C) maps."""
        bi, v, h, w, _ = imgs.shape
        return self.FPN_0(self.ResNet_0(imgs.reshape(bi * v, h, w, 3)),
                          levels=1)[0]

    def image_volume(self, batch: dict, maps: torch.Tensor) -> torch.Tensor:
        """(B, X, Y, Z, C) image features at the prior grid's centres: the
        mean over the views that see each centre (nearest sampling)."""
        bi, v, h, w, _ = batch['imgs'].shape
        pts = batch['points']
        b = pts.shape[0]
        if b % bi:
            raise ValueError(f'points batch {b} is not a multiple of the '
                             f'image batch {bi}')
        s = b // bi
        prior = torch.from_numpy(self.prior).to(pts.device)
        n = prior.shape[0]
        view_mask = batch.get('view_mask')
        if view_mask is None:
            view_mask = torch.ones((b, v), dtype=torch.bool,
                                   device=pts.device)
        vol = point_image_sample_batched(
            prior.expand(bi, s, n, 3),
            torch.ones((bi, s, n), dtype=torch.bool, device=pts.device),
            maps.reshape(bi, v, *maps.shape[1:]), batch['proj'],
            batch['aug_inv'], (h, w), 'nearest', view_mask.reshape(bi, s, v),
            self.view_group)
        return vol.reshape(b, *self.n_voxels, maps.shape[-1])

    def voxelize(self, batch: dict) -> S.SparseTensor:
        """The points at the fine lattice, relative to the range's lower
        corner, one sample at a time; their xyz are the features."""
        pts = batch['points']
        shifted = pts - pts.new_tensor(self.point_cloud_range[:3])
        return S.from_points_per_sample(shifted, pts, batch['points_mask'],
                                        self.voxel_size, self.input_capacity)

    def point_volume(self, batch: dict) -> torch.Tensor:
        """(B, X, Y, Z, 512) MinkResNet's stride-64 level, densified into
        the prior grid (dense_fusion_occ.py:223-258)."""
        top = self.MinkResNet_0(self.voxelize(batch))[-1]
        return S.to_dense_b(
            top, torch.zeros(3, dtype=torch.int32, device=top.coords.device),
            self.n_voxels)

    def fuse(self, image: torch.Tensor, points: torch.Tensor):
        """The (B, X, Y, Z, C) volume the U-Net takes: the image volume and
        the point volume concatenated, then the optional pre-neck."""
        x = torch.cat([image, points], dim=-1)
        return self.pre_neck(x) if hasattr(self, 'pre_neck') else x

    def features(self, batch: dict) -> torch.Tensor:
        return self.fuse(
            self.image_volume(batch, self.image_maps(batch['imgs'])),
            self.point_volume(batch))

    def neck(self, x: torch.Tensor):
        """The U-Net on a (B, X, Y, Z, C) volume: per-scale (B, X/2^i,
        Y/2^i, Z/2^i, neck3d_channels) features."""
        x = x.permute(0, 4, 1, 2, 3).contiguous()
        feats = checkpointed(self.ImVoxelNeck_0, x) if self.remat_neck \
            else self.ImVoxelNeck_0(x)
        return [f.permute(0, 2, 3, 4, 1) for f in feats]

    def logits(self, batch: dict):
        """Per-scale (B, X/2^i, Y/2^i, Z/2^i, num_classes) logits."""
        return self.OccHead_0(self.neck(self.features(batch)))

    def forward(self, batch: dict, mode: str = 'predict'):
        """``'loss'`` (with autograd) returns {loss_occ_0..2}; ``'feats'``
        (the per-scale logits) and ``'predict'`` ((B, X, Y, Z) class ids)
        run without autograd."""
        if mode == 'loss':
            return self.OccHead_0.loss(self.logits(batch), batch['gt_occ'],
                                       batch['gt_occ_mask'],
                                       batch.get('visible_mask'))
        if mode not in ('feats', 'predict'):
            raise ValueError(f'unknown mode {mode!r}')
        with torch.no_grad():
            preds = self.logits(batch)
            return preds if mode == 'feats' else self.OccHead_0.predict(preds)


def _prior_points(prior_range, n_voxels, prior_origin) -> np.ndarray:
    """(X * Y * Z, 3) float32 voxel centres of the prior grid, x-major (the
    reference's ``grid_anchors([n_voxels[::-1]])`` traversed x first), plus
    ``prior_origin``."""
    nx, ny, nz = n_voxels
    gen = AlignedAnchor3DRangeGenerator(ranges=[list(prior_range)],
                                        sizes=[[1.0, 1.0, 1.0]],
                                        rotations=[0.0])
    a = gen.single_level_grid_anchors((nz, ny, nx), 1)  # (Z, Y, X, 1, 1, 7)
    pts = a[..., 0, 0, :3].transpose(2, 1, 0, 3).reshape(-1, 3)
    return pts.astype(np.float32) + np.asarray(prior_origin, np.float32)
