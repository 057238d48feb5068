"""FCAF3D sparse FPN + anchor-free detection head (port of
``embodiedscan_tpu/models/fcaf3d.py``: ``FCAF3DHead.__call__``, the target
assigner, ``loss`` in each box mode and the flat-engine ``predict``).

Box modes (``bbox_mode``): ``'euler9d'``, the rot-mat head (6D rotation,
corner-chamfer box loss); ``'yaw7d'`` and ``'aa6d'``, the published FCAF3D
head's yaw-only and axis-aligned boxes with the rotated- and
axis-aligned-IoU losses. Every mode decodes to (.., 9) euler boxes, its
unused angles zero, so the NMS and the metrics are shared.
"""

from typing import List, NamedTuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from ..geometry import boxes as gbox
from ..geometry.nms import nms3d
from ..geometry.rotations import (matrix_to_euler_zxy, ortho_6d_to_matrix,
                                  rotation_3d_in_euler)
from ..ops import sparse as S
from ..utils.trace import span
from .losses import (axis_aligned_iou_loss, bbox_cd_loss, bce_with_logits,
                     rotated_iou_loss, sigmoid_focal_loss)
from .norm import MaskedBatchNorm
from .sparse_nn import SparseConv, fpn_prune_scores, fpn_tables

# bias init matching mmengine bias_init_with_prob(0.01)
_CLS_BIAS = float(-np.log((1 - 0.01) / 0.01))


class HeadOutputs(NamedTuple):
    """Per-level head predictions, each a list over FPN levels: (B, N_l, ...)
    tensors; points (B, N_l, 3) world coords; masks (B, N_l)."""
    center: List[torch.Tensor]
    reg: List[torch.Tensor]
    cls: List[torch.Tensor]
    points: List[torch.Tensor]
    masks: List[torch.Tensor]


def decode_bbox(points: torch.Tensor, reg: torch.Tensor) -> torch.Tensor:
    """12-dim regression -> (.., 9) euler box.

    reg = (d_xmin, d_xmax, d_ymin, d_ymax, d_zmin, d_zmax, 6D rotation).
    """
    rot = ortho_6d_to_matrix(reg[..., 6:9], reg[..., 9:12])
    euler = matrix_to_euler_zxy(rot)
    shift = torch.stack([(reg[..., 1] - reg[..., 0]) / 2,
                         (reg[..., 3] - reg[..., 2]) / 2,
                         (reg[..., 5] - reg[..., 4]) / 2], -1)
    shift = rotation_3d_in_euler(shift[..., None, :], euler)[..., 0, :]
    size = torch.stack([reg[..., 0] + reg[..., 1], reg[..., 2] + reg[..., 3],
                        reg[..., 4] + reg[..., 5]], -1)
    return torch.cat([points + shift, size, euler], -1)


def decode_bbox_mode(points: torch.Tensor, reg: torch.Tensor,
                     mode: str) -> torch.Tensor:
    """Mode-dispatched regression decode, always to (.., 9) euler boxes:
    'euler9d' as :func:`decode_bbox`; 'yaw7d' is the 6 face distances and
    a z angle, 'aa6d' the 6 distances alone (the unused angles zero)."""
    if mode == 'euler9d':
        return decode_bbox(points, reg)
    size = torch.stack([reg[..., 0] + reg[..., 1], reg[..., 2] + reg[..., 3],
                        reg[..., 4] + reg[..., 5]], -1)
    shift = torch.stack([(reg[..., 1] - reg[..., 0]) / 2,
                         (reg[..., 3] - reg[..., 2]) / 2,
                         (reg[..., 5] - reg[..., 4]) / 2], -1)
    zeros = torch.zeros_like(size[..., :1])
    if mode == 'yaw7d':
        euler = torch.cat([reg[..., 6:7], zeros, zeros], -1)
        shift = rotation_3d_in_euler(shift[..., None, :], euler)[..., 0, :]
    elif mode == 'aa6d':
        euler = torch.cat([zeros, zeros, zeros], -1)
    else:
        raise ValueError(f'unknown bbox_mode {mode!r}')
    return torch.cat([points + shift, size, euler], -1)


# regression channel count per bbox_mode
REG_OUTS = {'euler9d': 12, 'yaw7d': 7, 'aa6d': 6}
# the regression row that non-positive locations take before the decode:
# unit distances, then the identity 6D rotation or a zero yaw (so the
# rot-mat decode never sees atan2(0, 0), whose gradient is NaN and would
# poison the masked box loss)
BENIGN_TAIL = {'euler9d': [1.0, 0, 0, 0, 1, 0], 'yaw7d': [0.0], 'aa6d': []}
# training: the reference head's pts_assign_threshold and
# pts_center_threshold
ASSIGN_THRESHOLD = 27
CENTER_THRESHOLD = 18


def assign_targets(points: torch.Tensor, levels: torch.Tensor,
                   pmask: torch.Tensor, gt_boxes: torch.Tensor,
                   gt_labels: torch.Tensor, gt_mask: torch.Tensor,
                   n_levels: int, assign_thr: int, center_thr: int):
    """FCAF3D target assignment for one sample.

    Args:
        points: (P, 3) world coords of all level locations concatenated.
        levels: (P,) level index per location.
        pmask: (P,) location validity.
        gt_boxes: (G, 9) euler boxes (gravity-centered).
        gt_labels: (G,) int labels; gt_mask: (G,) validity.

    Returns:
        (center_t (P,), bbox_t (P, 9), cls_t (P,)): cls_t is -1 for
        background or invalid locations.
    """
    float_max = 1e8
    p = points.shape[0]
    fd = gbox.face_distances(points, gt_boxes)  # (P, G, 6)
    inside = (fd.amin(-1) > 0) & pmask[:, None] & gt_mask[None, :]

    level_onehot = levels[:, None] == torch.arange(n_levels,
                                                   device=levels.device)
    n_pos = torch.einsum('pl,pg->lg', level_onehot.to(torch.float32),
                         inside.to(torch.float32))  # (L, G)
    lower = n_pos < assign_thr
    lower_index = torch.clamp(torch.argmax(lower.to(torch.int32), 0) - 1,
                              min=0)
    all_upper = (~lower).all(0)
    best_level = torch.where(all_upper, torch.full_like(lower_index,
                                                        n_levels - 1),
                             lower_index)  # (G,)
    level_cond = best_level[None, :] == levels[:, None]

    x, y, z = fd[..., 0:2], fd[..., 2:4], fd[..., 4:6]
    centerness = torch.sqrt(torch.clamp(
        x.amin(-1) / torch.clamp(x.amax(-1), min=1e-12) *
        y.amin(-1) / torch.clamp(y.amax(-1), min=1e-12) *
        z.amin(-1) / torch.clamp(z.amax(-1), min=1e-12), min=0))
    centerness = torch.where(inside & level_cond, centerness,
                             torch.full_like(centerness, -1.0))

    # the kth-largest centerness per gt, duplicates counted
    kth = min(center_thr + 1, p)
    top_centerness = torch.topk(centerness.T, kth, dim=-1).values[..., -1]
    topk_cond = centerness > top_centerness[None, :]

    volumes = gbox.volume(gt_boxes)[None, :].expand_as(centerness)
    volumes = torch.where(inside & level_cond & topk_cond & gt_mask[None, :],
                          volumes, torch.full_like(volumes, float_max))
    min_vol = volumes.amin(-1)
    min_inds = torch.argmin(volumes, -1)

    center_t = centerness.gather(1, min_inds[:, None])[:, 0]
    bbox_t = gt_boxes[min_inds]
    cls_t = torch.where(min_vol >= float_max, torch.full_like(min_inds, -1),
                        gt_labels[min_inds].long())
    cls_t = torch.where(pmask, cls_t, torch.full_like(cls_t, -1))
    return center_t, bbox_t, cls_t


def fpn_up_block(owner: nn.Module, i: int, x: S.SparseTensor, prune_level,
                 lateral: S.SparseTensor, keep: int) -> S.SparseTensor:
    """One top-down FPN step into level ``i`` through ``owner``'s
    ``up_block_{i+1}`` layers (tconv, bn1, conv, bn2): the coarser level
    ``x`` upsampled, its children summed into the ``lateral`` level, the
    ``keep`` children with the best scores interpolated from the coarser
    level's ``prune_level`` = (coords, scores, mask, 27-neighbor table),
    whose table drives the child tables (``fpn_tables``)."""
    name = f'up_block_{i + 1}'
    up = S.generative_transpose2(x, getattr(owner, f'{name}_tconv'))
    pcoords, pscores, pm, pnbr = prune_level
    nbr_u, lat_idx, corner_idx = fpn_tables(pnbr, pcoords, pm, lateral)
    f = F.elu(getattr(owner, f'{name}_bn1')(up.feats, up.mask))
    f = getattr(owner, f'{name}_conv')(f, up.mask, nbr_u)
    f = F.elu(getattr(owner, f'{name}_bn2')(f, up.mask))
    x = S.scatter_sum_into(S.SparseTensor(up.coords, f, up.mask), lateral,
                           lat_idx)
    score = fpn_prune_scores(pscores, pm, corner_idx, x.mask)
    return S.topk_select_b(x, score, keep)


class FCAF3DHead(nn.Module):
    """Sparse FPN + head (reference FCAF3DHeadRotMat, or with ``bbox_mode``
    'yaw7d' / 'aa6d' the reference FCAF3DHead); the MaskedBatchNorms use
    batch statistics in training mode.

    Args:
        in_channels: per-level input channels (after image fusion).
        fpn_capacities: static voxel capacity per FPN level (0 = finest).
        strides: lattice stride of each level relative to the voxel grid.
        decouple_bbox_loss: the 'euler9d' box loss as the weighted sum of
            ``decouple_groups`` chamfers (3: the center, size and rotation
            groups; 4: also the whole box), each group the prediction's own
            fields with the target's others; else one chamfer of the whole
            box. ``norm_decouple_loss`` divides each box's chamfers by the
            norm of its target's size (at least 0.1).
        cd_mode, cd_group: the chamfer's distance ('l1' or 'l2') and corner
            grouping ('g8' or 'g4'), see ``losses.bbox_cd_loss``.
    """

    def __init__(self, num_classes: int, in_channels=(128, 256, 512, 1024),
                 out_channels: int = 128, bbox_mode: str = 'euler9d',
                 voxel_size: float = 0.01, strides=(8, 16, 32, 64),
                 fpn_capacities=(24576, 8192, 4096, 2048),
                 pts_prune_threshold: int = 100000,
                 decouple_bbox_loss: bool = True, decouple_groups: int = 4,
                 decouple_weights=(0.2, 0.2, 0.2, 0.4),
                 norm_decouple_loss: bool = False, cd_mode: str = 'l1',
                 cd_group: str = 'g8', nms_pre: int = 1000,
                 iou_thr: float = 0.5, score_thr: float = 0.01,
                 max_candidates: int = 1024, max_dets: int = 256,
                 predict_protocol: str = 'reference'):
        super().__init__()
        if predict_protocol not in ('reference', 'full9d'):
            raise ValueError(f'unknown predict_protocol {predict_protocol!r}')
        if bbox_mode not in REG_OUTS:
            raise ValueError(f'unknown bbox_mode {bbox_mode!r}')
        self.num_classes = num_classes
        self.in_channels = tuple(in_channels)
        self.bbox_mode = bbox_mode
        self.voxel_size = voxel_size
        self.strides = tuple(strides)
        self.fpn_capacities = tuple(fpn_capacities)
        self.pts_prune_threshold = pts_prune_threshold
        self.decouple_bbox_loss = decouple_bbox_loss
        self.decouple_groups = decouple_groups
        self.decouple_weights = tuple(decouple_weights)
        self.norm_decouple_loss = norm_decouple_loss
        self.cd_mode = cd_mode
        self.cd_group = cd_group
        self.nms_pre = nms_pre
        self.iou_thr = iou_thr
        self.score_thr = score_thr
        self.max_candidates = max_candidates
        self.max_dets = max_dets
        self.predict_protocol = predict_protocol
        n = len(self.in_channels)
        self.conv_center = nn.Linear(out_channels, 1, bias=False)
        self.conv_reg = nn.Linear(out_channels, REG_OUTS[bbox_mode], bias=False)
        self.conv_cls = nn.Linear(out_channels, num_classes)
        self.scales = nn.Parameter(torch.ones(n))
        for i in range(n):
            cin = self.in_channels[i]
            self.add_module(f'out_block_{i}_conv', SparseConv(cin,
                                                              out_channels))
            self.add_module(f'out_block_{i}_bn', MaskedBatchNorm(out_channels))
            if i < n - 1:
                name = f'up_block_{i + 1}'
                self.register_parameter(f'{name}_tconv', nn.Parameter(
                    torch.zeros(8, self.in_channels[i + 1], cin)))
                self.add_module(f'{name}_bn1', MaskedBatchNorm(cin))
                self.add_module(f'{name}_conv', SparseConv(cin, cin))
                self.add_module(f'{name}_bn2', MaskedBatchNorm(cin))

    def forward(self, inputs) -> HeadOutputs:
        with span('es.head'):
            n_levels = len(inputs)
            center_preds, reg_preds, cls_preds, points, masks = \
                [], [], [], [], []
            x = inputs[-1]
            prune_level = None  # the coarser level's, see fpn_up_block
            for i in range(n_levels - 1, -1, -1):
                if i < n_levels - 1:
                    x = fpn_up_block(self, i, x, prune_level, inputs[i],
                                     min(self.pts_prune_threshold,
                                         self.fpn_capacities[i]))

                nbr27 = S.neighbor_table_b(x, S.OFFSETS_3)
                out = getattr(self, f'out_block_{i}_conv')(x.feats, x.mask,
                                                           nbr27)
                out = F.elu(getattr(self, f'out_block_{i}_bn')(out, x.mask))
                center = self.conv_center(out)
                cls = self.conv_cls(out)
                reg_raw = self.conv_reg(out)
                # maximum, not clamp: a gradient splits at a tie, as jnp.clip's
                reg_dist = torch.exp(self.scales[i] * reg_raw[..., :6])
                reg_dist = torch.maximum(reg_dist, reg_dist.new_tensor(1e-3))
                reg = torch.cat([reg_dist, reg_raw[..., 6:]], -1)
                prune_level = (x.coords, cls.amax(-1), x.mask, nbr27)

                world = x.coords.to(torch.float32) * (self.strides[i] *
                                                      self.voxel_size)
                center_preds.append(center)
                reg_preds.append(reg)
                cls_preds.append(cls)
                points.append(world)
                masks.append(x.mask)

            return HeadOutputs(center_preds[::-1], reg_preds[::-1],
                               cls_preds[::-1], points[::-1], masks[::-1])

    def loss(self, outs: HeadOutputs, gt_boxes: torch.Tensor,
             gt_labels: torch.Tensor, gt_mask: torch.Tensor) -> dict:
        """Batch loss: focal classification, centerness BCE and the box
        loss of ``bbox_mode`` (the rotated IoU for 'yaw7d', the
        axis-aligned IoU for 'aa6d', the corner chamfer for 'euler9d').
        gt_*: (B, G, ...) padded ground truth."""
        with span('es.loss'):
            levels = torch.cat([
                torch.full((p.shape[1],), i, dtype=torch.int64,
                           device=p.device)
                for i, p in enumerate(outs.points)])
            pts = torch.cat(outs.points, 1)  # (B, P, 3)
            pmask = torch.cat(outs.masks, 1)
            center = torch.cat(outs.center, 1)[..., 0]
            reg = torch.cat(outs.reg, 1)
            cls = torch.cat(outs.cls, 1)
            b = pts.shape[0]
            with torch.no_grad():
                targets = [assign_targets(
                    pts[i], levels, pmask[i], gt_boxes[i], gt_labels[i],
                    gt_mask[i], len(outs.points), ASSIGN_THRESHOLD,
                    CENTER_THRESHOLD) for i in range(b)]
            center_t, bbox_t, cls_t = (torch.stack(t) for t in zip(*targets))
            pos = cls_t >= 0
            # the batch mean of the positives (the reference's reduce_mean)
            n_pos_avg = torch.clamp(pos.sum(1).to(torch.float32).mean(),
                                    min=1.0)
            benign = reg.new_tensor([1.0] * 6 + BENIGN_TAIL[self.bbox_mode])
            c_l, b_l, cl_l = [], [], []
            for i in range(b):
                cl_l.append(sigmoid_focal_loss(cls[i], cls_t[i], pmask[i],
                                               self.num_classes, n_pos_avg))
                c_l.append(torch.nan_to_num(bce_with_logits(
                    center[i], center_t[i], pos[i], n_pos_avg)))
                reg_safe = torch.where(pos[i][:, None], reg[i], benign)
                dec = decode_bbox_mode(pts[i], reg_safe, self.bbox_mode)
                b_l.append(torch.nan_to_num(self.bbox_loss(dec, bbox_t[i],
                                                           pos[i])))
            return dict(loss_center=torch.stack(c_l).mean(),
                        loss_bbox=torch.stack(b_l).mean(),
                        loss_cls=torch.stack(cl_l).mean())

    def bbox_loss(self, dec: torch.Tensor, tgt: torch.Tensor,
                  pos: torch.Tensor) -> torch.Tensor:
        """One sample's box loss over its positive rows: decoded (P, 9)
        boxes against their assigned (P, 9) targets."""
        if self.bbox_mode == 'yaw7d':
            # the targets keep only their z angle
            tgt = torch.cat([tgt[:, :7], torch.zeros_like(tgt[:, 7:9])], -1)
            return rotated_iou_loss(dec, tgt, pos)
        if self.bbox_mode == 'aa6d':
            def corners(x):
                return torch.cat([x[:, :3] - x[:, 3:6] / 2,
                                  x[:, :3] + x[:, 3:6] / 2], -1)
            return axis_aligned_iou_loss(corners(dec), corners(tgt), pos)

        def cd(src, reduction='mean'):
            return bbox_cd_loss(src, tgt, pos, self.cd_mode, self.cd_group,
                                reduction)

        if not self.decouple_bbox_loss:
            return cd(dec)
        groups = [torch.cat([dec[:, :3], tgt[:, 3:]], -1),
                  torch.cat([tgt[:, :3], dec[:, 3:6], tgt[:, 6:]], -1),
                  torch.cat([tgt[:, :6], dec[:, 6:]], -1)]
        if self.decouple_groups == 4:
            groups.append(dec)
        weighted = zip(self.decouple_weights, groups)
        if not self.norm_decouple_loss:
            return sum(w * cd(g) for w, g in weighted)
        per = sum(w * cd(g, 'none') for w, g in weighted)
        size = torch.linalg.norm(tgt[:, 3:6], dim=-1)
        per = per / torch.maximum(size, size.new_tensor(0.1))[:, None]
        denom = torch.clamp(pos.sum() * per.shape[1], min=1)
        return torch.where(pos[:, None], per, torch.zeros_like(per)).sum() \
            / denom

    def predict(self, outs: HeadOutputs) -> dict:
        """Decode + multiclass NMS. Returns (B, D) padded detections.

        Per-sample sorts (level top-k, candidate top-k) run as one flat
        batched-key sort each (``topk_rows_b``); candidates arrive
        score-descending, so NMS skips its own sort.
        """
        with span('es.predict'):
            lvl_boxes, lvl_scores, lvl_masks = [], [], []
            for center, reg, cls, pt, m in zip(outs.center, outs.reg, outs.cls,
                                               outs.points, outs.masks):
                scores = torch.sigmoid(cls) * torch.sigmoid(center)
                scores = torch.where(m[..., None], scores,
                                     torch.zeros_like(scores))
                k = min(self.nms_pre, scores.shape[1])
                top = S.topk_rows_b(scores.amax(-1), m, k)
                lvl_boxes.append(decode_bbox_mode(S._take_rows(pt, top),
                                                  S._take_rows(reg, top),
                                                  self.bbox_mode))
                lvl_scores.append(S._take_rows(scores, top))
                lvl_masks.append(S._take_rows(m, top))
            boxes = torch.cat(lvl_boxes, dim=1)  # (B, T, 9)
            scores = torch.cat(lvl_scores, dim=1)  # (B, T, C)
            mask = torch.cat(lvl_masks, dim=1)  # (B, T)
            if self.bbox_mode == 'euler9d' and \
                    self.predict_protocol == 'reference':
                # published protocol: yaw-only boxes through NMS and in the
                # returned predictions
                boxes = boxes.clone()
                boxes[..., 7:9] = 0.0

            b = scores.shape[0]
            flat = torch.where(mask[..., None] & (scores > self.score_thr),
                               scores, torch.zeros_like(scores)).reshape(b, -1)
            kc = min(self.max_candidates, flat.shape[1])
            cand_idx = S.topk_rows_b(
                flat, torch.ones_like(flat, dtype=torch.bool), kc)
            cand_scores = S._take_rows(flat, cand_idx)
            pt_idx = torch.div(cand_idx, self.num_classes,
                               rounding_mode='floor')
            cand_labels = torch.remainder(cand_idx, self.num_classes)
            cand_boxes = S._take_rows(boxes, pt_idx)
            cand_mask = cand_scores > self.score_thr
            keep = torch.stack([
                nms3d(cand_boxes[i], cand_scores[i], cand_mask[i],
                      self.iou_thr, cand_labels[i], presorted=True)[1]
                for i in range(b)])
            d = min(self.max_dets, kc)
            return dict(bboxes=cand_boxes[:, :d], scores=cand_scores[:, :d],
                        labels=cand_labels[:, :d], mask=keep[:, :d])
