"""3D visual grounding: sparse neck, DETR decoder, grounder (port of
``embodiedscan_tpu/models/grounding.py``).

- ``MinkNeck``: the FCAF-style sparse FPN that emits per-location
  features, scores and coordinates for the decoder (its convs run on K2,
  its tables on K1, as the detector's head).
- ``DecoderLayer``: self-attention -> text cross-attention -> point
  cross-attention -> FFN, post-norm (flax LayerNorms, eps 1e-6).
- ``SparseFusionGrounder``: trunk + text encoder + top-k query selection +
  6 decoder layers with a shared box branch and contrastive token logits;
  ``mode='feats'``, ``'predict'`` and ``'loss'`` (every layer's boxes
  matched to the ground truth, then a token focal loss and a decoupled
  corner-chamfer box loss per layer).

Batch layout: the detector's (``models/detector.py``) plus
    text_ids:  (B, L) int token ids
    text_mask: (B, L) 0/1 token mask
and, for the loss,
    positive_maps: (B, G, L) float, each gt box's normalized token map
    gt_boxes:      (B, G, 9) float
    gt_mask:       (B, G) bool, the valid (unpadded) gt boxes
"""

import math
from typing import NamedTuple

import torch
from torch import nn
from torch.nn import functional as F

from ..geometry.iou import paired_iou_pruned
from ..geometry.rotations import rotation_3d_in_euler
from ..ops import sparse as S
from ..ops.hungarian import auction_match, hungarian_match
from ..utils.trace import span
from .attention import MultiHeadDotProductAttention
from .fcaf3d import _CLS_BIAS, fpn_up_block
from .losses import bbox_cd_loss
from .match_costs import bbox3d_l1_cost, binary_focal_cost
from .norm import MaskedBatchNorm
from .sparse_nn import SparseConv
from .text import FLAX_LN_EPS, ROBERTA_LN_EPS, TextEncoder
from .trunk import STRIDES, SparseFusionTrunk

_NEG_INF = -1e4


class MinkNeck(nn.Module):
    """Sparse FPN neck emitting (feats, scores, xyz, mask) per location,
    levels concatenated fine to coarse; one ``conv_cls`` shared by all
    levels scores the locations for the next level's prune.

    ``MinkNeck.live_counts``: device index -> int64 scalar on that
    device, the live locations the neck emitted, added on the device by
    every forward (out of the mask's width a sample, a shape known on the
    host); read it off the hot path (reading waits for the device)."""

    live_counts = {}

    def __init__(self, in_channels, out_channels: int = 256,
                 voxel_size: float = 0.01, strides=STRIDES,
                 fpn_capacities=(1024, 1024, 1024, 2048),
                 pts_prune_threshold: int = 1000):
        super().__init__()
        self.in_channels = tuple(in_channels)
        self.voxel_size = voxel_size
        self.strides = tuple(strides)
        self.fpn_capacities = tuple(fpn_capacities)
        self.pts_prune_threshold = pts_prune_threshold
        self.conv_cls = nn.Linear(out_channels, 1)
        n = len(self.in_channels)
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

    def forward(self, inputs):
        with span('es.neck'):
            out = self._forward(inputs)
            self._count(out[3])
            return out

    def _count(self, mask):
        dev = mask.device
        live = MinkNeck.live_counts.get(dev.index)
        if live is None:
            live = torch.zeros((), dtype=torch.int64, device=dev)
            MinkNeck.live_counts[dev.index] = live
        live += mask.sum()

    def _forward(self, inputs):
        n_levels = len(inputs)
        feats_l, scores_l, xyz_l, mask_l = [], [], [], []
        x = inputs[-1]
        prune_level = None  # the coarser level's, see fpn_up_block
        for i in range(n_levels - 1, -1, -1):
            if i < n_levels - 1:
                x = fpn_up_block(self, i, x, prune_level, inputs[i],
                                 min(self.pts_prune_threshold,
                                     self.fpn_capacities[i]))
            nbr = S.neighbor_table_b(x, S.OFFSETS_3)
            f = getattr(self, f'out_block_{i}_conv')(x.feats, x.mask, nbr)
            f = F.elu(getattr(self, f'out_block_{i}_bn')(f, x.mask))
            cls = self.conv_cls(f)
            prune_level = (x.coords, cls[..., 0], x.mask, nbr)
            feats_l.append(f)
            scores_l.append(cls)
            xyz_l.append(x.coords.to(torch.float32) *
                         (self.strides[i] * self.voxel_size))
            mask_l.append(x.mask)
        # levels were built top-down; fine-to-coarse order, concatenated
        return tuple(torch.cat(t[::-1], dim=1)
                     for t in (feats_l, scores_l, xyz_l, mask_l))


class PositionEmbeddingLearned(nn.Module):
    """xyz or box -> embedding: Dense, MaskedBatchNorm, ReLU, Dense."""

    def __init__(self, in_features: int, embed_dims: int = 256):
        super().__init__()
        self.Dense_0 = nn.Linear(in_features, embed_dims)
        self.MaskedBatchNorm_0 = MaskedBatchNorm(embed_dims)
        self.Dense_1 = nn.Linear(embed_dims, embed_dims)

    def forward(self, x, mask):
        h = F.relu(self.MaskedBatchNorm_0(self.Dense_0(x), mask))
        return self.Dense_1(h)


def _attn_mask(q_mask: torch.Tensor, k_mask: torch.Tensor) -> torch.Tensor:
    """(B, Q), (B, K) -> (B, 1, Q, K) boolean attention mask."""
    return (q_mask[:, :, None] & k_mask[:, None, :])[:, None]


class DecoderLayer(nn.Module):
    """self-attn -> text cross-attn -> point cross-attn -> FFN, post-norm."""

    def __init__(self, embed_dims: int = 256, num_heads: int = 8,
                 ffn_dims: int = 2048):
        super().__init__()
        for name in ('self_attn', 'cross_attn_text', 'cross_attn'):
            self.add_module(name, MultiHeadDotProductAttention(
                embed_dims, num_heads))
        for i in range(4):
            self.add_module(f'norm{i}', nn.LayerNorm(embed_dims,
                                                     eps=FLAX_LN_EPS))
        self.ffn_fc1 = nn.Linear(embed_dims, ffn_dims)
        self.ffn_fc2 = nn.Linear(ffn_dims, embed_dims)

    def forward(self, query, query_pos, q_mask, key, key_pos, k_mask,
                text_feats, text_mask):
        qp = query + query_pos
        q = self.norm0(query + self.self_attn(
            qp, qp, query, mask=_attn_mask(q_mask, q_mask)))
        q = self.norm1(q + self.cross_attn_text(
            q + query_pos, text_feats, text_feats,
            mask=_attn_mask(q_mask, text_mask)))
        q = self.norm2(q + self.cross_attn(
            q + query_pos, key + key_pos, key,
            mask=_attn_mask(q_mask, k_mask)))
        q = q + self.ffn_fc2(F.relu(self.ffn_fc1(q)))
        return self.norm3(q)


class RegBranch(nn.Module):
    """2x Linear+ReLU then Linear -> 9; the output layer starts at zero
    weights and bias [0, 0, -2, ..., -2]."""

    def __init__(self, embed_dims: int = 256, num_reg: int = 9):
        super().__init__()
        self.fc0 = nn.Linear(embed_dims, embed_dims)
        self.fc1 = nn.Linear(embed_dims, embed_dims)
        self.out = nn.Linear(embed_dims, num_reg)

    def forward(self, x):
        return self.out(F.relu(self.fc1(F.relu(self.fc0(x)))))


def decode_baseline(points: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
    """'baseline' box coder: center offsets + log sizes + euler angles."""
    size = torch.clamp(torch.exp(pred[..., 3:6]), min=2e-2)
    return torch.cat([pred[..., :3] + points, size, pred[..., 6:9]], -1)


def decode_fcaf(points: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
    """'FCAF' box coder, 9-dim variant: ``pred[..., :6]`` are log distances
    to the 6 faces (exp'd and clamped), ``pred[..., 6:9]`` the euler
    angles; the center shift is the face-distance asymmetry rotated into
    the box frame."""
    d = torch.clamp(torch.exp(pred[..., :6]), min=2e-2)
    euler = pred[..., 6:9]
    shift = torch.stack([(d[..., 1] - d[..., 0]) / 2,
                         (d[..., 3] - d[..., 2]) / 2,
                         (d[..., 5] - d[..., 4]) / 2], -1)
    shift = rotation_3d_in_euler(shift[..., None, :], euler)[..., 0, :]
    size = torch.stack([d[..., 0] + d[..., 1], d[..., 2] + d[..., 3],
                        d[..., 4] + d[..., 5]], -1)
    return torch.cat([points + shift, size, euler], -1)


_BOX_CODERS = {'baseline': decode_baseline, 'FCAF': decode_fcaf}
# 'hungarian': scipy on the host, as the reference; 'auction': on the device
_MATCHERS = {'hungarian': hungarian_match, 'auction': auction_match}


class ContrastiveEmbed(nn.Module):
    """visual . text^T / sqrt(C) + a learnable bias; masked tokens and
    visual rows at -1e4, padded to ``max_text_len`` with -1e4."""

    def __init__(self, max_text_len: int = 256):
        super().__init__()
        self.max_text_len = max_text_len
        self.bias = nn.Parameter(torch.full((1,), _CLS_BIAS))

    def forward(self, visual, text, text_mask, visual_mask=None):
        res = torch.einsum('bqc,blc->bql', visual, text)
        res = res / math.sqrt(visual.shape[-1]) + self.bias
        fill = res.new_tensor(_NEG_INF)
        res = torch.where(text_mask[:, None, :], res, fill)
        if visual_mask is not None:
            res = torch.where(visual_mask[:, :, None], res, fill)
        pad = self.max_text_len - res.shape[-1]
        if pad > 0:
            res = F.pad(res, (0, pad), value=_NEG_INF)
        return res


def top_k_indices(scores: torch.Tensor, k: int) -> torch.Tensor:
    """``jax.lax.top_k``'s indices of (B, N) float32 scores on any device:
    score-descending, ties (the -inf of masked rows among them) by
    ascending index. A stable sort of the monotone keys of
    ``ops.sparse._monotone_desc_key``, row by row."""
    if k > scores.shape[-1]:
        raise ValueError(f'top {k} of {scores.shape[-1]} rows')
    key = S._monotone_desc_key(scores)
    return torch.sort(key, dim=-1, stable=True)[1][:, :k]


class GroundingOutputs(NamedTuple):
    cls: torch.Tensor  # (L, B, Q, T) per-layer token logits
    boxes: torch.Tensor  # (L, B, Q, 9)
    query_mask: torch.Tensor  # (B, Q)
    query_index: torch.Tensor  # (B, Q) the neck row of each query


class SparseFusionGrounder(nn.Module):
    """Embodied Perceptron grounding variant (language -> 9-DoF box)."""

    def __init__(self, num_queries: int = 256, voxel_size: float = 0.01,
                 max_text_len: int = 256, embed_dims: int = 256,
                 num_decoder_layers: int = 6, input_capacity: int = 98304,
                 backbone_capacities=(65536, 32768, 24576, 8192, 4096, 2048),
                 fpn_capacities=(1024, 1024, 1024, 2048),
                 resnet_depth: int = 50, mink_depth: int = 34,
                 text_arch: str = 'roberta', text_layers: int = 12,
                 text_hidden: int = 768, text_heads: int = 12,
                 text_vocab_size: int = 30522,
                 text_ln_eps: float = ROBERTA_LN_EPS,
                 freeze_text: bool = True, box_coder: str = 'baseline',
                 matcher: str = 'hungarian', iou_cost_capacity: int = 0,
                 cost_cls_weight: float = 1.0, cost_l1_weight: float = 2.0,
                 cost_iou_weight: float = 2.0,
                 decouple_weights=(0.2, 0.2, 0.2, 0.4),
                 img_dtype: torch.dtype = torch.float32,
                 remat: bool | str = 'none'):
        super().__init__()
        if box_coder not in _BOX_CODERS:
            raise ValueError(f'unknown box coder {box_coder!r}')
        if matcher not in _MATCHERS:
            raise ValueError(f'unknown matcher {matcher!r}')
        self.match_fn = _MATCHERS[matcher]
        # pairs the IoU match cost clips exactly; 0 = max(2048, pairs // 8)
        self.iou_cost_capacity = iou_cost_capacity
        self.cost_weights = (cost_cls_weight, cost_l1_weight,
                             cost_iou_weight)
        self.decouple_weights = tuple(decouple_weights)
        self.num_queries = num_queries
        self.num_decoder_layers = num_decoder_layers
        self.decode_boxes = _BOX_CODERS[box_coder]
        self.trunk = SparseFusionTrunk(
            voxel_size=voxel_size, input_capacity=input_capacity,
            backbone_capacities=tuple(backbone_capacities),
            resnet_depth=resnet_depth, mink_depth=mink_depth,
            img_dtype=img_dtype, remat=remat)
        self.neck = MinkNeck(self.trunk.out_channels, embed_dims,
                             voxel_size=voxel_size,
                             fpn_capacities=tuple(fpn_capacities))
        self.text_encoder = TextEncoder(embed_dims, arch=text_arch,
                                        vocab_size=text_vocab_size,
                                        layers=text_layers,
                                        hidden=text_hidden, heads=text_heads,
                                        frozen=freeze_text,
                                        ln_eps=text_ln_eps)
        for i in range(num_decoder_layers):
            self.add_module(f'layer{i}', DecoderLayer(embed_dims))
        self.self_posembed = PositionEmbeddingLearned(9, embed_dims)
        self.cross_posembed = PositionEmbeddingLearned(3, embed_dims)
        self.decoder_norm = nn.LayerNorm(embed_dims, eps=FLAX_LN_EPS)
        # one box branch shared by every layer (share_pred_layer)
        self.reg_branch = RegBranch(embed_dims)
        self.cls_embed = ContrastiveEmbed(max_text_len)

    def select_queries(self, feats, xyz, mask, text_feats, text_mask):
        """The top ``num_queries`` neck locations by their best contrastive
        token score: (query feats, query xyz, query mask, indices)."""
        with span('es.select'):
            enc_cls = self.cls_embed(feats, text_feats, text_mask, mask)
            sel = torch.where(mask, enc_cls.amax(-1),
                              enc_cls.new_tensor(float('-inf')))
            top = top_k_indices(sel, self.num_queries)
            return (S._take_rows(feats, top), S._take_rows(xyz, top),
                    S._take_rows(mask, top), top)

    def decoder(self, query, query_coords, query_mask, query_index, feats,
                xyz, mask, text_feats, text_mask) -> GroundingOutputs:
        """The decoder layers over the queries :meth:`select_queries`
        returned, each refining the boxes from the query locations;
        per-layer token logits and boxes. The boxes fed back into the next
        layer's position embedding carry no gradient."""
        with span('es.decoder'):
            return self._decoder(query, query_coords, query_mask, query_index,
                                 feats, xyz, mask, text_feats, text_mask)

    def _decoder(self, query, query_coords, query_mask, query_index, feats,
                 xyz, mask, text_feats, text_mask) -> GroundingOutputs:
        pred_bboxes = self.decode_boxes(query_coords,
                                        self.reg_branch(query)).detach()
        key_pos = self.cross_posembed(xyz, mask)
        all_cls, all_boxes = [], []
        for i in range(self.num_decoder_layers):
            query_pos = self.self_posembed(pred_bboxes, query_mask)
            query = getattr(self, f'layer{i}')(
                query, query_pos, query_mask, feats, key_pos, mask,
                text_feats, text_mask)
            new_boxes = self.decode_boxes(query_coords, self.reg_branch(query))
            pred_bboxes = new_boxes.detach()
            all_cls.append(self.cls_embed(self.decoder_norm(query),
                                          text_feats, text_mask))
            all_boxes.append(new_boxes)
        return GroundingOutputs(torch.stack(all_cls), torch.stack(all_boxes),
                                query_mask, query_index)

    @staticmethod
    def predict(outs: GroundingOutputs) -> dict:
        """The last layer's boxes, each query's best token probability
        (0 for masked queries), the query mask and the neck rows the
        queries came from."""
        scores = torch.sigmoid(outs.cls[-1]).amax(-1)
        scores = torch.where(outs.query_mask, scores,
                             torch.zeros_like(scores))
        return dict(bboxes=outs.boxes[-1], scores=scores,
                    mask=outs.query_mask, query_index=outs.query_index)

    def outputs(self, batch: dict) -> tuple:
        """(GroundingOutputs, text mask): trunk, neck, text encoder,
        query selection and decoder."""
        feats, _, xyz, mask = self.neck(self.trunk(batch))
        text_mask = batch['text_mask'] > 0
        text_feats = self.text_encoder(batch['text_ids'], batch['text_mask'])
        queries = self.select_queries(feats, xyz, mask, text_feats, text_mask)
        return self.decoder(*queries, feats, xyz, mask, text_feats,
                            text_mask), text_mask

    @torch.no_grad()
    def match(self, outs: GroundingOutputs, text_mask: torch.Tensor,
              batch: dict) -> torch.Tensor:
        """Every layer's queries matched to the gt boxes in one matcher
        call: (L, B, Q) int32, the gt index or -1.

        The cost is the token focal cost, the boxes' L1 cost and their
        negative IoU, weighted; masked queries cost 1e6. The IoU of all
        L*B*Q*G pairs is one ``paired_iou_pruned`` call."""
        boxes, cls = outs.boxes, outs.cls
        gt_boxes, gt_mask = batch['gt_boxes'], batch['gt_mask']
        (nl, b, q), g = boxes.shape[:3], gt_boxes.shape[1]
        pairs = nl * b * q * g
        cap = self.iou_cost_capacity or max(2048, pairs // 8)
        iou = paired_iou_pruned(
            boxes[:, :, :, None, :].expand(nl, b, q, g, 9).reshape(-1, 9),
            gt_boxes[None, :, None].expand(nl, b, q, g, 9).reshape(-1, 9),
            min(cap, pairs)).reshape(nl, b, q, g)
        w_cls, w_l1, w_iou = self.cost_weights
        cost = (w_cls * binary_focal_cost(
            cls[..., :text_mask.shape[1]], batch['positive_maps'], text_mask)
            + w_l1 * bbox3d_l1_cost(boxes, gt_boxes) + w_iou * -iou)
        cost = torch.where(outs.query_mask[None, :, :, None], cost,
                           cost.new_tensor(1e6))
        return self.match_fn(cost, gt_mask.expand(nl, b, g))

    def loss(self, outs: GroundingOutputs, text_mask: torch.Tensor,
             batch: dict) -> dict:
        """Per decoder layer: the sigmoid focal loss over the (query,
        valid token) cells against the matched gt's positive map, and the
        decoupled corner-chamfer loss of the matched boxes (center, size,
        angles and the whole box, each alone against the gt), both over the
        batch's matched count clamped at 1. Keys ``d{i}.loss_cls``,
        ``d{i}.loss_bbox``, and ``loss_cls``, ``loss_bbox`` for the last
        layer."""
        matched = self.match(outs, text_mask, batch)
        pos_maps, gt_boxes = batch['positive_maps'], batch['gt_boxes']
        cls, boxes = outs.cls, outs.boxes
        nl, b, q, t = cls.shape
        pos = matched >= 0
        safe = torch.clamp(matched, min=0).long()
        bidx = torch.arange(b, device=cls.device)[None, :, None]
        labels = torch.where(pos[..., None], pos_maps[bidx, safe],
                             pos_maps.new_zeros(()))
        tgt = gt_boxes[bidx, safe]
        num_pos = pos.sum((1, 2)).to(cls.dtype)
        avg = torch.clamp(num_pos, min=1.0)
        tmask = torch.zeros(b, t, dtype=torch.bool, device=cls.device)
        tmask[:, :text_mask.shape[1]] = text_mask
        cell = outs.query_mask[:, :, None] & tmask[:, None, :]
        lab = torch.zeros_like(cls)
        lab[..., :labels.shape[-1]] = labels
        p = torch.sigmoid(cls)
        is_pos = lab > 0
        pt = torch.where(is_pos, p, 1 - p)
        alpha_t = torch.where(is_pos, 0.25, 0.75)
        focal = alpha_t * torch.pow(1 - pt, 2.0) * \
            -torch.log(torch.maximum(pt, pt.new_tensor(1e-12)))
        cls_loss = torch.where(cell, focal, torch.zeros_like(focal)).sum(
            (1, 2, 3)) / avg
        valid = pos.reshape(-1)
        pb, tb = boxes.reshape(-1, 9), tgt.reshape(-1, 9)
        groups = (torch.cat([pb[:, :3], tb[:, 3:]], -1),
                  torch.cat([tb[:, :3], pb[:, 3:6], tb[:, 6:]], -1),
                  torch.cat([tb[:, :6], pb[:, 6:]], -1),
                  pb)
        denom = torch.clamp(pos.reshape(nl, -1).sum(1).to(cls.dtype) * 8,
                            min=1.0)
        bbox_loss = sum(
            w * bbox_cd_loss(g_, tb, valid, reduction='none').reshape(nl, -1).sum(1)
            / denom for w, g_ in zip(self.decouple_weights, groups))
        bbox_loss = torch.nan_to_num(bbox_loss)
        losses = {}
        for i in range(nl):
            pre = '' if i == nl - 1 else f'd{i}.'
            losses[f'{pre}loss_cls'] = cls_loss[i]
            losses[f'{pre}loss_bbox'] = bbox_loss[i]
        return losses

    def forward(self, batch: dict, mode: str = 'predict'):
        """``'loss'`` (with autograd; needs positive_maps, gt_boxes and
        gt_mask) returns the per-layer losses of :meth:`loss`; ``'feats'``
        (GroundingOutputs) and ``'predict'`` (bboxes (B, Q, 9), scores
        (B, Q), mask (B, Q), query_index (B, Q)) run without autograd."""
        if mode == 'loss':
            return self.loss(*self.outputs(batch), batch)
        if mode not in ('feats', 'predict'):
            raise ValueError(f'unknown mode {mode!r}')
        with torch.no_grad():
            outs = self.outputs(batch)[0]
            return outs if mode == 'feats' else self.predict(outs)
