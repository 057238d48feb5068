"""The 3D visual grounder (EmbodiedScan's ``SparseFeatureFusion3DGrounder``,
configs/grounding/mv-grounding_8xb12_embodiedscan-vg-9dof.py) in plain
tensor operations: the shared trunk, MinkNeck, RoBERTa, the top-k query
selection, the post-norm decoder, ContrastiveEmbed and the baseline box
coder.

    neck:     the FCAF-style sparse FPN over the trunk's four levels, each
              level's locations scored by one shared ``conv_cls`` for the
              next level's prune; (feats, xyz, mask) of every level,
              concatenated fine to coarse
    select:   enc = ContrastiveEmbed(feats, text); the ``num_queries``
              live locations with the best max-over-tokens logit, in
              descending order (ties by ascending row), their feats and
              xyz the queries' content and reference points
    decoder:  per layer l, q_pos = PE_self(boxes_{l-1}),
              q = LN(q + SelfAttn(q + q_pos, q + q_pos, q))
              q = LN(q + TextAttn(q + q_pos, text, text))
              q = LN(q + PointAttn(q + q_pos, feats + PE_cross(xyz), feats))
              q = LN(q + W_2 relu(W_1 q))
              boxes_l = decode(xyz_q, RegBranch(q)), with boxes_0 from
              the selected queries themselves; cls_l = ContrastiveEmbed(
              LN_dec(q), text)
    embed:    visual . text / sqrt(C) + bias; masked tokens and rows at
              -1e4, padded to ``max_text_len``
    decode:   center = xyz + d[:3], size = max(exp(d[3:6]), 0.02),
              angles = d[6:9]
    predict:  the last layer's boxes, sigmoid(max over tokens of cls_L)
              (0 for masked queries), the query mask

Departures from the published description, each as the port runs it:

- the decoder's LayerNorms take epsilon 1e-6 (flax's, the JAX package's)
  where mmcv's default is 1e-5;
- attention as ``attention.py`` says (no dropout, masked logits at the
  float32 minimum, four named projections);
- the position embeddings are Linear, masked BatchNorm, ReLU, Linear
  (mmdet's 1x1 Conv1d and BatchNorm1d are the same maps over rows), the
  norm over live rows only;
- the box branch is shared by every layer (``share_pred_layer``) and the
  selection reads no separate encoder head: the decoder's ContrastiveEmbed
  scores the neck;
- the neck keeps at most ``fpn_capacities[i]`` locations of level i (the
  port's static capacities; ``pts_prune_threshold`` 1000 below them).
"""

import math

import torch
from torch import nn
from torch.nn import functional as F

from ..ops import sparse as S
from .attention import MultiHeadAttention
from .fcaf3d import _CLS_BIAS, fpn_up_block
from .norm import MaskedBatchNorm
from .sparse_nn import SparseConv
from .text import TextEncoder
from .trunk import STRIDES, SparseFusionTrunk

NEG = -1e4            # ContrastiveEmbed's fill
DECODER_LN_EPS = 1e-6


class MinkNeck(nn.Module):

    def __init__(self, in_channels, out_channels, voxel_size,
                 fpn_capacities, pts_prune_threshold=1000):
        super().__init__()
        self.in_channels = tuple(in_channels)
        self.voxel_size = voxel_size
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

    def forward(self, levels):
        """(feats (B, N, C), xyz (B, N, 3), mask (B, N)) over every level,
        finest first."""
        n = len(levels)
        out = [None] * n
        x, prune = levels[-1], None
        for i in range(n - 1, -1, -1):
            if i < n - 1:
                x = fpn_up_block(self, i, x, prune, levels[i],
                                 min(self.pts_prune_threshold,
                                     self.fpn_capacities[i]))
            nbr = S.neighbor_table_b(x, S.OFFSETS_3)
            f = getattr(self, f'out_block_{i}_conv')(x.feats, x.mask, nbr)
            f = F.elu(getattr(self, f'out_block_{i}_bn')(f, x.mask))
            prune = (x.coords, self.conv_cls(f)[..., 0], x.mask, nbr)
            xyz = x.coords.to(torch.float32) * (STRIDES[i] * self.voxel_size)
            out[i] = (f, xyz, x.mask)
        return tuple(torch.cat(parts, dim=1) for parts in zip(*out))


class PositionEmbedding(nn.Module):

    def __init__(self, cin, dims):
        super().__init__()
        self.Dense_0 = nn.Linear(cin, dims)
        self.MaskedBatchNorm_0 = MaskedBatchNorm(dims)
        self.Dense_1 = nn.Linear(dims, dims)

    def forward(self, x, mask):
        return self.Dense_1(F.relu(self.MaskedBatchNorm_0(self.Dense_0(x),
                                                          mask)))


def _pair_mask(q_mask, k_mask):
    return (q_mask[:, :, None] & k_mask[:, None, :])[:, None]


class DecoderLayer(nn.Module):

    def __init__(self, dims=256, heads=8, ffn=2048):
        super().__init__()
        self.self_attn = MultiHeadAttention(dims, heads)
        self.cross_attn_text = MultiHeadAttention(dims, heads)
        self.cross_attn = MultiHeadAttention(dims, heads)
        for i in range(4):
            self.add_module(f'norm{i}', nn.LayerNorm(dims,
                                                     eps=DECODER_LN_EPS))
        self.ffn_fc1 = nn.Linear(dims, ffn)
        self.ffn_fc2 = nn.Linear(ffn, dims)

    def forward(self, q, q_pos, q_mask, feats, key_pos, k_mask, text,
                text_mask):
        qp = q + q_pos
        q = self.norm0(q + self.self_attn(qp, qp, q, _pair_mask(q_mask,
                                                                q_mask)))
        q = self.norm1(q + self.cross_attn_text(
            q + q_pos, text, text, _pair_mask(q_mask, text_mask)))
        q = self.norm2(q + self.cross_attn(
            q + q_pos, feats + key_pos, feats, _pair_mask(q_mask, k_mask)))
        return self.norm3(q + self.ffn_fc2(F.relu(self.ffn_fc1(q))))


class RegBranch(nn.Module):

    def __init__(self, dims=256):
        super().__init__()
        self.fc0 = nn.Linear(dims, dims)
        self.fc1 = nn.Linear(dims, dims)
        self.out = nn.Linear(dims, 9)

    def forward(self, q):
        return self.out(F.relu(self.fc1(F.relu(self.fc0(q)))))


def decode_baseline(xyz, d):
    size = torch.clamp(torch.exp(d[..., 3:6]), min=2e-2)
    return torch.cat([xyz + d[..., :3], size, d[..., 6:9]], dim=-1)


class ContrastiveEmbed(nn.Module):

    def __init__(self, max_text_len):
        super().__init__()
        self.max_text_len = max_text_len
        self.bias = nn.Parameter(torch.full((1, ), _CLS_BIAS))

    def forward(self, visual, text, text_mask, visual_mask=None):
        res = visual @ text.transpose(1, 2) / math.sqrt(visual.shape[-1])
        res = (res + self.bias).masked_fill(~text_mask[:, None, :], NEG)
        if visual_mask is not None:
            res = res.masked_fill(~visual_mask[:, :, None], NEG)
        return F.pad(res, (0, self.max_text_len - res.shape[-1]), value=NEG)


def select_top(scores, k):
    """Row indices of the ``k`` largest of (B, N) scores, descending, ties
    by ascending row."""
    return torch.sort(scores, dim=1, descending=True, stable=True)[1][:, :k]


class SparseFusionGrounder(nn.Module):

    def __init__(self, num_queries=256, voxel_size=0.01, max_text_len=256,
                 embed_dims=256, num_decoder_layers=6,
                 input_capacity=98304,
                 backbone_capacities=(65536, 32768, 24576, 8192, 4096, 2048),
                 fpn_capacities=(1024, 1024, 1024, 2048), resnet_depth=50,
                 mink_depth=34, text_layers=12, text_hidden=768,
                 text_heads=12, text_vocab_size=50265, text_ln_eps=1e-5):
        super().__init__()
        self.num_queries = num_queries
        self.num_decoder_layers = num_decoder_layers
        self.trunk = SparseFusionTrunk(
            voxel_size=voxel_size, input_capacity=input_capacity,
            backbone_capacities=tuple(backbone_capacities),
            resnet_depth=resnet_depth, mink_depth=mink_depth)
        self.neck = MinkNeck(self.trunk.out_channels, embed_dims, voxel_size,
                             fpn_capacities)
        self.text_encoder = TextEncoder(embed_dims, text_vocab_size,
                                        text_hidden, text_layers, text_heads,
                                        text_ln_eps)
        for i in range(num_decoder_layers):
            self.add_module(f'layer{i}', DecoderLayer(embed_dims))
        self.self_posembed = PositionEmbedding(9, embed_dims)
        self.cross_posembed = PositionEmbedding(3, embed_dims)
        self.decoder_norm = nn.LayerNorm(embed_dims, eps=DECODER_LN_EPS)
        self.reg_branch = RegBranch(embed_dims)
        self.cls_embed = ContrastiveEmbed(max_text_len)

    def encode(self, batch):
        """The selection's inputs: the neck's (feats, xyz, mask), the text
        features and mask, and the contrastive logits of every neck
        location (B, N, max_text_len)."""
        feats, xyz, mask = self.neck(self.trunk(batch))
        text_mask = batch['text_mask'] > 0
        text = self.text_encoder(batch['text_ids'], text_mask)
        enc = self.cls_embed(feats, text, text_mask, mask)
        return dict(feats=feats, xyz=xyz, mask=mask, text=text,
                    text_mask=text_mask, enc_cls=enc)

    def select(self, enc):
        """The ``num_queries`` rows with the best max-over-tokens logit,
        masked rows last."""
        sel = enc['enc_cls'].amax(-1).masked_fill(~enc['mask'],
                                                  float('-inf'))
        return select_top(sel, self.num_queries)

    def decode(self, enc, index):
        """The decoder over the queries at neck rows ``index`` (B, Q):
        per-layer token logits (L, B, Q, T) and boxes (L, B, Q, 9), the
        query mask and the prediction."""
        feats, xyz, mask = enc['feats'], enc['xyz'], enc['mask']
        text, text_mask = enc['text'], enc['text_mask']
        q, q_xyz, q_mask = (S._take_rows(t, index) for t in (feats, xyz,
                                                              mask))
        boxes = decode_baseline(q_xyz, self.reg_branch(q))
        key_pos = self.cross_posembed(xyz, mask)
        cls, all_boxes = [], []
        for i in range(self.num_decoder_layers):
            q_pos = self.self_posembed(boxes, q_mask)
            q = getattr(self, f'layer{i}')(q, q_pos, q_mask, feats, key_pos,
                                           mask, text, text_mask)
            boxes = decode_baseline(q_xyz, self.reg_branch(q))
            cls.append(self.cls_embed(self.decoder_norm(q), text, text_mask))
            all_boxes.append(boxes)
        cls = torch.stack(cls)
        scores = torch.sigmoid(cls[-1]).amax(-1).masked_fill(~q_mask, 0.0)
        return dict(cls=cls, boxes=torch.stack(all_boxes), mask=q_mask,
                    bboxes=all_boxes[-1], scores=scores, query_index=index)
