"""Multi-head dot-product attention with the semantics of flax's
``nn.MultiHeadDotProductAttention`` and ``dot_product_attention_weights``
(the JAX package's decoder, tiny text encoder and RoBERTa use them).

The products and the softmax are written out: a row whose keys are all
masked gets uniform weights here, as in flax, where
``F.scaled_dot_product_attention`` and ``nn.MultiheadAttention`` return NaN
or other values. Projections are ``nn.Linear`` subclasses that know their
head split, so the weight converter can map flax's (D, H, Dh) and
(H, Dh, D) kernels onto them.
"""

import math

import torch
from torch import nn


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          mask: torch.Tensor | None = None,
                          bias: torch.Tensor | None = None) -> torch.Tensor:
    """(B, Q, H, Dh) queries over (B, K, H, Dh) keys and values ->
    (B, Q, H, Dh).

    The query is scaled by 1/sqrt(Dh) before the product; ``bias``
    (broadcast to (B, H, Q, K)) is added to the logits; where ``mask``
    (broadcast likewise) is False the logit becomes the float32 minimum;
    softmax over the keys.
    """
    q = q / math.sqrt(q.shape[-1])
    logits = torch.einsum('bqhd,bkhd->bhqk', q, k)
    if bias is not None:
        logits = logits + bias
    if mask is not None:
        logits = torch.where(mask, logits, logits.new_tensor(
            torch.finfo(logits.dtype).min))
    return torch.einsum('bhqk,bkhd->bqhd', torch.softmax(logits, -1), v)


class HeadsIn(nn.Linear):
    """D -> (H, Dh) projection (flax DenseGeneral, kernel (D, H, Dh) and
    bias (H, Dh); stored here as (H * Dh, D) and (H * Dh,))."""

    def __init__(self, in_features: int, heads: int, head_dim: int):
        super().__init__(in_features, heads * head_dim)
        self.heads = heads

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x).unflatten(-1, (self.heads, -1))


class HeadsOut(nn.Linear):
    """(H, Dh) -> D projection (flax DenseGeneral, kernel (H, Dh, D); stored
    here as (D, H * Dh))."""

    def __init__(self, heads: int, head_dim: int, out_features: int):
        super().__init__(heads * head_dim, out_features)
        self.heads = heads

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.flatten(-2))


class MultiHeadDotProductAttention(nn.Module):
    """flax ``nn.MultiHeadDotProductAttention``: ``query``, ``key``,
    ``value`` and ``out`` projections around :func:`dot_product_attention`.
    ``inputs_k`` defaults to ``inputs_q`` and ``inputs_v`` to ``inputs_k``;
    ``mask`` is boolean, broadcast to (B, H, Q, K)."""

    def __init__(self, in_features: int, num_heads: int,
                 qkv_features: int | None = None,
                 out_features: int | None = None):
        super().__init__()
        qkv = qkv_features or in_features
        if qkv % num_heads:
            raise ValueError(f'{qkv} features do not split into {num_heads} '
                             'heads')
        dh = qkv // num_heads
        self.query = HeadsIn(in_features, num_heads, dh)
        self.key = HeadsIn(in_features, num_heads, dh)
        self.value = HeadsIn(in_features, num_heads, dh)
        self.out = HeadsOut(num_heads, dh, out_features or in_features)

    def forward(self, inputs_q: torch.Tensor,
                inputs_k: torch.Tensor | None = None,
                inputs_v: torch.Tensor | None = None,
                mask: torch.Tensor | None = None) -> torch.Tensor:
        inputs_k = inputs_q if inputs_k is None else inputs_k
        inputs_v = inputs_k if inputs_v is None else inputs_v
        return self.out(dot_product_attention(
            self.query(inputs_q), self.key(inputs_k), self.value(inputs_v),
            mask=mask))
