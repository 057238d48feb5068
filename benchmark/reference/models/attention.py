"""Multi-head attention as the grounder's decoder uses it, in plain tensor
operations.

``MultiHeadAttention(q, k, v, mask)``: the published scaled dot-product
attention, softmax(Q K^T / sqrt(d_head)) V over ``heads`` heads, with a
``query``, ``key``, ``value`` and ``out`` projection (each a ``Linear``
with bias). Departures from the published description (mmcv's
``MultiheadAttention`` in EmbodiedScan's decoder):

- no dropout (evaluation);
- a masked key's logit is the float32 minimum instead of -inf, so a query
  whose keys are all masked attends to them uniformly (the port's
  semantics, flax's) where -inf would give NaN;
- the projections are four ``Linear`` layers named as the port's, where
  mmcv packs the input projections into one ``in_proj_weight``.
"""

import math

import torch
from torch import nn


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           mask: torch.Tensor | None = None,
           bias: torch.Tensor | None = None) -> torch.Tensor:
    """(B, Q, H, d) queries over (B, K, H, d) keys and values ->
    (B, Q, H, d): softmax over the keys of Q K^T / sqrt(d) (+ ``bias``;
    the float32 minimum where the boolean ``mask``, broadcast to
    (B, H, Q, K), is False) times V."""
    logits = torch.einsum('bqhd,bkhd->bhqk', q, k) / math.sqrt(q.shape[-1])
    if bias is not None:
        logits = logits + bias
    if mask is not None:
        logits = logits.masked_fill(~mask, torch.finfo(logits.dtype).min)
    weights = torch.softmax(logits, dim=-1)
    return torch.einsum('bhqk,bkhd->bqhd', weights, v)


class MultiHeadAttention(nn.Module):
    """``dims`` -> ``heads`` heads of ``dims // heads`` -> ``dims``."""

    def __init__(self, dims: int, heads: int):
        super().__init__()
        self.heads = heads
        self.query = nn.Linear(dims, dims)
        self.key = nn.Linear(dims, dims)
        self.value = nn.Linear(dims, dims)
        self.out = nn.Linear(dims, dims)

    def forward(self, q_in, k_in, v_in, mask=None):
        def split(x):
            return x.reshape(*x.shape[:-1], self.heads, -1)

        h = attend(split(self.query(q_in)), split(self.key(k_in)),
                   split(self.value(v_in)), mask)
        return self.out(h.reshape(*h.shape[:-2], -1))
