"""RoBERTa's encoder (roberta-base: 12 layers, hidden 768, 12 heads, FFN
3072, vocabulary 50265, 514 positions, LayerNorm eps 1e-5, pad id 1) and
the grounder's projection to the decoder's width, in plain tensor
operations.

The published layer equations (HF ``RobertaModel``, evaluation):

    positions = cumsum(not pad) * (not pad) + pad_id
    x = LN(word[ids] + position[positions] + token_type[0])
    per layer:  a = softmax(Q K^T / sqrt(d_head) + key_bias) V
                h = LN(x + W_o a)
                x = LN(h + W_2 gelu(W_1 h))     (the exact erf GELU)

with ``key_bias`` the float32 minimum on padded keys. Departures from the
published description:

- "not pad" is the prompt's text mask rather than ``ids != pad_id``: the
  two agree wherever the padding is exactly the masked tail, as in every
  prompt the benchmark draws;
- no pooler (the grounder reads the last hidden state) and no dropout;
- the submodules are named as the port's (``FlaxRobertaModule_0``,
  ``Dense_0`` for the projection) so that weights are handed over by
  name.
"""

import torch
from torch import nn
from torch.nn import functional as F

from .attention import attend


class _SelfAttention(nn.Module):

    def __init__(self, hidden, heads):
        super().__init__()
        self.heads = heads
        self.query = nn.Linear(hidden, hidden)
        self.key = nn.Linear(hidden, hidden)
        self.value = nn.Linear(hidden, hidden)

    def forward(self, x, key_bias):
        def split(t):
            return t.reshape(*t.shape[:-1], self.heads, -1)

        a = attend(split(self.query(x)), split(self.key(x)),
                   split(self.value(x)), bias=key_bias)
        return a.reshape(*a.shape[:-2], -1)


class _AddNorm(nn.Module):
    """LN(residual + dense(h))."""

    def __init__(self, cin, cout, eps):
        super().__init__()
        self.dense = nn.Linear(cin, cout)
        self.LayerNorm = nn.LayerNorm(cout, eps=eps)

    def forward(self, h, residual):
        return self.LayerNorm(residual + self.dense(h))


class _Attention(nn.Module):

    def __init__(self, hidden, heads, eps):
        super().__init__()
        self.add_module('self', _SelfAttention(hidden, heads))
        self.output = _AddNorm(hidden, hidden, eps)

    def forward(self, x, key_bias):
        return self.output(getattr(self, 'self')(x, key_bias), x)


class _Intermediate(nn.Module):

    def __init__(self, hidden, inner):
        super().__init__()
        self.dense = nn.Linear(hidden, inner)

    def forward(self, h):
        return F.gelu(self.dense(h))


class _Layer(nn.Module):

    def __init__(self, hidden, heads, eps):
        super().__init__()
        self.attention = _Attention(hidden, heads, eps)
        self.intermediate = _Intermediate(hidden, 4 * hidden)
        self.output = _AddNorm(4 * hidden, hidden, eps)

    def forward(self, x, key_bias):
        h = self.attention(x, key_bias)
        return self.output(self.intermediate(h), h)


class _Embeddings(nn.Module):

    def __init__(self, vocab, hidden, positions, eps):
        super().__init__()
        self.word_embeddings = nn.Embedding(vocab, hidden)
        self.position_embeddings = nn.Embedding(positions, hidden)
        self.token_type_embeddings = nn.Embedding(1, hidden)
        self.LayerNorm = nn.LayerNorm(hidden, eps=eps)


class _Encoder(nn.Module):

    def __init__(self, hidden, layers, heads, eps):
        super().__init__()
        self.layer = nn.ModuleList(_Layer(hidden, heads, eps)
                                   for _ in range(layers))


class Roberta(nn.Module):
    """RoBERTa's embeddings and encoder: (B, L) ids and 0/1 mask ->
    (B, L, hidden)."""

    PAD_ID = 1

    def __init__(self, vocab, hidden, layers, heads, eps, positions=514):
        super().__init__()
        self.embeddings = _Embeddings(vocab, hidden, positions, eps)
        self.encoder = _Encoder(hidden, layers, heads, eps)

    def forward(self, ids, text_mask):
        e = self.embeddings
        keep = text_mask.long()
        positions = torch.cumsum(keep, dim=1) * keep + self.PAD_ID
        x = e.LayerNorm(e.word_embeddings(ids) +
                        e.position_embeddings(positions) +
                        e.token_type_embeddings(torch.zeros_like(ids)))
        key_bias = torch.zeros(keep.shape, dtype=x.dtype, device=x.device)
        key_bias = key_bias.masked_fill(keep == 0,
                                        torch.finfo(x.dtype).min)
        key_bias = key_bias[:, None, None, :]
        for layer in self.encoder.layer:
            x = layer(x, key_bias)
        return x


class TextEncoder(nn.Module):
    """RoBERTa, then the grounder's ``text_feat_map``: hidden -> the
    decoder's width (``Dense_0``)."""

    def __init__(self, embed_dims, vocab, hidden, layers, heads, eps):
        super().__init__()
        self.FlaxRobertaModule_0 = Roberta(vocab, hidden, layers, heads, eps)
        self.Dense_0 = nn.Linear(hidden, embed_dims)

    def forward(self, ids, text_mask):
        return self.Dense_0(self.FlaxRobertaModule_0(ids, text_mask))
