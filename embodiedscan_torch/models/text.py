"""Text encoding for visual grounding (port of
``embodiedscan_tpu/models/text.py``: ``SimpleTokenizer``,
``build_positive_maps`` and ``TextEncoder``).

The JAX package runs HuggingFace's Flax RoBERTa; the port carries its own
RoBERTa in PyTorch, with the submodules named as the flax tree
(``FlaxRobertaModule_0/embeddings/word_embeddings``,
``.../encoder/layer/0/attention/self/query``, ...) so weights carry over
leaf for leaf. Its LayerNorms take HF's ``layer_norm_eps`` 1e-12, the
tiny arch's take flax's 1e-6; the GELU is the exact (erf) one.
"""

import re
from typing import Dict, List

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from .attention import MultiHeadDotProductAttention, dot_product_attention

_TOKEN_RE = re.compile(r"\w+|[^\w\s]")

ROBERTA_LN_EPS = 1e-12  # RobertaConfig.layer_norm_eps
FLAX_LN_EPS = 1e-6  # flax nn.LayerNorm's default


class SimpleTokenizer:
    """Deterministic offline tokenizer with char_to_token support."""

    def __init__(self, vocab_size: int = 30522, max_len: int = 256):
        self.vocab_size = vocab_size
        self.max_len = max_len
        self.bos, self.eos, self.pad = 0, 2, 1  # roberta conventions

    def _hash(self, word: str) -> int:
        h = 5381
        for ch in word.lower():
            h = ((h * 33) ^ ord(ch)) & 0x7FFFFFFF
        return 4 + h % (self.vocab_size - 4)

    def __call__(self, texts: List[str]) -> Dict[str, np.ndarray]:
        b = len(texts)
        ids = np.full((b, self.max_len), self.pad, np.int32)
        mask = np.zeros((b, self.max_len), bool)
        self._char_maps = []
        for i, text in enumerate(texts):
            toks = [(m.group(0), m.start(), m.end())
                    for m in _TOKEN_RE.finditer(text)]
            toks = toks[:self.max_len - 2]
            ids[i, 0] = self.bos
            char_map = np.full(len(text), -1, np.int64)
            for j, (w, s, e) in enumerate(toks):
                ids[i, j + 1] = self._hash(w)
                char_map[s:e] = j + 1
            ids[i, len(toks) + 1] = self.eos
            mask[i, :len(toks) + 2] = True
            self._char_maps.append(char_map)
        return dict(input_ids=ids, attention_mask=mask.astype(np.int32))

    def char_to_token(self, batch_idx: int, char_idx: int):
        cm = self._char_maps[batch_idx]
        if char_idx < 0 or char_idx >= len(cm) or cm[char_idx] < 0:
            return None
        return int(cm[char_idx])


def build_positive_maps(tokenizer, texts: List[str],
                        tokens_positive: List[List[List[List[int]]]],
                        max_text_len: int, max_boxes: int) -> np.ndarray:
    """Char spans -> normalized (B, max_boxes, max_text_len) token maps: a
    box's row has equal weights summing to ~1 over its spans' tokens.

    ``tokenizer`` must have tokenized ``texts`` last (its ``char_to_token``
    reads that call). A span edge on a character without a token tries the
    next one or two characters (start) or the previous one or two (end);
    a span whose edge still has none is skipped.
    """
    b = len(texts)
    out = np.zeros((b, max_boxes, max_text_len), np.float32)
    for i in range(b):
        for j, spans in enumerate(tokens_positive[i][:max_boxes]):
            for beg, end in spans:
                beg_pos = tokenizer.char_to_token(i, beg)
                end_pos = tokenizer.char_to_token(i, end - 1)
                if beg_pos is None:
                    beg_pos = tokenizer.char_to_token(i, beg + 1)
                    if beg_pos is None:
                        beg_pos = tokenizer.char_to_token(i, beg + 2)
                if end_pos is None:
                    end_pos = tokenizer.char_to_token(i, end - 2)
                    if end_pos is None:
                        end_pos = tokenizer.char_to_token(i, end - 3)
                if beg_pos is None or end_pos is None:
                    continue
                out[i, j, beg_pos:end_pos + 1] = 1.0
        sums = out[i].sum(-1, keepdims=True)
        out[i] = out[i] / (sums + 1e-6)
    return out


class _Embeddings(nn.Module):
    """Word + token-type + position embeddings, then LayerNorm."""

    def __init__(self, vocab_size, hidden, max_positions, type_vocab_size):
        super().__init__()
        self.word_embeddings = nn.Embedding(vocab_size, hidden)
        self.position_embeddings = nn.Embedding(max_positions, hidden)
        self.token_type_embeddings = nn.Embedding(type_vocab_size, hidden)
        self.LayerNorm = nn.LayerNorm(hidden, eps=ROBERTA_LN_EPS)

    def forward(self, input_ids, token_type_ids, position_ids):
        h = (self.word_embeddings(input_ids) +
             self.token_type_embeddings(token_type_ids) +
             self.position_embeddings(position_ids))
        return self.LayerNorm(h)


class _SelfAttention(nn.Module):
    """query / key / value Dense (D, D), split into heads."""

    def __init__(self, hidden, heads):
        super().__init__()
        self.heads = heads
        self.query = nn.Linear(hidden, hidden)
        self.key = nn.Linear(hidden, hidden)
        self.value = nn.Linear(hidden, hidden)

    def forward(self, x, bias):
        q, k, v = (lin(x).unflatten(-1, (self.heads, -1))
                   for lin in (self.query, self.key, self.value))
        return dot_product_attention(q, k, v, bias=bias).flatten(-2)


class _DenseNorm(nn.Module):
    """``LayerNorm(dense(h) + residual)`` (HF's SelfOutput and Output)."""

    def __init__(self, cin, cout):
        super().__init__()
        self.dense = nn.Linear(cin, cout)
        self.LayerNorm = nn.LayerNorm(cout, eps=ROBERTA_LN_EPS)

    def forward(self, h, residual):
        return self.LayerNorm(self.dense(h) + residual)


class _Attention(nn.Module):

    def __init__(self, hidden, heads):
        super().__init__()
        # 'self' is the flax name; reached through getattr
        self.add_module('self', _SelfAttention(hidden, heads))
        self.output = _DenseNorm(hidden, hidden)

    def forward(self, x, bias):
        return self.output(getattr(self, 'self')(x, bias), x)


class _Intermediate(nn.Module):

    def __init__(self, hidden, inner):
        super().__init__()
        self.dense = nn.Linear(hidden, inner)

    def forward(self, x):
        return F.gelu(self.dense(x))  # exact erf GELU, HF's "gelu"


class _Layer(nn.Module):

    def __init__(self, hidden, heads):
        super().__init__()
        self.attention = _Attention(hidden, heads)
        self.intermediate = _Intermediate(hidden, 4 * hidden)
        self.output = _DenseNorm(4 * hidden, hidden)

    def forward(self, x, bias):
        a = self.attention(x, bias)
        return self.output(self.intermediate(a), a)


class _Encoder(nn.Module):

    def __init__(self, hidden, layers, heads):
        super().__init__()
        self.layer = nn.ModuleList(_Layer(hidden, heads)
                                   for _ in range(layers))

    def forward(self, x, bias):
        for layer in self.layer:
            x = layer(x, bias)
        return x


class RobertaModule(nn.Module):
    """HF ``FlaxRobertaModule`` without the pooler (eval: no dropout):
    ``(input_ids, attention_mask, token_type_ids, position_ids)`` ->
    last hidden state (B, L, hidden). Padded keys get the additive bias
    float32-min, as HF's."""

    def __init__(self, vocab_size, hidden, layers, heads,
                 max_positions=514, type_vocab_size=1):
        super().__init__()
        self.embeddings = _Embeddings(vocab_size, hidden, max_positions,
                                      type_vocab_size)
        self.encoder = _Encoder(hidden, layers, heads)

    def forward(self, input_ids, attention_mask, token_type_ids,
                position_ids):
        x = self.embeddings(input_ids, token_type_ids, position_ids)
        keep = (attention_mask > 0)[:, None, None, :]
        bias = torch.zeros(keep.shape, dtype=x.dtype, device=x.device)
        bias = bias.masked_fill(~keep, torch.finfo(x.dtype).min)
        return self.encoder(x, bias)


class TextEncoder(nn.Module):
    """RoBERTa-architecture text encoder + projection to embed_dims.

    Args:
        arch: 'roberta' (RoBERTa of ``layers`` x ``hidden``, ``heads``
            heads, vocabulary ``vocab_size``) or 'tiny' (the JAX package's
            small pre-norm transformer, for tests).
        frozen: detach the encoder's output (the projection stays
            trainable), the reference's lr_mult 0.
    """

    def __init__(self, embed_dims: int = 256, arch: str = 'roberta',
                 vocab_size: int = 30522, hidden: int = 768,
                 layers: int = 12, heads: int = 12, frozen: bool = True):
        super().__init__()
        self.arch = arch
        self.layers = layers
        self.frozen = frozen
        if arch == 'roberta':
            self.FlaxRobertaModule_0 = RobertaModule(vocab_size, hidden,
                                                     layers, heads)
            self.proj_name = 'Dense_0'
        elif arch == 'tiny':
            self.add_module('Embed_0', nn.Embedding(vocab_size, hidden))
            for i in range(layers):
                for j in (2 * i, 2 * i + 1):
                    self.add_module(f'LayerNorm_{j}', nn.LayerNorm(
                        hidden, eps=FLAX_LN_EPS))
                self.add_module(f'MultiHeadDotProductAttention_{i}',
                                MultiHeadDotProductAttention(hidden, heads))
                self.add_module(f'Dense_{2 * i}', nn.Linear(hidden,
                                                            4 * hidden))
                self.add_module(f'Dense_{2 * i + 1}', nn.Linear(4 * hidden,
                                                                hidden))
            self.add_module(f'LayerNorm_{2 * layers}', nn.LayerNorm(
                hidden, eps=FLAX_LN_EPS))
            self.proj_name = f'Dense_{2 * layers}'
        else:
            raise ValueError(f'unknown text arch {arch!r}')
        # text_feat_map, the projection to the decoder's width
        self.add_module(self.proj_name, nn.Linear(hidden, embed_dims))

    def _tiny(self, input_ids, attention_mask):
        x = self.Embed_0(input_ids)
        mask = (attention_mask > 0)[:, None, None, :]
        for i in range(self.layers):
            y = getattr(self, f'LayerNorm_{2 * i}')(x)
            x = x + getattr(self, f'MultiHeadDotProductAttention_{i}')(
                y, y, mask=mask)
            y = getattr(self, f'LayerNorm_{2 * i + 1}')(x)
            y = F.relu(getattr(self, f'Dense_{2 * i}')(y))
            x = x + getattr(self, f'Dense_{2 * i + 1}')(y)
        return getattr(self, f'LayerNorm_{2 * self.layers}')(x)

    def forward(self, input_ids: torch.Tensor,
                attention_mask: torch.Tensor) -> torch.Tensor:
        """(B, L) token ids and 0/1 mask -> (B, L, embed_dims)."""
        if self.arch == 'roberta':
            mask = attention_mask.long()
            hidden = self.FlaxRobertaModule_0(
                input_ids, mask, torch.zeros_like(input_ids),
                torch.cumsum(mask, -1) * mask + 1)
        else:
            hidden = self._tiny(input_ids, attention_mask)
        if self.frozen:
            hidden = hidden.detach()
        return getattr(self, self.proj_name)(hidden)
