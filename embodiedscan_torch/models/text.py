"""Text encoding for visual grounding (port of
``embodiedscan_tpu/models/text.py``: ``SimpleTokenizer``,
``get_tokenizer``, ``build_positive_maps`` and ``TextEncoder``; and
``BPETokenizer``, the port's own byte-level BPE in place of the JAX
package's ``HFTokenizer``, which wraps ``transformers``).

The JAX package runs HuggingFace's Flax RoBERTa; the port carries its own
RoBERTa in PyTorch, with the submodules named as the flax tree
(``FlaxRobertaModule_0/embeddings/word_embeddings``,
``.../encoder/layer/0/attention/self/query``, ...) so weights carry over
leaf for leaf. Its LayerNorms take ``ln_eps``: by default HF's
``RobertaConfig`` default 1e-12, as the JAX package's; the mv_grounding
presets give roberta-base's published 1e-5 (and its 50265-row vocabulary).
The tiny arch's take flax's 1e-6; the GELU is the exact (erf) one.
"""

import json
import os
import re
import unicodedata
from typing import Dict, List

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from ..utils.trace import span
from .attention import MultiHeadDotProductAttention, dot_product_attention

_TOKEN_RE = re.compile(r"\w+|[^\w\s]")

ROBERTA_LN_EPS = 1e-12  # RobertaConfig's default layer_norm_eps
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


_CONTRACTIONS = ('s', 't', 're', 've', 'm', 'll', 'd')


def _is_space(c: str) -> bool:
    r"""Unicode White_Space (the regex ``\s``): Python's isspace less the
    information separators U+001C-U+001F."""
    return c.isspace() and not '\x1c' <= c <= '\x1f'


def _is_number(c: str) -> bool:
    return unicodedata.category(c)[0] == 'N'  # \p{N}: Nd, Nl, No


def _is_other(c: str) -> bool:
    return not (_is_space(c) or c.isalpha() or _is_number(c))


def _pretoken_end(text: str, i: int) -> int:
    r"""End of the pre-token starting at ``i`` under GPT-2's pattern
    ``'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|
    \s+(?!\S)|\s+`` (``str.isalpha`` is ``\p{L}``), alternatives
    tried in order at ``i``."""
    n = len(text)
    if text[i] == "'":
        for suffix in _CONTRACTIONS:
            if text.startswith(suffix, i + 1):
                return i + 1 + len(suffix)
    start = i + 1 if text[i] == ' ' and i + 1 < n else i
    for cls in (str.isalpha, _is_number, _is_other):
        j = start
        while j < n and cls(text[j]):
            j += 1
        if j > start:
            return j
    # whitespace: the run, less its last character when a non-space
    # follows it (that one prefixes the next word), unless it is alone
    j = i
    while j < n and _is_space(text[j]):
        j += 1
    return j if j == n or j - i == 1 else j - 1


def _bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's byte -> printable character table: printable Latin-1 bytes
    map to themselves, the other 68 to U+0100 onwards (the space to
    'Ġ')."""
    keep = list(range(ord('!'), ord('~') + 1)) + \
        list(range(ord('¡'), ord('¬') + 1)) + list(range(ord('®'), 256))
    table, extra = {b: chr(b) for b in keep}, 0
    for b in range(256):
        if b not in table:
            table[b] = chr(256 + extra)
            extra += 1
    return table


class BPETokenizer:
    """Byte-level BPE of RoBERTa (GPT-2's), read from a directory's
    ``vocab.json`` and ``merges.txt``, with the output of
    ``RobertaTokenizerFast(texts, padding='max_length', truncation=True,
    max_length=max_len)``: ``<s>`` text tokens ``</s>`` then ``<pad>``,
    the text cut to ``max_len - 2`` tokens. ``char_to_token`` follows the
    fast tokenizer's ``trim_offsets=True``: a token's span leaves out its
    leading space, so a space maps to no token; a character split over
    two tokens maps to the first. A special token written inside a text
    is tokenized as plain text.
    """

    def __init__(self, path: str, max_len: int = 256):
        with open(os.path.join(path, 'vocab.json'), encoding='utf-8') as f:
            self.vocab = json.load(f)
        ranks = {}
        with open(os.path.join(path, 'merges.txt'), encoding='utf-8') as f:
            for line in f:
                if line.startswith('#version'):
                    continue
                pair = tuple(line.rstrip('\r\n').split(' '))
                if len(pair) == 2:
                    ranks.setdefault(pair, len(ranks))
        self.ranks = ranks
        self.max_len = max_len
        self.vocab_size = len(self.vocab)
        self.bos, self.pad, self.eos = (self.vocab[t] for t in
                                        ('<s>', '<pad>', '</s>'))
        self.unk = self.vocab.get('<unk>')
        self.byte_char = _bytes_to_unicode()
        self._cache = {}

    def _bpe(self, word: str) -> List[str]:
        """Merges the lowest-ranked adjacent pair, every occurrence left to
        right, until no pair of ``word``'s symbols has a rank."""
        if word in self._cache:
            return self._cache[word]
        parts = list(word)
        while len(parts) > 1:
            best = min(zip(parts, parts[1:]),
                       key=lambda p: self.ranks.get(p, float('inf')))
            if best not in self.ranks:
                break
            merged, i = [], 0
            while i < len(parts):
                if i + 1 < len(parts) and (parts[i], parts[i + 1]) == best:
                    merged.append(parts[i] + parts[i + 1])
                    i += 2
                else:
                    merged.append(parts[i])
                    i += 1
            parts = merged
        self._cache[word] = parts
        return parts

    def tokenize(self, text: str):
        """(ids, spans): the text's token ids and each token's character
        span [start, end), trimmed of its leading spaces."""
        ids, spans, i = [], [], 0
        while i < len(text):
            end = _pretoken_end(text, i)
            chars, owner = [], []  # byte characters, their text position
            for pos in range(i, end):
                for b in text[pos].encode('utf-8'):
                    chars.append(self.byte_char[b])
                    owner.append(pos)
            at = 0
            for sym in self._bpe(''.join(chars)):
                ids.append(self.vocab.get(sym, self.unk))
                lead = len(sym) - len(sym.lstrip(self.byte_char[32]))
                lo, hi = owner[at], owner[at + len(sym) - 1] + 1
                spans.append((min(lo + lead, hi), hi))
                at += len(sym)
            i = end
        return ids, spans

    def __call__(self, texts: List[str]) -> Dict[str, np.ndarray]:
        b = len(texts)
        ids = np.full((b, self.max_len), self.pad, np.int32)
        mask = np.zeros((b, self.max_len), np.int32)
        self._char_maps = []
        for i, text in enumerate(texts):
            tok, spans = self.tokenize(text)
            tok, spans = tok[:self.max_len - 2], spans[:self.max_len - 2]
            row = [self.bos] + tok + [self.eos]
            ids[i, :len(row)] = row
            mask[i, :len(row)] = 1
            char_map = np.full(len(text), -1, np.int64)
            for j in range(len(spans) - 1, -1, -1):  # the first token wins
                char_map[spans[j][0]:spans[j][1]] = j + 1
            self._char_maps.append(char_map)
        return dict(input_ids=ids, attention_mask=mask)

    def char_to_token(self, batch_idx: int, char_idx: int):
        cm = self._char_maps[batch_idx]
        if char_idx < 0 or char_idx >= len(cm) or cm[char_idx] < 0:
            return None
        return int(cm[char_idx])


def get_tokenizer(path: str, max_len: int):
    """:class:`BPETokenizer` over the vocabulary files in ``path``, or the
    offline hash tokenizer when ``path`` is empty. A path without
    ``vocab.json`` and ``merges.txt`` raises."""
    if path:
        return BPETokenizer(path, max_len=max_len)
    return SimpleTokenizer(max_len=max_len)


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

    def __init__(self, vocab_size, hidden, max_positions, type_vocab_size,
                 ln_eps):
        super().__init__()
        self.word_embeddings = nn.Embedding(vocab_size, hidden)
        self.position_embeddings = nn.Embedding(max_positions, hidden)
        self.token_type_embeddings = nn.Embedding(type_vocab_size, hidden)
        self.LayerNorm = nn.LayerNorm(hidden, eps=ln_eps)

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

    def __init__(self, cin, cout, ln_eps):
        super().__init__()
        self.dense = nn.Linear(cin, cout)
        self.LayerNorm = nn.LayerNorm(cout, eps=ln_eps)

    def forward(self, h, residual):
        return self.LayerNorm(self.dense(h) + residual)


class _Attention(nn.Module):

    def __init__(self, hidden, heads, ln_eps):
        super().__init__()
        # 'self' is the flax name; reached through getattr
        self.add_module('self', _SelfAttention(hidden, heads))
        self.output = _DenseNorm(hidden, hidden, ln_eps)

    def forward(self, x, bias):
        return self.output(getattr(self, 'self')(x, bias), x)


class _Intermediate(nn.Module):

    def __init__(self, hidden, inner):
        super().__init__()
        self.dense = nn.Linear(hidden, inner)

    def forward(self, x):
        return F.gelu(self.dense(x))  # exact erf GELU, HF's "gelu"


class _Layer(nn.Module):

    def __init__(self, hidden, heads, ln_eps):
        super().__init__()
        self.attention = _Attention(hidden, heads, ln_eps)
        self.intermediate = _Intermediate(hidden, 4 * hidden)
        self.output = _DenseNorm(4 * hidden, hidden, ln_eps)

    def forward(self, x, bias):
        a = self.attention(x, bias)
        return self.output(self.intermediate(a), a)


class _Encoder(nn.Module):

    def __init__(self, hidden, layers, heads, ln_eps):
        super().__init__()
        self.layer = nn.ModuleList(_Layer(hidden, heads, ln_eps)
                                   for _ in range(layers))

    def forward(self, x, bias):
        for layer in self.layer:
            x = layer(x, bias)
        return x


class RobertaModule(nn.Module):
    """HF ``FlaxRobertaModule`` without the pooler (eval: no dropout):
    ``(input_ids, attention_mask, token_type_ids, position_ids)`` ->
    last hidden state (B, L, hidden). Padded keys get the additive bias
    float32-min, as HF's. ``ln_eps``: every LayerNorm's epsilon."""

    def __init__(self, vocab_size, hidden, layers, heads,
                 max_positions=514, type_vocab_size=1,
                 ln_eps=ROBERTA_LN_EPS):
        super().__init__()
        self.embeddings = _Embeddings(vocab_size, hidden, max_positions,
                                      type_vocab_size, ln_eps)
        self.encoder = _Encoder(hidden, layers, heads, ln_eps)

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
            heads, vocabulary ``vocab_size``, LayerNorm epsilon
            ``ln_eps``) or 'tiny' (the JAX package's small pre-norm
            transformer, for tests, its norms at flax's 1e-6).
        frozen: detach the encoder's output (the projection stays
            trainable), the reference's lr_mult 0.
    """

    def __init__(self, embed_dims: int = 256, arch: str = 'roberta',
                 vocab_size: int = 30522, hidden: int = 768,
                 layers: int = 12, heads: int = 12, frozen: bool = True,
                 ln_eps: float = ROBERTA_LN_EPS):
        super().__init__()
        self.arch = arch
        self.layers = layers
        self.frozen = frozen
        if arch == 'roberta':
            self.FlaxRobertaModule_0 = RobertaModule(vocab_size, hidden,
                                                     layers, heads,
                                                     ln_eps=ln_eps)
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
        with span('es.text'):
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
