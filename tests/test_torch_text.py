"""Port vs reference: the tokenizer, the text encoder (RoBERTa and the tiny
arch) and the attention module with flax's semantics.

Inputs are seeded numpy arrays, weights random flax trees converted leaf
by leaf. Token ids, masks and char_to_token are identical. Floats agree
within atol 2e-6 plus rtol 1e-5 (float32 products and LayerNorms in
another order through two layers; the largest outputs are of order 10).
"""

import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp

from embodiedscan_tpu.models.text import SimpleTokenizer as JTok
from embodiedscan_tpu.models.text import TextEncoder as JText
from embodiedscan_torch.models.attention import MultiHeadDotProductAttention
from embodiedscan_torch.models.text import SimpleTokenizer as TTok
from embodiedscan_torch.models.text import TextEncoder as TText
from embodiedscan_torch.utils.convert_weights import (export_jax_tree,
                                                      load_jax_variables)

from test_torch_helpers import random_variables, to_numpy

TOL = dict(atol=2e-6, rtol=1e-5)
TEXTS = ['find the red chair near the wall.',
         "It's the lamp (left of the sofa), isn't it?",
         'a' + ' very' * 40 + ' long prompt that is cut at max_len',
         '', 'Ünïcödé wörds, dashes-and_underscores: 3.5 m!']


@pytest.mark.parametrize('max_len', [8, 16, 64])
def test_tokenizer_ids_masks_char_to_token(max_len):
    want, got = JTok(max_len=max_len), TTok(max_len=max_len)
    jw, tw = want(TEXTS), got(TEXTS)
    for key in ('input_ids', 'attention_mask'):
        assert tw[key].dtype == jw[key].dtype
        np.testing.assert_array_equal(tw[key], jw[key])
    for i, text in enumerate(TEXTS):
        for c in range(-1, len(text) + 1):
            assert got.char_to_token(i, c) == want.char_to_token(i, c)


def _tokens(b=3, n=12, seed=0):
    """Random ids with 3, 7 and n valid tokens (padded positions hold the
    pad id, as the tokenizer writes them)."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(4, 30522, (b, n)).astype(np.int32)
    mask = np.zeros((b, n), np.int32)
    for i, length in enumerate((3, 7, n)[:b]):
        mask[i, :length] = 1
    return np.where(mask > 0, ids, 1).astype(np.int32), mask


@pytest.mark.parametrize('arch', ['roberta', 'tiny'])
def test_text_encoder_matches_reference(arch):
    ids, mask = _tokens()
    kw = dict(embed_dims=16, arch=arch, layers=2, hidden=32, heads=4)
    jm = JText(**kw)
    var = random_variables(jm, (jnp.asarray(ids), jnp.asarray(mask)))
    want = np.asarray(jm.apply(var, jnp.asarray(ids), jnp.asarray(mask)))
    tm = load_jax_variables(TText(**kw).eval(), var['params'])
    got = to_numpy(tm(torch.from_numpy(ids), torch.from_numpy(mask)))
    assert got.shape == want.shape == (3, 12, 16)
    np.testing.assert_allclose(got, want, **TOL)
    # the tree round trip: every leaf back in the flax layout, bit for bit
    back = export_jax_tree(tm)
    for path, leaf in jax.tree_util.tree_leaves_with_path(var['params']):
        node = back
        for k in path:
            node = node[k.key]
        np.testing.assert_array_equal(node, leaf)


def test_roberta_names_follow_the_flax_tree():
    tm = TText(embed_dims=16, arch='roberta', layers=2, hidden=32, heads=4)
    names = dict(tm.named_parameters())
    assert 'FlaxRobertaModule_0.encoder.layer.1.attention.self.query.weight' \
        in names
    assert names['FlaxRobertaModule_0.embeddings.word_embeddings.weight'
                 ].shape == (30522, 32)
    assert tm.FlaxRobertaModule_0.embeddings.LayerNorm.eps == 1e-12
    assert 'Dense_0.weight' in names


def test_frozen_encoder_detaches_only_the_trunk():
    ids, mask = _tokens()
    tm = TText(embed_dims=16, arch='tiny', layers=1, hidden=32, heads=4)
    tm(torch.from_numpy(ids), torch.from_numpy(mask)).sum().backward()
    assert tm.Dense_2.weight.grad is not None  # the projection trains
    assert tm.Embed_0.weight.grad is None


@pytest.mark.parametrize('masked_row', [False, True])
def test_attention_matches_flax(masked_row):
    """flax nn.MultiHeadDotProductAttention, with a query row whose keys
    are all masked: uniform weights (the mean of the values) in both."""
    rng = np.random.RandomState(1)
    b, q, k, d, h = 2, 5, 7, 32, 4
    xq = rng.randn(b, q, d).astype(np.float32)
    xk = rng.randn(b, k, d).astype(np.float32)
    xv = rng.randn(b, k, d).astype(np.float32)
    mask = rng.rand(b, 1, q, k) > 0.3
    if masked_row:
        mask[1, 0, 2] = False
    jm = fnn.MultiHeadDotProductAttention(num_heads=h, qkv_features=d)
    args = tuple(jnp.asarray(a) for a in (xq, xk, xv))
    var = random_variables(jm, args, mask=jnp.asarray(mask))
    want = np.asarray(jm.apply(var, *args, mask=jnp.asarray(mask)))
    tm = load_jax_variables(MultiHeadDotProductAttention(d, h), var['params'])
    got = to_numpy(tm(*(torch.from_numpy(a) for a in (xq, xk, xv)),
                      mask=torch.from_numpy(mask)))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **TOL)
    if masked_row:
        vals = to_numpy(tm.value(torch.from_numpy(xv)))[1].mean(0)
        mean = to_numpy(tm.out(torch.from_numpy(vals)))
        np.testing.assert_allclose(got[1, 2], mean, **TOL)
