"""Port vs reference on weights converted from a reference checkpoint:
the tiny grounder (RoBERTa text arch) loaded from the JAX test's grounder
checkpoint plus the backbones of ``full_reference_state_dict``, a RoBERTa of
its width and ``text_feat_map``, each package through its own converters,
serves two prompts tokenized by ``BPETokenizer`` on the CPU (flat engine
on the JAX side). Integers (query and keep masks) are exact; floats
(per-layer token logits and boxes, predictions) agree within atol 1e-4
plus rtol 1e-5.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from embodiedscan_tpu.models.grounding import SparseFusionGrounder as JG
from embodiedscan_tpu.utils import convert_weights as jC
from embodiedscan_torch.models.grounding import SparseFusionGrounder as TG
from embodiedscan_torch.models.text import BPETokenizer
from embodiedscan_torch.utils import convert_weights as tC

from test_torch_convert import GROUND, _grounder_sd
from test_torch_helpers import (flat_engine, random_variables, tiny_batch,
                                to_numpy, to_torch)

TOL = dict(atol=1e-4, rtol=1e-5)
FIXDIR = os.path.join(os.path.dirname(__file__), 'fixtures', 'roberta_tok')


@pytest.fixture(scope='module')
def grounder():
    """The tiny grounder on two prompts tokenized by ``BPETokenizer`` from
    the in-repo RoBERTa vocabulary fixture."""
    batch = tiny_batch()
    enc = BPETokenizer(FIXDIR, max_len=GROUND['max_text_len'])(
        ['find the red chair next to the table',
         'the small lamp on the desk near the window'])
    batch.update(text_ids=enc['input_ids'], text_mask=enc['attention_mask'])
    sd = _grounder_sd()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    with flat_engine():
        jm = JG(**GROUND)
        var, _, _ = jC.load_reference_grounder(
            random_variables(jm, (jb,), train=False, mode='feats'), sd,
            mink_depth=18, resnet_depth=18, num_layers=2, num_heads=8)
        jouts = jax.jit(lambda v, b: jm.apply(v, b, train=False,
                                              mode='feats'))(var, jb)
        # mode='predict' of the reference, from the same outputs
        scores = jnp.max(jax.nn.sigmoid(jouts.cls[-1]), -1)
        jpreds = dict(bboxes=jouts.boxes[-1], mask=jouts.query_mask,
                      scores=jnp.where(jouts.query_mask, scores, 0))
        jouts, jpreds = to_numpy((jouts, jpreds))
    tm, n, skipped = tC.load_reference_grounder(
        TG(**GROUND).eval(), sd, mink_depth=18, resnet_depth=18,
        num_layers=2, num_heads=8)
    assert skipped == [] and n == sum(1 for _ in tm.parameters()) + \
        sum(1 for _ in tm.buffers())
    tb = to_torch(batch)
    with torch.no_grad():
        touts, tpreds = tm(tb, mode='feats'), tm(tb, mode='predict')
    return jouts, jpreds, to_numpy(touts), to_numpy(tpreds)


def test_grounder_integers_exact(grounder):
    jouts, jpreds, touts, tpreds = grounder
    np.testing.assert_array_equal(touts.query_mask, jouts.query_mask)
    np.testing.assert_array_equal(tpreds['mask'], jpreds['mask'])
    assert tpreds['mask'].any()


def test_grounder_floats_within_tolerance(grounder):
    jouts, jpreds, touts, tpreds = grounder
    np.testing.assert_allclose(touts.cls, jouts.cls, err_msg='cls', **TOL)
    np.testing.assert_allclose(touts.boxes, jouts.boxes, err_msg='boxes',
                               **TOL)
    for key in ('bboxes', 'scores'):
        assert np.isfinite(tpreds[key]).all()
        np.testing.assert_allclose(tpreds[key], jpreds[key], err_msg=key,
                                   **TOL)
