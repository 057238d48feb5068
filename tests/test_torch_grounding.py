"""Port vs reference: the mv_grounding serving slice (flat engine) on the
tiny grounder of ``tests/test_grounding.py``, weights converted leaf by
leaf from one random flax tree.

Two models: RoBERTa text encoder with the 'baseline' box coder, and the
tiny text arch with the 'FCAF' coder and FPN capacities cut to 4, so that
its neck keeps fewer valid rows than queries (masked queries, fully masked
attention rows, ties among the -inf selection scores). Each serves two
batches of the same shapes: the seeded room, and one whose second sample
keeps 6 points (one voxel at the coarsest level). The model's
``max_text_len`` exceeds the prompt length so the logits' padding runs.

Integers are exact (neck coordinates and masks, selected query indices,
query mask); floats agree within atol 1e-4 plus rtol 1e-5 (float32 sums in
another order through the trunk, the neck, two text and two decoder
layers).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from embodiedscan_tpu.models.grounding import SparseFusionGrounder as JG
from embodiedscan_tpu.models.grounding import decode_fcaf as j_decode_fcaf
from embodiedscan_torch.configs.base import build_model, mv_grounding
from embodiedscan_torch.models.grounding import SparseFusionGrounder as TG
from embodiedscan_torch.models.grounding import decode_fcaf, top_k_indices
from embodiedscan_torch.models.text import SimpleTokenizer
from embodiedscan_torch.utils.convert_weights import (export_jax_tree,
                                                      load_jax_variables)

from test_torch_helpers import (flat_engine, random_variables, tiny_batch,
                                to_numpy, to_torch)

TOL = dict(atol=1e-4, rtol=1e-5)
# tests/test_grounding.py:tiny_grounder, with a longer max_text_len
TINY = dict(num_queries=16, voxel_size=0.05, max_text_len=20, embed_dims=32,
            num_decoder_layers=2, input_capacity=512,
            backbone_capacities=(512, 256, 256, 128, 64, 32),
            fpn_capacities=(64, 64, 32, 32), resnet_depth=18, mink_depth=18,
            text_layers=2, text_hidden=32, text_heads=4)
VARIANTS = {'roberta': dict(text_arch='roberta', box_coder='baseline'),
            'tiny_fcaf_few_rows': dict(text_arch='tiny', box_coder='FCAF',
                                       fpn_capacities=(4, 4, 4, 32))}


def _batches():
    """The seeded room and its sparse twin (sample 1: 6 points in a 0.2 m
    cube), each with two tokenized prompts of different lengths."""
    room = tiny_batch()
    tok = SimpleTokenizer(max_len=16)
    enc = tok(['find the red chair near the wall',
               'the lamp, left of the sofa'])
    room.update(text_ids=enc['input_ids'], text_mask=enc['attention_mask'])
    sparse = {k: v.copy() for k, v in room.items()}
    sparse['points_mask'][1] = False
    sparse['points_mask'][1, :6] = True
    sparse['points'][1, :6] = np.random.RandomState(3).uniform(
        0.5, 0.7, (6, 3)).astype(np.float32)
    return {'room': room, 'sparse': sparse}


def _jax_run(jm, v, b):
    """The reference's 'feats' and 'predict' outputs, with the neck output,
    the text features and the selected query indices, which it does not
    return: the neck's and text encoder's outputs and the first contrastive
    scores (over the neck) are captured, the top-k taken from them as
    ``SparseFusionGrounder.forward`` takes it."""
    outs, state = jm.apply(v, b, train=False, mode='feats',
                           capture_intermediates=True)
    inter = state['intermediates']
    feats, scores, xyz, mask = inter['neck']['__call__'][0]
    enc_cls = inter['cls_embed']['__call__'][0]
    sel = jnp.where(mask, jnp.max(enc_cls, -1), -jnp.inf)
    _, top = jax.lax.top_k(sel, jm.num_queries)
    parts = dict(feats=feats, scores=scores, xyz=xyz, mask=mask, top=top,
                 text_feats=inter['text_encoder']['__call__'][0])
    return parts, outs, jm.apply(v, b, train=False, mode='predict')


@pytest.fixture(scope='module', params=list(VARIANTS))
def variant(request):
    kw = dict(TINY, **VARIANTS[request.param])
    batches = _batches()
    with flat_engine():
        jm = JG(**kw)
        jb = {k: jnp.asarray(v) for k, v in batches['room'].items()}
        var = random_variables(jm, (jb,), train=False, mode='feats')
        # the reference starts the box branch's output at zero; N(0, 0.01)
        # keeps exp() of the log sizes tame, as random_variables does for
        # the detector's conv_reg (He scale gave sizes of 1e3 m)
        out = var['params']['reg_branch']['out']
        out['kernel'] = (np.random.RandomState(4).randn(
            *out['kernel'].shape) * 0.01).astype(np.float32)

        run = jax.jit(lambda v, b: _jax_run(jm, v, b))
        want = {name: to_numpy(run(var, {k: jnp.asarray(v)
                                         for k, v in b.items()}))
                for name, b in batches.items()}
    tm = TG(**kw).eval()
    load_jax_variables(tm, var['params'], var['batch_stats'])
    got = {}
    for name, b in batches.items():
        tb = to_torch(b)
        with torch.no_grad():
            feats, scores, xyz, mask = tm.neck(tm.trunk(tb))
            text_feats = tm.text_encoder(tb['text_ids'], tb['text_mask'])
            top = tm.select_queries(feats, xyz, mask, text_feats,
                                    tb['text_mask'] > 0)[3]
        parts = dict(feats=feats, scores=scores, xyz=xyz, mask=mask, top=top,
                     text_feats=text_feats)
        got[name] = to_numpy((parts, tm(tb, mode='feats'),
                              tm(tb, mode='predict')))
    return request.param, var, tm, want, got


@pytest.mark.parametrize('batch', ['room', 'sparse'])
def test_integers_exact(variant, batch):
    name, _, _, want, got = variant
    (jp, jf, jpred), (tp, tf, tpred) = want[batch], got[batch]
    for key in ('xyz', 'mask', 'top'):
        np.testing.assert_array_equal(tp[key], jp[key], err_msg=key)
    np.testing.assert_array_equal(tf.query_mask, jf.query_mask)
    np.testing.assert_array_equal(tpred['mask'], jpred['mask'])
    valid = jp['mask'].sum(1)
    if name == 'roberta':
        assert (valid >= TINY['num_queries']).all(), valid
    else:  # the case the variant is built for
        assert (valid < TINY['num_queries']).any(), valid
        assert not jf.query_mask.all()


@pytest.mark.parametrize('batch', ['room', 'sparse'])
def test_floats_within_tolerance(variant, batch):
    _, _, _, want, got = variant
    (jp, jf, jpred), (tp, tf, tpred) = want[batch], got[batch]
    for key in ('feats', 'scores', 'text_feats'):
        np.testing.assert_allclose(tp[key], jp[key], err_msg=key, **TOL)
    assert tf.cls.shape == jf.cls.shape == (2, 2, 16, TINY['max_text_len'])
    assert tf.boxes.shape == jf.boxes.shape == (2, 2, 16, 9)
    np.testing.assert_allclose(tf.cls, jf.cls, err_msg='cls', **TOL)
    np.testing.assert_allclose(tf.boxes, jf.boxes, err_msg='boxes', **TOL)
    for key in ('bboxes', 'scores'):
        assert np.isfinite(tpred[key]).all()
        np.testing.assert_allclose(tpred[key], jpred[key], err_msg=key, **TOL)


def test_strict_load_and_tree_round_trip(variant):
    """``load_jax_variables(strict=True)`` took the whole tree (trunk, neck,
    text encoder, decoder, both position embeddings); the export gives it
    back leaf for leaf, in the flax layout."""
    _, var, tm, _, _ = variant
    for kind, tree in (('params', var['params']),
                       ('buffers', var['batch_stats'])):
        back = export_jax_tree(tm, kind)
        want = jax.tree_util.tree_leaves_with_path(tree)
        assert len(jax.tree_util.tree_leaves(back)) == len(want)
        for path, leaf in want:
            node = back
            for k in path:
                node = node[k.key]
            assert node.shape == leaf.shape, path
            np.testing.assert_array_equal(node, leaf)
    assert set(var['batch_stats']) == {'trunk', 'neck', 'self_posembed',
                                       'cross_posembed'}


def test_decode_fcaf_matches_reference():
    rng = np.random.RandomState(5)
    points = rng.uniform(-3, 3, (2, 7, 3)).astype(np.float32)
    pred = (rng.randn(2, 7, 9) * 0.7).astype(np.float32)
    want = np.asarray(j_decode_fcaf(jnp.asarray(points), jnp.asarray(pred)))
    got = to_numpy(decode_fcaf(torch.from_numpy(points),
                               torch.from_numpy(pred)))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)


def test_top_k_indices_orders_ties_by_index():
    scores = torch.tensor([[0.5, -np.inf, 0.5, 2.0, -np.inf, 0.5, -np.inf]])
    want = jax.lax.top_k(jnp.asarray(scores.numpy()), 7)[1]
    got = top_k_indices(scores, 7)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), [[3, 0, 2, 5, 1, 4, 6]])
    with pytest.raises(ValueError):
        top_k_indices(scores, 8)


def test_build_model_grounding_entry_point():
    cfg = mv_grounding()
    assert cfg.model.fpn_capacities == (1024, 1024, 1024, 2048)
    m = cfg.model
    for key in ('num_queries', 'voxel_size', 'max_text_len',
                'input_capacity', 'backbone_capacities', 'fpn_capacities',
                'resnet_depth', 'mink_depth', 'text_layers', 'text_hidden',
                'text_heads'):
        setattr(m, key, TINY[key])
    m.text_arch = 'tiny'
    if torch.cuda.is_available():
        pytest.skip('checks the CPU-only behavior of the entry point')
    with pytest.raises(RuntimeError):
        build_model(cfg)  # defaults to cuda
    model = build_model(cfg, device='cpu')
    assert model.text_encoder.frozen
    out = to_numpy(model(to_torch(_batches()['room']), mode='predict'))
    assert out['bboxes'].shape == (2, 16, 9)
    assert out['scores'].shape == (2, 16)
    assert np.isfinite(out['bboxes']).all()
    # a seeded init: the same weights from the same seed
    again = build_model(cfg, device='cpu')
    for (name, a), b in zip(model.state_dict().items(),
                            again.state_dict().values()):
        assert torch.equal(a, b), name
    with pytest.raises(ValueError):
        model(to_torch(_batches()['room']), mode='bogus')
    with pytest.raises(KeyError):  # the loss needs the gt and positive maps
        model(to_torch(_batches()['room']), mode='loss')
