"""Port vs reference: the converters of reference torch checkpoints
(``embodiedscan_torch/utils/convert_weights.py`` against
``embodiedscan_tpu/utils/convert_weights.py``).

The same synthetic reference-layout state_dicts (the JAX tests' own
helpers in ``tests/test_convert.py`` and ``chip_smoke.reference_state_dict``
at small widths) go through both packages. Trees in the flax layout are
compared leaf for leaf, bit for bit; so are ``n_loaded``, the ``skipped``
paths and, after loading, ``export_jax_tree`` of the port's model against
the JAX variables. A port conv with ME-permuted weights is held against an
independent ME-semantics oracle (atol 1e-4: float32 sums of up to 27 x Cin
products in another order).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke as cs
from embodiedscan_tpu.models.detector import SparseFusionDetector as JDet
from embodiedscan_tpu.models.grounding import SparseFusionGrounder as JG
from embodiedscan_tpu.models.resnet2d import ResNet as JResNet
from embodiedscan_tpu.utils import convert_weights as jC
from embodiedscan_torch.models.detector import SparseFusionDetector as TDet
from embodiedscan_torch.models.grounding import SparseFusionGrounder as TG
from embodiedscan_torch.models.resnet2d import ResNet as TResNet
from embodiedscan_torch.ops import sparse as tS
from embodiedscan_torch.utils import convert_weights as tC

import test_convert as jt
from test_convert import make_torch_basicblock_resnet18
from test_me_permutation import me_offsets
from test_reference_predict_fixture import full_reference_state_dict
from test_torch_helpers import (flat_engine, random_variables, tiny_batch,
                                to_numpy)

# __graft_entry__._tiny_model and tests/test_grounding.py:tiny_grounder
# (RoBERTa text arch), as the port's parity tests build them
DET = dict(num_classes=5, voxel_size=0.05, input_capacity=256,
           backbone_capacities=(256, 128, 128, 64, 32, 16),
           fpn_capacities=(128, 64, 32, 16), max_dets=16, nms_pre=32,
           max_candidates=32, resnet_depth=18, mink_depth=18)
GROUND = dict(num_queries=16, voxel_size=0.05, max_text_len=16,
              embed_dims=32, num_decoder_layers=2, input_capacity=512,
              backbone_capacities=(512, 256, 256, 128, 64, 32),
              fpn_capacities=(64, 64, 32, 32), resnet_depth=18,
              mink_depth=18, text_arch='roberta', text_layers=2,
              text_hidden=32, text_heads=4)
WORD = 'text_encoder/FlaxRobertaModule_0/embeddings/word_embeddings/embedding'


def _leaves(tree, prefix=()):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _leaves(val, prefix + (key,))
        else:
            yield prefix + (key,), val


def assert_trees_identical(got, want):
    """Same paths, shapes, dtypes and bits (a converter's (params, stats)
    pair compares as two trees)."""
    if isinstance(want, tuple):
        got, want = dict(enumerate(got)), dict(enumerate(want))
    g, w = dict(_leaves(got)), dict(_leaves(want))
    assert sorted(g) == sorted(w)
    for path, leaf in w.items():
        a, b = np.asarray(g[path]), np.asarray(leaf)
        assert a.shape == b.shape and a.dtype == b.dtype, path
        np.testing.assert_array_equal(a, b, err_msg=str(path))


# --- the numpy converters ---------------------------------------------------


def _resnet18_sd():
    torch.manual_seed(0)
    return {k: v.numpy() for k, v in
            make_torch_basicblock_resnet18().state_dict().items()}


def _resnet50_sd():
    sd = cs._RefSD(1)
    cs._ref_resnet2d(sd, 50)
    return {k[len('backbone.'):]: v for k, v in sd.items()}


def _roberta_sd(vocab=60, hidden=32, pooler=True):
    sd = cs._RefSD(2)
    cs._ref_roberta(sd, hidden, 2, vocab)
    if pooler:
        sd.linear('text_encoder.pooler.dense', hidden, hidden)
    return dict(sd)


CONVERTERS = {
    'resnet18': lambda m: m.convert_torchvision_resnet(_resnet18_sd(), 18),
    'resnet50': lambda m: m.convert_torchvision_resnet(_resnet50_sd(), 50),
    'mink18': lambda m: m.convert_mink_resnet(
        jt.TestMinkResNetConversion()._fake_me_sd(depth=18), depth=18),
    'mink18_flip': lambda m: m.convert_mink_resnet(
        jt.TestMinkResNetConversion()._fake_me_sd(depth=18), depth=18,
        flip=True),
    'fcaf_head': lambda m: m.convert_fcaf_head(
        jt.TestFCAFHeadConversion()._fake_head_sd()),
    'fcaf_head_flip': lambda m: m.convert_fcaf_head(
        jt.TestFCAFHeadConversion()._fake_head_sd(), flip=True),
    'roberta': lambda m: m.convert_roberta(_roberta_sd(pooler=False)),
    'mink_neck': lambda m: m.convert_mink_neck(
        jt.TestGrounderConversion()._fake_grounder_sd()),
    'ground_decoder': lambda m: m.convert_ground_decoder(
        jt.TestGrounderConversion()._fake_grounder_sd(), num_layers=2),
}


@pytest.mark.parametrize('name', list(CONVERTERS))
def test_converter_trees_identical(name):
    assert_trees_identical(CONVERTERS[name](tC), CONVERTERS[name](jC))


def test_roberta_pooler_converts():
    # HF writes the pooler as pooler.dense.*; the rest of the tree is the
    # reference's (whose converter raises on a pooler: it reads
    # 'pooler.weight')
    sd = _roberta_sd(pooler=True)
    got = tC.convert_roberta(sd)
    np.testing.assert_array_equal(
        got.pop('pooler')['dense']['kernel'],
        sd['text_encoder.pooler.dense.weight'].T)
    assert_trees_identical(got, jC.convert_roberta(
        {k: v for k, v in sd.items() if '.pooler.' not in k}))


@pytest.mark.parametrize('flip', [False, True])
@pytest.mark.parametrize('k', [1, 2, 3])
def test_me_kernel_permutation(k, flip):
    got = tC.me_kernel_permutation(k, flip)
    np.testing.assert_array_equal(got, jC.me_kernel_permutation(k, flip))
    ours = {1: [(0, 0, 0)], 2: tS.OFFSETS_2, 3: tS.OFFSETS_3}[k]
    me = me_offsets(k)
    lo, hi = (0, k - 1) if k % 2 == 0 else (-(k // 2), k // 2)
    for i, off in enumerate(ours):
        want = tuple(lo + hi - o for o in off) if flip else tuple(off)
        assert me[got[i]] == want


@pytest.mark.parametrize('flip', [False, True])
@pytest.mark.parametrize('shape', [(27, 4, 5), (8, 4, 5), (1, 4, 5), (4, 5)])
def test_me_kernel_and_pointwise(shape, flip):
    w = np.random.RandomState(0).randn(*shape)
    np.testing.assert_array_equal(tC._me_kernel(w, flip),
                                  jC._me_kernel(w, flip))
    np.testing.assert_array_equal(tC._me_pointwise(w[:1] if w.ndim == 3
                                                   else w),
                                  jC._me_pointwise(w[:1] if w.ndim == 3
                                                   else w))


def test_load_torch_checkpoint(tmp_path):
    sd = {'a.weight': torch.randn(3, 2), 'b.num_batches_tracked':
          torch.tensor(4)}
    torch.save({'state_dict': sd, 'meta': {'epoch': 12}}, tmp_path / 'w.pth')
    torch.save(sd, tmp_path / 'bare.pth')
    for name in ('w.pth', 'bare.pth'):
        got = tC.load_torch_checkpoint(str(tmp_path / name))
        want = jC.load_torch_checkpoint(str(tmp_path / name))
        assert sorted(got) == sorted(want) == sorted(sd)
        for key in sd:
            np.testing.assert_array_equal(got[key], want[key])


# --- ME-permuted weights through the port's conv == the ME oracle ----------


def _sorted_level(rng, n, extent, c, low=None):
    lo = -extent if low is None else low
    coords = np.unique(rng.randint(lo, extent, (2 * n, 3)), axis=0)[:n]
    feats = rng.randn(len(coords), c).astype(np.float32)
    st = tS.SparseTensor(torch.from_numpy(coords.astype(np.int32))[None],
                         torch.from_numpy(feats)[None],
                         torch.ones(1, len(coords), dtype=torch.bool))
    return st, coords, feats


def test_submanifold_k3_matches_me_oracle():
    rng = np.random.RandomState(0)
    st, coords, feats = _sorted_level(rng, 64, 5, 6)
    w_me = rng.randn(27, 6, 5).astype(np.float32)
    table = {tuple(c): f for c, f in zip(coords, feats)}
    want = np.zeros((len(coords), 5), np.float32)
    for i, c in enumerate(coords):
        for k, off in enumerate(me_offsets(3)):
            nb = tuple(c + np.array(off))
            if nb in table:
                want[i] += table[nb] @ w_me[k]
    nbr = tS.neighbor_table_b(st, tS.OFFSETS_3)[0]
    got = tS.gather_matmul_conv(st.feats[0], st.mask[0], nbr,
                                torch.from_numpy(tC._me_kernel(w_me)))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


def test_strided_k3_matches_me_oracle():
    from embodiedscan_torch.models.sparse_nn import strided_queries
    rng = np.random.RandomState(1)
    st, coords, feats = _sorted_level(rng, 64, 9, 4, low=0)
    w_me = rng.randn(27, 4, 7).astype(np.float32)
    table = {tuple(c): f for c, f in zip(coords, feats)}
    out_coords = np.unique(coords // 2, axis=0)
    want = np.zeros((len(out_coords), 7), np.float32)
    for i, o in enumerate(out_coords):
        for k, off in enumerate(me_offsets(3)):
            nb = tuple(2 * o + np.array(off))
            if nb in table:
                want[i] += table[nb] @ w_me[k]
    dmap = tS.downsample_coords_b(st, 96)
    nbr = strided_queries(st, dmap, tS.OFFSETS_3)[0]
    got = tS.gather_matmul_conv(st.feats[0], st.mask[0], nbr,
                                torch.from_numpy(tC._me_kernel(w_me)))
    gm = dmap.mask[0].numpy()
    gc = dmap.coords[0].numpy()[gm]
    order = np.lexsort(gc.T[::-1])
    np.testing.assert_array_equal(gc[order], out_coords)
    np.testing.assert_allclose(got.numpy()[:gm.sum()][order], want,
                               atol=1e-4)


def test_generative_transpose_k2_matches_me_oracle():
    rng = np.random.RandomState(2)
    st, coords, feats = _sorted_level(rng, 40, 4, 5)
    w_me = rng.randn(8, 5, 4).astype(np.float32)
    want = {}
    for c, f in zip(coords, feats):
        for k, off in enumerate(me_offsets(2)):
            child = tuple(2 * c + np.array(off))
            want[child] = want.get(child, 0) + f @ w_me[k]
    up = tS.generative_transpose2(st, torch.from_numpy(tC._me_kernel(w_me)))
    um = up.mask[0].numpy()
    uc, uf = up.coords[0].numpy()[um], up.feats[0].numpy()[um]
    assert len(uc) == len(want)
    for c, f in zip(uc, uf):
        np.testing.assert_allclose(f, want[tuple(c)], atol=1e-4)


# --- the loaders: same counts, same skips, the same variables --------------


@pytest.fixture(scope='module')
def det_vars():
    """Random variables of the tiny detector (its abstract init, traced
    once)."""
    batch = {k: jnp.asarray(v) for k, v in tiny_batch().items()}
    with flat_engine():
        return random_variables(JDet(**DET), (batch,), train=False,
                                mode='feats')


@pytest.fixture(scope='module')
def ground_vars():
    batch = dict(tiny_batch(), text_ids=np.zeros((2, 16), np.int32),
                 text_mask=np.ones((2, 16), np.int32))
    with flat_engine():
        return random_variables(
            JG(**GROUND), ({k: jnp.asarray(v) for k, v in batch.items()},),
            train=False, mode='feats')


def _loaded_pair(var, tmodule, load):
    """``var`` copied into ``tmodule`` (strictly), then ``load(converters,
    variables_or_model)`` on both sides: (JAX (variables, n, skipped), port
    (model, n, skipped)). The JAX merge leaves ``var`` as it was."""
    tC.load_jax_variables(tmodule, var['params'], var.get('batch_stats'))
    return load(jC, var), load(tC, tmodule)


def _assert_same_load(jres, tres):
    (jvar, jn, js), (tm, tn, ts) = jres, tres
    assert tn == jn and ts == js
    assert_trees_identical(tC.export_jax_tree(tm, 'params'),
                           to_numpy(jvar['params']))
    assert_trees_identical(tC.export_jax_tree(tm, 'buffers'),
                           to_numpy(jvar.get('batch_stats', {})))


@pytest.mark.parametrize('base', [16, 64])
def test_load_resnet_skips_as_reference(base):
    # a 64-wide torchvision checkpoint into the 16-wide backbone: every
    # leaf skipped (mmengine's strict=False), on both sides
    torch.manual_seed(0)
    sd = {k: v.numpy() for k, v in
          make_torch_basicblock_resnet18(base).state_dict().items()}
    var = random_variables(JResNet(depth=18, base_channels=16),
                           (jnp.zeros((1, 32, 32, 3)),))
    jres, tres = _loaded_pair(
        var, TResNet(depth=18, base_channels=16),
        lambda m, v: m.load_resnet_into_variables(v, sd, depth=18,
                                                  prefix=()))
    _assert_same_load(jres, tres)
    assert (tres[1], bool(tres[2])) == ((100, False) if base == 16
                                        else (0, True))


def test_reference_detector_loads_as_reference(det_vars):
    sd = full_reference_state_dict()
    jres, tres = _loaded_pair(
        det_vars, TDet(**DET).eval(),
        lambda m, v: m.load_reference_detector(v, sd, mink_depth=18,
                                               resnet_depth=18))
    _assert_same_load(jres, tres)
    tm, n, skipped = tres
    assert skipped == []
    assert n == sum(1 for _ in tm.parameters()) + sum(1 for _ in
                                                      tm.buffers())


def _grounder_sd(vocab=30522, pooler=False):
    """The JAX test's grounder checkpoint plus the backbones of
    ``full_reference_state_dict``, a RoBERTa of the tiny grounder's width
    and ``text_feat_map``."""
    sd = jt.TestGrounderConversion()._fake_grounder_sd()
    sd.update({k: v for k, v in full_reference_state_dict().items()
               if k.startswith(('backbone.', 'backbone_3d.'))})
    sd.update(_roberta_sd(vocab, GROUND['text_hidden'], pooler))
    rng = np.random.RandomState(5)
    sd['text_feat_map.weight'] = rng.randn(32, GROUND['text_hidden']) * 0.05
    sd['text_feat_map.bias'] = rng.randn(32) * 0.05
    return sd


@pytest.mark.parametrize('case', ['full', 'roberta_base_vocab', 'partial'])
def test_reference_grounder_loads_as_reference(ground_vars, case):
    sd = _grounder_sd(*{'full': (), 'partial': (),
                        'roberta_base_vocab': (50265,)}[case])
    if case == 'partial':  # a head-and-decoder dump: no backbones, no text
        sd = {k: v for k, v in sd.items() if not k.startswith(
            ('backbone', 'text_encoder.'))}
    jres, tres = _loaded_pair(
        ground_vars, TG(**GROUND).eval(),
        lambda m, v: m.load_reference_grounder(v, sd, mink_depth=18,
                                               resnet_depth=18, num_layers=2,
                                               num_heads=8))
    _assert_same_load(jres, tres)
    tm, n, skipped = tres
    total = sum(1 for _ in tm.parameters()) + sum(1 for _ in tm.buffers())
    if case == 'full':
        assert skipped == [] and n == total
    elif case == 'partial':
        assert skipped == [] and 0 < n < total
    else:  # roberta-base's 50265 rows against the 30522 of both packages
        assert skipped == [WORD] and n == total - 1


def test_published_vocabulary_loads_into_a_grounder_of_its_size():
    """roberta-base's 50265-row word embedding, skipped by the JAX
    package's 30522-row encoder (above), loads into an encoder of the
    mv_grounding presets' vocabulary: every tensor taken, the rows as
    given."""
    sd = _grounder_sd(50265)
    model, n, skipped = tC.load_reference_grounder(
        TG(**GROUND, text_vocab_size=50265).eval(), sd, mink_depth=18,
        resnet_depth=18, num_layers=2, num_heads=8)
    total = sum(1 for _ in model.parameters()) + sum(1 for _ in
                                                     model.buffers())
    assert skipped == [] and n == total
    emb = model.text_encoder.FlaxRobertaModule_0.embeddings.word_embeddings
    want = np.asarray(sd['text_encoder.embeddings.word_embeddings.weight'],
                      np.float32)
    assert emb.weight.shape == (50265, GROUND['text_hidden'])
    np.testing.assert_array_equal(emb.weight.detach().numpy(), want)


def test_reference_grounder_skips_the_pooler_subtree():
    # a real grounder checkpoint holds RoBERTa's pooler; the port has none:
    # one skip for the whole subtree, the rest loads as without it
    sd = _grounder_sd(pooler=True)
    model, n, skipped = tC.load_reference_grounder(
        TG(**GROUND).eval(), sd, mink_depth=18, resnet_depth=18,
        num_layers=2, num_heads=8)
    total = sum(1 for _ in model.parameters()) + sum(1 for _ in
                                                     model.buffers())
    assert skipped == ['text_encoder/FlaxRobertaModule_0/pooler']
    assert n == total


def test_merge_reports_missing_subtrees_and_leaves(det_vars):
    # a subtree the port lacks is skipped once under its own path; a leaf
    # the port lacks, or of another shape, under its leaf path
    tm, var = TDet(**DET).eval(), det_vars
    tC.load_jax_variables(tm, var['params'], var['batch_stats'])
    params = {'conv_cls': {'bias': np.ones(5), 'extra': np.ones(2)},
              'ghost': {'kernel': np.ones(3)}, 'scales': np.ones(3)}
    stats = {'out_block_0_bn': {'mean': np.full(128, 2.0)}}
    jv, jn, js = jC._merge_into(var, params, stats, ('bbox_head',))
    _, tn, ts = tC._merge_into(tm, params, stats, ('bbox_head',))
    assert (tn, ts) == (jn, js) == (2, ['bbox_head/conv_cls/extra',
                                        'bbox_head/ghost',
                                        'bbox_head/scales'])
    assert_trees_identical(tC.export_jax_tree(tm, 'params'),
                           to_numpy(jv['params']))
    assert_trees_identical(tC.export_jax_tree(tm, 'buffers'),
                           to_numpy(jv['batch_stats']))
    # a prefix the port lacks skips everything under it
    _, tn, ts = tC._merge_into(tm, params, {}, ('nowhere',))
    _, jn, js = jC._merge_into(var, params, {}, ('nowhere',))
    assert (tn, ts) == (jn, js) == (0, ['nowhere/conv_cls', 'nowhere/ghost',
                                        'nowhere/scales'])


def test_chip_smoke_reference_state_dicts_load_fully(det_vars, ground_vars):
    """``chip_smoke.reference_state_dict`` at the tiny widths: the JAX
    loaders and the port's take every leaf, identically (the card's run
    takes it at the presets' widths)."""
    det = cs.reference_state_dict('mv_det3d', num_classes=5,
                                  resnet_depth=18, mink_depth=18)
    jres, tres = _loaded_pair(
        det_vars, TDet(**DET).eval(),
        lambda m, v: m.load_reference_detector(v, det, mink_depth=18,
                                               resnet_depth=18))
    _assert_same_load(jres, tres)
    assert tres[2] == [] and tres[1] == len(list(tres[0].parameters())) + \
        len(list(tres[0].buffers()))
    ground = cs.reference_state_dict(
        'mv_grounding', resnet_depth=18, mink_depth=18, embed_dims=32,
        decoder_layers=2, text_hidden=32, text_layers=2)
    jres, tres = _loaded_pair(
        ground_vars, TG(**GROUND).eval(),
        lambda m, v: m.load_reference_grounder(v, ground, mink_depth=18,
                                               resnet_depth=18, num_layers=2,
                                               num_heads=8))
    _assert_same_load(jres, tres)
    total = len(list(tres[0].parameters())) + len(list(tres[0].buffers()))
    assert tres[2] == [WORD] and tres[1] == total - 1
