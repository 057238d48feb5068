"""Port vs reference: the mv_grounding train step on the tiny grounder of
``tests/test_torch_grounding.py`` (tiny text arch, 'baseline' coder), in
training mode, weights converted leaf by leaf from one random flax tree.

The batch is the seeded room at b=2 with one prompt a sample and 4 padded
gt boxes, 3 valid in the first sample and 1 in the second, each with its
own span in the prompt. The reference's ``value_and_grad`` of
``mode='loss'`` is compiled once per module.

- Integers identical: the neck's coordinates and masks, the selected
  query indices, and every layer's and sample's Hungarian assignment (the
  cost matrices the host matcher receives agree to float rounding, see
  ``COST_RTOL``).
- The loss dict within rtol 1e-5; every gradient leaf (in the flax
  layout) within 1e-4 x its max|ref| and the batch statistics after the
  step within 1e-5 x max|ref|, as ``tests/test_torch_train.py`` holds the
  detector (a leaf that is 0 in exact arithmetic, such as an attention's
  key bias, holds only rounding noise and is held to its layer's kernel's
  scale). Leaves the loss does not reach (the neck's ``conv_cls``, the
  text encoder under its stop-gradient) have no gradient in the port and
  an all-zero one in the reference.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from embodiedscan_tpu.models.grounding import SparseFusionGrounder as JG
from embodiedscan_tpu.ops import hungarian as jH
from embodiedscan_torch.configs.base import build_train, mv_grounding
from embodiedscan_torch.models.grounding import SparseFusionGrounder as TG
from embodiedscan_torch.models.grounding import top_k_indices
from embodiedscan_torch.models.text import SimpleTokenizer, build_positive_maps
from embodiedscan_torch.ops import hungarian as tH
from embodiedscan_torch.train import state as tT
from embodiedscan_torch.utils.convert_weights import (export_jax_tree,
                                                      load_jax_variables)

from test_torch_helpers import (flat_engine, random_variables, tiny_batch,
                                to_numpy, to_torch)

# voxel 0.02 m, as tests/test_torch_train.py: at the serving test's 0.05
# the coarse levels hold 1-2 voxels a sample, batch statistics over so few
# rows leave selection scores tied within float rounding, and the top-k
# keeps whichever side the rounding favours
VOXEL = 0.02
TINY = dict(num_queries=16, voxel_size=VOXEL, max_text_len=20, embed_dims=32,
            num_decoder_layers=2, input_capacity=512,
            backbone_capacities=(512, 256, 256, 128, 64, 32),
            fpn_capacities=(64, 64, 32, 32), resnet_depth=18, mink_depth=18,
            text_arch='tiny', text_layers=2, text_hidden=32, text_heads=4)
TEXTS = ['find the red chair near the wall', 'the lamp, left of the sofa']
# each valid box's char span; sample 0 has 3 valid boxes, sample 1 one
SPANS = [[[[9, 18]], [[0, 4]], [[24, 32]]], [[[4, 8]]]]
# the match costs sum the IoU cost, whose float32 clipping differs from the
# reference's by up to ~1.4e-5 a pair (tests/test_torch_match.py), and
# logits that went through the trunk, neck and decoder in another order
COST_RTOL = 1e-4


def ground_batch():
    batch = tiny_batch()
    tok = SimpleTokenizer(max_len=16)
    enc = tok(TEXTS)
    rng = np.random.RandomState(6)
    b, g = 2, 4
    batch.update(
        text_ids=enc['input_ids'], text_mask=enc['attention_mask'],
        positive_maps=build_positive_maps(tok, TEXTS, SPANS, 16, g),
        gt_boxes=np.concatenate([rng.uniform(0.2, 1.8, (b, g, 2)),
                                 rng.uniform(0.2, 1.3, (b, g, 1)),
                                 rng.uniform(0.2, 0.8, (b, g, 3)),
                                 rng.uniform(-0.3, 0.3, (b, g, 3))],
                                -1).astype(np.float32),
        gt_mask=np.array([[1, 1, 1, 0], [1, 0, 0, 0]], bool))
    return batch


def _recording(mod, log):
    """``mod._scipy_assign`` that logs (cost, assignment) of each call."""
    orig = mod._scipy_assign

    def assign(cost):
        out = orig(cost)
        log.append((np.array(cost), np.array(out)))
        return out

    return assign


@pytest.fixture(scope='module')
def step_outputs():
    batch = ground_batch()
    jcalls, tcalls = [], []
    with flat_engine(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(jH, '_scipy_assign', _recording(jH, jcalls))
        jm = JG(**TINY)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        var = random_variables(jm, (jb,), train=False, mode='feats')
        # as tests/test_torch_grounding.py: N(0, 0.01) box branch output
        out = var['params']['reg_branch']['out']
        out['kernel'] = (np.random.RandomState(4).randn(
            *out['kernel'].shape) * 0.01).astype(np.float32)

        def step(params, stats, b):
            def loss_fn(p):
                losses, mut = jm.apply(
                    {'params': p, 'batch_stats': stats}, b, train=True,
                    mode='loss', mutable=['batch_stats', 'intermediates'],
                    capture_intermediates=lambda m, _: m.name in (
                        'neck', 'cls_embed'))
                inter = mut['intermediates']
                return sum(losses.values()), (
                    losses, mut['batch_stats'], inter['neck']['__call__'][0],
                    inter['cls_embed']['__call__'][0])

            (_, aux), grads = jax.value_and_grad(loss_fn, has_aux=True)(
                params)
            return aux, grads

        (jlosses, jstats, jneck, jenc), jgrads = to_numpy(
            jax.jit(step)(var['params'], var['batch_stats'], jb))
    jsel = np.where(jneck[3], jenc.max(-1), -np.inf)
    jtop = np.asarray(jax.lax.top_k(jnp.asarray(jsel), TINY['num_queries'])[1])

    tm = TG(**TINY).train()
    load_jax_variables(tm, var['params'], var['batch_stats'])
    seen = {}

    def keep_first(key):  # a hook returning None leaves the output alone
        return lambda mod, args, out: None if key in seen else \
            seen.update({key: out})

    hooks = [tm.neck.register_forward_hook(keep_first('neck')),
             tm.cls_embed.register_forward_hook(keep_first('enc'))]
    tb = to_torch(batch)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tH, '_scipy_assign', _recording(tH, tcalls))
        match = tm.match
        mp.setattr(tm, 'match', lambda *a: seen.setdefault('matched',
                                                           match(*a)))
        tlosses = tm(tb, mode='loss')
    for h in hooks:
        h.remove()
    sum(tlosses.values()).backward()
    no_grad = [n for n, p in tm.named_parameters() if p.grad is None]
    for p in tm.parameters():
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    neck = to_numpy(seen['neck'])
    tsel = torch.where(seen['neck'][3], seen['enc'].detach().amax(-1),
                       torch.tensor(float('-inf')))
    return dict(
        jax=(jlosses, jstats, jgrads, jneck, jtop, jcalls),
        torch=({k: float(v.detach()) for k, v in tlosses.items()},
               export_jax_tree(tm, 'buffers'), export_jax_tree(tm, 'grads'),
               neck, to_numpy(top_k_indices(tsel, TINY['num_queries'])),
               tcalls),
        matched=to_numpy(seen['matched']), no_grad=no_grad, batch=batch)


def _leaves(tree, prefix=()):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _leaves(val, prefix + (key,))
        else:
            yield prefix + (key,), np.asarray(val)


def test_integers_identical(step_outputs):
    """Neck coordinates and masks, selected queries, and every (layer,
    sample) matrix's assignment; the batch's valid gt counts differ, and
    the first layer's matches reach every valid gt."""
    _, _, _, jneck, jtop, jcalls = step_outputs['jax']
    _, _, _, tneck, ttop, tcalls = step_outputs['torch']
    for i in (2, 3):  # xyz, mask
        np.testing.assert_array_equal(tneck[i], jneck[i])
    np.testing.assert_array_equal(ttop, jtop)
    assert len(tcalls) == len(jcalls) == 2 * 2
    used = set()
    for cost, out in tcalls:  # (layer, sample) order; find the reference's
        diffs = [np.abs(cost - c).max() / np.abs(c[c < 1e5]).max()
                 for c, _ in jcalls]
        k = int(np.argmin(diffs))
        assert diffs[k] <= COST_RTOL and k not in used, diffs
        used.add(k)
        np.testing.assert_array_equal(out, jcalls[k][1])
    gm = step_outputs['batch']['gt_mask']
    matched = step_outputs['matched']
    assert matched.shape == (2, 2, TINY['num_queries'])
    for li in range(2):
        for i in range(2):
            cost = tcalls[2 * li + i][0]
            assert (cost[:, ~gm[i]] == 1e8).all()
            want = np.where(gm[i][np.clip(tcalls[2 * li + i][1], 0, 3)] &
                            (tcalls[2 * li + i][1] >= 0),
                            tcalls[2 * li + i][1], -1)
            np.testing.assert_array_equal(matched[li, i], want)
            assert sorted(matched[li, i][matched[li, i] >= 0]) == \
                list(np.flatnonzero(gm[i]))


def test_losses(step_outputs):
    """rtol 1e-5: float32 through the trunk, neck and two decoder layers in
    another order."""
    jl, tl = step_outputs['jax'][0], step_outputs['torch'][0]
    assert set(tl) == set(jl) == {'d0.loss_cls', 'd0.loss_bbox', 'loss_cls',
                                  'loss_bbox'}
    for key in jl:
        assert np.isfinite(tl[key]) and tl[key] > 0
        np.testing.assert_allclose(tl[key], jl[key], rtol=1e-5, err_msg=key)


def _zero_in_exact_arithmetic(path):
    """Gradient leaves that are 0 in exact arithmetic: an attention's key
    bias (the softmax ignores a shift common to all keys), the cross
    position embedding's output bias (it only shifts the point keys) and a
    position embedding's first bias (the batch-statistics norm after it
    subtracts the mean)."""
    joined = '/'.join(path)
    return joined.endswith(('key/bias', 'posembed/Dense_0/bias',
                            'cross_posembed/Dense_1/bias'))


@pytest.mark.parametrize('tree,rel', [('grads', 1e-4), ('stats', 1e-5)])
def test_leaves(step_outputs, tree, rel):
    """Every gradient leaf within 1e-4 x its max|ref| (backward through the
    decoder, the neck and the trunk in another order; the fusion gather's
    backward sums as tests/test_torch_train.py says), a leaf that is 0 in
    exact arithmetic within 1e-4 x max|ref| of its layer's kernel; the
    batch statistics after the step within 1e-5 x max|ref|."""
    _, jstats, jgrads, _, _, _ = step_outputs['jax']
    _, tstats, tgrads, _, _, _ = step_outputs['torch']
    jt, tt = (jgrads, tgrads) if tree == 'grads' else (jstats, tstats)
    want, got = dict(_leaves(jt)), dict(_leaves(tt))
    assert set(got) == set(want)
    bad, noise = [], 0
    for path, w in want.items():
        scale = max(float(np.abs(w).max()), 1e-30)
        if tree == 'grads' and _zero_in_exact_arithmetic(path) and \
                path[0] != 'text_encoder':  # that one's is exactly 0
            # rounding noise on both sides: held to its layer's kernel
            kernel = float(np.abs(want[path[:-1] + ('kernel',)]).max())
            assert scale <= 1e-5 * kernel, path
            scale, noise = kernel, noise + 1
        err = float(np.abs(got[path] - w).max())
        if not err <= rel * scale:
            bad.append(('/'.join(path), err / scale))
    assert not bad, bad
    if tree == 'grads':
        assert noise == 3 * TINY['num_decoder_layers'] + 3
        # the port gives no gradient exactly where the reference's is zero
        no_grad = step_outputs['no_grad']
        assert any(n.startswith('neck.conv_cls') for n in no_grad)
        assert any(n.startswith('text_encoder.') for n in no_grad)
        assert not any(n.startswith(('layer', 'trunk', 'reg_branch'))
                       for n in no_grad)
        for name in no_grad:
            node = jgrads
            for key in name.split('.')[:-1]:
                node = node[key]
            assert not any(np.asarray(v).any() for v in node.values()), name


def test_build_train_grounding_step():
    """``build_train`` on the CPU: the tiny grounder with the task's lr
    multipliers takes two finite steps; the text encoder and the 2D stem
    and first stage stay bit-identical, every other parameter moves."""
    cfg = mv_grounding()
    assert (cfg.schedule.lr, cfg.schedule.weight_decay,
            cfg.data.max_boxes) == (5e-4, 5e-4, 64)
    for key, val in TINY.items():
        setattr(cfg.model, key, val)
    model, opt = build_train(cfg, device='cpu', steps_per_epoch=1)
    assert model.training and len(opt.param_groups) == 2
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    tb = to_torch(ground_batch())
    for _ in range(2):
        metrics = tT.train_step(model, opt, tb)
        assert all(np.isfinite(float(v)) for v in metrics.values())
    frozen = {n for n, p in model.named_parameters() if not p.requires_grad}
    assert any(n.startswith('text_encoder.') for n in frozen)
    assert any('stem_conv' in n for n in frozen)
    assert any('layer1_' in n for n in frozen)
    for n, p in model.named_parameters():
        if n in frozen:
            assert torch.equal(p, before[n]), n
        else:
            assert not torch.equal(p, before[n]), n
