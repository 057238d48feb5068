"""Port vs reference: the optimizer with the per-parameter lr multipliers
of the training loop (``lr_mult_fn_for``), which freeze the 2D ResNet's
stem and first stage for every task, and for the grounder its text
encoder, with the decoder at 0.1.

The parameter trees are the tiny detector's and the tiny grounder's
(RoBERTa text arch) at the port's seeded init, exported in the flax
layout: no model runs. The reference's ``make_optimizer(..., lr_mult_fn=...,
params_template=...)`` (optax's ``multi_transform``: each group clipped on
its own, ``set_to_zero`` at 0) and the port's ``make_optimizer`` take two
updates on identical gradients whose group norms straddle the clip norm,
so a per-group clip and one global clip would give different updates.
Updates agree within 1e-6 (float32 rounding of the same formulas); frozen
leaves stay bit-identical.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from embodiedscan_tpu.train import loop as jL
from embodiedscan_tpu.train import state as jT
from embodiedscan_torch.configs.base import mv_det3d, mv_grounding
from embodiedscan_torch.models.detector import SparseFusionDetector as TDet
from embodiedscan_torch.models.detector import init_weights
from embodiedscan_torch.models.grounding import SparseFusionGrounder as TG
from embodiedscan_torch.train import loop as tL
from embodiedscan_torch.train import state as tT
from embodiedscan_torch.utils.convert_weights import _target, export_jax_tree

DET = dict(num_classes=5, voxel_size=0.02, input_capacity=256,
           backbone_capacities=(256, 128, 128, 64, 32, 16),
           fpn_capacities=(128, 64, 32, 16), max_dets=16, nms_pre=32,
           max_candidates=32, resnet_depth=18, mink_depth=18)
GROUNDER = dict(num_queries=16, voxel_size=0.05, max_text_len=20,
                embed_dims=32, num_decoder_layers=2, input_capacity=512,
                backbone_capacities=(512, 256, 256, 128, 64, 32),
                fpn_capacities=(64, 64, 32, 32), resnet_depth=18,
                mink_depth=18, text_arch='roberta', text_layers=2,
                text_hidden=32, text_heads=4)
# per task: (its config, the tiny model, each group's gradient norm):
# the grounder's 1.0 group is clipped alone, its 0.1 group is not (a
# global clip would scale it too); the detector's trainable group is below
# the clip norm, and its frozen group would push a global norm above it
TASKS = {
    'mv_det3d': (mv_det3d, lambda: TDet(**DET), {1.0: 6.0, 0.0: 50.0}),
    'mv_grounding': (mv_grounding, lambda: TG(**GROUNDER),
                     {1.0: 30.0, 0.1: 4.0, 0.0: 20.0}),
}


def _flat(tree, prefix=()):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _flat(val, prefix + (key,))
        else:
            yield prefix + (key,), np.array(val)  # a copy, not a view


def _unflat(flat):
    tree = {}
    for path, val in flat.items():
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = val
    return tree


@pytest.fixture(scope='module', params=list(TASKS))
def task(request):
    make_cfg, make_model, norms = TASKS[request.param]
    model = init_weights(make_model(), torch.Generator().manual_seed(0))
    params = dict(_flat(export_jax_tree(model, 'params')))
    mults = {p: jL.lr_mult_fn_for(request.param)(p) for p in params}
    assert set(mults.values()) == set(norms)
    # two steps of gradients, each group scaled to its norm
    rng = np.random.RandomState(1)
    steps = []
    for _ in range(2):
        grads = {p: rng.randn(*v.shape).astype(np.float32)
                 for p, v in params.items()}
        for m, norm in norms.items():
            paths = [p for p in grads if mults[p] == m]
            total = np.sqrt(sum(float((grads[p].astype(np.float64) ** 2
                                       ).sum()) for p in paths))
            for p in paths:
                grads[p] = (grads[p] * (norm / total)).astype(np.float32)
        steps.append(grads)
    return request.param, make_cfg(), model, params, mults, steps


def test_groups_match_reference_labels(task):
    """Every leaf of the model lands in the group of the reference's label:
    the multiplier of its parameter group, or frozen (out of the optimizer,
    no gradient required) at 0."""
    name, cfg, model, params, mults, _ = task
    opt = tT.make_optimizer(model, cfg, tL.lr_mult_fn_for(name),
                            steps_per_epoch=1)
    group_of = {id(p): g['lr_mult'] for g in opt.param_groups
                for p in g['params']}
    assert len(opt.param_groups) == len(set(mults.values()) - {0.0})
    n_frozen = 0
    for path, m in mults.items():
        tensor = _target(model, path)[0]
        if m == 0.0:
            n_frozen += 1
            assert not tensor.requires_grad and id(tensor) not in group_of
        else:
            assert tensor.requires_grad and group_of[id(tensor)] == m, path
    assert len(params) == sum(1 for _ in model.parameters())
    assert n_frozen >= (8 if name == 'mv_det3d' else 40)
    assert any(p[0] == 'trunk' and 'layer1_0' in p and mults[p] == 0.0
               for p in mults)
    if name == 'mv_grounding':  # the decoder's layer1 is not the ResNet's
        assert all(mults[p] == 0.1 for p in mults if p[0] == 'layer1')
        assert all(mults[p] == 0.0 for p in mults if p[0] == 'text_encoder')
    for p in model.parameters():
        p.requires_grad_(True)


def test_updates_match_reference(task):
    name, cfg, model, params, mults, steps = task
    sc = cfg.schedule
    tx = jT.make_optimizer(jT.multistep_lr(sc.lr, 1000,
                                           tuple(sc.milestones)),
                           sc.weight_decay, sc.clip_norm,
                           lr_mult_fn=jL.lr_mult_fn_for(name),
                           params_template=_unflat(params))
    jp = _unflat({p: jnp.asarray(v) for p, v in params.items()})
    jstate = tx.init(jp)

    @jax.jit
    def update(g, state, p):
        upd, state = tx.update(g, state, p)
        return upd, state, optax.apply_updates(p, upd)

    opt = tT.make_optimizer(model, cfg, tL.lr_mult_fn_for(name),
                            steps_per_epoch=1000)
    for grads in steps:
        before = dict(_flat(export_jax_tree(model, 'params')))
        upd, jstate, jp = update(_unflat({p: jnp.array(g)
                                          for p, g in grads.items()}),
                                 jstate, jp)
        for path, g in grads.items():
            tensor, fn = _target(model, path)
            if tensor.requires_grad:  # backward leaves frozen ones alone
                # a copy: the clip scales gradients in place
                tensor.grad = torch.from_numpy(np.array(fn(g)))
        opt.step()
        after = dict(_flat(export_jax_tree(model, 'params')))
        jupd = dict(_flat(upd))
        for path, m in mults.items():
            if m == 0.0:
                np.testing.assert_array_equal(after[path], params[path])
                assert not np.asarray(jupd[path]).any()
            else:
                np.testing.assert_allclose(after[path] - before[path],
                                           np.asarray(jupd[path]), rtol=0,
                                           atol=1e-6, err_msg=str(path))
        want = dict(_flat(jp))
        for path in mults:
            np.testing.assert_allclose(after[path], np.asarray(want[path]),
                                       rtol=0, atol=1e-6)
    assert all(g['count'] == 2 for g in opt.param_groups)
    for p in model.parameters():
        p.requires_grad_(True)
