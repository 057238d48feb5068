"""Two processes over ``torch.distributed`` (gloo on the CPU) against the
reference's data-parallel semantics.

- One update of ``train_step`` on two ranks, one sample each, from the
  same weights, against the reference's ``make_train_step_sharded``,
  computed as what its ``pmean`` computes: the mean of the two
  single-sample JAX gradients (each with its own loss normalizers) and of
  the two samples' new batch statistics, through the same optax update.
  The averaged gradients that AdamW receives are within 1e-4 x max|leaf|
  of the reference's (the gate of test_torch_train.py's single step), the
  norms' statistics within 1e-5 x max|leaf|, the losses returned within
  rtol 1e-5 of the two samples' mean; and the parameters after the update
  equal the reference optax update of those same averaged gradients
  within 1e-6. (The first AdamW update moves an element by about
  lr x sign(g) whatever |g| is, so an element whose gradient lies within
  float32 noise of zero may move either way in either package: the
  parameters are compared from the same gradients.) Two cases: the
  first train batch of ``fake_data``, whose gt boxes hold no points (no
  positive location), and two synthetic scans whose samples keep positive
  locations, so that the per-sample box and centerness normalizers take
  part. Each rank's ReLUs take the reference's decisions
  (``jax_relu_decisions``, ``test_torch_helpers.follow_relu``): a ReLU
  input within float32 rounding of 0 may fall on either side in either
  package (ROADMAP C.4; one of ``fake_data``'s samples has one), and
  anywhere else the decisions must agree.
- ``evaluate`` on two ranks over the three ``fake_data`` scenes (the
  second rank's shard padded by a repeated scene) gives the metrics of one
  process; the group helpers (``process_shard``, ``global_batch_size``,
  ``all_processes_scalar``, ``is_main_process``, ``gather_objects`` in
  rank order) answer for two processes.
"""

import contextlib
import pickle

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch.multiprocessing as mp

from embodiedscan_tpu.models.detector import SparseFusionDetector as JDet
from embodiedscan_tpu.train import loop as jL
from embodiedscan_tpu.train import state as jT
from embodiedscan_torch.configs import base as tcfg
from embodiedscan_torch.data.pipeline import collate
from embodiedscan_torch.data.synthetic import make_scan, scan_to_batch
from embodiedscan_torch.train.loop import evaluate, make_dataset

from test_torch_helpers import (TINY_DET, disk_cfg, dist_worker, flat_engine,
                                random_variables)

STEPS_PER_EPOCH = 3


def _run_two_ranks(tmp_path, job):
    path = str(tmp_path / 'job.pkl')
    with open(path, 'wb') as f:
        pickle.dump(job, f)
    init = f'file://{tmp_path}/rendezvous'
    mp.spawn(dist_worker, args=(2, init, path), nprocs=2, join=True)
    with open(path + '.out', 'rb') as f:
        return pickle.load(f)


def _leaves(tree, prefix=()):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _leaves(val, prefix + (key, ))
        else:
            yield prefix + (key, ), np.asarray(val)


def _mean(trees):
    flat = [dict(_leaves(t)) for t in trees]
    out = {}
    for path in flat[0]:
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = np.mean([f[path] for f in flat], axis=0)
    return out


@contextlib.contextmanager
def jax_relu_decisions():
    """While active, every ``flax.linen.relu`` traced appends its decisions
    (``x > 0``, a traced value) to the yielded list, in call order: a
    traced function returns them as outputs."""
    relu, decisions = fnn.relu, []

    def patched(x):
        decisions.append(x > 0)
        return relu(x)

    fnn.relu = patched
    try:
        yield decisions
    finally:
        fnn.relu = relu


def _two_samples(data, fake_data):
    """The two ranks' samples: ``fake_data``'s first train batch at b = 2
    (its gt boxes hold no points), or the synthetic scans of seeds 1 and 2
    (every gt box holds points; both samples keep positive locations
    through the FPN prune of these weights, so the box and centerness
    losses and their per-sample normalizers take part, where seeds 0 and 6
    keep none)."""
    if data == 'fake_data':
        batch = next(iter(make_dataset(disk_cfg(tcfg, fake_data,
                                                batch_size=2))))
        return {k: v for k, v in batch.items() if isinstance(v, np.ndarray)}
    return collate([scan_to_batch(
        make_scan(seed=s, n_views=4, hw=(64, 64), g=8, num_classes=5),
        n_views=2, num_points=1000, num_boxes=4, seed=s, train=True,
        points_per_view=300) for s in (1, 2)])


@pytest.mark.parametrize('data', ['synthetic', 'fake_data'])
def test_two_rank_update_matches_pmean(data, fake_data, tmp_path):
    cfg = disk_cfg(tcfg, fake_data)
    batch = _two_samples(data, fake_data)
    sc = cfg.schedule
    with flat_engine():
        jm = JDet(**TINY_DET)
        one = {k: jnp.asarray(v[:1]) for k, v in batch.items()}
        var = random_variables(jm, (one, ), train=False, mode='feats')
        var['params']['bbox_head']['conv_cls']['bias'][:] = 0

        @jax.jit
        def grads(params, stats, b):
            def loss_fn(p):
                with jax_relu_decisions() as decisions:
                    losses, mut = jm.apply(
                        {'params': p, 'batch_stats': stats}, b, train=True,
                        mode='loss', mutable=['batch_stats'])
                return sum(losses.values()), (losses, mut['batch_stats'],
                                              decisions)

            return jax.value_and_grad(loss_fn, has_aux=True)(params)

        # value_and_grad's ((total, (losses, new stats, ReLU decisions)),
        # grads) of each rank
        shards = [jax.device_get(grads(var['params'], var['batch_stats'],
                                       {k: jnp.asarray(v[r:r + 1])
                                        for k, v in batch.items()}))
                  for r in range(2)]
        tx = jT.make_optimizer(
            jT.multistep_lr(sc.lr, STEPS_PER_EPOCH, tuple(sc.milestones),
                            sc.gamma),
            sc.weight_decay, sc.clip_norm,
            lr_mult_fn=jL.lr_mult_fn_for('mv_det3d'),
            params_template=var['params'])

        @jax.jit
        def update(g, p):
            upd, _ = tx.update(g, tx.init(p), p)
            return optax.apply_updates(p, upd)

    want_grads = _mean([s[1] for s in shards])
    want_stats = _mean([s[0][1][1] for s in shards])
    want_losses = {k: np.mean([float(s[0][1][0][k]) for s in shards])
                   for k in shards[0][0][1][0]}
    if data == 'synthetic':
        assert all(float(s[0][1][0]['loss_bbox']) > 0 for s in shards)

    got = _run_two_ranks(tmp_path, dict(
        kind='step', cfg=cfg, steps_per_epoch=STEPS_PER_EPOCH, batch=batch,
        variables=(var['params'], var['batch_stats']),
        relu=[s[0][1][2] for s in shards]))
    print(f'{data}: ReLU decisions taken from the reference (rank, call, '
          f'count, worst |x| / max|x|):',
          [(r, *f) for r, fl in enumerate(got['flips']) for f in fl])
    mult = jL.lr_mult_fn_for('mv_det3d')
    trained = {p for p, _ in _leaves(want_grads) if mult(p) != 0}
    for tree, wtree, rel in ((got['grads'], want_grads, 1e-4),
                             (got['stats'], want_stats, 1e-5)):
        w = dict(_leaves(wtree))
        t = dict(_leaves(tree))
        assert set(t) == set(w)
        if tree is got['grads']:
            assert 100 < len(trained) < len(w)
            w = {p: v for p, v in w.items() if p in trained}
        bad = [('/'.join(p), float(np.abs(t[p] - v).max()))
               for p, v in w.items()
               if not np.abs(t[p] - v).max() <=
               rel * max(float(np.abs(v).max()), 1e-30)]
        assert not bad, bad
    with flat_engine():
        want = dict(_leaves(jax.device_get(update(got['grads'],
                                                  var['params']))))
    before = dict(_leaves(var['params']))
    moved = 0
    for path, val in _leaves(got['params']):
        np.testing.assert_allclose(val, want[path], rtol=0, atol=1e-6,
                                   err_msg='/'.join(path))
        moved += not np.array_equal(val, before[path])
    assert moved == len(trained)
    assert set(got['metrics']) == set(want_losses) | {'loss_total'}
    for key, val in want_losses.items():
        np.testing.assert_allclose(got['metrics'][key], val, rtol=1e-5)
    np.testing.assert_allclose(got['metrics']['loss_total'],
                               sum(want_losses.values()), rtol=1e-5)


def test_two_rank_evaluate_matches_one_process(fake_data, tmp_path):
    cfg = disk_cfg(tcfg, fake_data)
    want = evaluate(cfg, tcfg.build_model(cfg, device='cpu'), device='cpu')
    out = _run_two_ranks(tmp_path, dict(kind='eval', cfg=cfg))
    # rank 0's view of the group helpers
    assert out['helpers'] == ([0, 2, 4], 6, 0.5, True, [0, 1, 1])
    got = out['metrics']
    assert set(got) == set(want) and len(want) > 4
    for key, val in want.items():
        np.testing.assert_allclose(got[key], val, rtol=0, atol=1e-6)
