"""The ``(data, view)`` axis of ``embodiedscan_torch/parallel/mesh.py``.

- The layout: on eight gloo ranks, ``make_mesh(view_parallel=k)`` lays the
  ranks out as the reference's mesh over ``jax.devices()[:8]`` (the
  suite's 8 virtual CPU devices, as ``tests/test_parallel.py`` builds it);
  each rank's data group is its column and its view group its row (the
  ranks that ``view_sum`` and ``pmean_`` reach, bit by bit); every batch
  entry's ``batch_sharding`` gives each rank the slices that the
  reference's ``NamedSharding`` places on that device, and
  ``shard_batch`` returns them. Outside a process group of that size,
  ``make_mesh`` refuses more than one rank.
- Two gloo ranks (data 1 x view 2, spawned as ``tests/test_torch_dist.py``
  spawns them, on ``test_torch_helpers.view_worker``) against one process
  holding all views, from the same weights and batch of 4 views: the tiny
  detector's train step (the losses within rtol 1e-5; every gradient that
  AdamW receives and every norm statistic after the step within 1e-5 x
  its leaf's max|ref|) and a small occupancy model's request (logits
  within atol 1e-5 plus rtol 1e-5, class ids identical). The two
  processes each sum their two views and add the sums, where one process
  sums four views at once: float32 sums in another order.
- Four gloo ranks (data 2 x view 2) on two scenes of 4 views against the
  mean of one process's steps on each scene alone (the data axis's
  semantics, as ``tests/test_torch_dist.py`` holds it against the
  reference's ``pmean``): the losses within rtol 1e-5, the gradients and
  statistics within 1e-4 x max|ref| (``test_torch_dist.py``'s gate). The
  data axis alone (data 2 x view 1) gives the mean of the two scenes'
  steps exactly; splitting either of these two scenes' views over two
  ranks moves some 2D norms' gradients by up to 2.7e-5 x max|ref|
  (float32 sums in another order, carried through the backward).
"""

import pickle

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import jax

from embodiedscan_tpu.parallel import mesh as jM
from embodiedscan_torch.models.detector import init_weights
from embodiedscan_torch.parallel import mesh as tM

from test_torch_helpers import (TINY_DET, build_view_model, mesh_worker,
                                occ_batch, run_view_job, tiny_batch,
                                view_worker)

KEYS = dict(imgs=(8, 4, 8, 8, 3), proj=(8, 4, 4, 4), view_mask=(8, 4),
            points=(8, 16, 3), points_mask=(8, 16), gt_boxes=(8, 5, 9))
# the occupancy model of tests/test_torch_occupancy.py at its 8 x 8 x 4 grid
OCC = dict(num_classes=5, resnet_depth=18, resnet_base_channels=16,
           mink_depth=18, neck3d_channels=16, fpn_channels=8,
           pre_neck_channels=12, n_voxels=(8, 8, 4), input_capacity=1024,
           backbone_capacities=(1024, 1024, 1024, 512, 256, 128))


@pytest.fixture(scope='module')
def eight_ranks(tmp_path_factory):
    """Each of eight gloo ranks' meshes for k = 1, 2, 4 (``mesh_worker``)
    and the batch they were sharding."""
    tmp = tmp_path_factory.mktemp('mesh')
    batch = {key: np.arange(np.prod(s), dtype=np.float32).reshape(s)
             for key, s in KEYS.items()}
    path = str(tmp / 'job.pkl')
    with open(path, 'wb') as f:
        pickle.dump(dict(views=(1, 2, 4), batch=batch), f)
    mp.spawn(mesh_worker, args=(8, f'file://{tmp}/rendezvous', path),
             nprocs=8, join=True)
    outs = []
    for rank in range(8):
        with open(f'{path}.{rank}', 'rb') as f:
            outs.append(pickle.load(f))
    return outs, batch


@pytest.mark.parametrize('k', [1, 2, 4])
def test_layout_matches_the_reference_mesh(k, eight_ranks):
    outs, batch = eight_ranks
    devices = jax.devices()[:8]
    jmesh = jM.make_mesh(devices, view_parallel=k)
    jgrid = np.vectorize(lambda d: d.id)(jmesh.devices).reshape(8 // k, k)
    jsharded = jM.shard_batch(jmesh, batch)
    for rank, dev in enumerate(devices):
        got = outs[rank][k]
        np.testing.assert_array_equal(got['grid'], jgrid)
        assert got['rank'] == rank
        i, j = got['coords']
        assert jgrid[i, j] == rank
        assert got['data'] == jgrid[:, j].tolist()
        assert got['view'] == jgrid[i].tolist()
        assert got['view_sum'] == sum(2.0 ** r for r in jgrid[i])
        assert got['data_mean'] == sum(2.0 ** r for r in jgrid[:, j]) / (8 //
                                                                         k)
        mesh = tM.Mesh(got['grid'], rank)
        assert mesh.axis_names == jmesh.axis_names
        for key, shape in KEYS.items():
            js = jM.batch_sharding(jmesh, key)
            ts = tM.batch_sharding(mesh, key)
            assert jax.sharding.PartitionSpec(*ts.spec) == js.spec
            assert ts.index(shape) == tuple(
                js.devices_indices_map(shape)[dev]), (key, rank)
        for key, arr in jsharded.items():
            shard = [s for s in arr.addressable_shards if s.device == dev]
            np.testing.assert_array_equal(got['shards'][key],
                                          np.asarray(shard[0].data))
        assert tM.batch_shardings(mesh, batch).keys() == batch.keys()


def test_uneven_views_are_refused():
    mesh = tM.Mesh(np.arange(4).reshape(2, 2), 1)
    with pytest.raises(ValueError):
        tM.batch_sharding(mesh, 'imgs').index((2, 3, 8, 8, 3))
    with pytest.raises(ValueError):
        tM.make_mesh(6, view_parallel=4)


@pytest.mark.parametrize('world,k', [(2, 1), (4, 2), (8, 4)])
def test_a_mesh_needs_its_process_group(world, k):
    """Outside a process group of ``world`` ranks no group could sum the
    views or average the rows: refused, not run on one rank's part."""
    with pytest.raises(RuntimeError):
        tM.make_mesh(world, view_parallel=k)
    mesh = tM.make_mesh()
    assert mesh.grid.shape == (1, 1) and mesh.rank == 0
    assert mesh.data_group is None and mesh.view_group is None


def _views_batch(b=1):
    """``b`` scenes of 4 views, each from 4 camera positions."""
    batch = tiny_batch(b=b, p=1024, v=4, hw=32, seed=4)
    batch['proj'] = batch['proj'].copy()
    for j in range(4):
        batch['proj'][:, j, 0, 3] += 15.0 * (j - 1.5)
    rng = np.random.RandomState(5)
    batch.update(
        gt_boxes=np.concatenate([rng.uniform(0.3, 1.7, (b, 4, 3)),
                                 rng.uniform(0.3, 0.9, (b, 4, 3)),
                                 rng.uniform(-0.3, 0.3, (b, 4, 3))],
                                -1).astype(np.float32),
        gt_labels=rng.randint(0, 5, (b, 4)).astype(np.int32),
        gt_mask=np.ones((b, 4), bool))
    return batch


def _mean(outs):
    """The leafwise mean of equally nested dicts."""
    if isinstance(outs[0], dict):
        return {k: _mean([o[k] for o in outs]) for k in outs[0]}
    return np.mean(np.stack(outs), axis=0)


def _run(tmp_path, job, world=2):
    """The job on ``world`` ranks (view ``job['view']``), and in this
    process on all views: one job per data row's block of scenes, averaged
    over the rows as the data axis averages them."""
    path = str(tmp_path / 'job.pkl')
    with open(path, 'wb') as f:
        pickle.dump(job, f)
    mp.spawn(view_worker, args=(world, f'file://{tmp_path}/rendezvous',
                                path), nprocs=world, join=True)
    with open(path + '.out', 'rb') as f:
        got = pickle.load(f)
    rows = world // job['view']
    n = len(job['batch']['points']) // rows
    outs = []
    for r in range(rows):
        model = build_view_model(job)
        model.load_state_dict({k: torch.from_numpy(v)
                               for k, v in job['state'].items()})
        outs.append(run_view_job(job, model, {
            k: torch.from_numpy(v[r * n:(r + 1) * n])
            for k, v in job['batch'].items()}))
    return (outs[0] if rows == 1 else _mean(outs)), got


def _seeded_state(model):
    init_weights(model, torch.Generator().manual_seed(0))
    return {k: v.numpy().copy() for k, v in model.state_dict().items()}


def _leaves(tree, prefix=()):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _leaves(val, prefix + (key,))
        else:
            yield '/'.join(prefix + (key,)), np.asarray(val)


def _assert_step_matches(one, got, leaf_rtol=1e-5):
    for key, val in one['metrics'].items():
        np.testing.assert_allclose(got['metrics'][key], val, rtol=1e-5)
    assert one['metrics']['loss_bbox'] > 0
    for tree in ('grads', 'stats'):
        want, mine = dict(_leaves(one[tree])), dict(_leaves(got[tree]))
        assert set(mine) == set(want)
        bad = [(p, float(np.abs(mine[p] - w).max() / np.abs(w).max()))
               for p, w in want.items() if np.abs(w).max() > 0 and
               np.abs(mine[p] - w).max() > leaf_rtol * np.abs(w).max()]
        assert not bad, bad
    # the 2D branch learns from every rank's views
    g2d = [w for p, w in _leaves(one['grads']) if 'ResNet_0/layer4' in p]
    assert g2d and max(np.abs(g).max() for g in g2d) > 0


def test_view_parallel_train_step(tmp_path):
    from embodiedscan_torch.models.detector import SparseFusionDetector
    state = _seeded_state(SparseFusionDetector(**TINY_DET))
    one, two = _run(tmp_path, dict(kind='step', view=2, state=state,
                                   batch=_views_batch()))
    assert two['shapes']['imgs'] == (1, 2, 32, 32, 3)
    assert two['shapes']['points'] == (1, 1024, 3)
    _assert_step_matches(one, two)


def test_data_and_view_parallel_train_step(tmp_path):
    """Data 2 x view 2: each column averages the gradients, statistics and
    losses of its two scenes, each row sums its 2D branch's gradients."""
    from embodiedscan_torch.models.detector import SparseFusionDetector
    state = _seeded_state(SparseFusionDetector(**TINY_DET))
    batch = _views_batch(b=2)
    one, four = _run(tmp_path, dict(kind='step', view=2, state=state,
                                    batch=batch), world=4)
    assert four['shapes']['imgs'] == (1, 2, 32, 32, 3)
    assert four['shapes']['points'] == (1, 1024, 3)
    _assert_step_matches(one, four, leaf_rtol=1e-4)


def test_view_parallel_occupancy_request(tmp_path):
    from embodiedscan_torch.models.occupancy import DenseFusionOccPredictor
    state = _seeded_state(DenseFusionOccPredictor(**OCC))
    batch = occ_batch(b=1, p=1024, v=4, hw=64, n_voxels=(8, 8, 4))
    one, two = _run(tmp_path, dict(kind='occ', view=2, occ=OCC, state=state,
                                   batch=batch))
    assert two['shapes']['imgs'] == (1, 2, 64, 64, 3)
    for g, w in zip(two['logits'], one['logits']):
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(two['classes'], one['classes'])
