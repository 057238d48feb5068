"""Shared helpers of the port's parity tests (no tests here).

Inputs are made from a seed with numpy and handed to both packages as the
same arrays; results come back as numpy for comparison.
"""

import contextlib
from collections.abc import Mapping

import numpy as np
import pytest
import torch

torch.set_num_threads(1)


@contextlib.contextmanager
def flat_engine():
    """Run the JAX engine in the 'flat' batch mode the port implements
    (the suite's conftest defaults it to 'vmap'); enter before tracing."""
    from embodiedscan_tpu.ops import sparse as jS
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jS, 'BMAP_MODE', 'flat')
        yield


def to_numpy(tree):
    """Nested dict / tuple / list of JAX or torch arrays -> numpy."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_numpy(v) for v in tree) \
            if not hasattr(tree, '_fields') else type(tree)(
                *[to_numpy(v) for v in tree])
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return np.array(tree)


def to_torch(batch: dict) -> dict:
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def tiny_batch(b=2, p=256, v=1, hw=32, seed=0):
    """Numpy twin of ``__graft_entry__._tiny_batch`` without ground truth."""
    rng = np.random.RandomState(seed)
    pts = np.concatenate([
        rng.uniform(0, 2.0, (b, p, 2)),
        rng.uniform(0, 1.5, (b, p, 1))
    ], -1).astype(np.float32)
    k = np.array([[30.0, 0, hw / 2, 0], [0, 30.0, hw / 2, 0], [0, 0, 1, 0],
                  [0, 0, 0, 1]], np.float32)
    ext = np.eye(4, dtype=np.float32)
    ext[:3, 3] = [-1.0, -1.0, 6.0]
    return dict(
        points=pts,
        points_mask=np.ones((b, p), bool),
        imgs=rng.randn(b, v, hw, hw, 3).astype(np.float32),
        proj=np.tile((k @ ext)[None, None], (b, v, 1, 1)).astype(np.float32),
        aug_inv=np.tile(np.eye(4, dtype=np.float32), (b, 1, 1)),
    )


def random_variables(module, args, seed=0, **kwargs):
    """Random numpy ``{'params', 'batch_stats'}`` for a flax module, from
    its abstract init (no compile): kernels N(0, 2 / fan_out), norm scales
    and biases near (1, 0), running means small and variances positive."""
    import jax
    shapes = jax.eval_shape(
        lambda *a: module.init(jax.random.PRNGKey(0), *a, **kwargs), *args)
    rng = np.random.RandomState(seed)

    def fill(path, sds):
        name = path[-1]
        shape = sds.shape
        if path[-2:] == ('conv_reg', 'kernel'):
            # the reference's N(0, 0.01) regression init keeps exp() tame
            return (rng.randn(*shape) * 0.01).astype(np.float32)
        if path[-1] == 'kernel' and (path[-2] in ('conv_center', 'conv_cls')
                                     or path[-3:-2] == ('OccHead_0', )):
            # logits of order 1-10: distinct scores, moderate magnitudes
            return (rng.randn(*shape) * 0.1).astype(np.float32)
        if name == 'kernel':
            fan_out = int(np.prod(shape[:-2] or (1,))) * shape[-1]
            return (rng.randn(*shape) * np.sqrt(2.0 / fan_out)).astype(
                np.float32)
        if name == 'scale' or name == 'scales':
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        if name == 'var':
            return rng.uniform(0.5, 2.0, shape).astype(np.float32)
        if name == 'mean':
            return (rng.randn(*shape) * 0.1).astype(np.float32)
        if name.endswith('_tconv'):
            return (rng.randn(*shape) * np.sqrt(2.0 / (8 * shape[-1]))
                    ).astype(np.float32)
        return (rng.randn(*shape) * 0.1).astype(np.float32)

    def walk(tree, path=()):
        return {k: walk(v, path + (k,)) if isinstance(v, Mapping) else
                fill(path + (k,), v) for k, v in tree.items()}

    return {k: walk(v) for k, v in shapes.items()}


def occ_batch(b=2, p=1024, v=2, hw=64, n_voxels=(8, 8, 4), num_classes=5,
              m=64, seed=0):
    """A seeded occupancy batch: ``p`` points a sample spread over 6 x 6 m
    and 2.4 m of height inside the preset's ``point_cloud_range`` (more
    than the 1.28 m a 9-bit z reaches at 0.0025 m voxels, and past the
    5.12 m an 11-bit x or y reaches), ``v`` views from 7 m above, and
    ``m`` padded gt voxels of labels 1 .. num_classes - 1 on the prior
    grid, some masked, some out of the grid, with a visibility mask."""
    rng = np.random.RandomState(seed)
    pts = np.concatenate([rng.uniform(-3.0, 3.0, (b, p, 2)),
                          rng.uniform(-0.7, 1.7, (b, p, 1))],
                         -1).astype(np.float32)
    k = np.array([[0.8 * hw, 0, hw / 2, 0], [0, 0.8 * hw, hw / 2, 0],
                  [0, 0, 1, 0], [0, 0, 0, 1]], np.float32)
    projs = []
    for i in range(v):
        ext = np.eye(4, dtype=np.float32)
        ext[:3, 3] = [0.3 * i - 0.15 * (v - 1), 0.2 * i, 7.0]
        projs.append(k @ ext)
    lo = np.array([-1, -1, -1])
    hi = np.asarray(n_voxels) + 1
    gt = np.concatenate([rng.randint(lo, hi, (b, m, 3)),
                         rng.randint(1, num_classes, (b, m, 1))], -1)
    return dict(
        points=pts,
        points_mask=rng.uniform(size=(b, p)) > 0.05,
        imgs=rng.randn(b, v, hw, hw, 3).astype(np.float32),
        proj=np.tile(np.stack(projs)[None], (b, 1, 1, 1)),
        aug_inv=np.tile(np.eye(4, dtype=np.float32), (b, 1, 1)),
        gt_occ=gt.astype(np.float32),
        gt_occ_mask=rng.uniform(size=(b, m)) > 0.1,
        visible_mask=rng.uniform(size=(b, *n_voxels)) > 0.2,
    )


# the tiny detector of the runtime tests (test_torch_loop.py,
# test_torch_dist.py): the shipped depths' smallest (18), 5 classes,
# capacities for ~1000 points at 0.02 m
TINY_DET = dict(num_classes=5, voxel_size=0.02, input_capacity=1024,
                backbone_capacities=(1024, 512, 512, 256, 128, 64),
                fpn_capacities=(256, 128, 64, 32), max_dets=16, nms_pre=32,
                max_candidates=32, resnet_depth=18, mink_depth=18)


def disk_cfg(base, data_root, **data):
    """``base.mv_det3d()`` (``base``: either package's ``configs.base``) at
    the tiny detector's sizes over the ``fake_data`` scenes: one scene a
    train step, 2 train and 4 eval views of 32 x 32, 1000 points, the numpy
    host pipeline, no worker threads or prefetch; ``data`` overrides."""
    cfg = base.mv_det3d()
    for key, val in TINY_DET.items():
        setattr(cfg.model, key, val)
    d = cfg.data
    d.data_root, d.batch_size, d.repeat_times = data_root, 1, 1
    d.n_views_train, d.n_views_test, d.image_hw = 2, 4, (32, 32)
    d.n_points, d.points_per_view, d.max_boxes = 1000, 300, 4
    d.native_pipeline, d.num_workers, d.prefetch_depth = 'numpy', 1, 0
    for key, val in data.items():
        setattr(d, key, val)
    return cfg


def _copy(tree):
    if isinstance(tree, dict):
        return {k: _copy(v) for k, v in tree.items()}
    return np.array(tree, copy=True)


# a ReLU input within float32 rounding of 0 may fall on either side in
# either package (ROADMAP C.4); where the port's decision differs from the
# reference's, its input must be within RELU_TIE x max|input| of 0
RELU_TIE = 1e-5


@contextlib.contextmanager
def follow_relu(decisions):
    """While active, call k of ``F.relu`` returns ``x * decisions[k]``:
    the reference's decisions (``x > 0``, from ``jax_relu_decisions``; 4-D
    ones NHWC, as the reference's images, and NCHW here) on the port's
    values, the same values and gradients wherever the two packages agree.
    Raises where they differ off a tie (RELU_TIE); yields the (call,
    count, worst |x| / max|x|) of each call whose decisions were taken."""
    from torch.nn import functional
    relu, calls, flips = functional.relu, [0], []

    def patched(x, inplace=False):
        k = calls[0]
        calls[0] += 1
        want = torch.from_numpy(np.asarray(decisions[k]))
        if want.dim() == 4:
            want = want.permute(0, 3, 1, 2)
        want = want.reshape(x.shape)
        diff = want != (x > 0)
        if diff.any():
            size = x.detach().abs()
            worst = float(size[diff].max()) / max(float(size.max()), 1e-30)
            if not worst <= RELU_TIE:
                raise RuntimeError(f'relu call {k}: {int(diff.sum())} '
                                   f'decisions differ, |x| up to {worst:.3g} '
                                   f'x max|x|')
            flips.append((k, int(diff.sum()), worst))
        return x * want.to(x.dtype)

    functional.relu = patched
    try:
        yield flips
    finally:
        functional.relu = relu
    if calls[0] != len(decisions):
        raise RuntimeError(f'{calls[0]} relu calls, the reference made '
                           f'{len(decisions)}')


def dist_worker(rank, world, init_method, job_path):
    """One gloo rank of the two-process tests (``torch.multiprocessing``;
    importable without JAX). ``job_path`` holds a pickled dict: ``'kind'``
    'step' (the tiny detector from ``'variables'``, the task's optimizer
    with ``'steps_per_epoch'``, one ``train_step`` on row ``rank``
    of ``'batch'`` with its ReLUs taking the reference's decisions
    ``'relu'[rank]`` (:func:`follow_relu`), recording the averaged
    gradients AdamW receives) or
    'eval' (``evaluate`` of the seeded model of
    ``'cfg'`` over this rank's shard); rank 0 writes its result to
    ``job_path + '.out'``."""
    import pickle

    import torch.distributed as dist

    from embodiedscan_torch.configs.base import build_model
    from embodiedscan_torch.models.detector import SparseFusionDetector
    from embodiedscan_torch.parallel.mesh import replicate
    from embodiedscan_torch.parallel.multihost import (gather_objects,
                                                       init_distributed)
    from embodiedscan_torch.train.loop import evaluate, lr_mult_fn_for
    from embodiedscan_torch.train.state import make_optimizer, train_step
    from embodiedscan_torch.utils.convert_weights import (export_jax_tree,
                                                          load_jax_variables)
    with open(job_path, 'rb') as f:
        job = pickle.load(f)
    assert init_distributed('cpu', init_method, world, rank)
    try:
        if job['kind'] == 'step':
            model = SparseFusionDetector(**TINY_DET).train()
            params, stats = job['variables']
            load_jax_variables(model, params, stats)
            replicate(model)
            opt = make_optimizer(model, job['cfg'],
                                 lr_mult_fn_for('mv_det3d'),
                                 steps_per_epoch=job['steps_per_epoch'])
            batch = {k: torch.from_numpy(v[rank:rank + 1])
                     for k, v in job['batch'].items()}
            grads = {}
            step = opt.step

            def step_recording(closure=None):
                # the averaged gradients as AdamW receives them (before its
                # clip, which scales them in place); frozen parameters,
                # outside the optimizer, read as zero
                for p in model.parameters():
                    if p.grad is None:
                        p.grad = torch.zeros_like(p)
                grads.update(export_jax_tree(model, 'grads'))
                grads.update({k: _copy(v) for k, v in grads.items()})
                return step(closure)

            opt.step = step_recording
            with follow_relu(job['relu'][rank]) as flips:
                metrics = train_step(model, opt, batch)
            out = dict(grads=grads, params=export_jax_tree(model, 'params'),
                       stats=export_jax_tree(model, 'buffers'),
                       metrics={k: float(v) for k, v in metrics.items()},
                       flips=gather_objects([flips]))
        else:
            from embodiedscan_torch.parallel import multihost as mh
            model = build_model(job['cfg'], device='cpu')
            out = dict(metrics=evaluate(job['cfg'], model, device='cpu'),
                       helpers=(list(mh.process_shard(5)),
                                mh.global_batch_size(3),
                                mh.all_processes_scalar(rank),
                                mh.is_main_process(),
                                mh.gather_objects([rank] * (rank + 1))))
        if rank == 0:
            with open(job_path + '.out', 'wb') as f:
                pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def view_worker(rank, world, init_method, job_path):
    """One gloo rank of a ``(data, view)`` grid of ``world // job['view']``
    x ``job['view']`` processes (``torch.multiprocessing``; importable
    without JAX). ``job_path`` holds a pickled dict: ``'kind'`` 'step' (the
    tiny detector of ``TINY_DET`` from ``'state'``, one ``train_step`` on
    ``shard_batch`` of ``'batch'`` with the mesh, recording the gradients
    AdamW receives) or 'occ' (``'occ'``'s occupancy model from ``'state'``
    serving this rank's shard of ``'batch'``: its per-scale logits and
    class ids); rank 0 writes its result to ``job_path + '.out'``."""
    import pickle

    import torch.distributed as dist

    from embodiedscan_torch.parallel.mesh import (make_mesh, shard_batch,
                                                  use_mesh)
    from embodiedscan_torch.parallel.multihost import init_distributed
    with open(job_path, 'rb') as f:
        job = pickle.load(f)
    assert init_distributed('cpu', init_method, world, rank)
    try:
        mesh = make_mesh(view_parallel=job['view'])
        batch = shard_batch(mesh, {k: torch.from_numpy(v)
                                   for k, v in job['batch'].items()})
        model = build_view_model(job)
        model.load_state_dict({k: torch.from_numpy(v)
                               for k, v in job['state'].items()})
        use_mesh(model, mesh)
        out = run_view_job(job, model, batch, mesh)
        out['shapes'] = {k: tuple(v.shape) for k, v in batch.items()}
        if rank == 0:
            with open(job_path + '.out', 'wb') as f:
                pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def mesh_worker(rank, world, init_method, job_path):
    """One gloo rank of ``world`` (``torch.multiprocessing``; importable
    without JAX): for each ``view_parallel`` k of the pickled job's
    ``'views'``, ``make_mesh``'s grid, rank and coordinates, the ranks of
    its data and view groups, ``view_sum`` of ``2 ** rank`` over the view
    group and ``pmean_`` of it over the data group (which ranks took part,
    bit by bit), and this rank's ``shard_batch`` of ``'batch'``; written to
    ``job_path + f'.{rank}'``."""
    import pickle

    import torch.distributed as dist

    from embodiedscan_torch.parallel.mesh import (make_mesh, shard_batch,
                                                  view_sum)
    from embodiedscan_torch.parallel.multihost import (init_distributed,
                                                       pmean_)
    with open(job_path, 'rb') as f:
        job = pickle.load(f)
    assert init_distributed('cpu', init_method, world, rank)
    try:
        out = {}
        for k in job['views']:
            mesh = make_mesh(view_parallel=k)
            mine = torch.tensor([2.0 ** rank], dtype=torch.float64)
            mean = mine.clone()
            pmean_([mean], mesh.data_group)
            out[k] = dict(
                grid=mesh.grid, rank=mesh.rank, coords=mesh.coords(),
                data=(list(range(world)) if mesh.data_group is None else
                      dist.get_process_group_ranks(mesh.data_group)),
                view=([rank] if mesh.view_group is None else
                      dist.get_process_group_ranks(mesh.view_group)),
                view_sum=float(view_sum(mine, mesh.view_group)),
                data_mean=float(mean),
                shards=shard_batch(mesh, job['batch']))
        with open(f'{job_path}.{rank}', 'wb') as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def build_view_model(job):
    """The model of a :func:`view_worker` job, before its weights."""
    if job['kind'] == 'step':
        from embodiedscan_torch.models.detector import SparseFusionDetector
        return SparseFusionDetector(**TINY_DET).train()
    from embodiedscan_torch.models.occupancy import DenseFusionOccPredictor
    return DenseFusionOccPredictor(**job['occ']).eval()


def run_view_job(job, model, batch, mesh=None):
    """A :func:`view_worker` job's work on ``batch`` (the whole batch
    without a ``mesh``): a train step's losses, the gradients AdamW
    receives and the norms' statistics after it, or a request's logits
    and class ids; all as numpy."""
    if job['kind'] == 'occ':
        logits = model(batch, mode='feats')
        return dict(logits=[t.numpy() for t in logits],
                    classes=model.OccHead_0.predict(logits).numpy())
    from embodiedscan_torch.configs.base import Config
    from embodiedscan_torch.train.loop import lr_mult_fn_for
    from embodiedscan_torch.train.state import make_optimizer, train_step
    from embodiedscan_torch.utils.convert_weights import export_jax_tree
    opt = make_optimizer(model, Config(), lr_mult_fn_for('mv_det3d'),
                         steps_per_epoch=100)
    grads = {}
    step = opt.step

    def step_recording(closure=None):
        # frozen parameters, outside the optimizer, read as zero
        for p in model.parameters():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads.update(_copy(export_jax_tree(model, 'grads')))
        return step(closure)

    opt.step = step_recording
    metrics = train_step(model, opt, batch, mesh)
    return dict(grads=grads, stats=_copy(export_jax_tree(model, 'buffers')),
                metrics={k: float(v) for k, v in metrics.items()})
