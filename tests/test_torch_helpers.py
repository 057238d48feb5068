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
