"""The geometry public API that no task path calls, the anchor generators
and ``ChannelMapper``, against the reference package on the same seeded
inputs.

- Torch geometry (``boxes``, ``rotations``, ``projection``, ``iou``):
  float32 on the CPU against the reference's float32 jnp functions; bool
  masks identical, floats within atol 1e-6 + rtol 1e-6 (float32 trig and
  3-term products in another order on values of order 1-10).
- Numpy helpers (``np_boxes``, ``anchors``): the same numpy code, so
  identical to the last bit.
- ``ChannelMapper`` (kernel 1 and 3, eval and training mode): weights
  carried over by ``load_jax_variables`` from the reference's flax tree
  (and exported back equal); outputs and the updated running statistics
  within atol 1e-5 + rtol 1e-5 (float32 sums over 27 x C products and a
  batch normalization in another order); padded rows exactly zero.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from embodiedscan_tpu.geometry import boxes as jB
from embodiedscan_tpu.geometry import iou as jI
from embodiedscan_tpu.geometry import np_boxes as jN
from embodiedscan_tpu.geometry import projection as jP
from embodiedscan_tpu.geometry import rotations as jR
from embodiedscan_tpu.models import anchors as jA
from embodiedscan_tpu.models import sparse_nn as jSN
from embodiedscan_tpu.ops import sparse as jS
from embodiedscan_torch.geometry import boxes as tB
from embodiedscan_torch.geometry import iou as tI
from embodiedscan_torch.geometry import np_boxes as tN
from embodiedscan_torch.geometry import projection as tP
from embodiedscan_torch.geometry import rotations as tR
from embodiedscan_torch.models import anchors as tA
from embodiedscan_torch.models import sparse_nn as tSN
from embodiedscan_torch.ops import sparse as tS
from embodiedscan_torch.utils.convert_weights import (export_jax_tree,
                                                      load_jax_variables)

from test_torch_helpers import flat_engine, random_variables, to_numpy

TOL = dict(atol=1e-6, rtol=1e-6)
MAPPER_TOL = dict(atol=1e-5, rtol=1e-5)


def _both(fn_j, fn_t, *arrays, **kw):
    """(reference output, port output) as numpy on the same inputs."""
    want = fn_j(*[jnp.asarray(a) for a in arrays], **kw)
    got = fn_t(*[torch.from_numpy(np.asarray(a)) for a in arrays], **kw)
    return to_numpy(want), to_numpy(got)


def _close(fn_j, fn_t, *arrays, **kw):
    want, got = _both(fn_j, fn_t, *arrays, **kw)
    assert got.shape == want.shape and got.dtype == want.dtype
    if got.dtype == bool:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, **TOL)


def _boxes(rng, n=12):
    return np.concatenate([rng.uniform(-2, 2, (n, 3)),
                           rng.uniform(0.3, 2.0, (n, 3)),
                           rng.uniform(-1.2, 1.2, (n, 3))],
                          -1).astype(np.float32)


def _rigid(rng, rows):
    q = np.linalg.qr(rng.randn(3, 3))[0]
    q[:, 0] *= np.sign(np.linalg.det(q))
    t = np.eye(4, dtype=np.float32)
    t[:3, :3] = q
    t[:3, 3] = rng.randn(3)
    return t if rows == 4 else t[:3, :3].copy()


# --- geometry/boxes.py ------------------------------------------------------


@pytest.mark.parametrize('rows', [3, 4])
def test_boxes_transform_rotate(rows):
    rng = np.random.RandomState(0)
    boxes, mat = _boxes(rng), _rigid(rng, rows)
    _close(jB.transform, tB.transform, boxes, mat)
    if rows == 3:
        _close(jB.rotate, tB.rotate, boxes, mat)


def test_boxes_elementwise():
    rng = np.random.RandomState(1)
    boxes = _boxes(rng).reshape(3, 4, 9)  # leading axes broadcast
    _close(jB.gravity_center, tB.gravity_center, boxes)
    _close(lambda b: jB.scale(b, 1.3), lambda b: tB.scale(b, 1.3), boxes)
    trans = rng.randn(3).astype(np.float32)
    _close(jB.translate, tB.translate, boxes, trans)
    for direction in ('X', 'Y', 'Z'):
        _close(lambda b: jB.flip(b, direction),
               lambda b: tB.flip(b, direction), boxes)
    with pytest.raises(ValueError):
        tB.flip(torch.from_numpy(boxes), 'W')


def test_points_in_boxes():
    rng = np.random.RandomState(2)
    pts = rng.uniform(-3, 3, (400, 3)).astype(np.float32)
    boxes = _boxes(rng, 9)
    _close(jB.points_in_boxes, tB.points_in_boxes, pts, boxes)
    inside = tB.points_in_boxes(torch.from_numpy(pts),
                                torch.from_numpy(boxes)).numpy()
    assert 0 < inside.sum() < inside.size
    np.testing.assert_array_equal(tN.points_in_boxes_np(pts, boxes), inside)


# --- geometry/rotations.py, projection.py, iou.py ---------------------------


@pytest.mark.parametrize('axis', [0, 1, 2, -1, -2, -3])
def test_rotation_3d_in_axis(axis):
    rng = np.random.RandomState(3)
    pts = rng.randn(5, 7, 3).astype(np.float32)
    ang = rng.uniform(-3, 3, 5).astype(np.float32)
    _close(lambda p, a: jR.rotation_3d_in_axis(p, a, axis),
           lambda p, a: tR.rotation_3d_in_axis(p, a, axis), pts, ang)
    with pytest.raises(ValueError):
        tR.rotation_3d_in_axis(torch.from_numpy(pts), torch.from_numpy(ang),
                               3)


def test_limit_period():
    val = np.random.RandomState(4).uniform(-12, 12, 300).astype(np.float32)
    for offset, period in ((0.5, np.pi), (0.0, 2 * np.pi), (1.0, 0.5)):
        _close(lambda v: jR.limit_period(v, offset, period),
               lambda v: tR.limit_period(v, offset, period), val)


@pytest.mark.parametrize('shape', [(3, 3), (3, 4), (4, 4)])
@pytest.mark.parametrize('with_depth', [False, True])
def test_projection(shape, with_depth):
    rng = np.random.RandomState(5)
    k = np.eye(4, dtype=np.float32)
    k[:3, :3] = [[80.0, 0, 40], [0, 70, 30], [0, 0, 1]]
    k[:3, 3] = [0.5, -0.2, 0.01]
    proj = k[:shape[0], :shape[1]].copy()
    pts = np.concatenate([rng.uniform(-1, 1, (2, 20, 2)),
                          rng.uniform(0.5, 4, (2, 20, 1))],
                         -1).astype(np.float32)
    pts[1, :3, 2] = -0.5  # behind the camera: clamped in the batched form
    _close(lambda p, m: jP.points_cam2img(p, m, with_depth),
           lambda p, m: tP.points_cam2img(p, m, with_depth), pts[0], proj)
    projs = np.stack([proj, proj * 1.1])
    _close(lambda p, m: jP.batch_points_cam2img(p, m, with_depth),
           lambda p, m: tP.batch_points_cam2img(p, m, with_depth), pts,
           projs)
    if shape != (3, 4):  # an invertible intrinsic
        uvd = np.concatenate([rng.uniform(0, 80, (20, 2)),
                              rng.uniform(0.5, 4, (20, 1))],
                             -1).astype(np.float32)
        _close(jP.points_img2cam, tP.points_img2cam, uvd, proj)
    _close(jP.get_lidar2img, tP.get_lidar2img, proj, _rigid(rng, 4)[:3])


def test_axis_aligned_iou3d():
    rng = np.random.RandomState(6)
    lo = rng.uniform(-2, 2, (2, 15, 3))
    b = np.concatenate([lo, lo + rng.uniform(0.1, 2, (2, 15, 3))],
                       -1).astype(np.float32)
    b[1, 0] = b[0, 0]  # identical boxes: IoU 1
    _close(jI.axis_aligned_iou3d, tI.axis_aligned_iou3d, b[0], b[1])
    got = tI.axis_aligned_iou3d(torch.from_numpy(b[0]),
                                torch.from_numpy(b[1])).numpy()
    np.testing.assert_allclose(got[0, 0], 1.0, atol=1e-6)
    one = torch.tensor([[0.0, 0, 0, 2, 2, 2]])
    np.testing.assert_allclose(tI.axis_aligned_iou3d(
        one, torch.tensor([[1.0, 1, 1, 3, 3, 3]])).numpy(), [[1 / 15]],
        atol=1e-6)


# --- geometry/np_boxes.py and models/anchors.py -----------------------------


def test_np_boxes_standup_and_bev():
    rng = np.random.RandomState(7)
    boxes = _boxes(rng, 10)
    boxes[0, 6:9] = [np.pi / 2, 0, 0]
    for name in ('corner_to_standup_np', 'boxes_to_standup_np',
                 'corners_bev_np'):
        arg = jN.corners_np(boxes) if name == 'corner_to_standup_np' \
            else boxes
        got, want = getattr(tN, name)(arg), getattr(jN, name)(arg)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('case', ['one', 'sizes_per_range', 'shared_range',
                                  'two_levels', 'custom', 'flat2d'])
@pytest.mark.parametrize('aligned', [False, True, 'corner'])
def test_anchor_generators(case, aligned):
    kw = dict(ranges=[[0, 0, 0, 4, 4, 2]], sizes=[[1.0, 1.0, 1.0]],
              rotations=[0.0, 1.5707963])
    sizes = [(2, 4, 4)]
    if case == 'sizes_per_range':
        kw.update(ranges=[[0, 0, 0, 4, 4, 2], [-1, -1, 0, 3, 3, 1]],
                  sizes=[[1, 1, 1], [2, 1, 0.5]])
    elif case == 'shared_range':
        kw.update(sizes=[[1, 1, 1], [2, 2, 2]], rotations=[0.0],
                  size_per_range=False)
    elif case == 'two_levels':
        kw.update(scales=[1, 2])
        sizes = [(2, 4, 4), (1, 2, 3)]
    elif case == 'custom':
        kw.update(custom_values=(0.0, 0.0), reshape_out=False)
    elif case == 'flat2d':
        sizes = [(5, 3)]
    gens = []
    for A in (jA, tA):
        if aligned:
            gens.append(A.AlignedAnchor3DRangeGenerator(
                align_corner=aligned == 'corner', **kw))
        else:
            gens.append(A.Anchor3DRangeGenerator(**kw))
    want, got = gens
    assert isinstance(got, tA.Anchor3DRangeGenerator)
    assert (got.num_base_anchors, got.num_levels) == \
        (want.num_base_anchors, want.num_levels)
    for g, w in zip(got.grid_anchors(sizes), want.grid_anchors(sizes)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(
        got.anchors_single_range((2, 3, 5), [0, 0, 0, 4, 4, 2]),
        want.anchors_single_range((2, 3, 5), [0, 0, 0, 4, 4, 2]))


def test_aligned_anchors_at_cell_centres():
    gen = tA.AlignedAnchor3DRangeGenerator(ranges=[[0, 0, 0, 4, 4, 2]],
                                           sizes=[[1.0, 1.0, 1.0]],
                                           rotations=[0.0])
    a = gen.anchors_single_range((2, 4, 4), [0, 0, 0, 4, 4, 2])
    np.testing.assert_allclose(np.unique(a[..., 0]), [0.5, 1.5, 2.5, 3.5])
    np.testing.assert_allclose(np.unique(a[..., 2]), [0.5, 1.5])


# --- models/sparse_nn.py: ChannelMapper -------------------------------------


def _levels(b=2):
    """Two sparse levels per sample: unique coordinates, padded tails."""
    rng = np.random.RandomState(8)
    out = []
    for n, c, grid in ((48, 8, 6), (28, 12, 4)):
        coords = np.stack([rng.permutation(grid ** 3)[:n] for _ in range(b)])
        coords = np.stack(np.unravel_index(coords, (grid, ) * 3),
                          -1).astype(np.int32)
        feats = rng.randn(b, n, c).astype(np.float32)
        mask = np.arange(n)[None] < np.array([[n - 5], [n - 9]])[:b]
        out.append((coords, feats, mask))
    return out


@pytest.mark.parametrize('kernel_size', [1, 3])
def test_channel_mapper(kernel_size):
    levels = _levels()
    jst = [jS.SparseTensor(*(jnp.asarray(a) for a in lv)) for lv in levels]
    tst = [tS.SparseTensor(*(torch.from_numpy(a) for a in lv))
           for lv in levels]
    jm = jSN.ChannelMapper(out_channels=16, kernel_size=kernel_size)
    with flat_engine():
        var = random_variables(jm, (jst, ), train=False)
        want_eval = to_numpy(jax.jit(
            lambda v, s: jm.apply(v, s, train=False))(var, jst))
        want_train, stats = to_numpy(jax.jit(lambda v, s: jm.apply(
            v, s, train=True, mutable=['batch_stats']))(var, jst))
    tm = tSN.ChannelMapper([8, 12], 16, kernel_size)
    load_jax_variables(tm, var['params'], var['batch_stats'])
    exported = export_jax_tree(tm, 'params')
    for name in var['params']:
        for leaf, arr in var['params'][name].items():
            np.testing.assert_array_equal(exported[name][leaf], arr)
    with torch.no_grad():
        got_eval = to_numpy(tm.eval()(tst))
        got_train = to_numpy(tm.train()(tst))
    got_stats = export_jax_tree(tm, 'buffers')
    for got, want in ((got_eval, want_eval), (got_train, want_train)):
        for g, w, (_, _, mask) in zip(got, want, levels):
            np.testing.assert_array_equal(g.coords, w.coords)
            np.testing.assert_array_equal(g.mask, w.mask)
            assert g.feats.shape == mask.shape + (16, )
            np.testing.assert_allclose(g.feats, w.feats, **MAPPER_TOL)
            assert not g.feats[~mask].any()
    for name, leaves in stats['batch_stats'].items():
        for leaf, arr in leaves.items():
            np.testing.assert_allclose(got_stats[name][leaf], arr,
                                       **MAPPER_TOL)
    with pytest.raises(ValueError):
        tSN.ChannelMapper([8], 16, kernel_size=5)
