"""Port vs reference, module by module, at small widths with converted
weights. Integer tables are exact; floats agree within atol 1e-4 plus
rtol 1e-5 (float32 sums in another order, magnitudes above 1)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from embodiedscan_tpu.geometry import iou as jI
from embodiedscan_tpu.geometry import nms as jN
from embodiedscan_tpu.models import fcaf3d as jF
from embodiedscan_tpu.models import fusion as jFu
from embodiedscan_tpu.models import resnet2d as jR
from embodiedscan_tpu.models import sparse_nn as jSN
from embodiedscan_tpu.ops import sparse as jS
from embodiedscan_torch.geometry import iou as tI
from embodiedscan_torch.geometry import nms as tN
from embodiedscan_torch.models import fcaf3d as tF
from embodiedscan_torch.models import fusion as tFu
from embodiedscan_torch.models import resnet2d as tR
from embodiedscan_torch.models import sparse_nn as tSN
from embodiedscan_torch.ops import sparse as tS
from embodiedscan_torch.utils.convert_weights import load_jax_variables

from test_torch_helpers import (flat_engine, random_variables, tiny_batch,
                                to_numpy)

TOL = dict(atol=1e-4, rtol=1e-5)
CAPS = (256, 128, 128, 64, 32, 16)
FPN_CAPS = (128, 64, 32, 16)


def _sparse_input(b=2):
    batch = tiny_batch(b=b, p=400)
    pts = batch['points']
    return pts, batch['points_mask']


@pytest.fixture(scope='module')
def mink():
    """MinkResNet-18 on both sides (flat engine), with its input."""
    pts, pmask = _sparse_input()
    with flat_engine():
        jst = jS.from_points_b(jnp.asarray(pts), jnp.asarray(pts),
                               jnp.asarray(pmask), 0.05, 256)
        jm = jSN.MinkResNet(depth=18, capacities=CAPS)
        var = random_variables(jm, (jst,), train=False)
        jout = to_numpy(jax.jit(lambda v, s: jm.apply(v, s, train=False))(
            var, jst))
    tst = tS.from_points_b(torch.from_numpy(pts), torch.from_numpy(pts),
                           torch.from_numpy(pmask), 0.05, 256)
    tm = tSN.MinkResNet(depth=18, capacities=CAPS).eval()
    load_jax_variables(tm, var['params'], var['batch_stats'])
    with torch.no_grad():
        tout = to_numpy(tm(tst))
    return jout, tout, to_numpy(jst), to_numpy(tst)


def test_from_points_b(mink):
    _, _, jst, tst = mink
    for w, g in zip(jst, tst):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize('level', range(4))
def test_mink_resnet18(mink, level):
    jout, tout, _, _ = mink
    np.testing.assert_array_equal(tout[level].coords, jout[level].coords)
    np.testing.assert_array_equal(tout[level].mask, jout[level].mask)
    assert jout[level].mask.any()
    np.testing.assert_allclose(tout[level].feats, jout[level].feats, **TOL)


@pytest.mark.parametrize('depth', [18, 50])
def test_resnet2d(depth):
    x = np.random.RandomState(depth).randn(2, 32, 32, 3).astype(np.float32)
    jm = jR.ResNet(depth=depth, base_channels=8)
    var = random_variables(jm, (jnp.asarray(x),))
    want = to_numpy(jax.jit(jm.apply)(var, jnp.asarray(x)))
    tm = tR.ResNet(depth=depth, base_channels=8).eval()
    load_jax_variables(tm, var['params'], var['batch_stats'])
    with torch.no_grad():
        got = to_numpy(tm(torch.from_numpy(x)))
    assert len(got) == len(want) == 4
    for w, g in zip(want, got):
        np.testing.assert_allclose(g, w, **TOL)


def test_resnet2d_bf16():
    """img_dtype=bf16: both sides round to bf16 after every conv but in
    other places, so they agree to ~1% (bound: 3% of the output scale)."""
    x = np.random.RandomState(18).randn(2, 32, 32, 3).astype(np.float32)
    jm = jR.ResNet(depth=50, base_channels=8, dtype=jnp.bfloat16)
    var = random_variables(jm, (jnp.asarray(x),))
    want = to_numpy(jax.jit(jm.apply)(var, jnp.asarray(x, jnp.bfloat16)))
    tm = tR.ResNet(depth=50, base_channels=8, dtype=torch.bfloat16).eval()
    load_jax_variables(tm, var['params'], var['batch_stats'])
    with torch.no_grad():
        got = tm(torch.from_numpy(x).to(torch.bfloat16))
    for w, g in zip(want, got):
        assert g.dtype == torch.bfloat16
        w, g = w.astype(np.float32), g.float().numpy()
        assert np.abs(g - w).max() <= 3e-2 * np.abs(w).max()
        assert np.abs(g - w).mean() <= 3e-2 * np.abs(w).mean()


@pytest.mark.parametrize('mode', ['nearest', 'bilinear'])
def test_point_image_sample_batched(mode):
    rng = np.random.RandomState(1)
    batch = tiny_batch(b=2, p=300, v=3)
    pts = batch['points'].reshape(2, 1, 300, 3)
    pmask = rng.rand(2, 1, 300) > 0.1
    feats = rng.randn(2, 3, 8, 8, 5).astype(np.float32)
    proj = batch['proj'].copy()
    proj[:, 1, :3, 3] += [0.5, -0.3, 0.2]  # views that differ
    aug = batch['aug_inv']
    vmask = np.array([[[True, False, True]], [[True, True, True]]])
    want = jFu.point_image_sample_batched(
        *map(jnp.asarray, (pts, pmask, feats, proj, aug)), (32, 32), mode,
        jnp.asarray(vmask))
    got = tFu.point_image_sample_batched(
        *map(torch.from_numpy, (pts, pmask, feats, proj, aug)), (32, 32),
        mode, torch.from_numpy(vmask))
    assert np.abs(np.asarray(want)).max() > 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_fcaf3d_head_forward(mink):
    """Head on the backbone's levels, with random fused features."""
    jout, _, _, _ = mink
    rng = np.random.RandomState(3)
    in_ch = (16, 24, 32, 40)
    levels = [(l.coords, (rng.randn(*l.mask.shape, c) * l.mask[..., None]
                          ).astype(np.float32), l.mask)
              for l, c in zip(jout, in_ch)]
    with flat_engine():
        jh = jF.FCAF3DHead(num_classes=7, in_channels=in_ch, voxel_size=0.05,
                           fpn_capacities=FPN_CAPS)
        jin = [jS.SparseTensor(*map(jnp.asarray, l)) for l in levels]
        var = random_variables(jh, (jin,), train=False)
        want = to_numpy(jax.jit(lambda v, x: jh.apply(v, x, train=False))(
            var, jin))
    th = tF.FCAF3DHead(num_classes=7, in_channels=in_ch, voxel_size=0.05,
                       fpn_capacities=FPN_CAPS).eval()
    load_jax_variables(th, var['params'], var['batch_stats'])
    with torch.no_grad():
        got = to_numpy(th([tS.SparseTensor(*map(torch.from_numpy, l))
                           for l in levels]))
    for name in ('points', 'masks'):
        for w, g in zip(getattr(want, name), getattr(got, name)):
            np.testing.assert_array_equal(g, w)
    for name in ('center', 'reg', 'cls'):
        for w, g in zip(getattr(want, name), getattr(got, name)):
            np.testing.assert_allclose(g, w, **TOL)


def _boxes(rng, n):
    return np.concatenate([
        rng.uniform(0, 2, (n, 3)), rng.uniform(0.3, 1.0, (n, 3)),
        rng.uniform(-np.pi, np.pi, (n, 1)), rng.uniform(-0.3, 0.3, (n, 2)),
    ], -1).astype(np.float32)


def test_boxes3d_iou_rotated_touching_degenerate():
    rng = np.random.RandomState(0)
    b1 = _boxes(rng, 12)
    b2 = _boxes(rng, 9)
    # touching: b2[0] shares b1[0]'s +x face; degenerate: zero-size boxes
    b2[0] = b1[0]
    b2[0, 6:9] = 0
    b1[0, 6:9] = 0
    b2[0, 0] = b1[0, 0] + b1[0, 3]
    b2[1] = b1[1]  # identical rotated box: IoU 1
    b2[2, 3:6] = 0.0
    b1[3, 5] = 0.0
    want = np.asarray(jI.boxes3d_iou(jnp.asarray(b1), jnp.asarray(b2)))
    got = tI.boxes3d_iou(torch.from_numpy(b1), torch.from_numpy(b2)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)
    assert abs(got[1, 1] - 1) < 1e-4 and got[0, 0] < 1e-4
    assert ((want > 0.01) & (want < 0.99)).any()


def test_nms3d():
    rng = np.random.RandomState(1)
    k = 64
    centers = rng.uniform(0, 1.2, (k, 3))
    boxes = np.concatenate([centers, rng.uniform(0.4, 0.8, (k, 3)),
                            rng.uniform(-1, 1, (k, 3))], -1).astype(np.float32)
    scores = np.sort(rng.rand(k).astype(np.float32))[::-1].copy()
    mask = rng.rand(k) > 0.1
    labels = rng.randint(0, 3, k).astype(np.int32)
    for presorted in (True, False):
        sc = scores if presorted else rng.permutation(scores)
        jo, jk = jN.nms3d(jnp.asarray(boxes), jnp.asarray(sc),
                          jnp.asarray(mask), 0.3, jnp.asarray(labels),
                          presorted=presorted)
        to, tk = tN.nms3d(torch.from_numpy(boxes), torch.from_numpy(sc),
                          torch.from_numpy(mask), 0.3,
                          torch.from_numpy(labels), presorted=presorted)
        np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
        assert 0 < np.asarray(jk).sum() < mask.sum()
