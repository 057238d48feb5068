"""Port vs reference: the FCAF3D training losses, ``face_distances``, the
target assigner and the head's loss, values and gradients.

Inputs are numpy arrays from a seed, handed to both packages. Values and
gradients agree within rtol 1e-5 plus atol 1e-6 x max|ref| (float32 sums
of a few thousand terms in another order); the assigner's class targets
are identical.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from embodiedscan_tpu.geometry import boxes as jB
from embodiedscan_tpu.models import fcaf3d as jF
from embodiedscan_tpu.models import losses as jL
from embodiedscan_torch.geometry import boxes as tB
from embodiedscan_torch.models import fcaf3d as tF
from embodiedscan_torch.models import losses as tL


def _close(got, want, rel=1e-6):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-5,
                               atol=rel * scale)


def _both(jfn, tfn, *arrays, argnums=(0,)):
    """(value, grads) of a scalar function on both sides, the gradients
    taken with respect to ``argnums`` of the float arrays."""
    jval, jgrads = jax.value_and_grad(jfn, argnums=argnums)(
        *map(jnp.asarray, arrays))
    targs = [torch.from_numpy(a).requires_grad_(i in argnums)
             for i, a in enumerate(arrays)]
    tval = tfn(*targs)
    tval.backward()
    return (np.asarray(jval), [np.asarray(g) for g in jgrads],
            tval.detach().numpy(), [targs[i].grad.numpy() for i in argnums])


def _boxes(rng, n, size=(0.2, 1.0), angle=0.5):
    return np.concatenate([rng.uniform(0, 2, (n, 3)),
                           rng.uniform(*size, (n, 3)),
                           rng.uniform(-angle, angle, (n, 3))],
                          -1).astype(np.float32)


def test_face_distances():
    rng = np.random.RandomState(0)
    pts = rng.uniform(0, 2, (60, 3)).astype(np.float32)
    boxes = _boxes(rng, 7)
    want = jB.face_distances(jnp.asarray(pts), jnp.asarray(boxes))
    got = tB.face_distances(torch.from_numpy(pts), torch.from_numpy(boxes))
    _close(got.numpy(), want)
    # all positive exactly inside: the box centers are inside their boxes
    inside = (got.amin(-1) > 0).numpy()
    assert inside.any() and not inside.all()


def _cls_inputs(seed=1):
    rng = np.random.RandomState(seed)
    logits = (rng.randn(2, 40, 5) * 3).astype(np.float32)
    labels = rng.randint(-1, 5, (2, 40)).astype(np.int32)
    valid = rng.rand(2, 40) > 0.2
    return logits, labels, valid


def test_sigmoid_focal_loss():
    logits, labels, valid = _cls_inputs()
    jv, jg, tv, tg = _both(
        lambda x: jL.sigmoid_focal_loss(x, jnp.asarray(labels),
                                        jnp.asarray(valid), 5, 7.0),
        lambda x: tL.sigmoid_focal_loss(x, torch.from_numpy(labels),
                                        torch.from_numpy(valid), 5,
                                        torch.tensor(7.0)), logits)
    _close(tv, jv)
    _close(tg[0], jg[0])


def test_bce_with_logits_splits_the_gradient_at_zero_as_jax():
    logits, _, valid = _cls_inputs(2)
    logits = logits[..., 0]
    logits[:, ::4] = 0.0  # ties of max(x, 0) on valid rows
    targets = np.random.RandomState(3).rand(2, 40).astype(np.float32)
    jv, jg, tv, tg = _both(
        lambda x, t: jL.bce_with_logits(x, t, jnp.asarray(valid), 3.0),
        lambda x, t: tL.bce_with_logits(x, t, torch.from_numpy(valid),
                                        torch.tensor(3.0)),
        logits, targets, argnums=(0, 1))
    _close(tv, jv)
    for g, w in zip(tg, jg):
        _close(g, w)


@pytest.mark.parametrize('valid_share', [1.0, 0.7])
def test_bbox_cd_loss(valid_share):
    rng = np.random.RandomState(4)
    src, dst = _boxes(rng, 30), _boxes(rng, 30)
    valid = rng.rand(30) < valid_share
    jv, jg, tv, tg = _both(
        lambda s, d: jL.bbox_cd_loss(s, d, jnp.asarray(valid)),
        lambda s, d: tL.bbox_cd_loss(s, d, torch.from_numpy(valid)), src,
        dst, argnums=(0, 1))
    _close(tv, jv)
    for g, w in zip(tg, jg):
        _close(g, w)


def test_bbox_cd_loss_reduction_none():
    rng = np.random.RandomState(5)
    src, dst = _boxes(rng, 12), _boxes(rng, 12)
    valid = rng.rand(12) > 0.3
    want = jL.bbox_cd_loss(jnp.asarray(src), jnp.asarray(dst),
                           jnp.asarray(valid), reduction='none')
    got = tL.bbox_cd_loss(torch.from_numpy(src), torch.from_numpy(dst),
                          torch.from_numpy(valid), reduction='none')
    assert got.shape == (12, 8)
    _close(got.numpy(), want)


def test_bbox_cd_loss_tied_corners():
    """A zero-size source box has all 8 corners at one point, level with
    the middle of an axis-aligned cube's top-right edge: its two corners
    (z = +-0.25) tie for the L1 minimum. The min's gradient splits between
    them, so the source's z gradient is 0; passed whole to one corner it
    would be +-0.2."""
    rng = np.random.RandomState(6)
    # centers on a 0.25 m grid, half sizes 0.25 and a shift of multiples of
    # 1/16: every corner and L1 distance is exact, so the ties are exact
    dst = np.zeros((5, 9), np.float32)
    dst[:, :3] = rng.randint(0, 8, (5, 3)) * 0.25
    dst[:, 3:6] = 0.5
    src = dst.copy()
    src[:, 3:6] = 0.0
    src[:, :3] += np.float32([0.375, 0.3125, 0.0])
    valid = np.ones(5, bool)
    jv, jg, tv, tg = _both(
        lambda s, d: jL.bbox_cd_loss(s, d, jnp.asarray(valid)),
        lambda s, d: tL.bbox_cd_loss(s, d, torch.from_numpy(valid)), src,
        dst, argnums=(0, 1))
    _close(tv, jv)
    for g, w in zip(tg, jg):
        _close(g, w)
    np.testing.assert_array_equal(tg[0][:, 2], 0.0)
    assert np.abs(tg[0][:, 0]).min() > 0.1


@pytest.fixture(scope='module')
def assign_case():
    """Four levels of locations (with duplicates, so centerness ties) and
    six GT boxes, one of them padding."""
    rng = np.random.RandomState(7)
    sizes = (160, 80, 40, 20)
    pts = np.concatenate([rng.uniform(0, 2, (n, 3)) for n in sizes])
    pts[10:20] = pts[0:10]  # duplicated locations
    levels = np.concatenate([np.full(n, i) for i, n in enumerate(sizes)])
    pmask = rng.rand(len(pts)) > 0.1
    boxes = _boxes(rng, 6, size=(0.4, 1.2), angle=0.3)
    labels = rng.randint(0, 5, 6)
    gmask = np.array([1, 1, 1, 1, 1, 0], bool)
    args = (pts.astype(np.float32), levels.astype(np.int32), pmask, boxes,
            labels.astype(np.int32), gmask)
    want = jF.assign_targets(*map(jnp.asarray, args), 4, 27, 18)
    got = tF.assign_targets(*map(torch.from_numpy, args), 4, 27, 18)
    return [np.asarray(a) for a in want], [a.numpy() for a in got]


def test_assign_targets_classes_identical(assign_case):
    (_, _, jcls), (_, _, tcls) = assign_case
    assert (jcls >= 0).sum() > 10, 'too few positives to compare'
    np.testing.assert_array_equal(tcls, jcls)


@pytest.mark.parametrize('which', [0, 1])
def test_assign_targets_center_and_box(assign_case, which):
    want, got = assign_case
    _close(got[which], want[which])


def _head_outputs(rng, b=2, sizes=(48, 24, 12, 6), c=5):
    center, reg, cls, points, masks = [], [], [], [], []
    for n in sizes:
        center.append(rng.randn(b, n, 1).astype(np.float32))
        r = rng.randn(b, n, 12).astype(np.float32) * 0.5
        r[..., :6] = np.abs(r[..., :6]) + 0.1
        reg.append(r)
        cls.append(rng.randn(b, n, c).astype(np.float32))
        points.append(rng.uniform(0, 2, (b, n, 3)).astype(np.float32))
        masks.append(rng.rand(b, n) > 0.1)
    return center, reg, cls, points, masks


def test_head_loss_values_and_gradients():
    rng = np.random.RandomState(8)
    center, reg, cls, points, masks = _head_outputs(rng)
    gt = np.stack([_boxes(rng, 4, size=(0.5, 1.5), angle=0.3)
                   for _ in range(2)])
    glab = rng.randint(0, 5, (2, 4)).astype(np.int32)
    gmask = np.ones((2, 4), bool)
    head = jF.FCAF3DHead(num_classes=5)

    def jloss(ce, re, cl):
        outs = jF.HeadOutputs(list(ce), list(re), list(cl),
                              [jnp.asarray(p) for p in points],
                              [jnp.asarray(m) for m in masks])
        return head.loss(outs, jnp.asarray(gt), jnp.asarray(glab),
                         jnp.asarray(gmask))

    jvals, jvjp = jax.vjp(jloss, *[[jnp.asarray(a) for a in x]
                                   for x in (center, reg, cls)])
    tparams = [[torch.from_numpy(a).requires_grad_() for a in x]
               for x in (center, reg, cls)]
    outs = tF.HeadOutputs(*tparams, [torch.from_numpy(p) for p in points],
                          [torch.from_numpy(m) for m in masks])
    thead = tF.FCAF3DHead(num_classes=5, in_channels=(8, 8, 8, 8))
    tvals = thead.loss(outs, torch.from_numpy(gt), torch.from_numpy(glab),
                       torch.from_numpy(gmask))
    assert set(tvals) == set(jvals)
    for key in jvals:
        _close(tvals[key].detach().numpy(), jvals[key])
    sum(tvals.values()).backward()
    jgrads = jvjp({k: jnp.ones(()) for k in jvals})
    for tg, jg in zip(tparams, jgrads):
        for t, j in zip(tg, jg):
            _close(t.grad.numpy(), j)
