"""Port vs reference: the FCAF3D head's box modes and their losses.

- ``decode_bbox_mode`` in each of 'euler9d', 'yaw7d' and 'aa6d';
  ``build_model(bbox_mode=...)`` builds each mode's head.
- ``boxes3d_overlap_paired``: volume, IoU and their gradients (through the
  Sutherland-Hodgman clip, the SAT bound's minimum and the union clamp)
  against ``jax.grad`` over identical, disjoint, face-touching, z-rotated
  and general 9-DoF pairs.
- ``rotated_iou_loss``, ``axis_aligned_iou_loss`` and ``bbox_cd_loss``
  over {l1, l2} x {g8, g4} x {mean, none}, with gradients.

(``FCAF3DHead.loss`` in every branch, and the converters: in
``test_torch_head_loss.py``.)

Inputs are numpy arrays from a seed, handed to both packages. Values
within rtol 1e-5 plus atol 1e-6 x max|ref|; gradients of the clipped
overlap within 1e-4 x max|ref| (a clipped vertex is a quotient of plane
distances, which float32 rounds differently in another order), other
gradients as the values.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from embodiedscan_tpu.geometry import iou as jI
from embodiedscan_tpu.models import fcaf3d as jF
from embodiedscan_tpu.models import losses as jL
from embodiedscan_torch.geometry import iou as tI
from embodiedscan_torch.models import fcaf3d as tF
from embodiedscan_torch.models import losses as tL

MODES = ('euler9d', 'yaw7d', 'aa6d')
# the clipped overlap's gradients: atol GRAD_REL x max|ref|
GRAD_REL = 1e-4


def _close(got, want, rel=1e-6, rtol=1e-5):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
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


def _boxes(rng, n, angle=0.5, yaw_only=False):
    ang = rng.uniform(-angle, angle, (n, 3))
    if yaw_only:
        ang[:, 1:] = 0.0
    return np.concatenate([rng.uniform(0, 3, (n, 3)),
                           rng.uniform(0.3, 2.0, (n, 3)), ang],
                          -1).astype(np.float32)


def _perturbed(rng, boxes, shift=0.3, angle=0.3, yaw_only=False):
    out = boxes.copy()
    out[:, :3] += rng.uniform(-shift, shift, out[:, :3].shape)
    out[:, 3:6] *= rng.uniform(0.7, 1.3, out[:, 3:6].shape)
    da = rng.uniform(-angle, angle, out[:, 6:].shape)
    if yaw_only:
        da[:, 1:] = 0.0
    out[:, 6:] += da
    return out.astype(np.float32)


# --- decode ------------------------------------------------------------------


@pytest.mark.parametrize('mode', MODES)
def test_decode_bbox_mode(mode):
    rng = np.random.RandomState(0)
    pts = rng.uniform(0, 3, (50, 3)).astype(np.float32)
    reg = rng.randn(50, tF.REG_OUTS[mode]).astype(np.float32)
    reg[:, :6] = np.abs(reg[:, :6]) + 0.05
    jv, jg, tv, tg = _both(
        lambda r: jnp.sum(jF.decode_bbox_mode(jnp.asarray(pts), r, mode) *
                          jnp.arange(9.0)),
        lambda r: (tF.decode_bbox_mode(torch.from_numpy(pts), r, mode) *
                   torch.arange(9.0)).sum(), reg)
    _close(tv, jv)
    _close(tg[0], jg[0])
    got = tF.decode_bbox_mode(torch.from_numpy(pts), torch.from_numpy(reg),
                              mode).numpy()
    _close(got, jF.decode_bbox_mode(jnp.asarray(pts), jnp.asarray(reg), mode))
    assert got.shape == (50, 9)
    if mode != 'euler9d':
        np.testing.assert_array_equal(got[:, 7:9], 0.0)
    if mode == 'aa6d':
        np.testing.assert_array_equal(got[:, 6], 0.0)


@pytest.mark.parametrize('mode', MODES)
def test_build_model_takes_the_box_mode(mode):
    from embodiedscan_torch.configs.base import build_model
    from embodiedscan_torch.tools.quality_smoke import tiny_cfg
    model = build_model(tiny_cfg('mv_det3d'), 'cpu', bbox_mode=mode)
    assert model.bbox_head.bbox_mode == mode
    assert model.bbox_head.conv_reg.out_features == tF.REG_OUTS[mode]
    if mode != 'euler9d':
        with pytest.raises(ValueError):
            build_model(tiny_cfg('mv_occ'), 'cpu', bbox_mode=mode)


def test_reg_outs_and_unknown_mode():
    assert tF.REG_OUTS == jF.REG_OUTS
    with pytest.raises(ValueError):
        tF.FCAF3DHead(num_classes=3, bbox_mode='quat10d')


# --- the exact paired overlap --------------------------------------------------


def _pairs(kind):
    rng = np.random.RandomState(1)
    n = 24
    if kind == 'identical':
        a = _boxes(rng, n)
        return a, a.copy()
    if kind == 'disjoint':
        a = _boxes(rng, n)
        b = _perturbed(rng, a)
        b[:, 0] += 6.0
        return a, b
    if kind == 'touching':
        # axis-aligned, b against a's x+ face, overlapping in y and z
        a = _boxes(rng, n, angle=0.0)
        b = a.copy()
        b[:, 3:6] *= rng.uniform(0.6, 1.2, (n, 3)).astype(np.float32)
        b[:, 0] = a[:, 0] + (a[:, 3] + b[:, 3]) / 2
        b[:, 1:3] += rng.uniform(-0.1, 0.1, (n, 2)).astype(np.float32)
        return a, b
    if kind == 'rotz':
        a = _boxes(rng, n, angle=3.0, yaw_only=True)
        return a, _perturbed(rng, a, angle=1.0, yaw_only=True)
    a = _boxes(rng, n)
    return a, _perturbed(rng, a)


def _jax_paired(vol_fn):
    """boxes3d_overlap_paired's composition over ``vol_fn`` (the shipping
    ``_intersection_volume_flat``, or one of its two branches)."""
    def run(a, b):
        vol = vol_fn(a, b)
        v1 = jnp.abs(a[:, 3] * a[:, 4] * a[:, 5])
        v2 = jnp.abs(b[:, 3] * b[:, 4] * b[:, 5])
        return vol, vol / jnp.clip(v1 + v2 - vol, min=1e-8)
    return run


def _weighted(fn, w1, w2):
    def scalar(a, b):
        vol, iou = fn(a, b)
        return (vol * w1).sum() + (iou * w2).sum()
    return scalar


@pytest.mark.parametrize('kind', ['identical', 'disjoint', 'touching',
                                  'rotz', 'general'])
def test_boxes3d_overlap_paired(kind):
    """Volume and IoU, and the gradient of a weighted sum of both with
    respect to both box sets. Identical boxes sit where the clipped volume
    equals the SAT bound up to float32 rounding, the kink of their
    ``minimum``: the side (or the even split of a tie) that each package
    takes follows its rounding, and XLA rounds the differentiated program
    differently from the forward one. There the port's gradient must be
    the reference's gradient of one of the three (clipped volume, bound,
    their mean), each computed by ``jax.grad``."""
    a, b = _pairs(kind)
    rng = np.random.RandomState(2)
    w1 = rng.randn(len(a)).astype(np.float32)
    w2 = rng.randn(len(a)).astype(np.float32)
    jvol, jiou = jI.boxes3d_overlap_paired(jnp.asarray(a), jnp.asarray(b))
    ta = torch.from_numpy(a).requires_grad_()
    tb = torch.from_numpy(b).requires_grad_()
    tvol, tiou = tI.boxes3d_overlap_paired(ta, tb)
    _close(tvol.detach().numpy(), jvol, rel=1e-5)
    _close(tiou.detach().numpy(), jiou, rel=1e-5)
    if kind == 'disjoint':
        assert not np.asarray(jvol).any() and not tvol.detach().any()
    elif kind == 'touching':
        np.testing.assert_allclose(tiou.detach().numpy(), 0.0, atol=1e-6)
    elif kind == 'identical':
        np.testing.assert_allclose(tiou.detach().numpy(), 1.0, atol=1e-5)
    else:
        assert (np.asarray(jiou) > 0.05).mean() > 0.8
    ((tvol * torch.from_numpy(w1)).sum() +
     (tiou * torch.from_numpy(w2)).sum()).backward()
    got = np.concatenate([ta.grad.numpy(), tb.grad.numpy()], 1)

    def jgrad(vol_fn):
        g = jax.grad(_weighted(_jax_paired(vol_fn), w1, w2), argnums=(0, 1))(
            jnp.asarray(a), jnp.asarray(b))
        return np.concatenate([np.asarray(x) for x in g], 1)

    want = jgrad(jI._intersection_volume_flat)
    scale = max(float(np.abs(want).max()), 1e-30)
    if kind != 'identical':
        np.testing.assert_allclose(got, want, rtol=0, atol=GRAD_REL * scale)
        return
    inf = jnp.inf

    def clipped(x, y):
        # the shipping volume with the bound lifted out of the minimum
        bound = jI._axis_overlap_bound
        jI._axis_overlap_bound = lambda p, q: jnp.full(p.shape[:1], inf)
        try:
            return jI._intersection_volume_flat(x, y)
        finally:
            jI._axis_overlap_bound = bound

    g_clip, g_bound = jgrad(clipped), jgrad(jI._axis_overlap_bound)
    options = np.stack([g_clip, g_bound, (g_clip + g_bound) / 2])
    near = np.abs(options - got[None]).max(-1) <= GRAD_REL * scale
    assert near.any(0).all(), np.nonzero(~near.any(0))
    near_ref = np.abs(options - want[None]).max(-1) <= GRAD_REL * scale
    assert near_ref.any(0).all()


def test_overlap_paired_matches_the_pairwise_overlap():
    """The paired values equal the diagonal of ``boxes3d_overlap`` (to
    float32 rounding: the two batch their lanes differently)."""
    a, b = _pairs('general')
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    vol, iou = tI.boxes3d_overlap_paired(ta, tb)
    pvol, piou = tI.boxes3d_overlap(ta, tb)
    np.testing.assert_allclose(vol.numpy(), np.diag(pvol.numpy()),
                               rtol=1e-6)
    np.testing.assert_allclose(iou.numpy(), np.diag(piou.numpy()),
                               rtol=1e-6)


# --- the IoU and chamfer losses ------------------------------------------------


@pytest.mark.parametrize('dims', [7, 9])
def test_rotated_iou_loss(dims):
    rng = np.random.RandomState(3)
    tgt = _boxes(rng, 40, yaw_only=dims == 7)
    pred = _perturbed(rng, tgt, yaw_only=dims == 7)
    tgt, pred = tgt[:, :dims].copy(), pred[:, :dims].copy()
    valid = rng.rand(40) > 0.3
    jv, jg, tv, tg = _both(
        lambda p, t: jL.rotated_iou_loss(p, t, jnp.asarray(valid)),
        lambda p, t: tL.rotated_iou_loss(p, t, torch.from_numpy(valid)),
        pred, tgt, argnums=(0, 1))
    _close(tv, jv)
    assert 0.05 < float(tv) < 1.0
    for g, w in zip(tg, jg):
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=GRAD_REL * np.abs(w).max())
    assert not tg[0][~valid].any()


def test_axis_aligned_iou_loss():
    rng = np.random.RandomState(4)
    lo = rng.uniform(0, 3, (40, 3))
    tgt = np.concatenate([lo, lo + rng.uniform(0.3, 2, (40, 3))], 1)
    pred = tgt + rng.uniform(-0.3, 0.3, tgt.shape)
    pred[:5, :3] += 4.0  # disjoint pairs
    pred[5:8] = tgt[5:8]  # identical pairs: ties of every max and min
    tgt, pred = tgt.astype(np.float32), pred.astype(np.float32)
    valid = rng.rand(40) > 0.2
    jv, jg, tv, tg = _both(
        lambda p, t: jL.axis_aligned_iou_loss(p, t, jnp.asarray(valid)),
        lambda p, t: tL.axis_aligned_iou_loss(p, t, torch.from_numpy(valid)),
        pred, tgt, argnums=(0, 1))
    _close(tv, jv)
    for g, w in zip(tg, jg):
        _close(g, w)


@pytest.mark.parametrize('mode', ['l1', 'l2'])
@pytest.mark.parametrize('group', ['g8', 'g4'])
@pytest.mark.parametrize('reduction', ['mean', 'none'])
def test_bbox_cd_loss_modes(mode, group, reduction):
    rng = np.random.RandomState(5)
    dst = _boxes(rng, 30)
    src = _perturbed(rng, dst)
    valid = rng.rand(30) > 0.3
    w = rng.randn(30, 8).astype(np.float32)

    def jfn(s, d):
        out = jL.bbox_cd_loss(s, d, jnp.asarray(valid), mode, group,
                              reduction)
        return out if reduction == 'mean' else (out * w).sum()

    def tfn(s, d):
        out = tL.bbox_cd_loss(s, d, torch.from_numpy(valid), mode, group,
                              reduction)
        return out if reduction == 'mean' else (out * torch.from_numpy(w)
                                                ).sum()

    jv, jg, tv, tg = _both(jfn, tfn, src, dst, argnums=(0, 1))
    _close(tv, jv)
    for g, want in zip(tg, jg):
        _close(g, want)
    per = tL.bbox_cd_loss(torch.from_numpy(src), torch.from_numpy(dst),
                          torch.from_numpy(valid), mode, group, 'none')
    _close(per.numpy(), jL.bbox_cd_loss(jnp.asarray(src), jnp.asarray(dst),
                                        jnp.asarray(valid), mode, group,
                                        'none'))
