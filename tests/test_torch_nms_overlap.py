"""K4, the rotated NMS's suppression matrix (``csrc/nms_overlap.cu``), on
the CPU: the kernel cannot run here, so these tests hold its per-pair
algorithm to the torch route.

- The skips are exact: on adversarial box sets the torch route's matrix is
  already false wherever K4 skips a pair (j <= i, two labels, a
  separating-axis bound of exactly 0).
- :func:`k4_model` is K4's per-pair algorithm in NumPy float32, line by
  line in the kernel's order of operations, over :func:`nms_fields`' real
  output; it agrees with ``boxes3d_iou`` and gives the same matrix.
- CPU tensors take the torch route and load no library; the wrapper's
  checks raise without a card.

``python3 kernel_ab.py --nms`` holds the kernel itself to the torch route on
the card, on these sets among others.
"""

import numpy as np
import pytest
import torch

from embodiedscan_torch.geometry import boxes as Bx
from embodiedscan_torch.geometry import iou as I
from embodiedscan_torch.geometry import nms as N
from embodiedscan_torch.ops import kernels

F32 = np.float32
# the kernel's float constants: PyTorch's float rounding of the Python ones
DENOM_EPS, KEEP_TOL, COPL_TOL, UNION_EPS = (F32(1e-12), F32(1e-5), F32(3e-5),
                                            F32(1e-8))
SIXTH = F32(1) / F32(6)
SLOTS = 10
FACES = ((0, 1, 2, 3), (4, 7, 6, 5), (0, 4, 5, 1), (3, 2, 6, 7), (0, 3, 7, 4),
         (1, 5, 6, 2))
ROT, CENTER, SIZE = 0, 9, 12  # nms_fields' layout
CORNER_NORM = Bx._CORNERS_NORM  # boxes.py's corners in units of the sizes


def box_sets(seed: int, yaw_only: bool, n: int = 64) -> np.ndarray:
    """(n, 9) float32 adversarial boxes: random overlapping boxes, exact
    duplicates, face-touching and coplanar neighbours, nested boxes,
    zero-size boxes and far-away ones (separating-axis bound 0). The
    touching and coplanar pairs are exact where their box is axis-aligned
    with dyadic coordinates, within rounding where it is rotated."""
    rng = np.random.RandomState(seed)

    def rand(m):
        ang = np.zeros((m, 3))
        ang[:, 0] = rng.uniform(-np.pi, np.pi, m)
        if not yaw_only:
            ang[:, 1:] = rng.uniform(-1, 1, (m, 2))
        return np.concatenate([rng.uniform(0, 1.5, (m, 3)),
                               rng.uniform(0.3, 1.0, (m, 3)), ang], 1)

    def shifted(b, local):
        """b moved by ``local`` (a multiple of its sizes) in its frame."""
        out = b.copy()
        rot = I.euler_zxy_to_matrix(torch.from_numpy(b[None, 6:9])).numpy()[0]
        out[:3] = b[:3] + rot @ (local * b[3:6])
        return out

    base = rand(n - 36)
    grid = np.array([[0.5, 0.5, 0.5, 1, 1, 1, 0, 0, 0],
                     [1.5, 0.5, 0.5, 1, 1, 1, 0, 0, 0],      # touches at x = 1
                     [0.75, 0.5, 0.25, 0.5, 1, 0.5, 0, 0, 0],  # coplanar z = 0
                     [0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0, 0, 0],  # nested
                     [0.5, 1.5, 0.5, 1, 1, 1, 0, 0, 0],      # touches at y = 1
                     [0.5, 0.5, 1.5, 1, 1, 1, 0, 0, 0]])     # touches at z = 1
    pick = rng.randint(0, len(base), 30)
    extra = [base[pick[m]] for m in range(6)]  # duplicates
    extra += [shifted(base[p], np.array([1.0, 0, 0])) for p in pick[6:10]]
    extra += [shifted(base[p], np.array([0, 0, 0.5])) for p in pick[10:14]]
    nested = base[pick[14:20]].copy()
    nested[:, 3:6] *= 0.5
    extra += list(nested)
    zero = base[pick[20:24]].copy()
    zero[0, 3] = 0.0
    zero[1, 4:6] = 0.0
    zero[2, 3:6] = 0.0
    extra += list(zero[:3])
    far = base[pick[24:30]].copy()
    far[:, :3] += 20.0
    extra += list(far) + [shifted(base[pick[23]], np.array([1.0, 1.0, 0]))]
    boxes = np.concatenate([base, grid, np.stack(extra)]).astype(np.float32)
    return boxes[rng.permutation(len(boxes))]


# (seed, yaw_only, labels): yaw-only and full 9-DoF, one to four labels
SETS = ((0, True, None), (1, False, 4), (2, True, 2), (3, False, 1))


def _set(idx: int):
    seed, yaw_only, n_labels = SETS[idx]
    boxes = box_sets(seed, yaw_only)
    labels = None
    if n_labels is not None:
        labels = np.random.RandomState(seed + 100).randint(
            0, n_labels, len(boxes)).astype(np.int64)
    return boxes, labels


_IOU = {}


def _torch_iou(idx: int):
    """The torch route's IoU matrix of set ``idx`` (computed once)."""
    if idx not in _IOU:
        boxes, _ = _set(idx)
        t = torch.from_numpy(boxes)
        _IOU[idx] = I.boxes3d_iou(t, t).numpy()
    return _IOU[idx]


def _dot3(x0, y0, x1, y1, x2, y2):
    return (x0 * y0 + x1 * y1) + x2 * y2


def _tmin(a, b):  # torch.minimum
    return np.where(np.isnan(a) | (a < b), a, b)


def _tmax(a, b):  # torch.maximum
    return np.where(np.isnan(a) | (a > b), a, b)


def _tabs(a):  # iou.py _abs
    return np.where(a >= 0, a, -a)


def _frame_bound(own, oth):
    ra, rb = own[:, ROT:ROT + 9], oth[:, ROT:ROT + 9]
    co, ct = own[:, CENTER:CENTER + 3], oth[:, CENTER:CENTER + 3]
    half = F32(0.5)
    length = []
    for k in range(3):
        p_own = _dot3(co[:, 0], ra[:, k], co[:, 1], ra[:, 3 + k], co[:, 2],
                      ra[:, 6 + k])
        p_oth = _dot3(ct[:, 0], ra[:, k], ct[:, 1], ra[:, 3 + k], ct[:, 2],
                      ra[:, 6 + k])
        m = [_tabs(_dot3(ra[:, k], rb[:, l], ra[:, 3 + k], rb[:, 3 + l],
                         ra[:, 6 + k], rb[:, 6 + l])) *
             (oth[:, SIZE + l] * half) for l in range(3)]
        w = (m[0] + m[2]) + m[1]
        h = own[:, SIZE + k] * half
        hi = _tmin(p_own + h, p_oth + w)
        lo = _tmax(p_own - h, p_oth - w)
        length.append(_tmax(hi - lo, F32(0)))
    return (length[0] * length[2]) * length[1]


def _plane_offsets(box):
    out = []
    for j in range(6):
        s, c = F32(1 if j < 3 else -1), j % 3
        r = box[:, ROT:ROT + 9]
        out.append(_dot3(s * r[:, c], box[:, CENTER], s * r[:, 3 + c],
                         box[:, CENTER + 1], s * r[:, 6 + c],
                         box[:, CENTER + 2]) + box[:, SIZE + c] * F32(0.5))
    return out


def _clip(v, cnt, n, d, ops):
    """One half-space clip of every lane's polygon: v (3, SLOTS, L)."""
    ds = [_dot3(v[0, s], n[0], v[1, s], n[1], v[2, s], n[2]) - d
          for s in range(SLOTS)]
    ops += 6 * SLOTS
    out = np.zeros_like(v)
    run = np.zeros_like(cnt)
    for s in range(SLOTS):
        sn = s + 1 if s + 1 < SLOTS else 0
        wrap = s + 1 < cnt
        d_n = np.where(wrap, ds[sn], ds[0])
        cur_in, nxt_in = ds[s] <= 0, d_n <= 0
        emit = (s < cnt) & cur_in
        slot = run == np.arange(SLOTS)[:, None]
        out = np.where(emit & slot, v[:, s:s + 1], out)
        run = run + emit
        emit = (s < cnt) & (cur_in != nxt_in)
        denom = ds[s] - d_n
        t = ds[s] / np.where(np.abs(denom) > DENOM_EPS, denom, DENOM_EPS)
        nxt = np.where(wrap, v[:, sn], v[:, 0])
        iv = v[:, s] + t * (nxt - v[:, s])
        slot = run == np.arange(SLOTS)[:, None]
        out = np.where(emit & slot, iv[:, None], out)
        run = run + emit
        ops += 11 * emit
    cnt = np.minimum(run, SLOTS)
    return np.where(np.arange(SLOTS)[:, None] < cnt, out, v), cnt


def _clipped_volume(own, n, d, ops):
    """Signed volume of each pair's ``own`` faces clipped by the six
    half-spaces (n[j] (3, P), d[j] (P,))."""
    p = own.shape[0]
    rot = own[:, ROT:ROT + 9]
    corner = np.zeros((p, 8, 3), F32)
    for m in range(8):  # rot @ (size * norm) + center, as the kernel does
        l0, l1, l2 = (own[:, SIZE + j] * F32(CORNER_NORM[m, j])
                      for j in range(3))
        for i in range(3):
            corner[:, m, i] = _dot3(l0, rot[:, 3 * i], l1, rot[:, 3 * i + 1],
                                    l2, rot[:, 3 * i + 2]) + own[:, CENTER + i]
    ops += 8 * 3 + 8 * 3 * 6
    face_vol = []
    for f in range(6):
        v = np.zeros((3, SLOTS, p), F32)
        for s in range(4):
            v[:, s] = corner[:, FACES[f][s]].T
        cnt = np.full(p, 4)
        for j in range(6):
            v, cnt = _clip(v, cnt, n[j], d[j], ops)
        acc = np.zeros(p, F32)
        for i in range(1, SLOTS - 1):
            x, y, z, x1, y1, z1 = (v[0, i], v[1, i], v[2, i], v[0, i + 1],
                                   v[1, i + 1], v[2, i + 1])
            det = _dot3(y * z1 - z * y1, v[0, 0], z * x1 - x * z1, v[1, 0],
                        x * y1 - y * x1, v[2, 0])
            acc = acc + np.where(i + 1 < cnt, det, F32(0))
        ops += 15 * (SLOTS - 2)
        face_vol.append(acc)
    fv = face_vol
    return ((((fv[0] + fv[4]) + (fv[1] + fv[5])) + fv[2]) + fv[3]) * SIXTH


def _half_spaces(box, off, shift, minus):
    n, d = [], []
    for j in range(6):
        s, c = F32(1 if j < 3 else -1), j % 3
        n.append(np.stack([s * box[:, ROT + c], s * box[:, ROT + 3 + c],
                           s * box[:, ROT + 6 + c]]))
        d.append(off[j] - shift if minus else off[j] + shift)
    return n, d


def k4_model(fa: np.ndarray, fb: np.ndarray, thr: float):
    """K4's per-pair algorithm (``csrc/nms_overlap.cu``), each line the
    kernel's, for P pairs at once: fa, fb (P, 39) float32 ``nms_fields``
    rows, labels equal and j > i assumed. NumPy rounds every float32
    operation once, as the kernel's ``__f*_rn`` do.

    Returns (iou, over, clipped, ops): ``ops`` counts each clipped pair's
    float operations (multiplies, adds, subtracts, divides)."""
    with np.errstate(all='ignore'):
        bound = _tmin(_frame_bound(fa, fb), _frame_bound(fb, fa))
        clipped = bound != 0
        ops = np.full(len(fa), 2 * 119 + 12 * 7 + 3 + 12 + 2 * 6 + 8)
        off_a, off_b = _plane_offsets(fa), _plane_offsets(fb)
        big = _tabs(off_a[0])
        for x in off_a[1:] + off_b:
            big = _tmax(big, _tabs(x))
        scale = big + F32(1)
        n, d = _half_spaces(fb, off_b, scale * KEEP_TOL, False)
        vol_a = _clipped_volume(fa, n, d, ops)
        n, d = _half_spaces(fa, off_a, scale * COPL_TOL, True)
        vol_b = _clipped_volume(fb, n, d, ops)
        vol = _tmin(_tmax(vol_a + vol_b, F32(0)), bound)
        v1 = np.abs((fa[:, SIZE] * fa[:, SIZE + 1]) * fa[:, SIZE + 2])
        v2 = np.abs((fb[:, SIZE] * fb[:, SIZE + 1]) * fb[:, SIZE + 2])
        uni = (v1 + v2) - vol
        iou = vol / np.where(np.isnan(uni) | (uni >= UNION_EPS), uni,
                             UNION_EPS)
        iou = np.where(clipped, iou, F32(0))
        over = np.where(clipped, iou > F32(thr), F32(0) > F32(thr))
    return iou, over, clipped, np.where(clipped, ops, 0)


@pytest.mark.parametrize('idx', range(len(SETS)))
def test_skips_are_exact(idx):
    """Where K4 skips a pair, the torch route's matrix is false already."""
    boxes, labels = _set(idx)
    k = len(boxes)
    iou = _torch_iou(idx)
    same = np.ones((k, k), bool) if labels is None else \
        labels[:, None] == labels[None, :]
    t = torch.from_numpy(boxes)
    bound = I._axis_overlap_bound(t.repeat_interleave(k, 0),
                                  t.repeat(k, 1)).reshape(k, k).numpy()
    for thr in (0.25, 0.5):
        over = np.triu((iou > thr) & same, 1)
        skip = ~np.triu(np.ones((k, k), bool), 1) | ~same | (bound == 0)
        np.testing.assert_array_equal(over, over & ~skip)
        assert over.any()
    # the set exercises each skip, and clips pairs that stay below thr
    upper = np.triu(np.ones((k, k), bool), 1) & same
    assert (upper & (bound == 0)).any() and (upper & (bound > 0)).any()
    assert (upper & (bound > 0) & (iou < 0.25)).any()


def _model_pairs():
    """About 100 pairs (i < j) of the four sets, most of them clipped."""
    out = []
    for idx in range(len(SETS)):
        boxes, labels = _set(idx)
        k = len(boxes)
        rng = np.random.RandomState(idx)
        iou = _torch_iou(idx)
        i, j = np.nonzero(np.triu(np.ones((k, k), bool), 1))
        over_lap = iou[i, j] > 0
        sel = np.concatenate([rng.permutation(np.nonzero(over_lap)[0])[:20],
                              rng.permutation(np.nonzero(~over_lap)[0])[:5]])
        out.append((boxes, i[sel], j[sel], iou[i[sel], j[sel]]))
    return out


def test_model_matches_torch_route():
    n_pairs, n_clipped = 0, 0
    for boxes, i, j, want in _model_pairs():
        fields, _ = I.nms_fields(torch.from_numpy(boxes))
        f = fields.numpy()
        for thr in (0.3, 0.5):
            iou, over, clipped, ops = k4_model(f[i], f[j], thr)
            np.testing.assert_allclose(iou, want, rtol=0, atol=1e-6)
            np.testing.assert_array_equal(over, want > thr)
        assert (clipped >= (want > 0)).all()
        n_pairs += len(i)
        n_clipped += int(clipped.sum())
    assert n_pairs >= 100 and n_clipped >= 80


def _nms_torch_route(boxes, scores, mask, thr, labels):
    """nms3d as it was before K4: boxes3d_iou, the masks, the host sweep."""
    order = torch.argsort(torch.where(mask, -scores, torch.full_like(
        scores, torch.finfo(scores.dtype).max)), stable=True)
    b9 = I.boxes7d_to_9d(boxes[order][:, :7])
    over = I.boxes3d_iou(b9, b9) > thr
    lab = labels[order]
    over = torch.triu(over & (lab[:, None] == lab[None, :]), 1)
    alive = mask[order]
    sup = torch.zeros(len(boxes), dtype=torch.bool)
    for i in range(len(boxes)):
        if alive[i] and not sup[i]:
            sup |= over[i]
    return order, ~sup & alive


def test_cpu_route_loads_no_library(monkeypatch):
    def refuse():
        raise AssertionError('a CPU tensor loaded the kernel library')

    monkeypatch.setattr(kernels, 'library', refuse)
    boxes, labels = _set(2)
    boxes = torch.from_numpy(boxes[:32])
    labels = torch.from_numpy(labels[:32])
    rng = np.random.RandomState(5)
    scores = torch.from_numpy(rng.rand(32).astype(np.float32))
    mask = torch.from_numpy(rng.rand(32) > 0.1)
    launches = I.suppression_matrix.launches
    order, keep = N.nms3d(boxes, scores, mask, 0.1, labels)
    want_order, want_keep = _nms_torch_route(boxes, scores, mask, 0.1, labels)
    np.testing.assert_array_equal(order.numpy(), want_order.numpy())
    np.testing.assert_array_equal(keep.numpy(), want_keep.numpy())
    assert 0 < int(keep.sum()) < int(mask.sum())
    assert I.suppression_matrix.launches == launches
    over = I.suppression_matrix(boxes, 0.1, labels)
    assert over.dtype == torch.bool and over.shape == (32, 32)


def test_wrapper_checks(monkeypatch):
    monkeypatch.setattr(kernels, 'library', lambda: pytest.fail(
        'the checks loaded the kernel library'))
    boxes = torch.from_numpy(box_sets(0, True, 40))
    labels = torch.arange(40)
    fields, lab = I.nms_fields(boxes, labels)
    assert fields.shape == (40, 15) and fields.is_contiguous()
    assert lab.dtype == torch.int32
    np.testing.assert_array_equal(fields[:, 9:].numpy(), boxes[:, :6].numpy())
    with pytest.raises(ValueError):
        I.nms_fields(boxes[:, :7])
    with pytest.raises(TypeError):
        I.nms_fields(boxes.double())
    with pytest.raises(ValueError):
        I.nms_fields(boxes, labels[:-1])
    with pytest.raises(TypeError):
        I.nms_fields(boxes, labels.float())
    with pytest.raises(ValueError, match='CUDA'):
        I._nms_overlap_cuda(fields, lab, 0.5)
