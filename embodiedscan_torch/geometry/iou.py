"""Exact oriented 3D box overlap / IoU (port of
``embodiedscan_tpu/geometry/iou.py``).

Each box's 6 face quads are clipped against the other box's 6 half-spaces
(Sutherland-Hodgman with fixed-size vertex buffers, structure-of-arrays:
the pair axis is the last one), and the enclosed volume follows from the
divergence theorem as a signed sum of origin tetrahedra. The compaction
after each clip is a scatter into unique slots plus a spare dump slot,
which gives the same values as the reference's one-hot select, and the
same gradients: each emitted vertex takes the gradient of its slot.

Where the paired IoU is differentiated (the rotated-IoU loss), ties are
spelled as JAX differentiates them: ``torch.maximum`` and
``torch.minimum`` split a gradient equally between tied sides, as
``jnp.maximum``, ``jnp.minimum`` and ``jnp.clip`` do (``torch.clamp``
passes it whole to its input), and :func:`_abs` has JAX's gradient +1 at
0 (``torch.abs`` gives 0 there). A disjoint pair's volume is 0 on both
sides of ``min(volume, bound)``, and a touching pair's overlap length is 0
at the clip, so these ties are reached.
"""

import functools

import numpy as np
import torch

from ..ops import kernels
from .boxes import corners as box_corners
from .rotations import euler_zxy_to_matrix

# Outward-wound face quads for the reference corner ordering.
_FACE_IDX = np.array([
    [0, 1, 2, 3],  # x- face
    [4, 7, 6, 5],  # x+
    [0, 4, 5, 1],  # y-
    [3, 2, 6, 7],  # y+
    [0, 3, 7, 4],  # z-
    [1, 5, 6, 2],  # z+
], dtype=np.int64)

_MAX_VERTS = 10  # 4-gon + 6 convex clips

# pairs per chunk of boxes3d_overlap: bounds the (10, 12 * pairs) buffers
_PAIR_CHUNK = 1 << 18


def _abs(x: torch.Tensor) -> torch.Tensor:
    """|x| with JAX's gradient: +1 at 0 (``torch.abs`` gives 0 there)."""
    return torch.where(x >= 0, x, -x)


def _at_least(x: torch.Tensor, lo: float) -> torch.Tensor:
    """max(x, lo), a tie's gradient split as ``jnp.clip``'s."""
    return torch.maximum(x, x.new_tensor(lo))


def _clip_soa_body(vx, vy, vz, cnt, nx, ny, nz, d):
    """One half-space clip ``n . p <= d`` on (K, L) slot-row arrays; the
    first ``cnt`` (L,) slots of each lane are its polygon."""
    k = vx.shape[0]
    idx = torch.arange(k, device=vx.device)[:, None]
    ds = vx * nx + vy * ny + vz * nz - d
    wrap = idx + 1 < cnt
    d_n = torch.where(wrap, torch.roll(ds, -1, 0), ds[0:1])
    x_n = torch.where(wrap, torch.roll(vx, -1, 0), vx[0:1])
    y_n = torch.where(wrap, torch.roll(vy, -1, 0), vy[0:1])
    z_n = torch.where(wrap, torch.roll(vz, -1, 0), vz[0:1])
    cur_in = ds <= 0.0
    nxt_in = d_n <= 0.0
    denom = ds - d_n
    t = ds / torch.where(denom.abs() > 1e-12, denom,
                         torch.full_like(denom, 1e-12))
    ivx = vx + t * (x_n - vx)
    ivy = vy + t * (y_n - vy)
    ivz = vz + t * (z_n - vz)
    active = idx < cnt
    e_c = cur_in & active
    e_i = (cur_in != nxt_in) & active
    n_emit = e_c.to(torch.int64) + e_i.to(torch.int64)
    run = torch.cumsum(n_emit, 0)
    pc = run - n_emit
    pi = pc + e_c.to(torch.int64)
    dump = torch.full_like(pc, k)
    tc = torch.where(e_c, pc, dump)
    ti = torch.where(e_i, pi, dump)
    outs = []
    for v, iv in ((vx, ivx), (vy, ivy), (vz, ivz)):
        o = v.new_zeros((k + 1,) + v.shape[1:])
        o.scatter_(0, tc, v)
        o.scatter_(0, ti, iv)
        outs.append(o[:k])
    return outs[0], outs[1], outs[2], torch.clamp(run[-1], max=k)


def _soa_planes(boxes: torch.Tensor):
    """(B, 9) -> 6 x (nx, ny, nz) normals and 6 offsets, each (B,)."""
    rot = euler_zxy_to_matrix(boxes[:, 6:9])
    cx, cy, cz = boxes[:, 0], boxes[:, 1], boxes[:, 2]
    normals, offsets = [], []
    for j in range(6):
        s = 1.0 if j < 3 else -1.0
        nx, ny, nz = (s * rot[:, 0, j % 3], s * rot[:, 1, j % 3],
                      s * rot[:, 2, j % 3])
        half = boxes[:, 3 + j % 3] / 2
        normals.append((nx, ny, nz))
        offsets.append(nx * cx + ny * cy + nz * cz + half)
    return normals, offsets


def _clipped_volume_soa(corners_t: torch.Tensor, planes) -> torch.Tensor:
    """Signed volume of each box's 6 faces clipped by 6 half-spaces.

    Args:
        corners_t: (8, 3, B) corners of the face-owning boxes.
        planes: (pnx, pny, pnz, pd) each (6, B), per-lane clipping planes.
    """
    b = corners_t.shape[-1]
    face = corners_t[torch.as_tensor(_FACE_IDX, device=corners_t.device)]
    init = []
    for c in range(3):
        v = face[:, :, c, :].permute(1, 0, 2).reshape(4, 6 * b)
        init.append(torch.cat([v, v.new_zeros(_MAX_VERTS - 4, 6 * b)], 0))
    vx, vy, vz = init
    cnt = torch.full((6 * b,), 4, dtype=torch.int64, device=vx.device)
    tiled = [p[:, None, :].expand(6, 6, b).reshape(6, 6 * b) for p in planes]
    for j in range(6):
        vx, vy, vz, cnt = _clip_soa_body(vx, vy, vz, cnt, tiled[0][j],
                                         tiled[1][j], tiled[2][j],
                                         tiled[3][j])
    acc = torch.zeros_like(vx[0])
    for i in range(1, _MAX_VERTS - 1):
        cxp = vy[i] * vz[i + 1] - vz[i] * vy[i + 1]
        cyp = vz[i] * vx[i + 1] - vx[i] * vz[i + 1]
        czp = vx[i] * vy[i + 1] - vy[i] * vx[i + 1]
        det = cxp * vx[0] + cyp * vy[0] + czp * vz[0]
        acc = acc + torch.where(i + 1 < cnt, det, torch.zeros_like(det))
    return acc.reshape(6, b).sum(0) / 6.0


def _axis_overlap_bound(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """SAT upper bound on pair intersection volume: (B, 9) x 2 -> (B,)."""
    ra = euler_zxy_to_matrix(a[:, 6:9])
    rb = euler_zxy_to_matrix(b[:, 6:9])
    ca, cb = a[:, :3], b[:, :3]
    ha, hb = a[:, 3:6] / 2, b[:, 3:6] / 2

    def frame_bound(axes, c_own, h_own, r_other, c_other, h_other):
        p_own = torch.sum(c_own[:, :, None] * axes, dim=1)
        p_oth = torch.sum(c_other[:, :, None] * axes, dim=1)
        dots = _abs(torch.sum(axes[:, :, :, None] * r_other[:, :, None, :],
                              dim=1))
        w_oth = torch.sum(dots * h_other[:, None, :], dim=-1)
        hi = torch.minimum(p_own + h_own, p_oth + w_oth)
        lo = torch.maximum(p_own - h_own, p_oth - w_oth)
        return torch.prod(_at_least(hi - lo, 0.0), dim=-1)

    return torch.minimum(frame_bound(ra, ca, ha, rb, cb, hb),
                         frame_bound(rb, cb, hb, ra, ca, ha))


def _intersection_volume_flat(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact intersection volume of aligned box pairs: (B, 9) x 2 -> (B,)."""
    nb_ = a.shape[0]
    ca = box_corners(a).permute(1, 2, 0)  # (8, 3, B)
    cb = box_corners(b).permute(1, 2, 0)
    na, da = _soa_planes(a)
    nb, db = _soa_planes(b)
    # scale-aware tolerances: keep a's faces that graze b's boundary, shrink
    # a's half-spaces for b's faces so coplanar faces count exactly once
    scale = 1.0 + functools.reduce(torch.maximum, [_abs(x) for x in da + db])
    eps_keep = 1e-5 * scale
    eps_copl = 3e-5 * scale
    corners = torch.cat([ca, cb], -1)
    planes = (
        torch.stack([torch.cat([nb[j][0], na[j][0]]) for j in range(6)]),
        torch.stack([torch.cat([nb[j][1], na[j][1]]) for j in range(6)]),
        torch.stack([torch.cat([nb[j][2], na[j][2]]) for j in range(6)]),
        torch.stack([torch.cat([db[j] + eps_keep, da[j] - eps_copl])
                     for j in range(6)]),
    )
    vol2 = _clipped_volume_soa(corners, planes)
    vol = _at_least(vol2[:nb_] + vol2[nb_:], 0.0)
    return torch.minimum(vol, _axis_overlap_bound(a, b))


def boxes3d_overlap(boxes1: torch.Tensor, boxes2: torch.Tensor):
    """Pairwise exact intersection volume and IoU of oriented 9-DoF boxes:
    (N, 9) x (M, 9) -> (vol (N, M), iou (N, M))."""
    n, m = boxes1.shape[0], boxes2.shape[0]
    rows = max(1, _PAIR_CHUNK // max(m, 1))
    vols = []
    for s in range(0, n, rows):
        blk = boxes1[s:s + rows]
        a = blk.repeat_interleave(m, dim=0)
        b = boxes2.repeat(blk.shape[0], 1)
        vols.append(_intersection_volume_flat(a, b).reshape(blk.shape[0], m))
    vol = torch.cat(vols) if vols else boxes1.new_zeros(0, m)
    v1 = torch.abs(boxes1[:, 3] * boxes1[:, 4] * boxes1[:, 5])
    v2 = torch.abs(boxes2[:, 3] * boxes2[:, 4] * boxes2[:, 5])
    union = v1[:, None] + v2[None, :] - vol
    iou = vol / torch.clamp(union, min=1e-8)
    return vol, iou


def paired_iou_pruned(boxes1: torch.Tensor, boxes2: torch.Tensor,
                      capacity: int) -> torch.Tensor:
    """Exact IoU of aligned box pairs with SAT pruning: (P, 9) x 2 -> (P,).

    Of the pairs a match cost needs, most do not overlap at all.
    :func:`_axis_overlap_bound` bounds each pair's intersection volume from
    above, so a pair whose bound is 0 has IoU 0 exactly: only the
    ``capacity`` pairs with the largest bounds (a stable descending sort,
    ties by index) are clipped, the rest take 0. Exact unless more than
    ``capacity`` pairs overlap; then the smallest-bound ones are dropped.
    For costs without gradient (matching).
    """
    p = boxes1.shape[0]
    v1 = torch.abs(boxes1[:, 3] * boxes1[:, 4] * boxes1[:, 5])
    v2 = torch.abs(boxes2[:, 3] * boxes2[:, 4] * boxes2[:, 5])
    if capacity >= p:
        vol = _intersection_volume_flat(boxes1, boxes2)
    else:
        bound = _axis_overlap_bound(boxes1, boxes2)
        sel = torch.sort(-bound, stable=True)[1][:capacity]
        vol = boxes1.new_zeros(p).index_put_(
            (sel,), _intersection_volume_flat(boxes1[sel], boxes2[sel]))
    return vol / torch.clamp(v1 + v2 - vol, min=1e-8)


def boxes3d_overlap_paired(boxes1: torch.Tensor, boxes2: torch.Tensor):
    """Exact overlap of aligned pairs, differentiable by autograd:
    (N, 9) x (N, 9) -> (vol (N,), iou (N,))."""
    vol = _intersection_volume_flat(boxes1, boxes2)
    v1 = _abs(boxes1[:, 3] * boxes1[:, 4] * boxes1[:, 5])
    v2 = _abs(boxes2[:, 3] * boxes2[:, 4] * boxes2[:, 5])
    return vol, vol / _at_least(v1 + v2 - vol, 1e-8)


def boxes3d_iou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Pairwise exact IoU of oriented 9-DoF boxes: (N, 9) x (M, 9) -> (N, M)."""
    return boxes3d_overlap(boxes1, boxes2)[1]


def _suppression_matrix_plain(boxes: torch.Tensor, iou_thr: float,
                              labels: torch.Tensor | None = None):
    """:func:`suppression_matrix` as tensor code over all K x K pairs (the
    route of CPU tensors; on any device, the card check's yardstick)."""
    over = boxes3d_iou(boxes, boxes) > iou_thr
    if labels is not None:
        over = over & (labels[:, None] == labels[None, :])
    return torch.triu(over, diagonal=1)


def nms_fields(boxes: torch.Tensor, labels: torch.Tensor | None = None):
    """K4's inputs, checked: (K, 15) float32 per-box fields (the rotation
    matrix row-major, center, sizes: ``csrc/nms_overlap.cu``'s ``F_*``)
    and the labels as int32 (or None).

    The rotation matrix is the torch route's own
    (:func:`euler_zxy_to_matrix`: its sines and cosines); the kernel
    derives the rest per pair in the torch route's order of operations.
    """
    if boxes.dim() != 2 or boxes.shape[1] != 9:
        raise ValueError(f'nms_fields takes (K, 9) boxes, got '
                         f'{tuple(boxes.shape)}')
    if boxes.dtype != torch.float32:
        raise TypeError(f'nms_fields takes float32 boxes, got {boxes.dtype}')
    k = boxes.shape[0]
    if labels is not None:
        if labels.shape != (k,):
            raise ValueError(f'nms_fields takes ({k},) labels, got '
                             f'{tuple(labels.shape)}')
        if labels.dtype.is_floating_point or labels.dtype.is_complex or \
                labels.dtype == torch.bool:
            raise TypeError(f'nms_fields takes integer labels, got '
                            f'{labels.dtype}')
        if labels.device != boxes.device:
            raise ValueError('boxes and labels lie on different devices')
        labels = labels.to(torch.int32).contiguous()
    fields = torch.cat([euler_zxy_to_matrix(boxes[:, 6:9]).reshape(k, 9),
                        boxes[:, :6]], 1)
    return fields, labels


def _nms_overlap_cuda(fields: torch.Tensor, labels: torch.Tensor | None,
                      iou_thr: float) -> torch.Tensor:
    """Launches K4 over :func:`nms_fields`' output on the current stream."""
    k = fields.shape[0]
    if not fields.is_cuda:
        raise ValueError(f'K4 takes CUDA tensors, got {fields.device}')
    if fields.shape != (k, 15) or fields.dtype != torch.float32 or \
            not fields.is_contiguous():
        raise ValueError('K4 takes contiguous (K, 15) float32 fields')
    if labels is not None and (labels.shape != (k,) or
                               labels.dtype != torch.int32 or
                               not labels.is_contiguous() or
                               labels.device != fields.device):
        raise ValueError('K4 takes contiguous (K,) int32 labels on the '
                         "fields' device")
    over = torch.empty((k, k), dtype=torch.bool, device=fields.device)
    if k == 0:
        return over
    dev = fields.device
    counts = suppression_matrix.pair_counts.get(dev.index)
    if counts is None:
        counts = torch.zeros(2, dtype=torch.int64, device=dev)
        suppression_matrix.pair_counts[dev.index] = counts
    err = kernels.library().es_nms_overlap(
        fields.data_ptr(), None if labels is None else labels.data_ptr(), k,
        float(iou_thr), over.data_ptr(), counts.data_ptr(),
        kernels.stream_handle(dev))
    kernels.check(err, 'es_nms_overlap')
    suppression_matrix.launches += 1
    return over


def suppression_matrix(boxes: torch.Tensor, iou_thr: float,
                       labels: torch.Tensor | None = None) -> torch.Tensor:
    """The rotated NMS's (K, K) bool matrix: ``over[i, j]`` for j > i, the
    same label (when ``labels`` are given) and IoU above ``iou_thr``, of
    (K, 9) boxes.

    On a CUDA tensor one launch of K4 (``csrc/nms_overlap.cu``) over
    :func:`nms_fields`, which computes each pair's IoU in the tensor
    code's order of operations on the card; on a CPU tensor
    :func:`_suppression_matrix_plain`, the tensor code.
    """
    if boxes.is_cuda:
        return _nms_overlap_cuda(*nms_fields(boxes, labels), iou_thr)
    return _suppression_matrix_plain(boxes, iou_thr, labels)


suppression_matrix.launches = 0  # K4 launches (CUDA path only)
# device index -> int64 (2,) on that device: the pairs K4 clipped and the
# pairs it was given (j > i), added up by the kernel; read them off the
# hot path (reading waits for the device)
suppression_matrix.pair_counts = {}


def boxes7d_to_9d(boxes: torch.Tensor) -> torch.Tensor:
    """Pad (..., 7) yaw boxes (or (..., 6) axis-aligned) to 9-DoF rows."""
    n_extra = 9 - boxes.shape[-1]
    if n_extra == 0:
        return boxes
    return torch.cat([boxes, boxes.new_zeros(boxes.shape[:-1] + (n_extra,))],
                     dim=-1)


def axis_aligned_iou3d(boxes1: torch.Tensor,
                       boxes2: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU of axis-aligned (N, 6) and (M, 6) boxes given as
    x1y1z1x2y2z2."""
    lt = torch.maximum(boxes1[:, None, :3], boxes2[None, :, :3])
    rb = torch.minimum(boxes1[:, None, 3:], boxes2[None, :, 3:])
    whd = torch.clamp(rb - lt, min=0.0)
    inter = whd[..., 0] * whd[..., 1] * whd[..., 2]
    v1 = torch.prod(boxes1[:, 3:] - boxes1[:, :3], dim=-1)
    v2 = torch.prod(boxes2[:, 3:] - boxes2[:, :3], dim=-1)
    return inter / torch.clamp(v1[:, None] + v2[None, :] - inter, min=1e-8)
