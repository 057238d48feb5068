"""Host-side data pipeline: multi-view RGB-D -> static-shape batches (port
of ``embodiedscan_tpu/data/pipeline.py``; numpy only, bit for bit the
reference package's arrays for the same ``np.random.RandomState`` streams).

Numpy re-implementation of the reference transform pipeline
(``embodiedscan/datasets/transforms/``): view selection (multiview.py:34-109),
depth back-projection (points.py:30-81), per-view sampling, ego->global
aggregation (multiview.py:139-169), flip/rot/scale/trans augmentation
(augmentation.py:11,253), and packing (formatting.py:48). Every output is
padded to a static shape (fixed V views, P points, G boxes, masks for
validity), and the whole 3D augmentation is also returned as one 4x4
matrix whose inverse feeds the projection-based fusion (all reference aug
ops are linear).
"""

from typing import Dict, List, Optional, Sequence

import numpy as np

from ..geometry.np_boxes import flip_boxes_np, rotate_z_boxes_np

# data_preprocessor normalization (configs/detection/mv-det3d...py:19-22)
IMG_MEAN = np.array([123.675, 116.28, 103.53], np.float32)
IMG_STD = np.array([58.395, 57.12, 57.375], np.float32)


def select_views(n_total: int, n_images: int, ordered: bool,
                 rng: np.random.RandomState) -> np.ndarray:
    """Frame selection (reference multiview.py:47-64)."""
    ids = np.arange(n_total)
    replace = n_images > n_total
    if ordered:
        if n_images == 1:
            return ids[:1]
        step = (n_total - 1) // (n_images - 1)
        if step > 0:
            ids = ids[::step][:n_images]
            return ids
        return rng.choice(ids, n_images, replace=replace)
    return rng.choice(ids, n_images, replace=replace)


def rgbd_to_points(depth_img: np.ndarray,
                   depth_cam2img: np.ndarray) -> np.ndarray:
    """Depth map -> (N, 3) camera-frame points (reference points.py:30-57)."""
    h, w = depth_img.shape
    us, vs = np.meshgrid(np.arange(w), np.arange(h))
    grid = np.stack([us.astype(np.float32), vs.astype(np.float32), depth_img],
                    -1).reshape(-1, 3)
    nonzero = depth_img.reshape(-1) > 0
    grid = grid[nonzero]
    pad = np.eye(4, dtype=np.float32)
    k = np.asarray(depth_cam2img, np.float32)
    pad[:k.shape[0], :k.shape[1]] = k
    inv = np.linalg.inv(pad)
    xys = grid[:, :2] * grid[:, 2:3]
    homo = np.concatenate(
        [xys, grid[:, 2:3], np.ones_like(grid[:, :1])], -1)
    return (homo @ inv.T)[:, :3]


def point_sample(points: np.ndarray, num: int,
                 rng: np.random.RandomState) -> np.ndarray:
    """Random subsample to ``num`` points (replace if fewer available)."""
    n = len(points)
    if n == 0:
        return np.zeros((0, points.shape[1]), points.dtype)
    idx = rng.choice(n, num, replace=num > n)
    return points[idx]


def aggregate_points_list(points_list: List[np.ndarray],
                          extrinsics: List[np.ndarray]) -> List[np.ndarray]:
    """Per-view ego points -> per-view global-frame arrays
    (reference multiview.py:139-169). extrinsic is global2ego;
    global = solve(extrinsic, p). Keeping the per-view split preserves the
    reference's ``points_slice_indices`` for sweep construction."""
    out = []
    for pts, ext in zip(points_list, extrinsics):
        homo = np.concatenate([pts[:, :3], np.ones_like(pts[:, :1])], -1)
        glob = np.linalg.solve(ext.astype(np.float64), homo.T).T
        out.append(glob[:, :3].astype(np.float32))
    return out


def aggregate_points(points_list: List[np.ndarray],
                     extrinsics: List[np.ndarray]) -> np.ndarray:
    """Concatenated variant of :func:`aggregate_points_list`."""
    return np.concatenate(aggregate_points_list(points_list, extrinsics),
                          axis=0)


def multiview_world_points(depths: np.ndarray, depth_intrinsics,
                           extrinsics, points_per_view: int,
                           rng: np.random.RandomState,
                           native: str = 'auto') -> List[np.ndarray]:
    """Per-view depth -> sampled world-frame point lists (fused hot path).

    Semantically ``rgbd_to_points`` + ``point_sample`` +
    ``aggregate_points_list`` per view. With ``native != 'numpy'`` and the
    compiled core available (``embodiedscan_torch.native``), the
    back-projection/transform runs threaded C++ with deterministic
    splitmix64 sampling (seeded from ``rng``); the numpy path keeps
    RandomState sampling. Both are uniform samples of the same point set —
    the row streams differ between backends.
    """
    v = len(depths)
    same_hw = len({d.shape for d in depths}) == 1
    if native != 'numpy' and same_hw:
        from .. import native as nat
        if nat.available():
            pts, counts = nat.multiview_backproject(
                np.stack(depths), np.stack(depth_intrinsics),
                np.stack(extrinsics))
            seeds = rng.randint(0, 2**31 - 1, size=v)
            out = []
            for i in range(v):
                n = int(counts[i])
                if n == 0:
                    out.append(np.zeros((0, 3), np.float32))
                    continue
                idx = nat.sample_indices(n, points_per_view, int(seeds[i]))
                out.append(nat.gather_rows3(pts[i], idx))
            return out
    per_view = [
        point_sample(rgbd_to_points(depths[i], depth_intrinsics[i]),
                     points_per_view, rng) for i in range(v)
    ]
    return aggregate_points_list(per_view, list(extrinsics))


def random_flip(points: np.ndarray, boxes: np.ndarray,
                rng: np.random.RandomState, ratio_h: float = 0.5,
                ratio_v: float = 0.5):
    """BEV flips (augmentation.py:11-250); returns the 4x4 aug matrix."""
    mat = np.eye(4, dtype=np.float32)
    if rng.rand() < ratio_h:
        points = points.copy()
        points[:, 0] = -points[:, 0]
        boxes = flip_boxes_np(boxes, 'X')
        mat[0, 0] = -1
    if rng.rand() < ratio_v:
        points = points.copy()
        points[:, 1] = -points[:, 1]
        boxes = flip_boxes_np(boxes, 'Y')
        mat = np.diag([1, -1, 1, 1]).astype(np.float32) @ mat
    return points, boxes, mat


def global_rot_scale_trans(points: np.ndarray, boxes: np.ndarray,
                           rng: np.random.RandomState,
                           rot_range=(-0.087266, 0.087266),
                           scale_range=(0.9, 1.1),
                           translation_std=(0.1, 0.1, 0.1)):
    """R -> S -> T augmentation (augmentation.py:322-447) + its 4x4 matrix.

    The reference negates the sampled angle (augmentation.py:383 "-1 is to
    align with v0.17") and rotates points by ``p @ R.T``.
    """
    angle = -rng.uniform(rot_range[0], rot_range[1])
    c, s = np.cos(angle), np.sin(angle)
    rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    points = points.copy()
    points[:, :3] = points[:, :3] @ rot.T
    boxes = rotate_z_boxes_np(boxes, angle)

    scale = rng.uniform(scale_range[0], scale_range[1])
    points[:, :3] *= scale
    boxes = boxes.copy()
    boxes[:, :6] *= scale

    trans = rng.normal(scale=np.asarray(translation_std), size=3).astype(
        np.float32)
    points[:, :3] += trans
    boxes[:, :3] += trans

    mat = np.eye(4, dtype=np.float32)
    mat[:3, :3] = scale * rot
    mat[:3, 3] = trans
    return points, boxes, mat


def normalize_imgs(imgs: np.ndarray, bgr_to_rgb: bool = False) -> np.ndarray:
    """(V, H, W, 3) uint8/float -> normalized float32 (data_preprocessor)."""
    imgs = imgs.astype(np.float32)
    if bgr_to_rgb:
        imgs = imgs[..., ::-1]
    return (imgs - IMG_MEAN) / IMG_STD


def pack_sample(points: np.ndarray,
                imgs: np.ndarray,
                intrinsics: List[np.ndarray],
                extrinsics: List[np.ndarray],
                gt_boxes: np.ndarray,
                gt_labels: np.ndarray,
                aug_mat: Optional[np.ndarray],
                num_points: int,
                num_boxes: int,
                rng: np.random.RandomState) -> Dict[str, np.ndarray]:
    """Pad everything to static shapes and compose projection matrices."""
    pts = point_sample(points, num_points, rng)
    p = len(pts)
    pts_pad = np.zeros((num_points, 3), np.float32)
    pts_pad[:p] = pts[:, :3]
    pmask = np.zeros(num_points, bool)
    pmask[:p] = True

    proj = []
    for k, ext in zip(intrinsics, extrinsics):
        pad = np.eye(4, dtype=np.float32)
        k = np.asarray(k, np.float32)
        pad[:k.shape[0], :k.shape[1]] = k
        proj.append(pad @ np.asarray(ext, np.float32))
    proj = np.stack(proj)

    g = min(len(gt_boxes), num_boxes)
    boxes_pad = np.zeros((num_boxes, 9), np.float32)
    labels_pad = np.zeros(num_boxes, np.int32)
    gmask = np.zeros(num_boxes, bool)
    boxes_pad[:g] = gt_boxes[:g]
    labels_pad[:g] = gt_labels[:g]
    gmask[:g] = True

    aug = np.eye(4, dtype=np.float32) if aug_mat is None else aug_mat
    return dict(
        points=pts_pad,
        points_mask=pmask,
        imgs=imgs.astype(np.float32),
        proj=proj,
        aug_inv=np.linalg.inv(aug).astype(np.float32),
        view_mask=np.ones(len(proj), bool),
        gt_boxes=boxes_pad,
        gt_labels=labels_pad,
        gt_mask=gmask,
    )


def collate(samples: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    """Stack a list of packed samples into a batch."""
    return {
        k: np.stack([s[k] for s in samples])
        for k in samples[0]
    }


def points_range_filter(points: np.ndarray,
                        pc_range: Sequence[float]) -> np.ndarray:
    """Filter points to the cuboid range (reference points.py:226-277).

    Callers apply the reference's keep-original fallback when fewer than
    100 points survive in total.
    """
    r = np.asarray(pc_range, np.float32)
    m = np.all((points[:, :3] > r[:3]) & (points[:, :3] < r[3:6]), axis=1)
    return points[m]


def pack_sweeps(view_points: List[np.ndarray],
                view_visible_ids: Optional[List[np.ndarray]],
                imgs: np.ndarray,
                intrinsics: List[np.ndarray],
                extrinsics: List[np.ndarray],
                gt_boxes: np.ndarray,
                gt_labels: np.ndarray,
                aug_mat: Optional[np.ndarray],
                num_points: int,
                num_boxes: int,
                rng: np.random.RandomState,
                occ_visible: Optional[List[np.ndarray]] = None,
                ) -> Dict[str, np.ndarray]:
    """Build the continuous-task pseudo-batch: 1..V cumulative sweeps.

    Static-shape version of ``ConstructMultiSweeps`` (multiview.py:173-248) +
    the batchwise expansion (data_preprocessor.py:176-208) + the image
    feature-slice reuse of ``embodied_det3d.py:109-160``: instead of a
    ragged pseudo-batch with image slicing ``[:idx + 1]``, every sweep is a
    static-shape batch row whose ``view_mask`` hides future frames, while
    the images/projections are stored ONCE per scan (leading dim 1) — the
    trunk detects the ``sweeps-per-scan = B_points / B_imgs`` ratio and runs
    the 2D backbone once, exactly like the reference's slice reuse.

    Per-sweep GT visibility follows the reference's cumulative
    visible-instance union: sweep i keeps instances seen by views 0..i
    (multiview.py:193-223); with no visibility info all GT stays visible.

    Args:
        view_points: per selected view, (Ni, 3) global-frame (augmented)
            points in view order.
        view_visible_ids: per selected view, int arrays of visible gt rows.
        occ_visible: per selected view, dense (X, Y, Z) bool visibility
            (occupancy task); sweeps get the cumulative logical-or
            (multiview.py:206-228).

    Returns:
        dict with sweep-axis keys (V, ...) — points/points_mask/view_mask/
        gt_*/[visible_mask] — and scan-axis keys (1, ...) — imgs/proj/
        aug_inv.
    """
    v = len(view_points)
    base = pack_sample(np.zeros((0, 3), np.float32), imgs, intrinsics,
                       extrinsics, gt_boxes, gt_labels, aug_mat, 1,
                       num_boxes, rng)
    g_valid = base['gt_mask']

    pts_rows, pmask_rows, vmask_rows, gmask_rows, vis_rows = [], [], [], [], []
    visible = np.zeros(num_boxes, bool) if view_visible_ids is not None \
        else None
    occ_cum = None
    for idx in range(v):
        cum = np.concatenate(view_points[:idx + 1])
        if len(cum) > num_points:
            cum = point_sample(cum, num_points, rng)
        row = np.zeros((num_points, 3), np.float32)
        row[:len(cum)] = cum[:, :3]
        pm = np.zeros(num_points, bool)
        pm[:len(cum)] = True
        pts_rows.append(row)
        pmask_rows.append(pm)
        vm = np.zeros(v, bool)
        vm[:idx + 1] = True
        vmask_rows.append(vm)
        if visible is not None:
            ids = np.asarray(view_visible_ids[idx], np.int64)
            ids = ids[(ids >= 0) & (ids < num_boxes)]
            visible[ids] = True
            gmask_rows.append(g_valid & visible)
        else:
            gmask_rows.append(g_valid.copy())
        if occ_visible is not None:
            occ_cum = occ_visible[idx].astype(bool) if occ_cum is None \
                else (occ_cum | occ_visible[idx].astype(bool))
            vis_rows.append(occ_cum.copy())

    out = dict(
        points=np.stack(pts_rows),
        points_mask=np.stack(pmask_rows),
        imgs=base['imgs'][None],
        proj=base['proj'][None],
        aug_inv=base['aug_inv'][None],
        view_mask=np.stack(vmask_rows),
        gt_boxes=np.tile(base['gt_boxes'][None], (v, 1, 1)),
        gt_labels=np.tile(base['gt_labels'][None], (v, 1)),
        gt_mask=np.stack(gmask_rows),
    )
    if occ_visible is not None:
        out['visible_mask'] = np.stack(vis_rows)
    return out


def collate_sweeps(scans: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    """Concatenate sweep pseudo-batches of several scans.

    Sweep-axis keys become (B*V, ...) in scan-major order; scan-axis keys
    (imgs/proj/aug_inv) become (B, ...) — the layout the trunk's grouped
    fusion expects.
    """
    return {
        k: np.concatenate([s[k] for s in scans], axis=0)
        for k in scans[0]
    }
