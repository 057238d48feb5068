"""Synthetic multi-view RGB-D scan fixture (port of
``embodiedscan_tpu/data/synthetic.py``: the same arrays from the same seed).

Stands in for the EmbodiedScan dataset in tests and smoke runs (the
reference ships no test fixtures either): a random room with oriented
boxes, cameras on a ring, depth rendered by point-splatting a dense scene
cloud through each camera (z-buffer min-depth per pixel). Exercises the
whole pipeline: depth -> back-projection -> aggregation -> augmentation ->
static-shape packing.
"""

import os
from typing import Dict

import numpy as np

from ..geometry.np_boxes import corners_np, euler_zxy_to_matrix_np
from . import pipeline as pl


def _scene_cloud(rng, n=60000, room=(6.0, 6.0, 3.0)):
    """Points on the floor and two walls plus random furniture boxes."""
    w, d, h = room
    n3 = n // 3
    floor = np.stack([rng.uniform(0, w, n3), rng.uniform(0, d, n3),
                      np.zeros(n3)], -1)
    wall1 = np.stack([rng.uniform(0, w, n3), np.zeros(n3),
                      rng.uniform(0, h, n3)], -1)
    wall2 = np.stack([np.zeros(n - 2 * n3), rng.uniform(0, d, n - 2 * n3),
                      rng.uniform(0, h, n - 2 * n3)], -1)
    return np.concatenate([floor, wall1, wall2]).astype(np.float32)


def _boxes(rng, g, room=(6.0, 6.0, 3.0), num_classes=284):
    centers = np.stack([
        rng.uniform(0.8, room[0] - 0.8, g),
        rng.uniform(0.8, room[1] - 0.8, g),
        rng.uniform(0.4, 1.1, g)
    ], -1)
    sizes = rng.uniform(0.5, 1.4, (g, 3))
    angles = np.stack([
        rng.uniform(-np.pi, np.pi, g),
        rng.uniform(-0.2, 0.2, g),
        rng.uniform(-0.2, 0.2, g)
    ], -1)
    boxes = np.concatenate([centers, sizes, angles], -1).astype(np.float32)
    labels = rng.randint(0, num_classes, g).astype(np.int64)
    return boxes, labels


def _camera_ring(n_views, room=(6.0, 6.0, 3.0)):
    """global2ego (extrinsic) matrices for cameras orbiting the room center."""
    cx, cy = room[0] / 2, room[1] / 2
    exts = []
    for i in range(n_views):
        ang = 2 * np.pi * i / n_views
        eye = np.array([cx + 2.5 * np.cos(ang), cy + 2.5 * np.sin(ang), 1.5])
        fwd = np.array([cx, cy, 0.8]) - eye
        fwd = fwd / np.linalg.norm(fwd)
        up = np.array([0.0, 0, 1.0])
        right = np.cross(fwd, up)
        right /= np.linalg.norm(right)
        down = np.cross(fwd, right)
        # camera frame: x right, y down, z forward
        rot = np.stack([right, down, fwd])  # world->cam rotation rows
        ext = np.eye(4, dtype=np.float32)
        ext[:3, :3] = rot
        ext[:3, 3] = -rot @ eye
        exts.append(ext)
    return exts


def _render_depth(cloud, ext, k, hw):
    """Min-depth point splat through the camera -> (H, W) depth map."""
    h, w = hw
    homo = np.concatenate([cloud, np.ones_like(cloud[:, :1])], -1)
    cam = (homo @ ext.T)[:, :3]
    z = cam[:, 2]
    front = z > 0.05
    cam = cam[front]
    z = z[front]
    uv = cam[:, :2] / z[:, None]
    u = np.round(uv[:, 0] * k[0, 0] + k[0, 2]).astype(np.int64)
    v = np.round(uv[:, 1] * k[1, 1] + k[1, 2]).astype(np.int64)
    ok = (u >= 0) & (u < w) & (v >= 0) & (v < h)
    depth = np.full(h * w, np.inf, np.float32)
    np.minimum.at(depth, v[ok] * w + u[ok], z[ok])
    depth[~np.isfinite(depth)] = 0.0
    return depth.reshape(h, w)


def make_scan(seed: int = 0, n_views: int = 6, hw=(128, 128), g: int = 8,
              num_classes: int = 284) -> Dict:
    """One synthetic scan: views with depth/rgb/poses + GT boxes."""
    rng = np.random.RandomState(seed)
    room = (6.0, 6.0, 3.0)
    cloud = _scene_cloud(rng, room=room)
    boxes, labels = _boxes(rng, g, room, num_classes)
    # sprinkle points on and *inside* the gt boxes so boxes are "visible":
    # FCAF assignment needs strictly-interior locations (min face distance
    # > 0) — boundary-only surface points never produce positives
    corners = corners_np(boxes)
    for bx, c8 in zip(boxes, corners):
        rot = euler_zxy_to_matrix_np(bx[6:9])
        local = rng.uniform(-0.45, 0.45, (450, 3)).astype(np.float32) \
            * bx[3:6]
        interior = (local @ rot.T + bx[:3]).astype(np.float32)
        t = rng.uniform(0, 1, (150, 2)).astype(np.float32)
        # bilinear points on the top face (corners 1, 2, 6, 5 have z1)
        a, b, c, d = c8[1], c8[2], c8[6], c8[5]
        face = (a[None] * (1 - t[:, :1]) * (1 - t[:, 1:]) +
                b[None] * (1 - t[:, :1]) * t[:, 1:] +
                c[None] * t[:, :1] * t[:, 1:] +
                d[None] * t[:, :1] * (1 - t[:, 1:]))
        cloud = np.concatenate([cloud, interior, face.astype(np.float32)])
    h, w = hw
    k = np.array([[0.6 * w, 0, w / 2], [0, 0.6 * w, h / 2], [0, 0, 1]],
                 np.float32)
    exts = _camera_ring(n_views, room)
    views = []
    for ext in exts:
        depth = _render_depth(cloud, ext, k, hw)
        rgb = rng.randint(0, 255, (h, w, 3)).astype(np.uint8)
        views.append(dict(depth=depth, rgb=rgb, extrinsic=ext, intrinsic=k))
    return dict(views=views, gt_boxes=boxes, gt_labels=labels)


def mat_to_quat(rot):
    """3x3 rotation matrix -> (x, y, z, w) unit quaternion, the inverse of
    ``tools/demo.py:quat_to_mat`` (Shepperd's method)."""
    m = np.asarray(rot, np.float64)
    i = int(np.argmax([np.trace(m), m[0, 0], m[1, 1], m[2, 2]]))
    if i == 0:
        s = 2 * np.sqrt(1 + np.trace(m))
        q = [m[2, 1] - m[1, 2], m[0, 2] - m[2, 0], m[1, 0] - m[0, 1],
             s * s / 4]
    elif i == 1:
        s = 2 * np.sqrt(1 + m[0, 0] - m[1, 1] - m[2, 2])
        q = [s * s / 4, m[0, 1] + m[1, 0], m[0, 2] + m[2, 0],
             m[2, 1] - m[1, 2]]
    elif i == 2:
        s = 2 * np.sqrt(1 + m[1, 1] - m[0, 0] - m[2, 2])
        q = [m[0, 1] + m[1, 0], s * s / 4, m[1, 2] + m[2, 1],
             m[0, 2] - m[2, 0]]
    else:
        s = 2 * np.sqrt(1 + m[2, 2] - m[0, 0] - m[1, 1])
        q = [m[0, 2] + m[2, 0], m[1, 2] + m[2, 1], s * s / 4,
             m[1, 0] - m[0, 1]]
    return np.asarray(q) / s


def write_scan_dir(path, scan):
    """Writes a scan of :func:`make_scan` as a scan directory that
    ``tools/demo.py:load_scan_dir`` reads: every second pose line in the
    translation and quaternion form, the others as 4x4 matrices; depth in
    millimetres."""
    from PIL import Image
    os.makedirs(os.path.join(path, 'rgb'), exist_ok=True)
    os.makedirs(os.path.join(path, 'depth'), exist_ok=True)
    np.savetxt(os.path.join(path, 'intrinsic.txt'),
               np.asarray(scan['views'][0]['intrinsic'], np.float64))
    lines = []
    for i, view in enumerate(scan['views']):
        name = f'{i:05d}'
        Image.fromarray(view['rgb']).save(
            os.path.join(path, 'rgb', name + '.jpg'))
        Image.fromarray(np.round(view['depth'] * 1000).astype(
            np.uint16)).save(os.path.join(path, 'depth', name + '.png'))
        cam2global = np.linalg.inv(np.asarray(view['extrinsic'], np.float64))
        if i % 2 == 1:
            vals = np.concatenate([cam2global[:3, 3],
                                   mat_to_quat(cam2global[:3, :3])])
        else:
            vals = cam2global.reshape(-1)
        lines.append(' '.join([name] + [repr(float(v)) for v in vals]))
    with open(os.path.join(path, 'poses.txt'), 'w') as f:
        f.write('\n'.join(lines) + '\n')


def _load_views(scan: Dict, n_views: int, train: bool,
                points_per_view: int, rng):
    ids = pl.select_views(len(scan['views']), n_views, ordered=not train,
                          rng=rng)
    pts_list, exts, ks, imgs = [], [], [], []
    for i in ids:
        view = scan['views'][i]
        pts = pl.rgbd_to_points(view['depth'], view['intrinsic'])
        pts_list.append(pl.point_sample(pts, points_per_view, rng))
        exts.append(view['extrinsic'])
        ks.append(view['intrinsic'])
        imgs.append(pl.normalize_imgs(view['rgb'][None])[0])
    return ids, pts_list, exts, ks, imgs


def scan_to_batch(scan: Dict, n_views: int, num_points: int, num_boxes: int,
                  seed: int = 0, train: bool = True,
                  points_per_view: int = 4096) -> Dict[str, np.ndarray]:
    """Run the full host pipeline on a synthetic scan -> packed sample."""
    rng = np.random.RandomState(seed)
    _, pts_list, exts, ks, imgs = _load_views(scan, n_views, train,
                                              points_per_view, rng)
    points = pl.aggregate_points(pts_list, exts)
    boxes, labels = scan['gt_boxes'], scan['gt_labels']
    aug = None
    if train:
        points, boxes, fmat = pl.random_flip(points, boxes, rng)
        points, boxes, rmat = pl.global_rot_scale_trans(points, boxes, rng)
        aug = rmat @ fmat
    return pl.pack_sample(points, np.stack(imgs), ks, exts, boxes, labels,
                          aug, num_points, num_boxes, rng)


def box_visibility(scan: Dict, view_ids, hw) -> list:
    """Per selected view: gt rows whose box center projects into the view.

    Synthetic stand-in for the dataset's per-image ``visible_instance_ids``
    (embodiedscan_dataset.py:189-195).
    """
    h, w = hw
    centers = scan['gt_boxes'][:, :3]
    homo = np.concatenate([centers, np.ones_like(centers[:, :1])], -1)
    out = []
    for i in view_ids:
        view = scan['views'][i]
        k, ext = view['intrinsic'], view['extrinsic']
        cam = (homo @ ext.T)[:, :3]
        z = np.maximum(cam[:, 2], 1e-6)
        u = cam[:, 0] / z * k[0, 0] + k[0, 2]
        v = cam[:, 1] / z * k[1, 1] + k[1, 2]
        vis = (cam[:, 2] > 0.05) & (u >= 0) & (u < w) & (v >= 0) & (v < h)
        out.append(np.where(vis)[0].astype(np.int64))
    return out


def scan_to_sweeps(scan: Dict, n_views: int, num_points: int, num_boxes: int,
                   seed: int = 0, train: bool = True,
                   points_per_view: int = 4096,
                   occ_shape=None) -> Dict[str, np.ndarray]:
    """Continuous-task pseudo-batch from a synthetic scan (1..V sweeps)."""
    rng = np.random.RandomState(seed)
    ids, pts_list, exts, ks, imgs = _load_views(scan, n_views, train,
                                                points_per_view, rng)
    view_pts = pl.aggregate_points_list(pts_list, exts)
    boxes, labels = scan['gt_boxes'], scan['gt_labels']
    aug = None
    if train:
        sizes = np.cumsum([len(p) for p in view_pts])[:-1]
        points = np.concatenate(view_pts)
        points, boxes, fmat = pl.random_flip(points, boxes, rng)
        points, boxes, rmat = pl.global_rot_scale_trans(points, boxes, rng)
        aug = rmat @ fmat
        view_pts = np.split(points, sizes)
    hw = scan['views'][0]['depth'].shape
    vis_ids = box_visibility(scan, ids, hw)
    occ_visible = None
    if occ_shape is not None:
        occ_visible = [rng.rand(*occ_shape) > 0.5 for _ in ids]
    return pl.pack_sweeps(view_pts, vis_ids, np.stack(imgs), ks, exts, boxes,
                          labels, aug, num_points, num_boxes, rng,
                          occ_visible=occ_visible)
