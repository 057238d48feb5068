"""In-the-wild detection demo (the reference package's ``demo/demo.py``: its
flags and scan layout; ``--device`` in place of its ``--platform``).

Runs the mv_det3d detector on one raw scan directory laid out as:

    <dir>/poses.txt      per line: name tx ty tz qx qy qz qw, or name and
                         the 16 values of a 4x4 camera-to-world matrix
    <dir>/intrinsic.txt  4x4 or 3x3 camera intrinsic
    <dir>/rgb/<name>.jpg  <dir>/depth/<name>.png  (depth in millimetres)

Usage:
    python -m embodiedscan_torch.tools.demo --dir D --work-dir W \\
        [--device cuda|cpu] [--out out.ply] [--n-views N] [a.b=c ...]

Restores the latest checkpoint of the work dir (the seeded initial weights
when there is none), keeps the detections above the score threshold after
class-wise NMS, and writes the scene's points and the kept boxes to a PLY.
"""

import argparse
import os
import time

import numpy as np
import torch


def quat_to_mat(q):
    """(x, y, z, w) unit quaternion -> 3x3 rotation matrix."""
    x, y, z, w = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ])


def load_scan_dir(path, n_views, image_hw, depth_shift=1000.0):
    """The first ``n_views`` views of a scan directory: per view the RGB
    image resized to ``image_hw`` (uint8), the depth in metres, the
    intrinsic scaled to the resized image and the depth intrinsic (both
    4x4), and the world-to-camera extrinsic."""
    from PIL import Image
    intrinsic = np.loadtxt(os.path.join(path, 'intrinsic.txt'),
                           dtype=np.float32)
    views = []
    with open(os.path.join(path, 'poses.txt')) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            name = parts[0]
            vals = np.asarray([float(v) for v in parts[1:]])
            cam2global = np.eye(4)
            if len(vals) == 7:
                cam2global[:3, :3] = quat_to_mat(vals[3:])
                cam2global[:3, 3] = vals[:3]
            else:
                cam2global = vals.reshape(4, 4)
            views.append((name, cam2global))
    views = views[:n_views]
    h, w = image_hw
    samples = []
    for name, cam2global in views:
        rgb = Image.open(os.path.join(path, 'rgb', name + '.jpg')).convert(
            'RGB')
        w0, h0 = rgb.size
        rgb = np.asarray(rgb.resize((w, h)), np.uint8)
        depth = np.asarray(
            Image.open(os.path.join(path, 'depth', name + '.png')),
            np.float32) / depth_shift
        k = np.eye(4, dtype=np.float32)
        k[:intrinsic.shape[0], :intrinsic.shape[1]] = intrinsic
        k_scaled = k.copy()
        k_scaled[:3] = np.diag([w / w0, h / h0, 1.0]).astype(
            np.float32) @ k[:3]
        samples.append(
            dict(rgb=rgb, depth=depth, intrinsic=k_scaled,
                 depth_intrinsic=k,
                 extrinsic=np.linalg.inv(cam2global).astype(np.float32)))
    return samples


def scan_request(views, cfg, rng):
    """(scene points (N, 3), the one-sample batch) of the loaded views:
    each view back-projected and sampled to ``points_per_view`` points,
    the views' points joined in the world frame, packed without gt boxes
    and collated."""
    from ..data import pipeline as pl
    pts_list, exts, ks, imgs = [], [], [], []
    for v in views:
        pts = pl.rgbd_to_points(v['depth'], v['depth_intrinsic'])
        pts_list.append(pl.point_sample(pts, cfg.data.points_per_view, rng))
        exts.append(v['extrinsic'])
        ks.append(v['intrinsic'])
        imgs.append(pl.normalize_imgs(v['rgb'][None])[0])
    points = pl.aggregate_points(pts_list, exts)
    sample = pl.pack_sample(points, np.stack(imgs), ks, exts,
                            np.zeros((0, 9), np.float32),
                            np.zeros((0,), np.int64), None, cfg.data.n_points,
                            cfg.data.max_boxes, rng)
    return points, pl.collate([sample])


def main(argv=None) -> dict:
    """Runs the demo as ``argv`` (default: the command line) asks. Returns
    the restored step (None without a checkpoint), the scene points, the
    kept boxes, scores and labels, the PLY's path and the seconds of each
    part (``load``: scan and batch; ``build``: model and restore;
    ``request``: the batch to the device, the model, the predictions
    back; ``export``: filter and PLY)."""
    parser = argparse.ArgumentParser(
        description='Detect 3D boxes in one raw RGB-D scan on the port')
    parser.add_argument('--dir', required=True)
    parser.add_argument('--work-dir', default='work_dirs/mv_det3d')
    parser.add_argument('--out', default='demo_out.ply')
    parser.add_argument('--device', default='cuda',
                        help="'cuda' (default; raises without a card) or "
                             "'cpu'")
    parser.add_argument('--n-views', type=int, default=10)
    parser.add_argument('overrides', nargs='*')
    args = parser.parse_args(argv)

    from ..configs.base import PRESETS, apply_overrides, build_model
    from ..data.loader import to_device
    from ..parallel.mesh import process_device
    from ..train.checkpoint import CheckpointManager
    from ..vis.visualization import export_scene_ply, nms_filter
    device = process_device(args.device)
    cfg = apply_overrides(PRESETS['mv_det3d'](), args.overrides)
    cfg.work_dir = args.work_dir
    seconds = {}

    t0 = time.perf_counter()
    views = load_scan_dir(args.dir, args.n_views, tuple(cfg.data.image_hw))
    points, batch = scan_request(views, cfg, np.random.RandomState(0))
    seconds['load'] = time.perf_counter() - t0

    t0 = time.perf_counter()
    model = build_model(cfg, device=device)
    step = CheckpointManager(cfg.work_dir).restore(model)
    seconds['build'] = time.perf_counter() - t0
    if step is not None:
        print(f'loaded checkpoint step {step}')
    else:
        print(f'no checkpoint under {cfg.work_dir}: the seeded initial '
              'weights')

    t0 = time.perf_counter()
    with torch.no_grad():
        preds = model(to_device(batch, device), mode='predict')
    preds = {k: v.cpu().numpy() for k, v in preds.items()}
    seconds['request'] = time.perf_counter() - t0

    t0 = time.perf_counter()
    keep = preds['mask'][0]
    boxes, scores, labels = nms_filter(preds['bboxes'][0][keep],
                                       preds['scores'][0][keep],
                                       preds['labels'][0][keep])
    print(f'{len(boxes)} detections after filtering')
    export_scene_ply(args.out, points, boxes, labels)
    seconds['export'] = time.perf_counter() - t0
    print(f'wrote {args.out}')
    print('seconds: ' + ', '.join(f'{k} {v:.3f}' for k, v in seconds.items()))
    return dict(step=step, points=points, boxes=boxes, scores=scores,
                labels=labels, out=args.out, seconds=seconds)


if __name__ == '__main__':
    main()
