"""Offline playback writers for the continuous tasks (port of
``embodiedscan_tpu/vis/continuous.py``; host numpy and PIL, no device).

``ContinuousSceneWriter.add_frame`` back-projects one RGB-D view into the
growing global cloud, reveals the boxes the view makes visible, and writes
the step's scene PLY and the camera image with the boxes drawn in;
``finish`` joins the images into an animated GIF.
``ContinuousOccupancyWriter`` does the same for occupancy grids: a voxel
PLY and a top-down class map a step.
"""

import os
from typing import List, Optional

import numpy as np

from .visualization import (draw_boxes_on_image, export_occupancy_ply,
                            export_scene_ply)


def category_color(label: int) -> np.ndarray:
    """Deterministic bright color per category id.

    Functional replacement for the reference's 939-line ``ColorMap`` table
    (``visualization/color_selector.py``): golden-ratio hue stepping gives
    stable, well-separated colors for all 284 classes without a table.
    """
    h = (label * 0.61803398875) % 1.0
    i = int(h * 6)
    f = h * 6 - i
    v, p, q, t = 255, 64, int(255 - 191 * f), int(64 + 191 * f)
    rgb = [(v, t, p), (q, v, p), (p, v, t), (p, q, v), (t, p, v),
           (v, p, q)][i % 6]
    return np.asarray(rgb, np.uint8)


def depth_to_colored_points(rgb: np.ndarray, depth: np.ndarray,
                            depth_cam2img: np.ndarray,
                            cam2global: np.ndarray,
                            max_depth: Optional[float] = None):
    """Depth + RGB -> global-frame (N, 3) points and (N, 3) uint8 colors.

    Host-side analog of ``from_depth_to_point``
    (``visualization/utils.py:9-31``); colors come from the nearest RGB
    pixel, points go through cam2global.
    """
    h, w = depth.shape
    us, vs = np.meshgrid(np.arange(w), np.arange(h))
    z = depth.reshape(-1)
    ok = z > 0
    if max_depth is not None:
        ok &= z < max_depth
    k = np.asarray(depth_cam2img, np.float64)
    inv = np.linalg.inv(k[:3, :3])
    p2d = np.stack([us.reshape(-1), vs.reshape(-1), np.ones(h * w)], 0)
    cam = (inv @ p2d) * z[None]
    homo = np.concatenate([cam, np.ones((1, h * w))], 0)
    world = (np.asarray(cam2global, np.float64) @ homo)[:3].T
    rh, rw = rgb.shape[:2]
    ri = np.clip((vs.reshape(-1) * rh) // h, 0, rh - 1)
    rj = np.clip((us.reshape(-1) * rw) // w, 0, rw - 1)
    colors = np.asarray(rgb, np.uint8)[ri, rj]
    return world[ok].astype(np.float32), colors[ok]


def _write_gif(frames: List[np.ndarray], path: str,
               ms_per_frame: int) -> Optional[str]:
    """``frames`` as a looping animated GIF at ``path`` (None when there
    are none)."""
    if not frames:
        return None
    from PIL import Image
    imgs = [Image.fromarray(f) for f in frames]
    imgs[0].save(path, save_all=True, append_images=imgs[1:],
                 duration=ms_per_frame, loop=0)
    return path


class ContinuousSceneWriter:
    """Streaming detection playback: accumulate RGB-D frames + visible boxes.

    Mirrors ``ContinuousDrawer.draw_next`` (continuous_drawer.py:99-174):
    each frame back-projects the view into the global cloud, reveals the GT/
    predicted boxes whose instances became visible, and renders the camera
    view with the boxes projected in.
    """

    def __init__(self, out_dir: str, downsample: int = 4):
        self.out_dir = out_dir
        self.downsample = max(1, downsample)
        os.makedirs(out_dir, exist_ok=True)
        self._pts: List[np.ndarray] = []
        self._cols: List[np.ndarray] = []
        self._boxes: List[np.ndarray] = []
        self._labels: List[int] = []
        self._seen = set()
        self._frames: List[np.ndarray] = []
        self.idx = 0

    def add_frame(self, rgb, depth, depth_cam2img, cam2global, proj,
                  boxes=None, labels=None, visible_ids=None):
        """One sweep step.

        Args:
            rgb/depth/depth_cam2img/cam2global: the view's raw data.
            proj: (4, 4) intrinsic @ global2cam for image-space drawing.
            boxes: (G, 9) all scene boxes; visible_ids: indices revealed by
                this frame (``scene['instances']`` occupancy semantics).
        """
        pts, cols = depth_to_colored_points(rgb, depth, depth_cam2img,
                                            cam2global)
        self._pts.append(pts[::self.downsample])
        self._cols.append(cols[::self.downsample])
        if boxes is not None and visible_ids is not None:
            for i in np.asarray(visible_ids).reshape(-1):
                i = int(i)
                if i not in self._seen and i < len(boxes):
                    self._seen.add(i)
                    self._boxes.append(np.asarray(boxes[i]))
                    self._labels.append(
                        int(labels[i]) if labels is not None else i)
        shown = np.stack(self._boxes) if self._boxes else None
        lab = np.asarray(self._labels) if self._labels else None
        export_scene_ply(
            os.path.join(self.out_dir, f'step_{self.idx:03d}.ply'),
            np.concatenate(self._pts), shown, lab,
            point_colors=np.concatenate(self._cols))
        frame = rgb if shown is None else draw_boxes_on_image(
            rgb, shown, proj, lab)
        self._frames.append(np.asarray(frame, np.uint8))
        self.idx += 1

    def finish(self, gif_name: str = 'playback.gif', ms_per_frame: int = 400):
        """Write the accumulated camera frames as an animated GIF."""
        return _write_gif(self._frames, os.path.join(self.out_dir, gif_name),
                          ms_per_frame)


class ContinuousOccupancyWriter:
    """Streaming occupancy playback (ContinuousOccupancyDrawer analog).

    Each step gets the currently-predicted (or cumulative-GT) occupancy
    grid; emits a voxel PLY per step and a BEV color map per frame for the
    GIF (argmax over z, category colors).
    """

    def __init__(self, out_dir: str, voxel_size: float = 0.16,
                 origin=(0.0, 0.0, 0.0)):
        self.out_dir = out_dir
        self.voxel_size = voxel_size
        self.origin = origin
        os.makedirs(out_dir, exist_ok=True)
        self._frames: List[np.ndarray] = []
        self.idx = 0

    def add_frame(self, occ: np.ndarray):
        occ = np.asarray(occ)
        export_occupancy_ply(
            os.path.join(self.out_dir, f'occ_{self.idx:03d}.ply'), occ,
            self.voxel_size, self.origin)
        # BEV snapshot: highest occupied voxel's class per column
        occupied = (occ > 0) & (occ != 255)
        zs = np.where(occupied, np.arange(occ.shape[2])[None, None, :], -1)
        top = zs.max(-1)  # (X, Y)
        cls = np.take_along_axis(
            occ, np.clip(top, 0, None)[..., None], axis=2)[..., 0]
        bev = np.zeros(occ.shape[:2] + (3,), np.uint8)
        mask = top >= 0
        if mask.any():
            bev[mask] = np.stack([category_color(int(c))
                                  for c in cls[mask]])
        # upscale for a visible GIF
        bev = np.repeat(np.repeat(bev, 4, 0), 4, 1)
        self._frames.append(bev)
        self.idx += 1

    def finish(self, gif_name: str = 'occupancy.gif',
               ms_per_frame: int = 400):
        """Write the accumulated top-down maps as an animated GIF."""
        return _write_gif(self._frames, os.path.join(self.out_dir, gif_name),
                          ms_per_frame)


def render_prediction_video(scan: dict, preds: dict, out_dir: str,
                            score_thr: float = 0.2) -> Optional[str]:
    """One-call demo: scan views + predicted boxes -> playback GIF.

    ``scan`` follows the synthetic/demo layout (``data/synthetic.py:90``):
    views with rgb/depth/intrinsic/extrinsic. ``preds`` holds bboxes/
    scores/labels arrays (post-NMS).
    """
    keep = np.asarray(preds['scores']) > score_thr
    boxes = np.asarray(preds['bboxes'])[keep]
    labels = np.asarray(preds.get('labels', np.zeros(keep.sum())))[keep]
    writer = ContinuousSceneWriter(out_dir)
    for view in scan['views']:
        ext = np.asarray(view['extrinsic'])  # global2cam
        k4 = np.eye(4, dtype=np.float64)
        k = np.asarray(view['intrinsic'])
        k4[:k.shape[0], :k.shape[1]] = k
        writer.add_frame(view['rgb'], view['depth'], view['intrinsic'],
                         np.linalg.inv(ext), k4 @ ext, boxes, labels,
                         visible_ids=np.arange(len(boxes)))
    return writer.finish()
