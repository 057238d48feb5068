"""EmbodiedScanExplorer: browse an EmbodiedScan dataset and render it to
files (port of ``embodiedscan_tpu/explorer.py``; host numpy and PIL, no
device).

It lists and counts the scans of the info pkls, renders a scan's RGB-D
views and gt boxes into a PLY (or a single-file HTML viewer when the path
ends in ``.html``), an occupancy grid into a voxel PLY, and boxes drawn
into one view as a PNG.
"""

import os
from typing import List, Optional

import numpy as np

from .data import pipeline as pl
from .data.dataset import load_info_pkl, load_view, parse_scan
from .vis.visualization import (draw_boxes_on_image, export_occupancy_ply,
                                export_scene_ply, nms_filter)


class EmbodiedScanExplorer:
    """Browse and render EmbodiedScan data (reference explorer.py API)."""

    def __init__(self, data_root: str, ann_files: List[str],
                 verbose: bool = False):
        self.data_root = data_root
        self.verbose = verbose
        self.infos = []
        self.metainfo = {}
        for ann in ann_files:
            infos, meta = load_info_pkl(os.path.join(data_root, ann))
            self.infos.extend(infos)
            if meta:
                self.metainfo = meta
        self._by_id = {info['sample_idx']: info for info in self.infos}
        if verbose:
            print(f'Loaded {len(self.infos)} scans')

    # ------------------------------------------------------------- browsing

    def count_scenes(self) -> int:
        return len(self.infos)

    def list_scenes(self) -> List[str]:
        return list(self._by_id.keys())

    def list_categories(self) -> List[str]:
        cats = self.metainfo.get('categories', {})
        return sorted(cats, key=lambda k: cats[k])

    def scene_info(self, scene: str) -> Optional[dict]:
        info = self._by_id.get(scene)
        if info is None:
            return None
        return dict(n_images=len(info['images']),
                    n_instances=len(info.get('instances', [])))

    # ------------------------------------------------------------ rendering

    def _scan(self, scene: str):
        return parse_scan(self._by_id[scene], self.data_root)

    def render_scene(self, scene: str, out_path: str, n_views: int = 6,
                     max_points_per_view: int = 20000):
        """Aggregate RGB-D views into a global cloud + GT boxes -> PLY."""
        scan = self._scan(scene)
        rng = np.random.RandomState(0)
        ids = pl.select_views(len(scan['views']), n_views, True, rng)
        pts_list, exts = [], []
        for i in ids:
            view = load_view(scan['views'][i], scan['depth_shift'], (480, 480))
            pts = pl.rgbd_to_points(view['depth'], view['depth_intrinsic'])
            pts_list.append(pl.point_sample(pts, max_points_per_view, rng))
            exts.append(view['extrinsic'])
        points = pl.aggregate_points(pts_list, exts)
        if out_path.endswith('.html'):
            # interactive single-file viewer (open3d draw_geometries analog)
            from .vis.html_viewer import export_scene_html
            export_scene_html(out_path, points, scan['gt_boxes'],
                              scan['gt_labels'],
                              class_names=self.list_categories() or None)
        else:
            export_scene_ply(out_path, points, scan['gt_boxes'],
                             scan['gt_labels'])
        return out_path

    def render_occupancy(self, occ: np.ndarray, out_path: str,
                         voxel_size: float = 0.16):
        export_occupancy_ply(out_path, occ, voxel_size)
        return out_path

    def show_image(self, scene: str, view_idx: int, out_path: str,
                   boxes: Optional[np.ndarray] = None,
                   labels: Optional[np.ndarray] = None):
        """Draw (GT or predicted) boxes on one view -> PNG."""
        from PIL import Image
        scan = self._scan(scene)
        view = load_view(scan['views'][view_idx], scan['depth_shift'],
                         (480, 480))
        if boxes is None:
            boxes, labels = scan['gt_boxes'], scan['gt_labels']
        proj = view['intrinsic'] @ view['extrinsic']
        img = draw_boxes_on_image(view['rgb'], boxes, proj, labels)
        Image.fromarray(img).save(out_path)
        return out_path

    def render_predictions(self, scene: str, boxes, scores, labels,
                           out_path: str, score_thr: float = 0.15):
        """NMS-filter predictions and render with the scene cloud."""
        fb, fs, fl = nms_filter(np.asarray(boxes), np.asarray(scores),
                                np.asarray(labels), score_thr)
        scan = self._scan(scene)
        rng = np.random.RandomState(0)
        ids = pl.select_views(len(scan['views']), 6, True, rng)
        pts_list, exts = [], []
        for i in ids:
            view = load_view(scan['views'][i], scan['depth_shift'], (480, 480))
            pts_list.append(
                pl.point_sample(
                    pl.rgbd_to_points(view['depth'],
                                      view['depth_intrinsic']), 20000, rng))
            exts.append(view['extrinsic'])
        points = pl.aggregate_points(pts_list, exts)
        export_scene_ply(out_path, points, fb, fl)
        return out_path
