"""Host-side visualization kit (port of
``embodiedscan_tpu/vis/visualization.py``): ASCII PLY export of scene
clouds, box wireframes and occupancy grids, box wireframes drawn into an
image with PIL, and the demos' score + NMS filter.
"""

from typing import List, Optional, Sequence

import numpy as np

from ..geometry.np_boxes import corners_np

# wireframe edges of the reference corner ordering
BOX_EDGES = [(0, 1), (1, 2), (2, 3), (3, 0), (4, 5), (5, 6), (6, 7), (7, 4),
             (0, 4), (1, 5), (2, 6), (3, 7)]

PALETTE = np.array(
    [[226, 85, 85], [85, 160, 226], [85, 226, 130], [226, 200, 85],
     [170, 85, 226], [85, 226, 226], [226, 130, 85], [140, 226, 85],
     [226, 85, 170], [120, 120, 226]], np.uint8)


def write_ply(path: str, points: np.ndarray,
              colors: Optional[np.ndarray] = None,
              edges: Optional[List] = None):
    """Write an ASCII PLY with optional per-vertex colors and edges."""
    n = len(points)
    if colors is None:
        colors = np.full((n, 3), 180, np.uint8)
    lines = [
        'ply', 'format ascii 1.0', f'element vertex {n}',
        'property float x', 'property float y', 'property float z',
        'property uchar red', 'property uchar green', 'property uchar blue'
    ]
    if edges:
        lines += [f'element edge {len(edges)}', 'property int vertex1',
                  'property int vertex2']
    lines.append('end_header')
    for p, c in zip(points, colors):
        lines.append(f'{p[0]:.4f} {p[1]:.4f} {p[2]:.4f} '
                     f'{int(c[0])} {int(c[1])} {int(c[2])}')
    if edges:
        for a, b in edges:
            lines.append(f'{a} {b}')
    with open(path, 'w') as f:
        f.write('\n'.join(lines) + '\n')


def boxes_wireframe(boxes: np.ndarray, labels: Optional[np.ndarray] = None):
    """(N, 9) boxes -> (vertices, colors, edges) for PLY export."""
    corners = corners_np(np.asarray(boxes, np.float32).reshape(-1, 9))
    verts, cols, edges = [], [], []
    for i, c8 in enumerate(corners):
        base = len(verts)
        color = PALETTE[int(labels[i]) % len(PALETTE)] if labels is not None \
            else PALETTE[i % len(PALETTE)]
        verts.extend(c8.tolist())
        cols.extend([color] * 8)
        edges.extend([(base + a, base + b) for a, b in BOX_EDGES])
    return np.asarray(verts, np.float32), np.asarray(cols, np.uint8), edges


def export_scene_ply(path: str, points: np.ndarray,
                     boxes: Optional[np.ndarray] = None,
                     labels: Optional[np.ndarray] = None,
                     point_colors: Optional[np.ndarray] = None):
    """Scene point cloud + box wireframes into one PLY."""
    pts = np.asarray(points, np.float32).reshape(-1, 3)
    cols = point_colors if point_colors is not None else np.full(
        (len(pts), 3), 160, np.uint8)
    edges = []
    if boxes is not None and len(boxes):
        bv, bc, edges = boxes_wireframe(boxes, labels)
        edges = [(a + len(pts), b + len(pts)) for a, b in edges]
        pts = np.concatenate([pts, bv])
        cols = np.concatenate([cols, bc])
    write_ply(path, pts, cols, edges)


def export_occupancy_ply(path: str, occ: np.ndarray, voxel_size: float = 0.16,
                         origin=(0.0, 0.0, 0.0)):
    """Occupied voxel centers (labels other than 0 and 255) as a colored
    cloud."""
    occ = np.asarray(occ)
    idx = np.argwhere((occ > 0) & (occ != 255))
    centers = (idx + 0.5) * voxel_size + np.asarray(origin)
    colors = PALETTE[occ[tuple(idx.T)] % len(PALETTE)]
    write_ply(path, centers.astype(np.float32), colors)


def draw_boxes_on_image(rgb: np.ndarray, boxes: np.ndarray, proj: np.ndarray,
                        labels: Optional[np.ndarray] = None,
                        texts: Optional[Sequence[str]] = None) -> np.ndarray:
    """Project 9-DoF boxes into a view and draw their wireframes.

    Args:
        rgb: (H, W, 3) uint8 image.
        boxes: (N, 9) euler boxes in the global frame.
        proj: (4, 4) intrinsic @ extrinsic.
    """
    from PIL import Image, ImageDraw
    img = Image.fromarray(np.asarray(rgb, np.uint8))
    draw = ImageDraw.Draw(img)
    h, w = rgb.shape[:2]
    corners = corners_np(np.asarray(boxes, np.float32).reshape(-1, 9))
    for i, c8 in enumerate(corners):
        homo = np.concatenate([c8, np.ones((8, 1))], -1)
        cam = homo @ np.asarray(proj, np.float32).T
        z = cam[:, 2]
        if (z <= 0.05).all():
            continue
        uv = cam[:, :2] / np.clip(z[:, None], 1e-3, None)
        color = tuple(
            int(x) for x in (PALETTE[int(labels[i]) % len(PALETTE)]
                             if labels is not None else PALETTE[i % 10]))
        for a, b in BOX_EDGES:
            if z[a] > 0.05 and z[b] > 0.05:
                draw.line([tuple(uv[a]), tuple(uv[b])], fill=color, width=2)
        if texts is not None and z[0] > 0.05 and 0 <= uv[0][0] < w \
                and 0 <= uv[0][1] < h:
            draw.text(tuple(uv[0]), str(texts[i]), fill=color)
    return np.asarray(img)


def nms_filter(boxes: np.ndarray, scores: np.ndarray, labels: np.ndarray,
               score_thr: float = 0.15, iou_thr: float = 0.15,
               top_k: int = 100):
    """Host-side prediction filter for demos: the boxes above
    ``score_thr``, class-wise greedy NMS at ``iou_thr`` (on the CPU), the
    ``top_k`` best kept."""
    import torch

    from ..geometry.nms import nms3d
    keep0 = scores > score_thr
    boxes, scores, labels = boxes[keep0], scores[keep0], labels[keep0]
    if len(boxes) == 0:
        return boxes, scores, labels
    order, keep = nms3d(torch.as_tensor(boxes), torch.as_tensor(scores),
                        torch.ones(len(boxes), dtype=torch.bool), iou_thr,
                        torch.as_tensor(labels))
    order = order.numpy()[keep.numpy()][:top_k]
    return boxes[order], scores[order], labels[order]
