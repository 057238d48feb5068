"""Single-file interactive HTML scene viewer and thick-edge box meshes
(port of ``embodiedscan_tpu/vis/html_viewer.py``; host numpy, no device).

``export_scene_html`` embeds the scene's points, 9-DoF box wireframes and a
class legend as JSON beside a small dependency-free canvas renderer
(orbit, zoom, pan), so the file opens in any browser without a network.
``boxes_line_mesh`` turns every box edge into a triangulated square prism,
so wireframes survive mesh viewers that do not draw PLY edges.
"""

import json
from typing import List, Optional

import numpy as np

from ..geometry.np_boxes import corners_np
from .visualization import BOX_EDGES, PALETTE

_HTML_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>EmbodiedScan scene</title>
<style>
 body {{ margin:0; background:#111; color:#ddd; font:12px sans-serif;
        overflow:hidden }}
 #hud {{ position:fixed; top:8px; left:8px; background:#0009; padding:6px
        10px; border-radius:6px; line-height:1.5 }}
 canvas {{ display:block }}
</style></head><body>
<div id="hud">drag: rotate &middot; wheel: zoom &middot; shift-drag: pan
 &middot; <span id="legend"></span></div>
<canvas id="c"></canvas>
<script>
const SCENE = {scene_json};
const cv = document.getElementById('c'), ctx = cv.getContext('2d');
let W, H; const resize = () => {{ W = cv.width = innerWidth;
  H = cv.height = innerHeight; }}; resize(); onresize = resize;
const P = SCENE.points, C = SCENE.colors, B = SCENE.boxes || [];
const center = [0,1,2].map(i => P.reduce((s,p)=>s+p[i],0)/(P.length||1));
let yaw = 0.8, pitch = 0.6, dist = 2.5 * (SCENE.radius || 5), pan = [0,0];
function project(p) {{
  const x = p[0]-center[0], y = p[1]-center[1], z = p[2]-center[2];
  const cy=Math.cos(yaw), sy=Math.sin(yaw), cp=Math.cos(pitch),
        sp=Math.sin(pitch);
  const x1 = cy*x + sy*y, y1 = -sy*x + cy*y;
  const y2 = cp*y1 + sp*z, z2 = -sp*y1 + cp*z;
  const d = dist - y2;
  if (d <= 0.05) return null;
  const f = 0.9 * Math.min(W, H) / d * (dist / (SCENE.radius || 5)) * 0.45;
  return [W/2 + f*x1 + pan[0], H/2 - f*z2 + pan[1], d];
}}
function draw() {{
  ctx.fillStyle = '#111'; ctx.fillRect(0, 0, W, H);
  const pts = [];
  for (let i = 0; i < P.length; i++) {{
    const q = project(P[i]); if (q) pts.push([q[2], q[0], q[1], C[i]]);
  }}
  pts.sort((a, b) => b[0] - a[0]);
  const r = Math.max(1, 2.2 - dist / (4 * (SCENE.radius || 5)));
  for (const [d, x, y, c] of pts) {{
    ctx.fillStyle = `rgb(${{c[0]}},${{c[1]}},${{c[2]}})`;
    ctx.fillRect(x - r, y - r, 2 * r, 2 * r);
  }}
  ctx.lineWidth = 2;
  for (const box of B) {{
    const uv = box.corners.map(project);
    ctx.strokeStyle = `rgb(${{box.color[0]}},${{box.color[1]}},` +
                      `${{box.color[2]}})`;
    ctx.beginPath();
    for (const [a, b] of SCENE.edges) {{
      if (uv[a] && uv[b]) {{ ctx.moveTo(uv[a][0], uv[a][1]);
        ctx.lineTo(uv[b][0], uv[b][1]); }}
    }}
    ctx.stroke();
    if (box.text && uv[0]) {{
      ctx.fillStyle = '#fff'; ctx.fillText(box.text, uv[0][0], uv[0][1]);
    }}
  }}
}}
let drag = null;
cv.onmousedown = e => drag = [e.clientX, e.clientY, e.shiftKey];
onmouseup = () => drag = null;
onmousemove = e => {{
  if (!drag) return;
  const dx = e.clientX - drag[0], dy = e.clientY - drag[1];
  if (drag[2]) {{ pan[0] += dx; pan[1] += dy; }}
  else {{ yaw += dx * 0.008;
    pitch = Math.max(-1.5, Math.min(1.5, pitch + dy * 0.008)); }}
  drag = [e.clientX, e.clientY, drag[2]]; requestAnimationFrame(draw);
}};
cv.onwheel = e => {{ dist *= Math.exp(e.deltaY * 0.001);
  requestAnimationFrame(draw); e.preventDefault(); }};
document.getElementById('legend').innerHTML = (SCENE.legend || [])
  .map(l => `<span style="color:rgb(${{l[1]}})">&#9632; ${{l[0]}}</span>`)
  .join(' ');
draw();
</script></body></html>
"""


def export_scene_html(path: str, points: np.ndarray,
                      boxes: Optional[np.ndarray] = None,
                      labels: Optional[np.ndarray] = None,
                      point_colors: Optional[np.ndarray] = None,
                      class_names: Optional[List[str]] = None,
                      texts: Optional[List[str]] = None,
                      max_points: int = 60000):
    """Write a single-file interactive viewer for one scene.

    Args:
        points: (N, 3) scene points (global frame, meters).
        boxes: optional (M, 9) euler boxes.
        labels: optional (M,) int class ids (colors + legend).
        point_colors: optional (N, 3) uint8; default height-colored.
        class_names: id -> name strings for the legend.
        texts: optional per-box annotation strings.
        max_points: uniform subsample cap to keep the file/browser snappy.
    """
    pts = np.asarray(points, np.float32).reshape(-1, 3)
    if len(pts) > max_points:
        sel = np.linspace(0, len(pts) - 1, max_points).astype(int)
        pts = pts[sel]
        point_colors = None if point_colors is None else \
            np.asarray(point_colors)[sel]
    if point_colors is None:
        # height-colored gradient (open3d-free stand-in for rgb clouds)
        z = pts[:, 2]
        zmin = float(z.min()) if len(z) else 0.0
        t = (z - zmin) / max(float(np.ptp(z)) if len(z) else 0.0, 1e-6)
        point_colors = np.stack([60 + 160 * t, 80 + 100 * (1 - t),
                                 200 - 140 * t], -1).astype(np.uint8)
    box_records = []
    legend = {}
    if boxes is not None and len(boxes):
        corners = corners_np(np.asarray(boxes, np.float32).reshape(-1, 9))
        for i, c8 in enumerate(corners):
            li = int(labels[i]) if labels is not None else i
            color = PALETTE[li % len(PALETTE)]
            rec = dict(corners=np.round(c8, 4).tolist(),
                       color=color.tolist())
            name = (class_names[li] if class_names is not None
                    and 0 <= li < len(class_names) else str(li))
            if texts is not None:
                rec['text'] = str(texts[i])
            elif class_names is not None and labels is not None:
                rec['text'] = name
            box_records.append(rec)
            if class_names is not None and labels is not None:
                legend[name] = ','.join(str(int(x)) for x in color)
    radius = float(np.abs(pts - pts.mean(0)).max()) if len(pts) else 5.0
    scene = dict(points=np.round(pts, 4).tolist(),
                 colors=np.asarray(point_colors, np.uint8).tolist(),
                 boxes=box_records, edges=BOX_EDGES,
                 legend=sorted(legend.items()), radius=radius)
    with open(path, 'w') as f:
        f.write(_HTML_TEMPLATE.format(scene_json=json.dumps(scene)))


# ---------------------------------------------------------------- line mesh

def boxes_line_mesh(boxes: np.ndarray, labels: Optional[np.ndarray] = None,
                    radius: float = 0.01):
    """Box edges as triangulated square prisms (LineMesh parity).

    The reference's ``LineMesh`` (visualization/line_mesh.py) replaces
    open3d line sets with cylinder meshes so edges are visible in mesh
    renderers. Here every box edge becomes a 4-sided prism (8 vertices, 8
    triangles) — same purpose, dependency-free.

    Returns:
        (verts (V, 3) float32, colors (V, 3) uint8, faces (F, 3) int lists).
    """
    corners = corners_np(np.asarray(boxes, np.float32).reshape(-1, 9))
    verts, cols, faces = [], [], []
    for i, c8 in enumerate(corners):
        color = PALETTE[int(labels[i]) % len(PALETTE)] if labels is not None \
            else PALETTE[i % len(PALETTE)]
        for a, b in BOX_EDGES:
            p, q = c8[a], c8[b]
            d = q - p
            n = np.linalg.norm(d)
            if n < 1e-8:
                continue
            d = d / n
            # build an orthonormal frame around the edge direction
            up = np.array([0.0, 0.0, 1.0]) if abs(d[2]) < 0.9 \
                else np.array([1.0, 0.0, 0.0])
            u = np.cross(d, up)
            u /= np.linalg.norm(u)
            v = np.cross(d, u)
            base = len(verts)
            for end in (p, q):
                for su, sv in ((1, 1), (-1, 1), (-1, -1), (1, -1)):
                    verts.append(end + radius * (su * u + sv * v))
                    cols.append(color)
            for k in range(4):
                k2 = (k + 1) % 4
                faces.append((base + k, base + 4 + k, base + 4 + k2))
                faces.append((base + k, base + 4 + k2, base + k2))
    return (np.asarray(verts, np.float32), np.asarray(cols, np.uint8),
            faces)


def write_ply_mesh(path: str, verts: np.ndarray, colors: np.ndarray,
                   faces: List):
    """ASCII PLY with triangle faces (meshlab/cloudcompare-compatible)."""
    lines = [
        'ply', 'format ascii 1.0', f'element vertex {len(verts)}',
        'property float x', 'property float y', 'property float z',
        'property uchar red', 'property uchar green', 'property uchar blue',
        f'element face {len(faces)}',
        'property list uchar int vertex_indices', 'end_header'
    ]
    for p, c in zip(verts, colors):
        lines.append(f'{p[0]:.4f} {p[1]:.4f} {p[2]:.4f} '
                     f'{int(c[0])} {int(c[1])} {int(c[2])}')
    for f3 in faces:
        lines.append(f'3 {f3[0]} {f3[1]} {f3[2]}')
    with open(path, 'w') as f:
        f.write('\n'.join(lines) + '\n')


def export_boxes_line_mesh_ply(path: str, boxes: np.ndarray,
                               labels: Optional[np.ndarray] = None,
                               radius: float = 0.01):
    """Boxes as a thick-edge wireframe mesh PLY (LineMesh analog)."""
    verts, cols, faces = boxes_line_mesh(boxes, labels, radius)
    write_ply_mesh(path, verts, cols, faces)
