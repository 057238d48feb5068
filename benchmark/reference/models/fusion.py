"""Multi-view point-image feature fusion (port of
``embodiedscan_tpu/models/fusion.py:point_image_sample_batched``).

Every 3D point is projected into every view, the view's feature map is
sampled (one flat row gather for all (scan, sweep, view, point) tuples) and
the samples are averaged over the views that see the point.
"""

import numpy as np
import torch

from ..geometry.projection import _pad_to_4x4
from ..ops.segment import gather_rows

# the most (point, view, channel) samples held at once: a pseudo-batch of
# many sweeps over many views (cont_det3d's 50 x 50 at 24576 points and 64
# channels: 15.7 GB of float32 samples, three copies live) is sampled a
# chunk of sweeps at a time, with the same values (each sweep's mean is
# its own)
MAX_SAMPLES = 2**28


def _pixel_scale(pad: int, size: int) -> float:
    """float32 (size - 1) * f32(1 / pad), as a Python float."""
    return float(np.float32(size - 1) * (np.float32(1.0) / np.float32(pad)))


def point_image_sample_batched(points: torch.Tensor, point_mask: torch.Tensor,
                               img_feats: torch.Tensor, proj: torch.Tensor,
                               aug_inv: torch.Tensor, pad_hw: tuple,
                               mode: str = 'nearest',
                               view_mask: torch.Tensor | None = None,
                               view_group=None) -> torch.Tensor:
    """Whole-batch fusion.

    Args:
        points: (BI, S, N, 3) world points (S sweeps share a scan's views).
        point_mask: (BI, S, N).
        img_feats: (BI, V, Hf, Wf, C) NHWC feature maps.
        proj: (BI, V, 4, 4); aug_inv: (BI, 4, 4); view_mask: (BI, S, V).
        pad_hw: network input (H_pad, W_pad).
        mode: 'nearest' or 'bilinear' (zero padding outside).
        view_group: where the views are split over a mesh's view axis
            (``parallel.mesh``), its group: the sum and the count over
            views are summed over it, so that every process of the group
            gets the mean over all the views.

    Returns:
        (BI, S, N, C) float32 valid-view means (zero where no view sees the
        point).
    """
    bi, v, hf, wf, c = img_feats.shape
    s, n = points.shape[1:3]
    h_pad, w_pad = pad_hw
    proj = _pad_to_4x4(proj)
    ones = torch.ones_like(points[..., :1])
    pts = torch.einsum('bsni,bji->bsnj', torch.cat([points, ones], -1),
                       aug_inv)
    pts = torch.cat([pts[..., :3], ones], -1)
    uvw = torch.einsum('bsnj,bvkj->bsvnk', pts, proj)  # (BI, S, V, N, 4)
    depth = uvw[..., 2]
    uv = uvw[..., :2] / torch.clamp(depth[..., None], min=1e-3)
    coor_x, coor_y = uv[..., 0], uv[..., 1]

    valid = (coor_x > 0) & (coor_x < w_pad) & (coor_y > 0) & \
        (coor_y < h_pad) & (depth > 0) & point_mask[:, :, None, :]
    if view_mask is not None:
        valid = valid & view_mask[:, :, :, None]

    # the pixel mapping of grid_sample(align_corners=True), u / W_pad *
    # (Wf - 1), as XLA computes the jitted reference's: one product with
    # the float32 constant (Wf - 1) * f32(1 / W_pad) (the division by a
    # constant becomes a product with its reciprocal, and the two constant
    # factors fold); a point within an ulp of a pixel centre or half-pixel
    # then rounds as there
    xf = coor_x * _pixel_scale(w_pad, wf)
    yf = coor_y * _pixel_scale(h_pad, hf)

    flat = img_feats.reshape(bi * v * hf * wf, c)
    vbase = (torch.arange(bi * v, dtype=torch.int64, device=points.device) *
             (hf * wf)).reshape(bi, 1, v, 1)

    def sweeps(sl):
        """The (BI, S', N, C) means of the sweeps ``sl``."""
        ok, xs, ys = valid[:, sl], xf[:, sl], yf[:, sl]
        s_ = ok.shape[1]

        def gather(yi, xi):
            yi = torch.clamp(yi, 0, hf - 1)
            xi = torch.clamp(xi, 0, wf - 1)
            # out-of-frustum pairs read row 0; their samples are zeroed below
            idx = torch.where(ok, vbase + yi * wf + xi,
                              torch.zeros_like(yi)).reshape(-1)
            return gather_rows(flat, idx).reshape(bi, s_, v, n, c).to(
                torch.float32)

        if mode == 'nearest':
            sampled = gather(torch.round(ys).long(), torch.round(xs).long())
        else:
            x0 = torch.floor(xs).long()
            y0 = torch.floor(ys).long()
            tx = (xs - x0)[..., None]
            ty = (ys - y0)[..., None]

            def inb(yi, xi):
                return ((yi >= 0) & (yi < hf) & (xi >= 0) &
                        (xi < wf)).to(torch.float32)[..., None]

            sampled = (
                gather(y0, x0) * inb(y0, x0) * (1 - tx) * (1 - ty) +
                gather(y0, x0 + 1) * inb(y0, x0 + 1) * tx * (1 - ty) +
                gather(y0 + 1, x0) * inb(y0 + 1, x0) * (1 - tx) * ty +
                gather(y0 + 1, x0 + 1) * inb(y0 + 1, x0 + 1) * tx * ty)

        sampled = torch.where(ok[..., None], sampled,
                              torch.zeros_like(sampled))
        cnt = ok.sum(dim=2)  # (BI, S', N)
        total = sampled.sum(dim=2)  # (BI, S', N, C)
        out = total / torch.clamp(cnt, min=1)[..., None]
        keep = (cnt > 0)[..., None] & point_mask[:, sl, :, None]
        return torch.where(keep, out, torch.zeros_like(out))

    step = max(1, MAX_SAMPLES // (bi * v * n * c))
    if step >= s:
        return sweeps(slice(None))
    return torch.cat([sweeps(slice(i, i + step)) for i in range(0, s, step)],
                     dim=1)
