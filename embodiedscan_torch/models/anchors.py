"""The voxel-aligned 3D anchor grid that the occupancy model uses as its
prior (host-side numpy; port of the parts of
``embodiedscan_tpu/models/anchors.py:AlignedAnchor3DRangeGenerator`` that
``DenseFusionOccPredictor`` reads: one range, centres at the cells'
middles).
"""

from typing import Sequence

import numpy as np


class AlignedAnchor3DRangeGenerator:
    """Anchors centred on the cells of a grid over one range, one per size
    and rotation (anchor_3d_generator.py:241-355)."""

    def __init__(self, anchor_range: Sequence[float],
                 sizes: Sequence[Sequence[float]] = ((3.9, 1.6, 1.56),),
                 rotations: Sequence[float] = (0, 1.5707963)):
        self.anchor_range = list(anchor_range)
        self.sizes = np.asarray(sizes, np.float32).reshape(-1, 3)
        self.rotations = np.asarray(rotations, np.float32)

    def _centers(self, feature_size):
        """Per-axis (z, y, x) cell centres (float64)."""
        r = self.anchor_range
        axes = []
        for dim, lo, hi in zip(feature_size, (r[2], r[1], r[0]),
                               (r[5], r[4], r[3])):
            edges = np.linspace(lo, hi, dim + 1)
            axes.append(edges[:dim] + (edges[1] - edges[0]) / 2)
        return tuple(axes)

    def single_level_grid_anchors(self, featmap_size, scale) -> np.ndarray:
        """(Z, Y, X, sizes, rotations, 7) float32 anchors of one level
        (x, y, z, dx, dy, dz, yaw); ``featmap_size`` is (Z, Y, X)."""
        zc, yc, xc = self._centers(featmap_size)
        sizes = self.sizes * scale
        shape = (len(zc), len(yc), len(xc), len(sizes), len(self.rotations))
        out = np.empty(shape + (7, ), np.float32)
        out[..., 0] = xc[None, None, :, None, None]
        out[..., 1] = yc[None, :, None, None, None]
        out[..., 2] = zc[:, None, None, None, None]
        out[..., 3:6] = sizes[None, None, None, :, None, :]
        out[..., 6] = self.rotations[None, None, None, None, :]
        return out
