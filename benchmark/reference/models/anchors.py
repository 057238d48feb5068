"""3D anchor grids on the host (port of
``embodiedscan_tpu/models/anchors.py``, the reference's
``anchor_3d_generator.py:12-355``; numpy, no device).

``Anchor3DRangeGenerator`` spreads anchor centres uniformly over each range,
end points included; ``AlignedAnchor3DRangeGenerator`` puts them at the
cells' centres (or corners), which is the occupancy model's prior grid
(``DenseFusionOccPredictor``).
"""

from typing import List, Sequence, Tuple

import numpy as np


class Anchor3DRangeGenerator:
    """Range-based 3D anchor generator (anchor_3d_generator.py:12-238)."""

    def __init__(self,
                 ranges: Sequence[Sequence[float]],
                 sizes: Sequence[Sequence[float]] = ((3.9, 1.6, 1.56),),
                 scales: Sequence[int] = (1,),
                 rotations: Sequence[float] = (0, 1.5707963),
                 custom_values: Sequence[float] = (),
                 reshape_out: bool = True,
                 size_per_range: bool = True):
        ranges = [list(r) for r in ranges]
        sizes = [list(s) for s in sizes]
        if size_per_range:
            if len(sizes) != len(ranges):
                assert len(ranges) == 1
                ranges = ranges * len(sizes)
            assert len(ranges) == len(sizes)
        else:
            assert len(ranges) == 1
        self.ranges = ranges
        self.sizes = sizes
        self.scales = list(scales)
        self.rotations = list(rotations)
        self.custom_values = tuple(custom_values)
        self.reshape_out = reshape_out
        self.size_per_range = size_per_range

    @property
    def num_base_anchors(self) -> int:
        """Total number of base anchors in a feature grid."""
        return len(self.rotations) * np.asarray(self.sizes).reshape(-1,
                                                                    3).shape[0]

    @property
    def num_levels(self) -> int:
        """Number of feature levels the generator is applied to."""
        return len(self.scales)

    def _centers(self, feature_size, anchor_range):
        """Per-axis center coordinates (z, y, x lists)."""
        return (np.linspace(anchor_range[2], anchor_range[5],
                            feature_size[0]),
                np.linspace(anchor_range[1], anchor_range[4],
                            feature_size[1]),
                np.linspace(anchor_range[0], anchor_range[3],
                            feature_size[2]))

    def anchors_single_range(self, feature_size, anchor_range, scale=1,
                             sizes=((3.9, 1.6, 1.56),),
                             rotations=(0, 1.5707963)) -> np.ndarray:
        """(Z, Y, X, num_sizes, num_rots, 7[+C]) anchors for one range."""
        if len(feature_size) == 2:
            feature_size = [1, feature_size[0], feature_size[1]]
        zc, yc, xc = self._centers(feature_size, anchor_range)
        sizes = np.asarray(sizes, np.float32).reshape(-1, 3) * scale
        rotations = np.asarray(rotations, np.float32)
        Z, Y, X = len(zc), len(yc), len(xc)
        S, R = sizes.shape[0], rotations.shape[0]
        shape = (Z, Y, X, S, R)
        out = np.empty(shape + (7 + len(self.custom_values),), np.float32)
        out[..., 0] = xc[None, None, :, None, None]
        out[..., 1] = yc[None, :, None, None, None]
        out[..., 2] = zc[:, None, None, None, None]
        out[..., 3:6] = sizes[None, None, None, :, None, :]
        out[..., 6] = rotations[None, None, None, None, :]
        if self.custom_values:
            out[..., 7:] = 0.0
        return out

    def single_level_grid_anchors(self, featmap_size, scale) -> np.ndarray:
        """Anchors of one level; per-size ranges joined on the size axis."""
        if not self.size_per_range:
            return self.anchors_single_range(featmap_size, self.ranges[0],
                                             scale, self.sizes,
                                             self.rotations)
        return np.concatenate([
            self.anchors_single_range(featmap_size, r, scale, [s],
                                      self.rotations)
            for r, s in zip(self.ranges, self.sizes)
        ], axis=-3)

    def grid_anchors(self, featmap_sizes: List[Tuple[int, ...]]
                     ) -> List[np.ndarray]:
        """Multi-level anchors; reshaped to (N, 7[+C]) if reshape_out."""
        assert self.num_levels == len(featmap_sizes)
        out = []
        for i in range(self.num_levels):
            a = self.single_level_grid_anchors(featmap_sizes[i],
                                               self.scales[i])
            if self.reshape_out:
                a = a.reshape(-1, a.shape[-1])
            out.append(a)
        return out


class AlignedAnchor3DRangeGenerator(Anchor3DRangeGenerator):
    """Voxel-grid-aligned variant (anchor_3d_generator.py:241-355).

    Centers sit at voxel centers (or corners when ``align_corner``), matching
    the feature grid — this is the occupancy prior generator.
    """

    def __init__(self, align_corner: bool = False, **kwargs):
        super().__init__(**kwargs)
        self.align_corner = align_corner

    def _centers(self, feature_size, anchor_range):
        axes = []
        for dim, (lo, hi) in zip(feature_size,
                                 [(anchor_range[2], anchor_range[5]),
                                  (anchor_range[1], anchor_range[4]),
                                  (anchor_range[0], anchor_range[3])]):
            edges = np.linspace(lo, hi, dim + 1)
            c = edges[:dim]
            if not self.align_corner:
                c = c + (edges[1] - edges[0]) / 2
            axes.append(c)
        return tuple(axes)
