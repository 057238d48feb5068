"""Camera projection helpers (port of ``embodiedscan_tpu/geometry/projection.py``)."""

import torch


def _pad_to_4x4(mat: torch.Tensor) -> torch.Tensor:
    """Embed a (..., r<=4, c<=4) projection matrix into (..., 4, 4) identity."""
    r, c = mat.shape[-2:]
    if (r, c) == (4, 4):
        return mat
    out = torch.eye(4, dtype=mat.dtype, device=mat.device).expand(
        mat.shape[:-2] + (4, 4)).clone()
    out[..., :r, :c] = mat
    return out
