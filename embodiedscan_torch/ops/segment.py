"""Row gather of the fusion path (forward of
``embodiedscan_tpu/ops/segment.py:gather_rows``).

The reference wraps the gather in a sort-based backward because TPU
scatter-adds are slow; the port's forward is plain indexing.
"""

import torch


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[(Q,) idx]``; ``idx`` must lie in [0, table.shape[0])."""
    return table[idx.long()]
