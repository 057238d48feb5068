"""Row gather of the fusion path (port of
``embodiedscan_tpu/ops/segment.py:gather_rows``).

The reference wraps the gather in a sort-based backward because TPU
scatter-adds are slow. The port's forward is ``index_select``, whose
backward is ``index_add_``: an atomic accumulate on the card. (Indexing as
``table[idx]`` would differentiate through ``index_put_`` with
accumulation, which sorts the indices first; with the fusion's many
duplicate indices that took most of a train step on an H100.)
"""

import torch


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[(Q,) idx]``; ``idx`` must lie in [0, table.shape[0])."""
    return torch.index_select(table, 0, idx.long())
