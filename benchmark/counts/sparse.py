"""Bytes and operations of one call of the port's sparse-conv entry points,
from the call's arguments (the kernels' contract), copied from the port's
smoke run (``chip_smoke.py:_conv_bound``, ``_wgrad_bound``): inputs read
once, the output written once, two operations per multiply-add over the
(row, offset) pairs that hit a valid row. The operation count stays a
device tensor (read once the traced stretch is over)."""

import torch


def conv(entry, feats, mask, nbr, w, bias=None, bf16=False, *, mirror=None):
    """``gather_matmul_conv(feats, mask, nbr, w, bias)`` or ``conv_dgrad(
    dout, out_mask, table, w, bf16, mirror=...)``: (bytes, flops)."""
    n, cin = feats.shape
    m, k = nbr.shape
    cout = w.shape[-1] if mirror is None else w.shape[1]
    if entry == 'conv_dgrad':
        bias = None
    safe = torch.where(nbr >= 0, nbr, torch.zeros_like(nbr)).long()
    hits = ((nbr >= 0) & (nbr < n) & mask[safe.clamp(max=n - 1)]).sum()
    nbytes = (feats.numel() * feats.element_size() + mask.numel() +
              nbr.numel() * 4 + w.numel() * w.element_size() +
              (0 if bias is None else cout * 4) + m * cout * 4)
    return float(nbytes), 2.0 * cin * cout * hits.double()


def wgrad(entry, x, xm, idx, y, ym, bf16=False):
    """``conv_wgrad(x, x_mask, idx, y, y_mask)``: (bytes, flops)."""
    r, cx = x.shape
    k, cy = idx.shape[1], y.shape[1]
    ny = y.shape[0]
    safe = torch.where(idx >= 0, idx, torch.zeros_like(idx)).long()
    hits = ((idx >= 0) & (idx < ny) & xm[:, None] &
            ym[safe.clamp(max=ny - 1)]).sum()
    nbytes = (x.numel() * x.element_size() + xm.numel() + idx.numel() * 4 +
              y.numel() * y.element_size() + ym.numel() + k * cx * cy * 4)
    return float(nbytes), 2.0 * cx * cy * hits.double()
