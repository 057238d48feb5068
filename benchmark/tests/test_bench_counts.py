"""The count functions against counts by hand."""

import math

import torch
from torch import nn

from benchmark.counts import peaks, sparse
from benchmark.harness import trace


def test_conv_hits_by_hand():
    feats = torch.zeros(4, 8)
    mask = torch.tensor([True, True, False, True])
    nbr = torch.tensor([[0, 1, -1], [2, 3, 5], [1, -1, 3]], dtype=torch.int32)
    w = torch.zeros(3, 8, 16)
    nbytes, flops = sparse.conv('gather_matmul_conv', feats, mask, nbr, w)
    # hits: (0,0) (0,1) (1,3) (2,0) (2,2): row 2 is masked, 5 is outside
    assert float(flops) == 2 * 8 * 16 * 5
    assert nbytes == 4 * 8 * 4 + 4 + 9 * 4 + 3 * 8 * 16 * 4 + 3 * 16 * 4


def test_dgrad_reads_the_forward_weights_transposed():
    dout = torch.zeros(3, 16)
    mask = torch.ones(3, dtype=torch.bool)
    table = torch.tensor([[0, 1], [2, -1], [1, 1]], dtype=torch.int32)
    w = torch.zeros(2, 8, 16)        # the forward's (K, Cin, Cout)
    _, flops = sparse.conv('conv_dgrad', dout, mask, table, w, False,
                           mirror=True)
    assert float(flops) == 2 * 16 * 8 * 5


def test_wgrad_hits_by_hand():
    x = torch.zeros(3, 4)
    xm = torch.tensor([True, False, True])
    idx = torch.tensor([[0, 1], [1, 1], [2, 0]], dtype=torch.int32)
    y = torch.zeros(3, 6)
    ym = torch.tensor([True, True, False])
    _, flops = sparse.wgrad('conv_wgrad', x, xm, idx, y, ym)
    # rows 0 and 2 valid; pairs (0,0) (0,1) (2,0); (2,2) is masked in y
    assert float(flops) == 2 * 4 * 6 * 3


def test_unet_operations_by_width():
    """ImVoxelNeck's first block at mv_occ's widths, as the traced run
    counts it: a 3x3x3 conv of 768 channels over the 40 x 40 x 16 grid is
    2 x 25,600 x 27 x 768 x 768 operations, and a 2x2x2 stride-2
    transposed conv from 1536 to 768 channels over 20 x 20 x 8 cells is
    2 x 3,200 x 8 x 1536 x 768."""
    x = torch.empty(1, 768, 40, 40, 16, device='meta')
    conv = nn.Conv3d(768, 768, 3, padding=1, bias=False, device='meta')
    assert trace.dense_flops(lambda: conv(x)) == 2 * 25600 * 27 * 768 * 768
    up = nn.ConvTranspose3d(1536, 768, 2, stride=2, bias=False,
                            device='meta')
    xu = torch.empty(1, 1536, 20, 20, 8, device='meta')
    assert trace.dense_flops(lambda: up(xu)) == 2 * 3200 * 8 * 1536 * 768


def test_training_counts_both_gradients():
    lin = nn.Linear(64, 32)
    x = torch.randn(10, 64, requires_grad=True)
    assert trace.dense_flops(lambda: lin(x).sum().backward()) == \
        3 * 2 * 10 * 64 * 32


def test_least_seconds():
    assert math.isclose(peaks.least_seconds(3.35e12, 0), 1.0)
    assert math.isclose(peaks.least_seconds(0, 165e12), 1.0)
