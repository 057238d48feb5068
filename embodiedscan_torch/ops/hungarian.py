"""Matching queries to padded ground truths (port of
``embodiedscan_tpu/ops/hungarian.py``).

``hungarian_match`` is the reference's host matcher: every cost matrix of
a batch goes to the host in one copy, scipy's ``linear_sum_assignment``
solves each, and the assignments come back in one copy. Padded gt columns
carry a huge cost, so they are never preferred, and assignments to them
are discarded. ``auction_match`` is the on-device eps-optimal option
(Bertsekas' auction), in plain tensor code.
"""

import numpy as np
import torch

_BIG = 1e8


def _scipy_assign(cost: np.ndarray) -> np.ndarray:
    """(Q, G) float cost -> (Q,) int32 column per row, -1 for none; NaN
    and infinite costs are clamped to +-100 first."""
    from scipy.optimize import linear_sum_assignment
    cost = np.nan_to_num(np.asarray(cost, np.float64), nan=100.0,
                         posinf=100.0, neginf=-100.0)
    rows, cols = linear_sum_assignment(cost)
    out = np.full(cost.shape[0], -1, np.int32)
    out[rows] = cols.astype(np.int32)
    return out


def _drop_padded(assigned: torch.Tensor,
                 gt_mask: torch.Tensor) -> torch.Tensor:
    """-1 where a row's column is a padded gt (or none)."""
    g = gt_mask.shape[-1]
    safe = torch.clamp(assigned, 0, g - 1).long()
    valid = (assigned >= 0) & torch.gather(gt_mask, -1, safe)
    return torch.where(valid, assigned, torch.full_like(assigned, -1))


def hungarian_match(cost: torch.Tensor, gt_mask: torch.Tensor) -> torch.Tensor:
    """Match queries to (padded) ground truths.

    Args:
        cost: (..., Q, G) match cost (lower is better).
        gt_mask: (..., G) validity of the gt columns.

    Returns:
        (..., Q) int32: the matched gt index per query, -1 if unmatched.
    """
    *lead, q, g = cost.shape
    gt_mask = gt_mask.expand(*lead, g)
    masked = torch.where(gt_mask[..., None, :], cost.detach(),
                         cost.new_tensor(_BIG))
    host = masked.cpu().numpy().reshape(-1, q, g)
    out = np.stack([_scipy_assign(c) for c in host]).reshape(*lead, q)
    assigned = torch.from_numpy(out).to(cost.device)
    return _drop_padded(assigned, gt_mask)


def auction_match(cost: torch.Tensor, gt_mask: torch.Tensor,
                  eps: float = 1e-3, max_iters: int = 2000) -> torch.Tensor:
    """On-device eps-optimal assignment by Bertsekas' auction algorithm.

    Bidders are the valid gt columns (needs Q >= the number of valid gts);
    items are the queries. Every unassigned bidder bids in each round,
    Jacobi-style, with a single eps (no price scaling). A matrix whose
    bidders are all assigned, or which has run ``max_iters`` rounds, stops
    changing while the others go on; gts left unmatched at the cap count as
    background. Args and returns as :func:`hungarian_match`.
    """
    *lead, q, g = cost.shape
    dev = cost.device
    gm = gt_mask.expand(*lead, g).reshape(-1, g)
    n = gm.shape[0]
    value = -torch.where(gm[:, None, :], cost.detach().reshape(n, q, g),
                         cost.new_tensor(_BIG)).transpose(1, 2)  # (n, G, Q)
    value = torch.nan_to_num(value, nan=-100.0, posinf=100.0, neginf=-100.0)
    neg_inf = value.new_tensor(float('-inf'))
    gt_ids = torch.arange(g, device=dev)
    q_ids = torch.arange(q, device=dev).expand(n, q)
    prices = value.new_zeros(n, q)
    query_of_gt = torch.full((n, g), -1, dtype=torch.int64, device=dev)
    rounds = torch.zeros(n, dtype=torch.int64, device=dev)
    while True:
        unassigned = (query_of_gt < 0) & gm
        active = unassigned.any(1) & (rounds < max_iters)
        if not bool(active.any()):
            break
        net = value - prices[:, None, :]
        best_j = torch.argmax(net, dim=2)  # (n, G)
        b1 = torch.amax(net, dim=2)
        net2 = net.scatter(2, best_j[..., None], float('-inf'))
        b2 = torch.amax(net2, dim=2)
        b2 = torch.where(torch.isfinite(b2), b2, b1 - 1.0)  # Q == 1
        bids = torch.gather(prices, 1, best_j) + (b1 - b2) + eps
        bids = torch.where(unassigned, bids, neg_inf)
        # each query's best bid; ties go to the lowest gt index
        bid_mat = torch.full((n, g, q), float('-inf'), device=dev).scatter(
            2, best_j[..., None], bids[..., None])
        win_bid = torch.amax(bid_mat, dim=1)  # (n, Q)
        win_gt = torch.argmax(bid_mat, dim=1)
        got = win_bid > neg_inf
        # the previous owner of a re-sold query loses it
        lost = torch.gather(got, 1, torch.clamp(query_of_gt, 0, q - 1)) & \
            (query_of_gt >= 0)
        new_owner = torch.where(lost, torch.full_like(query_of_gt, -1),
                                query_of_gt)
        # winners take ownership; queries without a sale write to column g,
        # which is dropped (a gt wins at most one query per round)
        sale_gt = torch.where(got, win_gt, torch.full_like(win_gt, g))
        new_owner = torch.cat([new_owner, new_owner.new_zeros(n, 1)], 1
                              ).scatter(1, sale_gt, q_ids)[:, :g]
        new_prices = torch.where(got, win_bid, prices)
        query_of_gt = torch.where(active[:, None], new_owner, query_of_gt)
        prices = torch.where(active[:, None], new_prices, prices)
        rounds = rounds + active.long()
    # gt -> query into query -> gt; valid gts own distinct queries
    valid = (query_of_gt >= 0) & gm
    target = torch.where(valid, query_of_gt, torch.full_like(query_of_gt, q))
    assigned = torch.full((n, q + 1), -1, dtype=torch.int64, device=dev
                          ).scatter(1, target, gt_ids.expand(n, g))[:, :q]
    return assigned.to(torch.int32).reshape(*lead, q)
