"""Port vs reference: the grounding loss's matching pieces.

- The six match costs of ``models/match_costs.py`` within 1e-6 relative
  (float32, the same formulas; sums of a few terms in another order), but
  the IoU cost (see ``IOU_ATOL``).
- ``hungarian_match`` (scipy on the host) and ``auction_match`` (on the
  device): identical integers, with padded gt columns, masked queries (the
  grounder's 1e6 cost), NaN and +-inf costs, and for the port's batched
  form one call over stacked matrices.
- ``paired_iou_pruned`` with the capacity below, at and above the pair
  count, with many pairs whose SAT bound is 0 (ties in the sort): within
  ``IOU_ATOL``.
- ``build_positive_maps`` identical, spans whose edges need the
  next-character and previous-character fallbacks included.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from embodiedscan_tpu.geometry import iou as jI
from embodiedscan_tpu.models import match_costs as jC
from embodiedscan_tpu.models import text as jText
from embodiedscan_tpu.ops import hungarian as jH
from embodiedscan_torch.geometry import iou as tI
from embodiedscan_torch.models import match_costs as tC
from embodiedscan_torch.models import text as tText
from embodiedscan_torch.ops import hungarian as tH

from test_torch_helpers import to_numpy

# The exact IoU sums signed tetrahedra about the origin: for boxes a few
# meters out, float32 cancellation leaves up to ~1.4e-5 between the port
# and the reference on the same inputs (the pairs below; the serving
# slice's IoU test holds 1e-4), so IoU values are held to an absolute 5e-5
IOU_ATOL = 5e-5


def _boxes(rng, n, spread=3.0):
    return np.concatenate([
        rng.uniform(-spread, spread, (n, 3)),
        rng.uniform(0.2, 1.5, (n, 3)),
        rng.uniform(-0.6, 0.6, (n, 3)),
    ], -1).astype(np.float32)


def _rel_close(got, want, rel=1e-6):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rel,
                               atol=rel * max(np.abs(want).max(), 1e-30))


# --- match costs -------------------------------------------------------------


def test_bbox3d_l1_cost_and_iou3d_cost():
    rng = np.random.RandomState(0)
    pred, gt = _boxes(rng, 12), _boxes(rng, 5)
    pred[:3] = gt[:3] + rng.normal(0, 0.1, (3, 9)).astype(np.float32)
    want = jC.bbox3d_l1_cost(jnp.asarray(pred), jnp.asarray(gt))
    got = tC.bbox3d_l1_cost(torch.from_numpy(pred), torch.from_numpy(gt))
    assert got.shape == (12, 5)
    _rel_close(got.numpy(), want)
    want = jC.iou3d_cost(jnp.asarray(pred), jnp.asarray(gt))
    got = tC.iou3d_cost(torch.from_numpy(pred), torch.from_numpy(gt))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=IOU_ATOL)
    assert (tC.iou3d_cost(torch.from_numpy(pred), torch.from_numpy(gt))
            < -0.1).sum() >= 3


def test_token_and_focal_costs():
    rng = np.random.RandomState(1)
    logits = (rng.randn(10, 7) * 3).astype(np.float32)
    gt_logits = rng.randn(4, 7).astype(np.float32)
    labels = np.array([0, 6, 3, 3], np.int32)
    masks = (rng.rand(4, 7) > 0.5)
    cases = (
        (jC.token_map_cost, tC.token_map_cost, (logits, gt_logits)),
        (jC.focal_loss_cost, tC.focal_loss_cost, (logits, labels)),
        (jC.mask_focal_loss_cost, tC.mask_focal_loss_cost, (logits, masks)),
    )
    for jf, tf, args in cases:
        want = jf(*[jnp.asarray(a) for a in args])
        got = tf(*[torch.from_numpy(a) for a in args])
        assert got.shape == (10, 4)
        _rel_close(got.numpy(), want)


def test_binary_focal_cost_batched():
    """The port's leading dimensions (layers, batch) broadcast against the
    per-sample maps and token mask: each (layer, sample) slice equals the
    reference's unbatched cost."""
    rng = np.random.RandomState(2)
    nl, b, q, g, t = 3, 2, 9, 4, 12
    logits = (rng.randn(nl, b, q, t) * 3).astype(np.float32)
    maps = np.zeros((b, g, t), np.float32)
    for i in range(b):
        for j in range(g):
            s = rng.randint(1, t - 3)
            maps[i, j, s:s + rng.randint(1, 3)] = 1.0
    maps /= maps.sum(-1, keepdims=True) + 1e-6
    tmask = np.zeros((b, t), bool)
    tmask[0, :10], tmask[1, :6] = True, True
    got = tC.binary_focal_cost(torch.from_numpy(logits),
                               torch.from_numpy(maps),
                               torch.from_numpy(tmask)).numpy()
    assert got.shape == (nl, b, q, g)
    for li in range(nl):
        for i in range(b):
            want = jC.binary_focal_cost(jnp.asarray(logits[li, i]),
                                        jnp.asarray(maps[i]),
                                        jnp.asarray(tmask[i]))
            _rel_close(got[li, i], want)


# --- matchers ----------------------------------------------------------------


def _match_cases():
    """(cost (Q, G), gt_mask (G,), query mask (Q,)) cases."""
    rng = np.random.RandomState(3)
    out = []
    for q, g, n_valid in ((16, 6, 4), (16, 6, 6), (5, 8, 3), (12, 4, 1),
                          (7, 7, 0)):
        cost = (rng.rand(q, g) * 10).astype(np.float32)
        gm = np.zeros(g, bool)
        gm[rng.permutation(g)[:n_valid]] = True
        qm = rng.rand(q) > 0.25
        out.append((cost, gm, qm))
    cost, gm, qm = (rng.rand(14, 5) * 4).astype(np.float32), \
        np.array([1, 1, 0, 1, 1], bool), np.ones(14, bool)
    cost[2, 0], cost[5, 1], cost[7, 3] = np.nan, np.inf, -np.inf
    cost[9, :] = np.nan
    out.append((cost, gm, qm))
    return out


def _masked(cost, qm):
    """The grounder's masking of invalid queries (1e6) before matching."""
    return np.where(qm[:, None], cost, np.float32(1e6)).astype(np.float32)


@pytest.mark.parametrize('case', range(6))
def test_hungarian_match_identical(case):
    cost, gm, qm = _match_cases()[case]
    c = _masked(cost, qm)
    want = np.asarray(jH.hungarian_match(jnp.asarray(c), jnp.asarray(gm)))
    got = tH.hungarian_match(torch.from_numpy(c), torch.from_numpy(gm))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert set(got.numpy()[got.numpy() >= 0]) <= set(np.flatnonzero(gm))


@pytest.mark.parametrize('case', [0, 1, 3, 4, 5])
def test_auction_match_identical(case):
    """Cases with Q >= the valid gts (the auction's precondition)."""
    cost, gm, qm = _match_cases()[case]
    c = _masked(cost, qm)
    want = np.asarray(jH.auction_match(jnp.asarray(c), jnp.asarray(gm)))
    got = tH.auction_match(torch.from_numpy(c), torch.from_numpy(gm))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize('matcher', ['hungarian_match', 'auction_match'])
def test_matchers_batched(matcher):
    """One port call over (L, B, Q, G) with a (L, B, G) mask equals the
    reference's call on each matrix; for the auction, matrices converge
    after different numbers of rounds."""
    rng = np.random.RandomState(4)
    nl, b, q, g = 3, 2, 10, 4
    cost = (rng.rand(nl, b, q, g) * 6).astype(np.float32)
    cost[0, 1] = np.round(cost[0, 1])  # ties
    gm = np.array([[1, 1, 1, 0], [1, 0, 1, 0]], bool)
    gml = np.broadcast_to(gm, (nl, b, g))
    got = getattr(tH, matcher)(torch.from_numpy(cost),
                               torch.from_numpy(np.ascontiguousarray(gml)))
    assert got.shape == (nl, b, q)
    for li in range(nl):
        for i in range(b):
            want = getattr(jH, matcher)(jnp.asarray(cost[li, i]),
                                        jnp.asarray(gm[i]))
            np.testing.assert_array_equal(got[li, i].numpy(),
                                          np.asarray(want))


# --- the pruned pair IoU -----------------------------------------------------


def _pairs(seed):
    """Pairs of a decoder's queries against gt boxes: ~1/4 near their gt,
    the rest spread over the room (SAT bound 0: ties)."""
    rng = np.random.RandomState(seed)
    n = 600
    b = _boxes(rng, n, spread=4.0)
    a = _boxes(rng, n, spread=4.0)
    near = rng.rand(n) < 0.25
    a[near, :3] = b[near, :3] + rng.normal(0, 0.3, (near.sum(), 3))
    a[near, 3:6] = b[near, 3:6] * rng.uniform(0.7, 1.3, (near.sum(), 3))
    a[:5] = b[:5]  # exact matches
    return a.astype(np.float32), b.astype(np.float32)


@pytest.mark.parametrize('capacity', [16, 256, 599, 600, 4096])
def test_paired_iou_pruned(capacity):
    a, b = _pairs(5)
    want = np.asarray(jI.paired_iou_pruned(jnp.asarray(a), jnp.asarray(b),
                                           capacity))
    got = tI.paired_iou_pruned(torch.from_numpy(a), torch.from_numpy(b),
                               capacity).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=IOU_ATOL)
    bound = to_numpy(tI._axis_overlap_bound(torch.from_numpy(a),
                                            torch.from_numpy(b)))
    n_pos = int((bound > 0).sum())
    assert 100 < n_pos < 400 and (bound == 0).sum() > 200
    if capacity >= n_pos:  # every overlapping pair clipped: exact
        exact = np.asarray(jI.boxes3d_overlap_paired(jnp.asarray(a),
                                                     jnp.asarray(b))[1])
        np.testing.assert_allclose(got, exact, rtol=0, atol=IOU_ATOL)
    else:  # the smallest-bound pairs were dropped
        assert (got == 0).sum() >= len(a) - capacity


# --- positive maps -----------------------------------------------------------


def test_build_positive_maps_identical():
    """Spans on token edges, starting on a space (next character), ending
    one or two characters past a token (previous characters), a span whose
    edges find no token (skipped), several spans for one box, boxes past
    ``max_boxes`` (dropped) and a prompt longer than the tokenizer keeps."""
    texts = ['find the red chair near the wall',
             'the lamp ,  left of the sofa !',
             ' '.join(['word'] * 20)]
    spans = [
        [[[9, 18]], [[0, 4]], [[24, 32]], [[8, 13]], [[9, 19], [0, 4]]],
        [[[4, 10]], [[12, 16]], [[3, 5]], [[8, 11]], [[27, 30]], [[0, 3]]],
        [[[0, 4]], [[95, 99]]],
    ]
    for max_len, max_boxes in ((16, 4), (24, 8)):
        jt, tt = jText.SimpleTokenizer(max_len=max_len), \
            tText.SimpleTokenizer(max_len=max_len)
        jenc, tenc = jt(texts), tt(texts)
        np.testing.assert_array_equal(tenc['input_ids'], jenc['input_ids'])
        want = jText.build_positive_maps(jt, texts, spans, max_len, max_boxes)
        got = tText.build_positive_maps(tt, texts, spans, max_len, max_boxes)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
        assert (got.sum(-1) > 0.99).sum() >= 6
    # the fallbacks ran: a span starting on a space and one ending past it
    assert tt.char_to_token(1, 8) is None and tt.char_to_token(1, 11) is None
