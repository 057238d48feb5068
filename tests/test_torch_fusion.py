"""The fusion's pixel rounding against the jitted reference.

Under ``jit`` XLA computes the reference's ``u / W_pad * (Wf - 1)`` as one
product with a folded float32 constant. Points projected within a few ulps
of every feature-pixel centre and half-pixel of a 480-px image (``Wf - 1``
= 119 and 59) must gather the same pixels in the port as in the jitted
JAX ``point_image_sample_batched``, in both sampling modes; the gathered
row indices are read from inside both functions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from embodiedscan_tpu.models import fusion as jF
from embodiedscan_tpu.ops import segment as jseg
from embodiedscan_torch.models import fusion as tF

PAD = 480


def boundary_coords(wf: int, ulps: int = 3) -> np.ndarray:
    """float32 image coordinates at and within ``ulps`` ulps of each
    u = t * PAD / (wf - 1), t a pixel centre or half-pixel of the map."""
    out = []
    for t in np.arange(0, wf - 0.5, 0.5):
        c = np.float32(t * PAD / (wf - 1))
        down, up = c, c
        out.append(c)
        for _ in range(ulps):
            down = np.nextafter(down, np.float32(-np.inf))
            up = np.nextafter(up, np.float32(np.inf))
            out += [down, up]
    v = np.asarray(out, np.float32)
    return v[(v > 1e-3) & (v < PAD - 1e-3)]


def inputs(wf: int):
    """Points at depth 1 under identity projections, so the projected u, v
    are the coordinates exactly; one 480 x 480 view whose (wf x wf) map
    has random features."""
    xs = boundary_coords(wf)
    n = len(xs)
    pts = np.stack([xs, xs[::-1].copy(), np.ones(n, np.float32)], -1)
    feats = np.random.RandomState(wf).randn(1, 1, wf, wf, 4)
    return (pts[None, None], np.ones((1, 1, n), bool),
            feats.astype(np.float32), np.eye(4, dtype=np.float32)[None, None],
            np.eye(4, dtype=np.float32)[None])


@pytest.mark.parametrize('wf', [120, 60])
@pytest.mark.parametrize('mode', ['nearest', 'bilinear'])
def test_pixel_indices_match_jitted_reference(wf, mode, monkeypatch):
    args = inputs(wf)
    jax_idx, torch_idx = [], []
    jax_gather = jseg.gather_rows

    def jax_spy(flat, idx):
        jax.debug.callback(lambda i: jax_idx.append(np.asarray(i)), idx,
                           ordered=True)
        return jax_gather(flat, idx)

    torch_gather = tF.gather_rows

    def torch_spy(flat, idx):
        torch_idx.append(idx.numpy().copy())
        return torch_gather(flat, idx)

    monkeypatch.setattr(jseg, 'gather_rows', jax_spy)
    monkeypatch.setattr(tF, 'gather_rows', torch_spy)
    fn = jax.jit(lambda *a: jF.point_image_sample_batched(
        *a, (PAD, PAD), mode))
    want = np.asarray(jax.block_until_ready(fn(*map(jnp.asarray, args))))
    jax.effects_barrier()
    got = tF.point_image_sample_batched(*map(torch.from_numpy, args),
                                        (PAD, PAD), mode).numpy()
    assert len(jax_idx) == len(torch_idx) == (1 if mode == 'nearest' else 4)
    for j, t in zip(jax_idx, torch_idx):
        np.testing.assert_array_equal(t, j.astype(np.int64))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
