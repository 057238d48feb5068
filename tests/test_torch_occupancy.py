"""Port vs reference: the mv_occ serving slice (flat engine) piece by piece
and whole, on small widths (ResNet-18 base 16, MinkResNet-18, FPN 8,
pre-neck 12, U-Net out 16, 5 classes), weights converted leaf by leaf
from one random flax tree.

Integers are identical (the prior grid, voxel coordinates and masks, the
predicted classes); floats agree within atol 1e-4 plus rtol 1e-5 (float32
sums in another order through the 2D branch, the sparse branch and the
U-Net). The voxel is the preset's 0.0025 m (prior range 6.4 m / 40 / 64):
at b = 2 the flat engine's key layout keeps 9 bits of z, 1.28 m, so the
rooms here are 2.4 m tall.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from embodiedscan_tpu.models import occupancy as jO
from embodiedscan_tpu.models.fpn import FPN as JFPN
from embodiedscan_tpu.ops import sparse as jS
from embodiedscan_torch.configs.base import build_model, mv_occ
from embodiedscan_torch.models import occupancy as tO
from embodiedscan_torch.models.fpn import FPN as TFPN
from embodiedscan_torch.ops import sparse as tS
from embodiedscan_torch.utils.convert_weights import (export_jax_tree,
                                                      load_jax_variables)

from test_torch_helpers import (flat_engine, occ_batch, random_variables,
                                to_numpy, to_torch)

TOL = dict(atol=1e-4, rtol=1e-5)
VOXEL = 6.4 / 40 / 64
# the model's small widths; n_voxels and capacities per case below
SMALL = dict(num_classes=5, resnet_depth=18, resnet_base_channels=16,
             mink_depth=18, neck3d_channels=16, fpn_channels=8,
             pre_neck_channels=12)
CASES = {
    'grid8_b1': dict(n_voxels=(8, 8, 4), b=1, p=1024, input_capacity=1024,
                     backbone_capacities=(1024, 1024, 1024, 512, 256, 128)),
    'grid40_b2': dict(n_voxels=(40, 40, 16), b=2, p=2048,
                      input_capacity=2048,
                      backbone_capacities=(2048, 2048, 2048, 1024, 512,
                                           512)),
}


def _jax_model(case):
    kw = dict(SMALL, n_voxels=case['n_voxels'],
              input_capacity=case['input_capacity'],
              backbone_capacities=case['backbone_capacities'])
    return jO.DenseFusionOccPredictor(**kw), kw


def _case_batch(case, seed=0):
    return occ_batch(b=case['b'], p=case['p'], n_voxels=case['n_voxels'],
                     seed=seed)


@pytest.mark.parametrize('n_voxels', [(8, 8, 4), (40, 40, 16), (6, 5, 3)])
def test_prior_points_identical(n_voxels):
    jm = jO.DenseFusionOccPredictor(n_voxels=n_voxels)
    want = np.asarray(jm._prior_points())
    got = tO._prior_points(jm.prior_range, n_voxels, jm.prior_origin)
    assert got.dtype == np.float32 and got.shape == (np.prod(n_voxels), 3)
    np.testing.assert_array_equal(got, want)


def test_fpn_odd_sizes():
    """Level sizes 13x11, 7x6, 4x3, 2x2: the top-down path upsamples by
    factors that are not 2 (nearest with half-pixel centres)."""
    rng = np.random.RandomState(1)
    chans, sizes = (16, 32, 64, 128), ((13, 11), (7, 6), (4, 3), (2, 2))
    xs = [rng.randn(2, h, w, c).astype(np.float32)
          for (h, w), c in zip(sizes, chans)]
    jm = JFPN(out_channels=8)
    var = random_variables(jm, ([jnp.asarray(x) for x in xs], ))
    want = to_numpy(jm.apply(var, [jnp.asarray(x) for x in xs]))
    tm = TFPN(chans, 8)
    load_jax_variables(tm, var['params'])
    with torch.no_grad():
        got = to_numpy(tm([torch.from_numpy(x) for x in xs]))
        first = to_numpy(tm([torch.from_numpy(x) for x in xs], levels=1))
    assert len(got) == 4 and len(first) == 1
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **TOL)
    np.testing.assert_array_equal(first[0], got[0])


def test_to_dense_identical():
    """Random unique coordinates, some out of the grid on every side, some
    masked, a nonzero origin: the same volumes bit for bit."""
    rng = np.random.RandomState(2)
    b, n, c, shape = 2, 40, 3, (5, 4, 3)
    origin = np.array([1, -1, 2], np.int32)
    coords = np.zeros((b, n, 3), np.int32)
    for i in range(b):
        cells = rng.choice(9 * 8 * 7, n, replace=False)
        coords[i] = np.stack(np.unravel_index(cells, (9, 8, 7)), -1) - 2
    st = (coords + origin, rng.randn(b, n, c).astype(np.float32),
          rng.uniform(size=(b, n)) > 0.2)
    want = np.asarray(jax.vmap(jS.to_dense, in_axes=(0, None, None))(
        jS.SparseTensor(*(jnp.asarray(a) for a in st)), jnp.asarray(origin),
        shape))
    got = tS.to_dense_b(tS.SparseTensor(*(torch.from_numpy(a) for a in st)),
                        torch.from_numpy(origin), shape).numpy()
    assert (want != 0).any() and (want == 0).any()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('b', [1, 2])
def test_per_sample_voxelization(b):
    """The model's voxelization (shifted by the range's lower corner) keeps
    what the reference's ``jax.vmap(from_points)`` keeps: coordinates,
    masks and features identical. At b = 2 the flat ``from_points_b``
    would lose the upper half of each 2.4 m room."""
    batch = occ_batch(b=b, p=3000, seed=3)
    pcr = np.asarray(mv_occ().model.point_cloud_range[:3], np.float32)
    shifted = batch['points'] - pcr
    args = (shifted, batch['points'], batch['points_mask'])
    want = to_numpy(jax.vmap(jS.from_points, in_axes=(0, 0, 0, None, None))(
        *(jnp.asarray(a) for a in args), VOXEL, 4096))
    got = to_numpy(tS.from_points_per_sample(
        *(torch.from_numpy(a) for a in args), VOXEL, 4096))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    z = want.coords[..., 2][want.mask]
    assert z.max() - z.min() >= 1.28 / VOXEL  # taller than 9 bits reach
    if b == 2:
        flat = to_numpy(tS.from_points_b(
            *(torch.from_numpy(a) for a in args), VOXEL, 4096))
        assert flat.mask.sum() < want.mask.sum()


def _module_parity(jm, tm, x, train):
    """(reference out, port out, reference stats after, port stats after)
    of one call on an NXYZC input; the port takes NCXYZ."""
    var = random_variables(jm, (jnp.asarray(x), ), train=False)
    load_jax_variables(tm, var['params'], var['batch_stats'])
    out, mut = jm.apply(var, jnp.asarray(x), train, mutable=['batch_stats'])
    tm.train(train)
    with torch.no_grad():
        got = tm(torch.from_numpy(x).permute(0, 4, 1, 2, 3).contiguous())
    return to_numpy(out), to_numpy(got), to_numpy(mut['batch_stats']), \
        export_jax_tree(tm, 'buffers')


def _assert_trees_close(got, want, **tol):
    for key, w in want.items():
        if isinstance(w, dict):
            _assert_trees_close(got[key], w, **tol)
        else:
            np.testing.assert_allclose(got[key], w, err_msg=key, **tol)


@pytest.mark.parametrize('train', [False, True])
@pytest.mark.parametrize('stride,cin,cout', [(1, 6, 6), (1, 4, 6),
                                             (2, 6, 12)])
def test_resblock3d(stride, cin, cout, train):
    """Identity and projected shortcuts; in training the batch statistics
    and flax's running update (momentum 0.99, fast variance)."""
    x = np.random.RandomState(4).randn(2, 6, 6, 4, cin).astype(np.float32)
    want, got, wstats, gstats = _module_parity(
        jO.ResBlock3D(cout, stride), tO.ResBlock3D(cin, cout, stride), x,
        train)
    np.testing.assert_allclose(got.transpose(0, 2, 3, 4, 1), want, **TOL)
    _assert_trees_close(gstats, wstats, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize('train', [False, True])
def test_imvoxel_neck(train):
    """Three scales on an 8x4x4 grid; the random transposed-conv kernels
    are not symmetric, so a missing flip would show."""
    x = np.random.RandomState(5).randn(2, 8, 4, 4, 6).astype(np.float32)
    jm, tm = jO.ImVoxelNeck(6, 8), tO.ImVoxelNeck(6, 8)
    var = random_variables(jm, (jnp.asarray(x), ), train=False)
    k = var['params']['up_1_t']['kernel']
    assert not np.allclose(k, k[::-1, ::-1, ::-1])
    want, got, wstats, gstats = _module_parity(jm, tm, x, train)
    assert [g.shape for g in got] == [(2, 8, 8, 4, 4), (2, 8, 4, 2, 2),
                                      (2, 8, 2, 1, 1)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.transpose(0, 2, 3, 4, 1), w, **TOL)
    _assert_trees_close(gstats, wstats, rtol=1e-5, atol=1e-7)


def test_transpose_conv_flip_is_needed():
    """Without the flip of the spatial axes the transposed conv differs
    (the converter's row for ``nn.ConvTranspose3d``)."""
    rng = np.random.RandomState(6)
    x = rng.randn(1, 3, 3, 3, 2).astype(np.float32)
    import flax.linen as fnn
    jm = fnn.ConvTranspose(3, (2, 2, 2), strides=(2, 2, 2), use_bias=False)
    kern = rng.randn(2, 2, 2, 2, 3).astype(np.float32)
    want = np.asarray(jm.apply({'params': {'kernel': kern}},
                               jnp.asarray(x)))
    tm = torch.nn.ConvTranspose3d(2, 3, 2, stride=2, bias=False)
    tx = torch.from_numpy(x).permute(0, 4, 1, 2, 3)
    with torch.no_grad():
        tm.weight.copy_(torch.from_numpy(kern.transpose(3, 4, 0, 1, 2)))
        unflipped = tm(tx).permute(0, 2, 3, 4, 1).numpy()
        load_jax_variables(tm, {'kernel': kern})
        got = tm(tx).permute(0, 2, 3, 4, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert np.abs(unflipped - want).max() > 0.1


@pytest.fixture(scope='module', params=list(CASES))
def model_outputs(request):
    case = CASES[request.param]
    batch = _case_batch(case)
    serve = {k: v for k, v in batch.items()
             if k not in ('gt_occ', 'gt_occ_mask', 'visible_mask')}
    with flat_engine():
        jm, kw = _jax_model(case)
        jb = {k: jnp.asarray(v) for k, v in serve.items()}
        var = random_variables(jm, (jb, ), train=False, mode='feats')
        want = to_numpy(jax.jit(lambda v, b: (
            jm.apply(v, b, train=False, mode='feats'),
            jm.apply(v, b, train=False, mode='predict')))(var, jb))
    tm = tO.DenseFusionOccPredictor(**kw).eval()
    load_jax_variables(tm, var['params'], var['batch_stats'])
    tb = to_torch(serve)
    got = to_numpy((tm(tb, mode='feats'), tm(tb, mode='predict')))
    return request.param, var, tm, want, got


def test_model_feats(model_outputs):
    _, _, _, (wfeats, _), (gfeats, _) = model_outputs
    assert len(gfeats) == 3
    for g, w in zip(gfeats, wfeats):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, **TOL)


def test_model_predict_identical(model_outputs):
    name, _, _, (_, wpred), (_, gpred) = model_outputs
    case = CASES[name]
    assert gpred.shape == (case['b'], *case['n_voxels'])
    np.testing.assert_array_equal(gpred, wpred)
    assert len(np.unique(wpred)) > 1


def test_converter_round_trip(model_outputs):
    """The whole occupancy tree (params and batch_stats) loads with
    strict=True and exports back bit for bit."""
    _, var, tm, _, _ = model_outputs
    for tree, kind in ((var['params'], 'params'),
                       (var['batch_stats'], 'buffers')):
        got = dict(_leaves(export_jax_tree(tm, kind)))
        want = dict(_leaves(tree))
        assert set(got) == set(want)
        for key, w in want.items():
            np.testing.assert_array_equal(got[key], w, err_msg=key)
    assert 'up_2_t' in var['params']['ImVoxelNeck_0']


def _leaves(tree, prefix=()):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _leaves(val, prefix + (key, ))
        else:
            yield prefix + (key, ), np.asarray(val)


def test_build_model_mv_occ():
    """The preset's fields as the reference's, and ``build_model`` on the
    CPU at small widths serves both modes."""
    cfg = mv_occ()
    m, d = cfg.model, cfg.data
    assert (m.task, m.occ_classes, tuple(m.n_voxels), m.occ_fpn_channels,
            m.occ_pre_neck_channels, m.resnet_base_channels) == \
        ('mv_occ', 81, (40, 40, 16), 256, 0, 64)
    assert (m.input_capacity, tuple(m.backbone_capacities)) == \
        (98304, (65536, 32768, 24576, 8192, 4096, 2048))
    assert (d.n_views_train, d.n_views_test, d.max_occ_voxels) == \
        (10, 20, 16384)
    assert tuple(cfg.schedule.milestones) == (16, 22)
    case = CASES['grid8_b1']
    m.occ_classes, m.n_voxels = 5, case['n_voxels']
    m.resnet_depth, m.mink_depth = 18, 18
    m.occ_fpn_channels, m.occ_pre_neck_channels = 8, 12
    m.input_capacity = case['input_capacity']
    m.backbone_capacities = case['backbone_capacities']
    model = build_model(cfg, device='cpu')
    assert isinstance(model, tO.DenseFusionOccPredictor)
    assert not model.training
    assert model.ImVoxelNeck_0.out_0_c.out_channels == 128
    tb = to_torch(_case_batch(case))
    pred = model(tb, mode='predict')
    feats = model(tb, mode='feats')
    assert pred.shape == (1, 8, 8, 4)
    assert torch.equal(pred, feats[0].argmax(-1))
    assert all(torch.isfinite(f).all() for f in feats)


def test_reference_checkpoint_loader_refuses_mv_occ(tmp_path):
    """No converter exists for a reference occupancy checkpoint (the
    reference package has none): ``load_reference_model`` and the CLI
    raise before building a model or reading the file, where they would
    otherwise merge a detector's converters into the occupancy model."""
    from embodiedscan_torch.tools import convert_checkpoint
    from embodiedscan_torch.utils.convert_weights import load_reference_model
    with pytest.raises(NotImplementedError, match="'mv_occ'"):
        load_reference_model(mv_occ(), {}, device='cpu')
    with pytest.raises(NotImplementedError, match="'mv_occ'"):
        convert_checkpoint.main(['mv_occ', str(tmp_path / 'absent.pth'),
                                 '--work-dir', str(tmp_path),
                                 '--device', 'cpu'])
    assert not any(tmp_path.iterdir())
