"""Port vs reference: ``FCAF3DHead.loss`` in every branch of its box loss,
and the converters carrying a 7- or 6-output ``conv_reg`` across.

The head's loss on seeded head outputs (four levels, two samples) in each
of: the rot-mat head's decoupled 4-group L1 / g8 chamfer (the default),
``cd_mode='l2'``, ``cd_group='g4'``, ``decouple_groups=3``,
``norm_decouple_loss=True``, the undecoupled chamfer, and the 'yaw7d' and
'aa6d' modes' IoU losses: the three losses within rtol 1e-5 plus atol 1e-6
x max|ref|, their gradients with respect to every level's center,
regression and class outputs within rtol 1e-5 plus atol 1e-4 x max|ref|
(the rotated IoU's clipped vertices; ``test_torch_heads.py``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from embodiedscan_tpu.models import fcaf3d as jF
from embodiedscan_tpu.models.detector import SparseFusionDetector as JDet
from embodiedscan_tpu.utils import convert_weights as jC
from embodiedscan_torch.models import fcaf3d as tF
from embodiedscan_torch.models.detector import SparseFusionDetector as TDet
from embodiedscan_torch.utils import convert_weights as tC

from test_reference_predict_fixture import full_reference_state_dict
from test_torch_heads import GRAD_REL, _boxes, _close
from test_torch_helpers import (flat_engine, random_variables, tiny_batch,
                                to_numpy)

# --- the head's loss in every branch -------------------------------------------

BRANCHES = {
    'euler9d': dict(),
    'cd_l2': dict(cd_mode='l2'),
    'cd_g4': dict(cd_group='g4'),
    'groups3': dict(decouple_groups=3),
    'norm_decouple': dict(norm_decouple_loss=True),
    'undecoupled': dict(decouple_bbox_loss=False, cd_mode='l2',
                        cd_group='g4'),
    'yaw7d': dict(bbox_mode='yaw7d'),
    'aa6d': dict(bbox_mode='aa6d'),
}


def _head_outputs(rng, n_reg, b=2, sizes=(48, 24, 12, 6), c=5):
    center, reg, cls, points, masks = [], [], [], [], []
    for n in sizes:
        center.append(rng.randn(b, n, 1).astype(np.float32))
        r = rng.randn(b, n, n_reg).astype(np.float32) * 0.5
        r[..., :6] = np.abs(r[..., :6]) + 0.1
        reg.append(r)
        cls.append(rng.randn(b, n, c).astype(np.float32))
        points.append(rng.uniform(0, 2, (b, n, 3)).astype(np.float32))
        masks.append(rng.rand(b, n) > 0.1)
    return center, reg, cls, points, masks


@pytest.mark.parametrize('branch', list(BRANCHES))
def test_head_loss_branches(branch):
    """The three losses and their gradients with respect to the center,
    regression and class outputs of every level."""
    kw = BRANCHES[branch]
    mode = kw.get('bbox_mode', 'euler9d')
    rng = np.random.RandomState(8)
    center, reg, cls, points, masks = _head_outputs(rng, tF.REG_OUTS[mode])
    gt = np.stack([_boxes(rng, 4, angle=0.3) for _ in range(2)])
    gt[..., 3:6] += 0.4
    glab = rng.randint(0, 5, (2, 4)).astype(np.int32)
    gmask = np.array([[1, 1, 1, 1], [1, 1, 1, 0]], bool)
    head = jF.FCAF3DHead(num_classes=5, **kw)

    def jloss(ce, re, cl):
        outs = jF.HeadOutputs(list(ce), list(re), list(cl),
                              [jnp.asarray(p) for p in points],
                              [jnp.asarray(m) for m in masks])
        return head.loss(outs, jnp.asarray(gt), jnp.asarray(glab),
                         jnp.asarray(gmask))

    jvals, jvjp = jax.vjp(jloss, *[[jnp.asarray(a) for a in x]
                                   for x in (center, reg, cls)])
    tparams = [[torch.from_numpy(a).requires_grad_() for a in x]
               for x in (center, reg, cls)]
    outs = tF.HeadOutputs(*tparams, [torch.from_numpy(p) for p in points],
                          [torch.from_numpy(m) for m in masks])
    thead = tF.FCAF3DHead(num_classes=5, in_channels=(8, 8, 8, 8), **kw)
    tvals = thead.loss(outs, torch.from_numpy(gt), torch.from_numpy(glab),
                       torch.from_numpy(gmask))
    assert set(tvals) == set(jvals)
    assert float(tvals['loss_bbox'].detach()) > 0
    for key in jvals:
        _close(tvals[key].detach().numpy(), jvals[key])
    sum(tvals.values()).backward()
    jgrads = jvjp({k: jnp.ones(()) for k in jvals})
    for tg, jg in zip(tparams, jgrads):
        for t, j in zip(tg, jg):
            np.testing.assert_allclose(t.grad.numpy(), np.asarray(j),
                                       rtol=1e-5,
                                       atol=GRAD_REL * np.abs(j).max())


# --- weights carried across ----------------------------------------------------

DET = dict(num_classes=5, voxel_size=0.05, input_capacity=256,
           backbone_capacities=(256, 128, 128, 64, 32, 16),
           fpn_capacities=(128, 64, 32, 16), max_dets=16, nms_pre=32,
           max_candidates=32, resnet_depth=18, mink_depth=18)


@pytest.mark.parametrize('mode', ['yaw7d', 'aa6d'])
def test_conv_reg_weights_carried_across(mode):
    """A flax tree of the JAX detector in ``mode`` loads strictly into the
    port and exports back bit for bit; a reference checkpoint whose
    ``conv_reg`` has the mode's outputs loads through both packages'
    converters with the same counts, no skip and the same variables."""
    batch = {k: jnp.asarray(v) for k, v in tiny_batch().items()}
    with flat_engine():
        var = random_variables(JDet(**DET, bbox_mode=mode), (batch,),
                               train=False, mode='feats')
    kern = var['params']['bbox_head']['conv_reg']['kernel']
    assert kern.shape[-1] == tF.REG_OUTS[mode]
    tm = TDet(**DET, bbox_mode=mode).eval()
    tC.load_jax_variables(tm, var['params'], var['batch_stats'])
    assert tm.bbox_head.conv_reg.weight.shape == (tF.REG_OUTS[mode], 128)
    exported = tC.export_jax_tree(tm, 'params')
    np.testing.assert_array_equal(exported['bbox_head']['conv_reg']['kernel'],
                                  kern)

    sd = full_reference_state_dict()
    cin = sd['bbox_head.conv_reg.kernel'].shape[-2]
    sd['bbox_head.conv_reg.kernel'] = np.random.RandomState(6).randn(
        cin, tF.REG_OUTS[mode]).astype(np.float32) * 0.01
    jvar, jn, js = jC.load_reference_detector(var, sd, mink_depth=18,
                                              resnet_depth=18)
    tm, tn, ts = tC.load_reference_detector(tm, sd, mink_depth=18,
                                            resnet_depth=18)
    assert (tn, ts) == (jn, js) and ts == []
    want = to_numpy(jvar['params'])
    got = tC.export_jax_tree(tm, 'params')
    np.testing.assert_array_equal(got['bbox_head']['conv_reg']['kernel'],
                                  sd['bbox_head.conv_reg.kernel'])
    np.testing.assert_array_equal(got['bbox_head']['conv_reg']['kernel'],
                                  want['bbox_head']['conv_reg']['kernel'])
