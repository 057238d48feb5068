"""The semantic occupancy task (``DenseFusionOccPredictor``): its reference
model, its trained parameters and how its served classes are compared.

Serving: ``class_gap``, the widest gap by which the reference's logit of
the class that the program served lies below its best, over every cell of
every request; ``logit_gap``, the program's logits at every scale against
the reference's, max |program - reference| / max |reference| per scale,
over a sample of the window's requests drawn from the seed (the
configuration's ``logits`` module).
"""

import math

import torch

from benchmark.harness.check import worse

FROZEN = ('stem_conv', 'stem_bn', 'layer1_')


def build(model: dict, serve: bool = False) -> torch.nn.Module:
    """The occupancy model of the configuration's ``model`` section (the
    same for serving)."""
    from benchmark.reference.models.occupancy import DenseFusionOccPredictor
    m = model
    return DenseFusionOccPredictor(
        num_classes=m['occ_classes'], n_voxels=tuple(m['n_voxels']),
        point_cloud_range=tuple(m['point_cloud_range']),
        input_capacity=m['input_capacity'],
        backbone_capacities=tuple(m['backbone_capacities']),
        resnet_depth=m['resnet_depth'],
        resnet_base_channels=m['resnet_base_channels'],
        mink_depth=m['mink_depth'], fpn_channels=m['occ_fpn_channels'],
        pre_neck_channels=m['occ_pre_neck_channels'])


def trained(name: str) -> bool:
    """Whether the parameter ``name`` is trained (the 2D stem and first
    stage are frozen: ``frozen_stages=1``)."""
    return not any(f in name for f in FROZEN)


@torch.no_grad()
def predict(model, batch: dict):
    """The reference's per-scale logits, finest first."""
    return model(batch, mode='feats')


def compare_serve(outs: list, logits: list, refs: dict, work: dict,
                  device) -> dict:
    """``outs``: [(scene index, the served classes)] of every request;
    ``logits``: [(request, scene index, the program's per-scale logits)]
    of the sampled requests; ``refs``: scene index -> the reference's
    per-scale logits."""
    worst = {}
    for i, (scene, classes) in enumerate(outs):
        ref = refs[scene][0].cpu()
        served = torch.gather(ref, -1, classes.long()[..., None])[..., 0]
        worse(worst, 'class_gap', (ref.amax(-1) - served).amax(),
              f'request {i}')
    for i, scene, prog in logits:
        if len(prog) != len(refs[scene]):
            worse(worst, 'logit_gap', math.inf, f'request {i}: scales')
        for k, (p, r) in enumerate(zip(prog, refs[scene])):
            p, r = p.to(r.device).float(), r.float()
            gap = (p - r).abs().amax() / r.abs().amax().clamp(min=1e-30) \
                if p.shape == r.shape else math.inf
            worse(worst, 'logit_gap', gap, f'request {i} scale {k}')
    return worst
