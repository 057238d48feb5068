"""Seeded weights, made on the device in a few large draws, handed alike to
the program and to the plain reference by parameter name.

The rule follows the port's own initialization (He fan-out normal for the
sparse kernels and dense layers, LeCun normal for the 2D and 3D convs,
N(0, 0.01) head projections with the prior-probability class bias, zero
biases, norms at identity). It is read off the reference's modules, built
on the meta device, so it holds no memory and needs nothing of the
program.
"""

import math

import torch
from torch import nn

from ..reference import build as R
from ..reference.models.fcaf3d import _CLS_BIAS, FCAF3DHead
from .spec import sub_seed

CHUNK = 1 << 26   # elements drawn per call


def plan(model: dict, init: dict | None = None) -> list:
    """[(name, shape, kind, value)]: kind 'normal' (value = std) or
    'const' (value = fill), for every parameter of the configuration's
    model, in a fixed order. ``init``: a cell's own standard deviations
    by parameter name (a workload file's ``init``), over the rule."""
    with torch.device('meta'):
        ref = R.build_model(model)
    rules = {}
    for mod_name, mod in ref.named_modules():
        pre = mod_name + '.' if mod_name else ''
        for pname, p in mod.named_parameters(recurse=False):
            name = pre + pname
            if pname == 'kernel':              # sparse conv (K, Cin, Cout)
                rules[name] = ('normal', math.sqrt(2.0 / (p.shape[0] *
                                                          p.shape[2])))
            elif pname.endswith('_tconv'):
                rules[name] = ('normal', math.sqrt(2.0 / (8 * p.shape[-1])))
            elif isinstance(mod, nn.Linear) and pname == 'weight':
                rules[name] = ('normal', math.sqrt(2.0 / mod.out_features))
            elif isinstance(mod, nn.ConvTranspose3d) and pname == 'weight':
                rules[name] = ('normal', math.sqrt(1.0 / (
                    p.shape[0] * p[0, 0].numel())))
            elif isinstance(mod, (nn.Conv2d, nn.Conv3d)) and \
                    pname == 'weight':
                rules[name] = ('normal', math.sqrt(1.0 / p[0].numel()))
            elif pname in ('bias', ):
                rules[name] = ('const', 0.0)
            elif pname in ('scale', 'weight', 'scales'):
                rules[name] = ('const', 1.0)
            else:
                raise ValueError(f'no weight rule for {name}')
    # the head projections last, over the generic rule of their layers
    # (``named_modules`` yields the head before its children)
    for mod_name, mod in ref.named_modules():
        if isinstance(mod, FCAF3DHead):
            pre = mod_name + '.' if mod_name else ''
            for lin in ('conv_center', 'conv_reg', 'conv_cls'):
                rules[f'{pre}{lin}.weight'] = ('normal', 0.01)
            rules[f'{pre}conv_cls.bias'] = ('const', _CLS_BIAS)
    for name, std in (init or {}).items():
        if name not in rules:
            raise ValueError(f'init names no parameter: {name}')
        rules[name] = ('normal', float(std))
    return [(n, tuple(p.shape)) + rules[n] for n, p in ref.named_parameters()]


def values(pl: list, seed: int, device):
    """Yields (name, tensor) for the plan ``pl`` under ``seed``: every
    normal leaf is a slice of one N(0, 1) draw of at most ``CHUNK``
    elements, scaled; the same seed and plan give the same values."""
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, 'weights'))
    group, size = [], 0
    for item in pl + [None]:
        n = 0 if item is None else math.prod(item[1])
        if item is None or (group and size + n > CHUNK):
            flat = torch.randn(size, generator=g, device=device)
            off = 0
            for name, shape, _, std in group:
                k = math.prod(shape)
                yield name, flat[off:off + k].view(shape) * std
                off += k
            group, size = [], 0
        if item is None:
            break
        name, shape, kind, val = item
        if kind == 'const':
            yield name, torch.full(shape, float(val), device=device)
        else:
            group.append(item)
            size += n


@torch.no_grad()
def load(model: nn.Module, pl: list, seed: int) -> None:
    """Copies the seeded values into ``model``'s parameters, by name; its
    parameters must be exactly the plan's."""
    params = dict(model.named_parameters())
    if set(params) != {n for n, *_ in pl}:
        raise ValueError('the model\'s parameters differ from the reference\'s'
                         ': ' + str(sorted(set(params) ^ {n for n, *_ in pl})
                                    [:8]))
    dev = next(iter(params.values())).device
    for name, val in values(pl, seed, dev):
        if tuple(params[name].shape) != tuple(val.shape):
            raise ValueError(f'{name}: shape {tuple(params[name].shape)} '
                             f'against {tuple(val.shape)}')
        params[name].copy_(val)
