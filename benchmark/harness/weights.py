"""Seeded weights, made on the device in a few large draws, handed alike to
the program and to the plain reference by parameter name.

The rule follows the port's own initialization (He fan-out normal for the
sparse kernels and dense layers, LeCun normal for the 2D and 3D convs,
zero biases, norms at identity), with the task file's own rules over it
(``weight_rules``: a head's projections, say). It is read off the
reference's modules, built on the meta device by the task file, so it
holds no memory and needs nothing of the program.
"""

import math

import torch
from torch import nn

from .spec import sub_seed

CHUNK = 1 << 26   # elements drawn per call


def plan(task, model: dict, init: dict | None = None) -> list:
    """[(name, shape, kind, value)]: kind 'normal' (value = std) or
    'const' (value = fill), for every parameter of the configuration's
    model, in a fixed order. ``task``: the cell's task file, which builds
    the model and may set rules of its own over the generic one;
    ``init``: a cell's own standard deviations by parameter name (a
    workload file's ``init``), over both."""
    with torch.device('meta'):
        ref = task.build(model)
    rules = {}
    for mod_name, mod in ref.named_modules():
        pre = mod_name + '.' if mod_name else ''
        for pname, p in mod.named_parameters(recurse=False):
            rule = _generic(mod, pname, p)
            if rule is not None:
                rules[pre + pname] = rule
    rules.update(getattr(task, 'weight_rules', lambda ref: {})(ref))
    for name, _ in ref.named_parameters():
        if name not in rules:
            raise ValueError(f'no weight rule for {name}')
    for name, std in (init or {}).items():
        if name not in rules:
            raise ValueError(f'init names no parameter: {name}')
        rules[name] = ('normal', float(std))
    return [(n, tuple(p.shape)) + rules[n] for n, p in ref.named_parameters()]


def _generic(mod, pname: str, p):
    """The generic rule of the parameter ``pname`` of ``mod``, or None."""
    if pname == 'kernel':              # sparse conv (K, Cin, Cout)
        return 'normal', math.sqrt(2.0 / (p.shape[0] * p.shape[2]))
    if pname.endswith('_tconv'):
        return 'normal', math.sqrt(2.0 / (8 * p.shape[-1]))
    if isinstance(mod, nn.Linear) and pname == 'weight':
        return 'normal', math.sqrt(2.0 / mod.out_features)
    if isinstance(mod, nn.ConvTranspose3d) and pname == 'weight':
        return 'normal', math.sqrt(1.0 / (p.shape[0] * p[0, 0].numel()))
    if isinstance(mod, (nn.Conv2d, nn.Conv3d)) and pname == 'weight':
        return 'normal', math.sqrt(1.0 / p[0].numel())
    if pname in ('bias', ):
        return 'const', 0.0
    if pname in ('scale', 'weight', 'scales'):
        return 'const', 1.0
    return None


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
