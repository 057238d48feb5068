"""Load the reference package's variables into the port's modules, and
export the port's tensors as the reference's trees.

The port's submodules carry the reference's flax names, so a flax leaf
``a/b/c/leaf`` lands on ``model.get_submodule('a.b.c')``; only the layout of
the leaf depends on the kind of module it lands on:

================  ===============  ======================
leaf kind         flax layout      port layout
================  ===============  ======================
sparse kernel     (K, Cin, Cout)   kept as is
Dense kernel      (in, out)        (out, in) nn.Linear
attention q/k/v   (D, H, Dh),      (H * Dh, D), (H * Dh,)
kernel, bias      (H, Dh)          ``attention.HeadsIn``
attention out     (H, Dh, D)       (D, H * Dh)
kernel                             ``attention.HeadsOut``
Conv kernel       HWIO             OIHW nn.Conv2d
Embed embedding   (V, C)           nn.Embedding weight
LayerNorm scale   (C,)             nn.LayerNorm weight
bias/mean/var,    (C,) or as       copied
other params      declared
================  ===============  ======================
"""

import numpy as np
import torch
from torch import nn

from ..models.attention import HeadsIn, HeadsOut


def _leaves(tree, prefix=()):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _leaves(val, prefix + (key,))
        else:
            yield prefix + (key,), np.asarray(val)


def _target(model: nn.Module, path):
    """(tensor to fill, array transform) for one flax leaf path."""
    mod = model.get_submodule('.'.join(path[:-1]))
    leaf = path[-1]
    if isinstance(mod, HeadsIn):
        if leaf == 'kernel':
            return mod.weight, lambda a: a.reshape(a.shape[0], -1).T
        if leaf == 'bias':
            return mod.bias, lambda a: a.reshape(-1)
    if isinstance(mod, HeadsOut) and leaf == 'kernel':
        return mod.weight, lambda a: a.reshape(-1, a.shape[-1]).T
    if isinstance(mod, nn.Linear) and leaf == 'kernel':
        return mod.weight, lambda a: a.T
    if isinstance(mod, nn.Conv2d) and leaf == 'kernel':
        return mod.weight, lambda a: a.transpose(3, 2, 0, 1)
    if isinstance(mod, nn.Embedding) and leaf == 'embedding':
        return mod.weight, lambda a: a
    if isinstance(mod, nn.LayerNorm) and leaf == 'scale':
        return mod.weight, lambda a: a
    tensor = getattr(mod, leaf, None)
    if not isinstance(tensor, torch.Tensor):
        raise KeyError(f'no port tensor for {"/".join(path)}')
    return tensor, lambda a: a


def load_jax_variables(model: nn.Module, params: dict,
                       batch_stats: dict | None = None,
                       strict: bool = True) -> nn.Module:
    """Copy the reference's ``params`` and ``batch_stats`` trees (nested dicts
    of numpy arrays) into ``model`` in place.

    Every leaf must land on a port tensor of the converted shape; with
    ``strict``, every parameter and buffer of the port must receive a leaf
    (a partial tree, as a fine-tuning checkpoint holds, needs
    ``strict=False``).
    """
    filled = set()
    names = {id(t): n for n, t in list(model.named_parameters()) +
             list(model.named_buffers())}
    for tree in (params, batch_stats or {}):
        for path, arr in _leaves(tree):
            tensor, fn = _target(model, path)
            val = torch.from_numpy(np.ascontiguousarray(fn(arr)))
            if tuple(val.shape) != tuple(tensor.shape):
                raise ValueError(f'{"/".join(path)}: shape {tuple(val.shape)} '
                                 f'!= port {tuple(tensor.shape)}')
            with torch.no_grad():
                tensor.copy_(val.to(tensor.dtype))
            filled.add(names[id(tensor)])
    missing = sorted(set(names.values()) - filled)
    if strict and missing:
        raise KeyError(f'port tensors without a reference leaf: {missing}')
    return model


def _leaf(mod: nn.Module, name: str, tensor: torch.Tensor):
    """(flax leaf name, numpy array in the flax layout) of a port tensor."""
    arr = tensor.detach().cpu().numpy()
    if isinstance(mod, HeadsIn):
        if name == 'weight':
            return 'kernel', arr.T.reshape(arr.shape[1], mod.heads, -1)
        return name, arr.reshape(mod.heads, -1)
    if isinstance(mod, HeadsOut) and name == 'weight':
        return 'kernel', arr.T.reshape(mod.heads, -1, arr.shape[0])
    if isinstance(mod, nn.Linear) and name == 'weight':
        return 'kernel', arr.T
    if isinstance(mod, nn.Conv2d) and name == 'weight':
        return 'kernel', arr.transpose(2, 3, 1, 0)
    if isinstance(mod, nn.Embedding) and name == 'weight':
        return 'embedding', arr
    if isinstance(mod, nn.LayerNorm) and name == 'weight':
        return 'scale', arr
    return name, arr


def export_jax_tree(model: nn.Module, tensors: str = 'params') -> dict:
    """The inverse of :func:`load_jax_variables`: ``'params'`` (parameters),
    ``'grads'`` (their ``.grad``; a parameter without one raises) or
    ``'buffers'`` (the ``batch_stats``) as nested dicts of numpy arrays in
    the flax layout of the table above."""
    if tensors not in ('params', 'grads', 'buffers'):
        raise ValueError(f'tensors: {tensors!r}')
    named = model.named_buffers() if tensors == 'buffers' else \
        model.named_parameters()
    tree = {}
    for name, tensor in named:
        *path, leaf = name.split('.')
        if tensors == 'grads':
            if tensor.grad is None:
                raise ValueError(f'{name} has no gradient')
            tensor = tensor.grad
        key, arr = _leaf(model.get_submodule('.'.join(path)), leaf, tensor)
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[key] = arr
    return tree
