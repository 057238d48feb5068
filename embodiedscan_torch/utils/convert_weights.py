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

The second half converts the reference's own torch checkpoints (a
torchvision ResNet, MinkowskiEngine's MinkResNet, the FCAF3D head, HF
RoBERTa, the grounder's neck, decoder and head branches): copies of the
JAX package's numpy converters (``embodiedscan_tpu/utils/
convert_weights.py``) turn a reference state_dict into trees in the flax
layout, and :func:`_merge_into` places those onto the port's modules with
mmengine's ``load_checkpoint(strict=False)`` semantics.

MinkowskiEngine enumerates a kernel's offsets odometer-style with the first
spatial axis varying fastest, while ``ops.sparse.OFFSETS_3`` / ``OFFSETS_2``
vary z fastest: :func:`me_kernel_permutation` maps ME's rows onto the
port's (``ours[i] = me[perm[i]]``); the JAX package's
``tests/test_me_permutation.py`` pins it against an ME-semantics oracle.
"""

from typing import Dict

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


def _leaf(mod: nn.Module, name: str, arr: np.ndarray):
    """(flax leaf name, array in the flax layout) of a port tensor's values
    ``arr``."""
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


def _flax_tree(model: nn.Module, tensors: str, values) -> dict:
    """The model's parameters (``tensors='params'``) or buffers as a nested
    dict in the flax layout, each leaf from ``values(name, tensor)``."""
    named = model.named_buffers() if tensors == 'buffers' else \
        model.named_parameters()
    tree = {}
    for name, tensor in named:
        *path, leaf = name.split('.')
        key, arr = _leaf(model.get_submodule('.'.join(path)), leaf,
                         values(name, tensor))
        _set(tree, (*path, key), arr)
    return tree


def export_jax_tree(model: nn.Module, tensors: str = 'params') -> dict:
    """The inverse of :func:`load_jax_variables`: ``'params'`` (parameters),
    ``'grads'`` (their ``.grad``; a parameter without one raises) or
    ``'buffers'`` (the ``batch_stats``) as nested dicts of numpy arrays in
    the flax layout of the table above."""
    if tensors not in ('params', 'grads', 'buffers'):
        raise ValueError(f'tensors: {tensors!r}')

    def values(name, tensor):
        if tensors == 'grads':
            if tensor.grad is None:
                raise ValueError(f'{name} has no gradient')
            tensor = tensor.grad
        return tensor.detach().cpu().numpy()

    return _flax_tree(model, tensors, values)


def _merge_into(model: nn.Module, params: dict, stats: dict, prefix):
    """Places converted ``(params, stats)`` trees (flax layout) onto the
    port's tensors under the flax path ``prefix``, as the JAX package's
    ``_merge_into`` merges them into its variables.

    mmengine's ``load_checkpoint(strict=False)`` semantics: a leaf whose
    port tensor is missing or of another shape (in the flax layout) is
    skipped, a subtree with no counterpart is skipped once under its own
    path; ``params`` merge into the model's parameters, ``stats`` into its
    buffers (the ``batch_stats``). Returns ``(model, n_loaded, skipped)``
    with the skipped paths as ``'a/b/c'``.
    """
    skipped, loaded = [], 0

    def merge(dst, src, path):
        nonlocal loaded
        for k, v in src.items():
            if isinstance(v, dict):
                if isinstance(dst.get(k), dict):
                    merge(dst[k], v, path + (k,))
                else:
                    skipped.append('/'.join(path + (k,)))
            elif isinstance(dst.get(k), np.ndarray) and \
                    dst[k].shape == np.shape(v):
                tensor, fn = _target(model, path + (k,))
                val = fn(np.asarray(v).astype(np.float32))
                with torch.no_grad():
                    tensor.copy_(torch.from_numpy(np.ascontiguousarray(val)))
                loaded += 1
            else:
                skipped.append('/'.join(path + (k,)))

    prefix = tuple(prefix)
    for tree, kind in ((params, 'params'), (stats, 'buffers')):
        if not tree:
            continue
        # the port's leaves as zero-stride arrays: shapes, no copies
        node = _flax_tree(model, kind, lambda _, t: np.broadcast_to(
            np.float32(0), tuple(t.shape)))
        for p in prefix:
            node = node.get(p, {}) if isinstance(node, dict) else {}
        merge(node, tree, prefix)
    return model, loaded, skipped


def _set(tree, path, value):
    node = tree
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = value


# ---------------------------------------------------------------------------
# Reference torch checkpoints -> trees in the flax layout (numpy only)
# ---------------------------------------------------------------------------

def _put(tree, path, value):
    node = tree
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = np.asarray(value)


def load_torch_checkpoint(path: str) -> Dict[str, np.ndarray]:
    """A reference ``.pth`` (an mmengine checkpoint or a bare state_dict)
    as a state_dict of numpy arrays, loaded on the CPU."""
    ckpt = torch.load(path, map_location='cpu', weights_only=False)
    sd = ckpt.get('state_dict', ckpt)
    return {k: v.numpy() for k, v in sd.items() if hasattr(v, 'numpy')}


def _conv(w):
    return np.transpose(np.asarray(w), (2, 3, 1, 0))  # OIHW -> HWIO


def convert_torchvision_resnet(state_dict: Dict[str, np.ndarray],
                               depth: int = 50):
    """torchvision ResNet state_dict -> (params, batch_stats) of the
    port's ``ResNet``: ``layer{i}.{j}.conv{k}`` / ``bn{k}`` ->
    ``layer{i}_{j}/Conv_{k-1}`` / ``FrozenBatchNorm_{k-1}``, the downsample
    -> the block's trailing Conv / FrozenBatchNorm; BatchNorm weight and
    bias -> scale and bias, running statistics -> mean and var. Any base
    width."""
    n_blocks = {18: (2, 2, 2, 2), 34: (3, 4, 6, 3), 50: (3, 4, 6, 3),
                101: (3, 4, 23, 3)}[depth]
    bottleneck = depth >= 50
    params: Dict = {}
    stats: Dict = {}
    sd = {k: np.asarray(v) for k, v in state_dict.items()}
    _put(params, ('stem_conv', 'kernel'), _conv(sd['conv1.weight']))
    _put(params, ('stem_bn', 'scale'), sd['bn1.weight'])
    _put(params, ('stem_bn', 'bias'), sd['bn1.bias'])
    _put(stats, ('stem_bn', 'mean'), sd['bn1.running_mean'])
    _put(stats, ('stem_bn', 'var'), sd['bn1.running_var'])

    n_convs = 3 if bottleneck else 2
    for i, blocks in enumerate(n_blocks):
        for j in range(blocks):
            src = f'layer{i + 1}.{j}'
            dst = f'layer{i + 1}_{j}'
            for k in range(n_convs):
                _put(params, (dst, f'Conv_{k}', 'kernel'),
                     _conv(sd[f'{src}.conv{k + 1}.weight']))
                _put(params, (dst, f'FrozenBatchNorm_{k}', 'scale'),
                     sd[f'{src}.bn{k + 1}.weight'])
                _put(params, (dst, f'FrozenBatchNorm_{k}', 'bias'),
                     sd[f'{src}.bn{k + 1}.bias'])
                _put(stats, (dst, f'FrozenBatchNorm_{k}', 'mean'),
                     sd[f'{src}.bn{k + 1}.running_mean'])
                _put(stats, (dst, f'FrozenBatchNorm_{k}', 'var'),
                     sd[f'{src}.bn{k + 1}.running_var'])
            if f'{src}.downsample.0.weight' in sd:
                _put(params, (dst, f'Conv_{n_convs}', 'kernel'),
                     _conv(sd[f'{src}.downsample.0.weight']))
                _put(params, (dst, f'FrozenBatchNorm_{n_convs}', 'scale'),
                     sd[f'{src}.downsample.1.weight'])
                _put(params, (dst, f'FrozenBatchNorm_{n_convs}', 'bias'),
                     sd[f'{src}.downsample.1.bias'])
                _put(stats, (dst, f'FrozenBatchNorm_{n_convs}', 'mean'),
                     sd[f'{src}.downsample.1.running_mean'])
                _put(stats, (dst, f'FrozenBatchNorm_{n_convs}', 'var'),
                     sd[f'{src}.downsample.1.running_var'])
    return params, stats


def load_resnet_into_variables(model, torch_state_dict, depth=50,
                               prefix=('trunk', 'ResNet_0')):
    """Converted torchvision weights onto ``model``'s ResNet at ``prefix``;
    a leaf of another shape is skipped (a 64-wide torchvision checkpoint
    against the detection config's 16-wide backbone degrades as the
    reference's mmengine load does). Returns (model, n_loaded, skipped)."""
    params, stats = convert_torchvision_resnet(torch_state_dict, depth)
    return _merge_into(model, params, stats, prefix)


def me_kernel_permutation(kernel_size: int = 3, flip: bool = False):
    """``perm`` with ``ours[i] = me[perm[i]]`` for a kernel of
    ``kernel_size`` 3 (27 offsets, -1..1 per axis), 2 (the generative
    transpose's 8, 0..1) or 1. ``flip`` mirrors ME's offsets (for a
    convention that gathers at ``u - off``)."""
    if kernel_size == 1:
        return np.array([0])
    if kernel_size == 3:
        rng = (-1, 0, 1)
    elif kernel_size == 2:
        rng = (0, 1)
    else:
        raise ValueError(f'unsupported kernel_size {kernel_size}')
    ours = [(dx, dy, dz) for dx in rng for dy in rng for dz in rng]
    me = [(dx, dy, dz) for dz in rng for dy in rng for dx in rng]
    if flip:
        lo, hi = min(rng), max(rng)
        me = [tuple(lo + hi - o for o in off) for off in me]
    index = {off: i for i, off in enumerate(me)}
    return np.array([index[off] for off in ours])


def _me_kernel(w, flip=False):
    """ME conv kernel (K, Cin, Cout) -> the port's row order; ME stores a
    kernel-volume-1 conv as a plain (Cin, Cout) matrix, which becomes
    (1, Cin, Cout) unpermuted."""
    w = np.asarray(w)
    if w.ndim == 2:
        return w[None]
    k = {27: 3, 8: 2, 1: 1}[w.shape[0]]
    return w[me_kernel_permutation(k, flip)]


def _me_pointwise(w):
    """ME 1x1 kernel -> (Cin, Cout) matrix of a pointwise Dense."""
    w = np.asarray(w)
    return w[0] if w.ndim == 3 else w


def _bn_getter(sd, prefix):
    def bn_get(name, field):
        for key in (f'{name}.bn.{field}', f'{name}.{field}'):
            if key in sd:
                return sd[key]
        raise KeyError(f'{prefix}{name}.{field} not in state dict')
    return bn_get


def convert_mink_resnet(state_dict: Dict[str, np.ndarray], depth: int = 34,
                        prefix: str = 'backbone_3d.', flip: bool = False):
    """Reference MinkResNet weights -> (params, batch_stats) of the port's
    ``MinkResNet``: the ME stem ``conv1`` / ``norm1`` -> ``SparseConv_0`` /
    ``MaskedInstanceNorm_0``; ``layer{i}.0`` (conv1, conv2, downsample) ->
    ``SparseStage_{i-1}``'s ``SparseConv_{0,1,2}`` / ``MaskedBatchNorm_*``
    (bottleneck depths: ``b0_conv1`` / ``b0_conv3`` Dense and the strided
    conv2); ``layer{i}.{j}`` -> ``SparseBasicBlock_{j-1}`` /
    ``SparseBottleneck_{j-1}``. Every (K, Cin, Cout) kernel takes the ME
    row permutation. BatchNorm keys may be ``norm.bn.*`` (ME's
    MinkowskiBatchNorm wraps BatchNorm1d) or ``norm.*``."""
    n_blocks = {18: (2, 2, 2, 2), 34: (3, 4, 6, 3), 50: (3, 4, 6, 3),
                101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}[depth]
    bottleneck = depth >= 50
    sd = {k[len(prefix):]: np.asarray(v) for k, v in state_dict.items()
          if k.startswith(prefix)}
    params: Dict = {}
    stats: Dict = {}
    bn_get = _bn_getter(sd, prefix)

    def put_bn(dst_path, src_name):
        _put(params, dst_path + ('scale',), bn_get(src_name, 'weight'))
        _put(params, dst_path + ('bias',), bn_get(src_name, 'bias'))
        _put(stats, dst_path + ('mean',), bn_get(src_name, 'running_mean'))
        _put(stats, dst_path + ('var',), bn_get(src_name, 'running_var'))

    _put(params, ('SparseConv_0', 'kernel'), _me_kernel(sd['conv1.kernel'],
                                                        flip))
    for key in ('norm1.inst_norm.weight', 'norm1.weight'):
        if key in sd:
            _put(params, ('MaskedInstanceNorm_0', 'scale'), sd[key])
            _put(params, ('MaskedInstanceNorm_0', 'bias'),
                 sd[key.replace('weight', 'bias')])
            break

    for i, blocks in enumerate(n_blocks):
        stage = f'SparseStage_{i}'
        src0 = f'layer{i + 1}.0'
        if bottleneck:
            _put(params, (stage, 'b0_conv1', 'kernel'),
                 _me_pointwise(sd[f'{src0}.conv1.kernel']))
            put_bn((stage, 'MaskedBatchNorm_0'), f'{src0}.norm1')
            _put(params, (stage, 'SparseConv_0', 'kernel'),
                 _me_kernel(sd[f'{src0}.conv2.kernel'], flip))
            put_bn((stage, 'MaskedBatchNorm_1'), f'{src0}.norm2')
            _put(params, (stage, 'b0_conv3', 'kernel'),
                 _me_pointwise(sd[f'{src0}.conv3.kernel']))
            put_bn((stage, 'MaskedBatchNorm_2'), f'{src0}.norm3')
            _put(params, (stage, 'SparseConv_1', 'kernel'),
                 _me_kernel(sd[f'{src0}.downsample.0.kernel'], flip))
            put_bn((stage, 'MaskedBatchNorm_3'), f'{src0}.downsample.1')
        else:
            _put(params, (stage, 'SparseConv_0', 'kernel'),
                 _me_kernel(sd[f'{src0}.conv1.kernel'], flip))
            put_bn((stage, 'MaskedBatchNorm_0'), f'{src0}.norm1')
            _put(params, (stage, 'SparseConv_1', 'kernel'),
                 _me_kernel(sd[f'{src0}.conv2.kernel'], flip))
            put_bn((stage, 'MaskedBatchNorm_1'), f'{src0}.norm2')
            _put(params, (stage, 'SparseConv_2', 'kernel'),
                 _me_kernel(sd[f'{src0}.downsample.0.kernel'], flip))
            put_bn((stage, 'MaskedBatchNorm_2'), f'{src0}.downsample.1')
        block_name = 'SparseBottleneck' if bottleneck else 'SparseBasicBlock'
        for j in range(1, blocks):
            src = f'layer{i + 1}.{j}'
            dst = (stage, f'{block_name}_{j - 1}')
            if bottleneck:
                _put(params, dst + ('conv1', 'kernel'),
                     _me_pointwise(sd[f'{src}.conv1.kernel']))
                put_bn(dst + ('MaskedBatchNorm_0',), f'{src}.norm1')
                _put(params, dst + ('SparseConv_0', 'kernel'),
                     _me_kernel(sd[f'{src}.conv2.kernel'], flip))
                put_bn(dst + ('MaskedBatchNorm_1',), f'{src}.norm2')
                _put(params, dst + ('conv3', 'kernel'),
                     _me_pointwise(sd[f'{src}.conv3.kernel']))
                put_bn(dst + ('MaskedBatchNorm_2',), f'{src}.norm3')
            else:
                _put(params, dst + ('SparseConv_0', 'kernel'),
                     _me_kernel(sd[f'{src}.conv1.kernel'], flip))
                put_bn(dst + ('MaskedBatchNorm_0',), f'{src}.norm1')
                _put(params, dst + ('SparseConv_1', 'kernel'),
                     _me_kernel(sd[f'{src}.conv2.kernel'], flip))
                put_bn(dst + ('MaskedBatchNorm_1',), f'{src}.norm2')
    return params, stats


def load_mink_resnet_into_variables(model, torch_state_dict, depth=34,
                                    prefix=('trunk', 'MinkResNet_0'),
                                    src_prefix='backbone_3d.', flip=False):
    """Converted reference MinkResNet weights onto ``model`` at ``prefix``
    (skips as :func:`load_resnet_into_variables`)."""
    params, stats = convert_mink_resnet(torch_state_dict, depth,
                                        prefix=src_prefix, flip=flip)
    return _merge_into(model, params, stats, prefix)


def convert_roberta(state_dict: Dict[str, np.ndarray],
                    prefix: str = 'text_encoder.'):
    """HF torch ``RobertaModel`` state_dict -> the params of the port's
    ``RobertaModule`` (named as HF's FlaxRobertaModule): Linear weights
    transpose to (in, out) kernels, embeddings and LayerNorms copy
    through. A pooler converts to ``pooler/dense``, which the port's
    encoder lacks: the merge skips it."""
    sd = {k[len(prefix):]: np.asarray(v) for k, v in state_dict.items()
          if k.startswith(prefix)}
    params: Dict = {}

    def dense(dst, src):
        _put(params, dst + ('kernel',), sd[src + '.weight'].T)
        _put(params, dst + ('bias',), sd[src + '.bias'])

    def lnorm(dst, src):
        _put(params, dst + ('scale',), sd[src + '.weight'])
        _put(params, dst + ('bias',), sd[src + '.bias'])

    _put(params, ('embeddings', 'word_embeddings', 'embedding'),
         sd['embeddings.word_embeddings.weight'])
    _put(params, ('embeddings', 'position_embeddings', 'embedding'),
         sd['embeddings.position_embeddings.weight'])
    _put(params, ('embeddings', 'token_type_embeddings', 'embedding'),
         sd['embeddings.token_type_embeddings.weight'])
    lnorm(('embeddings', 'LayerNorm'), 'embeddings.LayerNorm')

    i = 0
    while f'encoder.layer.{i}.attention.self.query.weight' in sd:
        src = f'encoder.layer.{i}'
        dst = ('encoder', 'layer', str(i))
        for name in ('query', 'key', 'value'):
            dense(dst + ('attention', 'self', name),
                  f'{src}.attention.self.{name}')
        dense(dst + ('attention', 'output', 'dense'),
              src + '.attention.output.dense')
        lnorm(dst + ('attention', 'output', 'LayerNorm'),
              src + '.attention.output.LayerNorm')
        dense(dst + ('intermediate', 'dense'), src + '.intermediate.dense')
        dense(dst + ('output', 'dense'), src + '.output.dense')
        lnorm(dst + ('output', 'LayerNorm'), src + '.output.LayerNorm')
        i += 1
    if 'pooler.dense.weight' in sd:
        # HF's RobertaPooler.dense (the JAX package's converter reads
        # 'pooler.weight', which HF never writes, and raises)
        dense(('pooler', 'dense'), 'pooler.dense')
    return params


def load_roberta_into_variables(model, torch_state_dict,
                                prefix=('text_encoder',
                                        'FlaxRobertaModule_0'),
                                src_prefix='text_encoder.'):
    """Converted torch RoBERTa weights onto the grounder's text encoder.
    The port's vocabulary is 30522 rows, as the JAX package's: a
    roberta-base checkpoint's 50265-row word embedding is skipped."""
    params = convert_roberta(torch_state_dict, prefix=src_prefix)
    return _merge_into(model, params, {}, prefix)


def convert_fcaf_head(state_dict: Dict[str, np.ndarray], n_levels: int = 4,
                      prefix: str = 'bbox_head.', flip: bool = False):
    """Reference ``FCAF3DHeadRotMat`` weights -> (params, batch_stats) of
    the port's ``FCAF3DHead``: ``up_block_{i}`` = (tconv, bn, elu, conv, bn,
    elu) -> ``up_block_{i}_tconv`` / ``_bn1`` / ``_conv`` / ``_bn2``,
    ``out_block_{i}`` = (conv, bn, elu) -> ``out_block_{i}_conv`` / ``_bn``,
    the 1x1 ``conv_center`` / ``conv_reg`` / ``conv_cls`` -> Dense, the
    per-level ``scales.{i}.scale`` -> one ``scales`` vector; the ME row
    permutation on every spatial kernel (k = 2 for the generative
    transpose, 3 for the convs)."""
    sd = {k[len(prefix):]: np.asarray(v) for k, v in state_dict.items()
          if k.startswith(prefix)}
    params: Dict = {}
    stats: Dict = {}
    bn_get = _bn_getter(sd, prefix)

    def put_bn(dst, src):
        _put(params, (dst, 'scale'), bn_get(src, 'weight'))
        _put(params, (dst, 'bias'), bn_get(src, 'bias'))
        _put(stats, (dst, 'mean'), bn_get(src, 'running_mean'))
        _put(stats, (dst, 'var'), bn_get(src, 'running_var'))

    for i in range(1, n_levels):
        _put(params, (f'up_block_{i}_tconv',),
             _me_kernel(sd[f'up_block_{i}.0.kernel'], flip))
        put_bn(f'up_block_{i}_bn1', f'up_block_{i}.1')
        _put(params, (f'up_block_{i}_conv', 'kernel'),
             _me_kernel(sd[f'up_block_{i}.3.kernel'], flip))
        put_bn(f'up_block_{i}_bn2', f'up_block_{i}.4')
    for i in range(n_levels):
        _put(params, (f'out_block_{i}_conv', 'kernel'),
             _me_kernel(sd[f'out_block_{i}.0.kernel'], flip))
        put_bn(f'out_block_{i}_bn', f'out_block_{i}.1')
    _put(params, ('conv_center', 'kernel'),
         _me_pointwise(sd['conv_center.kernel']))
    _put(params, ('conv_reg', 'kernel'), _me_pointwise(sd['conv_reg.kernel']))
    _put(params, ('conv_cls', 'kernel'), _me_pointwise(sd['conv_cls.kernel']))
    if 'conv_cls.bias' in sd:
        _put(params, ('conv_cls', 'bias'), sd['conv_cls.bias'].reshape(-1))
    _put(params, ('scales',),
         np.array([float(np.asarray(sd[f'scales.{i}.scale']).reshape(()))
                   for i in range(n_levels)], np.float32))
    return params, stats


def load_reference_detector(model, torch_state_dict, mink_depth=34,
                            resnet_depth=50, flip=False):
    """A reference detection checkpoint (the groups ``backbone``, the
    torchvision ResNet; ``backbone_3d``, the MinkResNet; ``bbox_head``)
    onto the port's ``SparseFusionDetector``. Each group is optional, so a
    partial checkpoint loads what it holds. Returns (model, n_loaded,
    skipped)."""
    n1 = n2 = n3 = 0
    s1, s2, s3 = [], [], []
    if 'backbone.conv1.weight' in torch_state_dict:
        _, n1, s1 = load_resnet_into_variables(
            model,
            {k[len('backbone.'):]: v for k, v in torch_state_dict.items()
             if k.startswith('backbone.')},
            depth=resnet_depth, prefix=('trunk', 'ResNet_0'))
    if any(k.startswith('backbone_3d.') for k in torch_state_dict):
        _, n2, s2 = load_mink_resnet_into_variables(
            model, torch_state_dict, depth=mink_depth,
            prefix=('trunk', 'MinkResNet_0'), src_prefix='backbone_3d.',
            flip=flip)
    if any(k.startswith('bbox_head.') for k in torch_state_dict):
        hp, hs = convert_fcaf_head(torch_state_dict, flip=flip)
        _, n3, s3 = _merge_into(model, hp, hs, ('bbox_head',))
    return model, n1 + n2 + n3, s1 + s2 + s3


def _torch_linear(params, dst, sd, src):
    _put(params, dst + ('kernel',), sd[src + '.weight'].T)
    if src + '.bias' in sd:
        _put(params, dst + ('bias',), sd[src + '.bias'])


def _torch_mha(params, dst, sd, src, num_heads):
    """torch ``nn.MultiheadAttention`` (under mmcv's ``.attn``) -> flax
    MultiHeadDotProductAttention: ``in_proj`` (3E, E) splits into q, k, v
    kernels (E, H, E/H) and biases (H, E/H); ``out_proj`` -> (H, E/H, E)."""
    w = sd[src + '.attn.in_proj_weight']
    b = sd[src + '.attn.in_proj_bias']
    e = w.shape[1]
    hd = e // num_heads
    for i, name in enumerate(('query', 'key', 'value')):
        wi = w[i * e:(i + 1) * e]  # (E, E) out x in
        bi = b[i * e:(i + 1) * e]
        _put(params, dst + (name, 'kernel'), wi.T.reshape(e, num_heads, hd))
        _put(params, dst + (name, 'bias'), bi.reshape(num_heads, hd))
    wo = sd[src + '.attn.out_proj.weight']  # (E, E)
    _put(params, dst + ('out', 'kernel'), wo.T.reshape(num_heads, hd, e))
    _put(params, dst + ('out', 'bias'), sd[src + '.attn.out_proj.bias'])


def _torch_ln(params, dst, sd, src):
    _put(params, dst + ('scale',), sd[src + '.weight'])
    _put(params, dst + ('bias',), sd[src + '.bias'])


def _posembed(params, stats, dst, sd, src):
    """PositionEmbeddingLearned: Conv1d(k=1) + BN1d + ReLU + Conv1d(k=1) ->
    Dense + MaskedBatchNorm + Dense."""
    head = src + '.position_embedding_head'
    _put(params, dst + ('Dense_0', 'kernel'),
         sd[head + '.0.weight'][:, :, 0].T)
    _put(params, dst + ('Dense_0', 'bias'), sd[head + '.0.bias'])
    _put(params, dst + ('MaskedBatchNorm_0', 'scale'), sd[head + '.1.weight'])
    _put(params, dst + ('MaskedBatchNorm_0', 'bias'), sd[head + '.1.bias'])
    _put(stats, dst + ('MaskedBatchNorm_0', 'mean'),
         sd[head + '.1.running_mean'])
    _put(stats, dst + ('MaskedBatchNorm_0', 'var'),
         sd[head + '.1.running_var'])
    _put(params, dst + ('Dense_1', 'kernel'),
         sd[head + '.3.weight'][:, :, 0].T)
    _put(params, dst + ('Dense_1', 'bias'), sd[head + '.3.bias'])


def convert_mink_neck(state_dict, n_levels: int = 4,
                      prefix: str = 'neck_3d.', flip: bool = False):
    """Reference MinkNeck -> (params, batch_stats) of the port's
    ``MinkNeck``: the FCAF head's up / out block layout plus the biased 1x1
    ``conv_cls`` score head."""
    sd = {k[len(prefix):]: np.asarray(v) for k, v in state_dict.items()
          if k.startswith(prefix)}
    params, stats = {}, {}

    def bn(dst, src):
        for key in (f'{src}.bn.', f'{src}.'):
            if key + 'weight' in sd:
                _put(params, dst + ('scale',), sd[key + 'weight'])
                _put(params, dst + ('bias',), sd[key + 'bias'])
                _put(stats, dst + ('mean',), sd[key + 'running_mean'])
                _put(stats, dst + ('var',), sd[key + 'running_var'])
                return
        raise KeyError(f'{prefix}{src} batchnorm not in state dict')

    for i in range(1, n_levels):
        _put(params, (f'up_block_{i}_tconv',),
             _me_kernel(sd[f'up_block_{i}.0.kernel'], flip))
        bn((f'up_block_{i}_bn1',), f'up_block_{i}.1')
        _put(params, (f'up_block_{i}_conv', 'kernel'),
             _me_kernel(sd[f'up_block_{i}.3.kernel'], flip))
        bn((f'up_block_{i}_bn2',), f'up_block_{i}.4')
    for i in range(n_levels):
        _put(params, (f'out_block_{i}_conv', 'kernel'),
             _me_kernel(sd[f'out_block_{i}.0.kernel'], flip))
        bn((f'out_block_{i}_bn',), f'out_block_{i}.1')
    _put(params, ('conv_cls', 'kernel'), _me_pointwise(sd['conv_cls.kernel']))
    _put(params, ('conv_cls', 'bias'), sd['conv_cls.bias'].reshape(-1))
    return params, stats


def convert_ground_decoder(state_dict, num_layers: int = 6,
                           num_heads: int = 8, prefix: str = 'decoder.'):
    """Reference SparseFeatureFusionTransformerDecoder -> the port's
    decoder tree: per layer the self, text and point attentions, the FFN
    and 4 norms (``layer{i}``); the decoder-level learned position
    embeddings and final norm. The per-layer ``self_posembed`` modules the
    reference builds but never calls are ignored."""
    sd = {k[len(prefix):]: np.asarray(v) for k, v in state_dict.items()
          if k.startswith(prefix)}
    params, stats = {}, {}
    for i in range(num_layers):
        src = f'layers.{i}'
        dst = (f'layer{i}',)
        for name in ('self_attn', 'cross_attn_text', 'cross_attn'):
            _torch_mha(params, dst + (name,), sd, f'{src}.{name}', num_heads)
        _torch_linear(params, dst + ('ffn_fc1',), sd,
                      f'{src}.ffn.layers.0.0')
        _torch_linear(params, dst + ('ffn_fc2',), sd, f'{src}.ffn.layers.1')
        for n in range(4):
            _torch_ln(params, dst + (f'norm{n}',), sd, f'{src}.norms.{n}')
    _posembed(params, stats, ('self_posembed',), sd, 'self_posembed')
    _posembed(params, stats, ('cross_posembed',), sd, 'cross_posembed')
    _torch_ln(params, ('decoder_norm',), sd, 'norm')
    return params, stats


def load_reference_grounder(model, torch_state_dict, mink_depth=34,
                            resnet_depth=50, num_layers=6, num_heads=8,
                            flip=False):
    """A reference grounding checkpoint onto the port's
    ``SparseFusionGrounder``: the 2D and 3D backbones (each optional),
    MinkNeck, RoBERTa (optional) and ``text_feat_map`` (the text
    projection ``text_encoder/Dense_0``), the decoder, and the shared head
    branches (``reg_branches.0.{0,2,4}`` -> ``reg_branch`` fc0 / fc1 /
    out, ``cls_branches.0.bias`` -> ``cls_embed``). Returns (model,
    n_loaded, skipped)."""
    sd = torch_state_dict
    loaded, skipped = 0, []

    def add(result):
        nonlocal loaded
        loaded += result[1]
        skipped.extend(result[2])

    if 'backbone.conv1.weight' in sd:
        add(load_resnet_into_variables(
            model,
            {k[len('backbone.'):]: v for k, v in sd.items()
             if k.startswith('backbone.')},
            depth=resnet_depth, prefix=('trunk', 'ResNet_0')))
    if 'backbone_3d.conv1.kernel' in sd:
        add(load_mink_resnet_into_variables(
            model, sd, depth=mink_depth, prefix=('trunk', 'MinkResNet_0'),
            src_prefix='backbone_3d.', flip=flip))
    np_, ns_ = convert_mink_neck(sd, flip=flip)
    add(_merge_into(model, np_, ns_, ('neck',)))
    if 'text_encoder.embeddings.word_embeddings.weight' in sd:
        add(load_roberta_into_variables(
            model, sd, prefix=('text_encoder', 'FlaxRobertaModule_0'),
            src_prefix='text_encoder.'))
    if 'text_feat_map.weight' in sd:
        tp = {}
        _torch_linear(tp, (), sd, 'text_feat_map')
        add(_merge_into(model, tp, {}, ('text_encoder', 'Dense_0')))
    dp, ds = convert_ground_decoder(sd, num_layers=num_layers,
                                    num_heads=num_heads)
    add(_merge_into(model, dp, ds, ()))
    hp = {}
    _torch_linear(hp, ('fc0',), sd, 'bbox_head.reg_branches.0.0')
    _torch_linear(hp, ('fc1',), sd, 'bbox_head.reg_branches.0.2')
    _torch_linear(hp, ('out',), sd, 'bbox_head.reg_branches.0.4')
    add(_merge_into(model, hp, {}, ('reg_branch',)))
    if 'bbox_head.cls_branches.0.bias' in sd:
        cp = {}
        _put(cp, ('bias',), sd['bbox_head.cls_branches.0.bias'].reshape(-1))
        add(_merge_into(model, cp, {}, ('cls_embed',)))
    return model, loaded, skipped


def load_reference_model(cfg, state_dict: Dict[str, np.ndarray],
                         flip: bool = False, device='cuda'):
    """``configs.base.build_model(cfg, device)`` with a reference
    checkpoint's weights (a numpy state_dict, as
    :func:`load_torch_checkpoint` gives it) in place of its random init:
    :func:`load_reference_detector` or :func:`load_reference_grounder` by
    ``cfg.model.task``. Raises on ``device='cuda'`` without a card.
    Returns (model, n_loaded, skipped)."""
    from ..configs.base import build_model
    model = build_model(cfg, device=device)
    m = cfg.model
    if m.task == 'mv_grounding':
        return load_reference_grounder(
            model, state_dict, mink_depth=m.mink_depth,
            resnet_depth=m.resnet_depth,
            num_layers=model.num_decoder_layers,
            num_heads=model.layer0.self_attn.query.heads, flip=flip)
    return load_reference_detector(model, state_dict,
                                   mink_depth=m.mink_depth,
                                   resnet_depth=m.resnet_depth, flip=flip)
