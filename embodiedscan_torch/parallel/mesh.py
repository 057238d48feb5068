"""This process's device, the replicated model, and the ``(data, view)``
grid of processes (port of ``embodiedscan_tpu/parallel/mesh.py``).

The reference shards a batch over a ``data`` mesh axis and replicates the
model state; here each process of a ``torch.distributed`` group drives one
card, reads its own batch rows, and starts from rank 0's parameters and
buffers. With ``view_parallel=k`` the processes form a ``(data, view)``
grid, laid out as the reference's ``devices.reshape(n // k, k)``: the k
processes of a row share the same batch rows and each holds a contiguous
block of their views (``imgs``, ``proj``, ``view_mask``). What XLA inserts
for the reference is code here:

- the fusion's sum and count over views (``models/fusion.py``, also under
  the occupancy model's image volume) are summed over the row's processes
  (:func:`view_sum`); the backward of that sum is the identity, since
  everything after it is computed alike on every process of the row;
- each process's 2D branch (upstream of that sum: the ``view_branch``
  that each module with a ``view_group`` names) then holds the gradient
  of its own views: ``train.state.train_step``
  sums those gradients over the row, then averages every gradient, the
  norms' statistics and the losses over the column (the ``data`` axis)
  alone. The 2D branch's norms are frozen, so they need no sync.
"""

import os
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from ..ops.sparse import drop_bf16_weights

DATA_AXIS = 'data'
VIEW_AXIS = 'view'
# batch keys laid out (B, V, ...): these shard over the view axis as well
_VIEW_KEYS = ('imgs', 'proj', 'view_mask')


def process_device(device='cuda') -> torch.device:
    """This process's device: for CUDA, the card ``LOCAL_RANK`` (else the
    group rank modulo the cards present, else card 0), made current with
    ``torch.cuda.set_device`` (NCCL's collectives and ``all_gather_object``
    use the current card); the CPU as given. Raises when CUDA is asked
    for and absent."""
    device = torch.device(device)
    if device.type != 'cuda':
        return device
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           'on the CPU')
    if device.index is None:
        if 'LOCAL_RANK' in os.environ:
            index = int(os.environ['LOCAL_RANK'])
        elif dist.is_initialized():
            index = dist.get_rank() % torch.cuda.device_count()
        else:
            index = 0
        device = torch.device('cuda', index)
    torch.cuda.set_device(device)
    return device


@torch.no_grad()
def replicate(model: torch.nn.Module) -> torch.nn.Module:
    """Broadcasts rank 0's parameters and buffers to every process of the
    group (nothing to do outside one). A broadcast writes the tensors'
    memory without bumping their version counters, so the bf16 route's
    weight copies are dropped after it."""
    if dist.is_initialized():
        for t in model.state_dict().values():
            dist.broadcast(t, 0)
        drop_bf16_weights()
    return model


class Mesh(NamedTuple):
    """A ``(data, view)`` grid of ranks (``grid[i, j]`` is the rank at data
    index i, view index j), this process's ``rank``, and its process
    groups along each axis: ``data_group`` (the ranks of its column) and
    ``view_group`` (of its row); ``None`` stands for the default group, or
    for no group outside ``torch.distributed``."""
    grid: np.ndarray
    rank: int
    data_group: object = None
    view_group: object = None

    @property
    def axis_names(self) -> tuple:
        return (DATA_AXIS,) if self.grid.shape[1] == 1 else (DATA_AXIS,
                                                             VIEW_AXIS)

    @property
    def shape(self) -> dict:
        return dict(zip((DATA_AXIS, VIEW_AXIS), self.grid.shape))

    def coords(self) -> tuple:
        """(data index, view index) of this process's rank."""
        i, j = np.argwhere(self.grid == self.rank)[0]
        return int(i), int(j)


def make_mesh(world: int | None = None, view_parallel: int = 1) -> Mesh:
    """The grid of ``world`` ranks (default: the process group's size, else
    1): ``(data,)`` for ``view_parallel=1``, else ``(world // k, k)``, with
    this process's rank (the group's, else 0). Inside a process group every
    rank must call this alike: with ``view_parallel=k > 1`` it creates one
    group per row and per column (with ``k=1`` the data axis is the
    default group). Raises for more than one rank unless the process group
    holds exactly ``world`` ranks: its groups are what sum the views and
    average the rows."""
    group_world = dist.get_world_size() if dist.is_initialized() else 1
    if world is None:
        world = group_world
    k = max(1, view_parallel)
    if world % k:
        raise ValueError(f'{world} processes not divisible by '
                         f'view_parallel={k}')
    if world != group_world:
        raise RuntimeError(f'a mesh of {world} ranks needs a process group '
                           f'of {world}, not of {group_world}')
    rank = dist.get_rank() if dist.is_initialized() else 0
    grid = np.arange(world).reshape(world // k, k)
    data_group = view_group = None
    if k > 1:
        for j in range(k):
            g = dist.new_group(grid[:, j].tolist())
            if rank in grid[:, j]:
                data_group = g
        for i in range(world // k):
            g = dist.new_group(grid[i].tolist())
            if rank in grid[i]:
                view_group = g
    return Mesh(grid, rank, data_group, view_group)


class Sharding(NamedTuple):
    """How a batch entry lies over a mesh: ``spec`` names the mesh axis
    that splits each leading dimension (as a ``PartitionSpec``)."""
    mesh: Mesh
    spec: tuple

    def index(self, shape) -> tuple:
        """The slices of an array of ``shape`` that the mesh's rank holds:
        contiguous equal blocks along each sharded dimension, the rest
        whole."""
        at = dict(zip((DATA_AXIS, VIEW_AXIS), self.mesh.coords()))
        out = []
        for dim, size in enumerate(shape):
            axis = self.spec[dim] if dim < len(self.spec) else None
            if axis is None:
                out.append(slice(None))
                continue
            n = self.mesh.shape[axis]
            if size % n:
                raise ValueError(f'dimension {dim} of {tuple(shape)} does '
                                 f'not split over {n} {axis} shards')
            block = size // n
            out.append(slice(at[axis] * block, (at[axis] + 1) * block))
        return tuple(out)


def batch_sharding(mesh: Mesh, key: str | None = None) -> Sharding:
    """One batch entry's sharding: rows over ``data``; with a view axis,
    the per-view entries (``imgs``, ``proj``, ``view_mask``) also their
    views over ``view``, and the others whole on every process of a
    row."""
    if VIEW_AXIS in mesh.axis_names and (key is None or key in _VIEW_KEYS):
        return Sharding(mesh, (DATA_AXIS, VIEW_AXIS))
    return Sharding(mesh, (DATA_AXIS,))


def batch_shardings(mesh: Mesh, batch: dict) -> dict:
    return {k: batch_sharding(mesh, k) for k in batch}


def shard_batch(mesh: Mesh, batch: dict) -> dict:
    """This process's part of a whole batch of (B, ...) arrays or
    tensors."""
    return {k: v[batch_sharding(mesh, k).index(v.shape)]
            for k, v in batch.items()}


class _ViewSum(torch.autograd.Function):
    """The sum over a row's processes; its backward is the identity (what
    follows the sum is replicated over the row, so each process's
    gradient of the sum is already the whole gradient of its part)."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def view_sum(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over the view group ``group`` (a mesh's
    ``view_group``); ``x`` itself for no group."""
    if group is None:
        return x
    return _ViewSum.apply(x, group)


def use_mesh(model: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """Points every module of ``model`` that reduces over views (those
    with a ``view_group``: the detectors' trunk, the occupancy model) at
    ``mesh``'s view group."""
    for mod in model.modules():
        if hasattr(mod, 'view_group'):
            mod.view_group = mesh.view_group
    return model
