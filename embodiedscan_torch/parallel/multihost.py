"""Multi-process runtime over ``torch.distributed`` (port of
``embodiedscan_tpu/parallel/multihost.py``).

One process drives one card. A launcher (``torchrun``, or any that sets
``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
``MASTER_PORT``) starts one process per card; :func:`init_distributed` joins
them into one process group (NCCL between cards, gloo on the CPU). The
loaders read this process's shard of the scan list (``data/dataset.py``),
the train step averages gradients, the norms' statistics and the losses
over the group (``train.state.train_step``), and evaluation gathers
the per-process records with :func:`gather_objects`. Without a process
group every function here answers for one process of rank 0.
"""

import os

import torch
import torch.distributed as dist

_ENV = ('RANK', 'WORLD_SIZE', 'MASTER_ADDR', 'MASTER_PORT')


def init_distributed(device='cuda', init_method: str | None = None,
                     world_size: int | None = None,
                     rank: int | None = None) -> bool:
    """Joins the process group when a launcher's environment (or explicit
    ``init_method``, ``world_size`` and ``rank``) names one: NCCL for a
    CUDA ``device``, once this process's card is current
    (``mesh.process_device``), gloo for the CPU. Returns True when more than one
    process takes part, False for one process (a one-rank group is still
    joined, so its collectives run). Idempotent."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    if init_method is None and not all(k in os.environ for k in _ENV):
        return False
    device = torch.device(device)
    if device.type == 'cuda':
        from .mesh import process_device
        process_device(device)
        backend = 'nccl'
    else:
        backend = 'gloo'
    dist.init_process_group(backend, init_method=init_method or 'env://',
                            world_size=-1 if world_size is None
                            else world_size,
                            rank=-1 if rank is None else rank)
    return dist.get_world_size() > 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_shard(n_items: int) -> range:
    """The indices of a list of ``n_items`` that this process owns."""
    return range(process_index(), n_items, process_count())


def local_device_count() -> int:
    """Devices this process drives: one card (or the CPU)."""
    return 1


def global_batch_size(per_process_batch: int) -> int:
    return per_process_batch * process_count()


def is_main_process() -> bool:
    """Checkpoint, metrics-file and visualization gating."""
    return process_index() == 0


def _comm_device() -> torch.device:
    """Where this group's collectives take their tensors."""
    if dist.get_backend() == 'nccl':
        return torch.device('cuda', torch.cuda.current_device())
    return torch.device('cpu')


def gather_objects(objs: list) -> list:
    """Every process's list, concatenated in rank order, on every process
    (the reference's ``collect_results``). Under NCCL the current CUDA
    device must be this process's card (``init_distributed`` sets it)."""
    if process_count() == 1:
        return list(objs)
    parts = [None] * process_count()
    dist.all_gather_object(parts, list(objs))
    return [x for part in parts for x in part]


def psum_(tensors, group=None) -> None:
    """Replaces each tensor by its sum over the processes of ``group``
    (default: all), in place: one flat all-reduce per dtype. Nothing to do
    for one process outside a group."""
    if not dist.is_initialized():
        return
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.all_reduce(flat, group=group)
        offset = 0
        for t in ts:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


def pmean_(tensors, group=None) -> None:
    """Replaces each tensor by its mean over the processes of ``group``
    (default: all), in place: :func:`psum_`, then a division by the
    group's size (as ``jax.lax.pmean``)."""
    if not dist.is_initialized():
        return
    psum_(tensors, group)
    world = dist.get_world_size(group)
    for t in tensors:
        t.div_(world)


def all_processes_scalar(x) -> float:
    """The mean of a host scalar over the processes."""
    if process_count() == 1:
        return float(x)
    t = torch.tensor([float(x)], dtype=torch.float32, device=_comm_device())
    pmean_([t])
    return float(t)
