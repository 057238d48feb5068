"""This process's device and the replicated model (port of the 1D data
mesh of ``embodiedscan_tpu/parallel/mesh.py``).

The reference shards a batch over a ``data`` mesh axis and replicates the
model state; here each process of a ``torch.distributed`` group drives one
card, reads its own batch rows, and starts from rank 0's parameters and
buffers. The reference's ``(data, view)`` axis (views sharded over
devices) is not ported.
"""

import os

import torch
import torch.distributed as dist


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
    group (nothing to do outside one)."""
    if dist.is_initialized():
        for t in model.state_dict().values():
            dist.broadcast(t, 0)
    return model
