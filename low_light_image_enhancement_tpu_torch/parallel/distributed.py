"""Parallelism across processes on ``torch.distributed``.

Each process drives its own mesh (``parallel.sharding.make_mesh``). For
training the process group joins them on the ``data`` axis: a train step
made with a mesh (``train.make_train_step(tcfg, mesh)``) all-reduces its
gradients and metrics over the group when one is initialized, so every
process holds the same parameters and loss. For inference a mesh's
``spatial`` axis may span the group (``make_mesh`` with P times the
process's devices): ``enhance_spatial_sharded`` then takes and returns
each process's rows, the halos at the seams crossing the group.

Launch one process a card with ``torchrun --nproc-per-node N script.py``;
``initialize_distributed()`` then reads its rank, world size and
coordinator from the environment that ``torchrun`` sets.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from low_light_image_enhancement_tpu_torch.parallel.sharding import Mesh

__all__ = ["initialize_distributed", "global_batch_from_local",
           "process_group_size"]


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device="cuda",
    backend: Optional[str] = None,
) -> None:
    """Join the process group: ``nccl`` when the process's devices are
    CUDA (``device``), ``gloo`` on the CPU, or the ``backend`` given
    (gloo between processes that share one card, where NCCL refuses two
    ranks on one device; it sends host copies).

    ``coordinator_address`` is ``host:port`` (a TCP rendezvous) or an
    ``init_method`` URL such as ``file:///path``; omitted, the group reads
    ``MASTER_ADDR``/``MASTER_PORT`` from the environment. ``num_processes``
    and ``process_id`` default to ``WORLD_SIZE`` and ``RANK``. On CUDA the
    process takes the card ``LOCAL_RANK`` names (default: its rank modulo
    the cards there are)."""
    import torch.distributed as dist

    device = torch.device(device)
    if num_processes is None:
        num_processes = int(os.environ.get("WORLD_SIZE", "1"))
    if process_id is None:
        process_id = int(os.environ.get("RANK", "0"))
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("initialize_distributed(device='cuda'): CUDA "
                               "is not available")
        local = int(os.environ.get("LOCAL_RANK",
                                   process_id % torch.cuda.device_count()))
        torch.cuda.set_device(local)
        backend = backend or "nccl"
    elif device.type == "cpu":
        backend = backend or "gloo"
    else:
        raise ValueError(f"device must be cuda or cpu: {device!r}")
    dist.init_process_group(backend, init_method=init_method,
                            world_size=num_processes, rank=process_id)


def process_group_size() -> int:
    """The number of processes in the initialized group; 0 when there is
    none."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 0


def global_batch_from_local(mesh: Mesh, local_batch) -> torch.Tensor:
    """This process's part of the global batch (every process loads only
    its own slice) as a tensor on its mesh's first device: the step made
    with the mesh splits it over the mesh and all-reduces over the process
    group."""
    return torch.as_tensor(np.asarray(local_batch)).to(mesh.home)
