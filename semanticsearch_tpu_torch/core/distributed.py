"""Multi-process group initialization and the collectives across it.

Counterpart of ``semanticsearch_tpu/core/distributed.py``. Each process
drives all of its own devices (``core/mesh.py``); processes join one
``torch.distributed`` group: call :func:`initialize` once per process
before building the global mesh with :func:`global_mesh`. The sharded
top-k, the ring similarity and the device BM25's candidate merge cross the
process boundary through :func:`all_gather_rows` and :func:`ring_shift`
(NCCL on the card, gloo on the CPU).

A single-process run skips initialization entirely, so every code path
works unchanged in one process.

Start a multi-process run with ``torchrun`` (it sets ``MASTER_ADDR``,
``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK``) or call
``initialize("host:port", num_processes, process_id)`` in each process.
"""
from __future__ import annotations

import os
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from .logging import get_logger
from .mesh import (Mesh, MeshSpec, _device_array, _local_devices, local_rows,
                   make_mesh)

logger = get_logger("distributed")


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
) -> bool:
    """Join the process group; a no-op returning False for one process.

    Arguments default to torchrun's variables (``MASTER_ADDR`` and
    ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``). ``backend`` defaults to
    NCCL where a card is present, else gloo. Returns True when a
    multi-process group was joined."""
    if _joined():
        return True
    if coordinator_address is None and os.environ.get("MASTER_ADDR"):
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ.get('MASTER_PORT', '29500')}")
    num_processes = num_processes or _int_env("WORLD_SIZE")
    process_id = (process_id if process_id is not None
                  else _int_env("RANK"))
    if coordinator_address is None or not num_processes \
            or num_processes <= 1:
        return False  # single-process run
    if process_id is None:
        raise ValueError("a multi-process group needs each process's id "
                         "(process_id or RANK)")
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)
    logger.info("joined process group (%s): process %d of %d", backend,
                process_id, num_processes)
    return True


def _int_env(name: str) -> Optional[int]:
    val = os.environ.get(name)
    return int(val) if val is not None else None


def _joined() -> bool:
    return dist.is_available() and dist.is_initialized()


def global_mesh(spec: MeshSpec = MeshSpec(), n_slices: int = 0,
                local_devices: Optional[Sequence] = None) -> Mesh:
    """Mesh over every process's local devices, process-major (call after
    :func:`initialize`); each process must hold the same number. Devices
    are this process's cards under NCCL and its CPU under gloo, or
    ``local_devices`` (a list that may repeat a device, as in
    ``make_mesh``). ``n_slices`` > 0 gives a ("dcn", "data") mesh instead
    of ("data", "model"). Without a group it is the local mesh."""
    kind = "cuda" if torch.cuda.is_available() else "cpu"
    if _joined() and dist.get_backend() != "nccl":
        kind = "cpu"
    local = ([torch.device(d) for d in local_devices]
             if local_devices is not None else _local_devices(kind))
    if not _joined():
        if n_slices:
            from .mesh import hybrid_mesh

            return hybrid_mesh(n_slices, local)
        return make_mesh(spec, local)
    counts: List[Optional[int]] = [None] * dist.get_world_size()
    dist.all_gather_object(counts, len(local))
    if len(set(counts)) != 1:
        raise ValueError(f"processes hold different device counts: {counts}")
    world, rank = dist.get_world_size(), dist.get_rank()
    devices = [d for _ in range(world) for d in local]
    pids = np.repeat(np.arange(world), len(local))
    if n_slices:
        if len(devices) % n_slices:
            raise ValueError(f"{len(devices)} devices do not split into "
                             f"{n_slices} slices")
        shape, axes = (n_slices, len(devices) // n_slices), ("dcn", "data")
    else:
        shape, axes = spec.resolve(len(devices)), ("data", "model")
    return Mesh(_device_array(devices, shape), axes, group=dist.group.WORLD,
                process_ids=pids.reshape(shape), rank=rank)


def is_primary() -> bool:
    """True on the process that should write artifacts and logs."""
    return not _joined() or dist.get_rank() == 0


# -------------------------------------------------------------- collectives

def _comm_device(mesh: Mesh, fallback: torch.device) -> torch.device:
    """Where this process's side of a collective lives: its first card
    under NCCL, the CPU under gloo."""
    if dist.get_backend(mesh.group) == "nccl":
        return fallback if fallback.type == "cuda" else torch.device("cuda")
    return torch.device("cpu")


def all_gather_rows(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """Concatenate every process's ``x`` (the same shape everywhere) along
    dim 0 in process order; ``x`` itself inside one process. The result
    lands on ``x``'s device."""
    if mesh.group is None:
        return x
    dev = _comm_device(mesh, x.device)
    src = x.to(dev).contiguous()
    world = dist.get_world_size(mesh.group)
    out = torch.empty((world * src.shape[0], *src.shape[1:]),
                      dtype=src.dtype, device=dev)
    dist.all_gather_into_tensor(out, src, group=mesh.group)
    return out.to(x.device)


def ring_shift(mesh: Mesh, blocks: List[torch.Tensor],
               devices: List[torch.device]) -> List[torch.Tensor]:
    """One step of the ring over the row shards (``ppermute`` with shard
    i -> i + 1): ``blocks`` are this process's shards' blocks in shard
    order, ``devices`` where each shard lives; returns the block each
    shard holds next, copied onto its device. Across processes the last
    shard's block goes to the next process and the first shard's comes
    from the previous one."""
    if mesh.group is None:
        n = len(blocks)
        return [blocks[(j - 1) % n].to(devices[j], non_blocking=True)
                for j in range(n)]
    world = dist.get_world_size(mesh.group)
    rank = mesh.rank
    dev = _comm_device(mesh, devices[0])
    send = blocks[-1].to(dev).contiguous()
    recv = torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send, (rank + 1) % world, mesh.group),
           dist.P2POp(dist.irecv, recv, (rank - 1) % world, mesh.group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return ([recv.to(devices[0])]
            + [blocks[j - 1].to(devices[j], non_blocking=True)
               for j in range(1, len(blocks))])


def check_process_major(mesh: Mesh) -> None:
    """Collectives here need each process's row shards to be one
    contiguous block of the same size (a process-major global mesh)."""
    if mesh.group is None:
        return
    rows = local_rows(mesh)
    if not rows or rows != list(range(rows[0], rows[0] + len(rows))) \
            or rows[0] != mesh.rank * len(rows):
        raise ValueError("row shards are not process-major: build the mesh "
                         "with global_mesh")
