"""Multi-process group initialization and the collectives across it.

Counterpart of ``semanticsearch_tpu/core/distributed.py``. Each process
drives all of its own devices (``core/mesh.py``); processes join one
``torch.distributed`` group: call :func:`initialize` once per process
before building the global mesh with :func:`global_mesh`. The sharded
top-k, the ring similarity and the device BM25's candidate merge cross the
process boundary through :func:`all_gather_rows` and :func:`ring_shift`
(NCCL on the card, gloo on the CPU); data-parallel training through the
differentiable :func:`gather_rows` and the one-bucket gradient sum
:func:`all_reduce_flat`.

A single-process run skips initialization entirely, so every code path
works unchanged in one process.

Start a multi-process run with ``torchrun`` (it sets ``MASTER_ADDR``,
``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK``) or call
``initialize("host:port", num_processes, process_id)`` in each process.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

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


class _GatherRows(torch.autograd.Function):
    """:func:`all_gather_rows` with a gradient. Every process computes the
    same loss from the same gathered rows, so the gradient on the gathered
    tensor is the same everywhere: each process takes back its own rows'
    slice of it, and the processes' parameter gradients sum
    (:func:`all_reduce_flat`) to the gradient of the one loss."""

    @staticmethod
    def forward(ctx, x, mesh, counts):
        ctx.lo, ctx.n = sum(counts[:mesh.rank]), counts[mesh.rank]
        most = max(counts)
        if x.shape[0] < most:  # one shape everywhere for the collective
            x = torch.cat([x, x.new_zeros((most - x.shape[0],
                                           *x.shape[1:]))])
        out = all_gather_rows(mesh, x)
        if min(counts) == most:
            return out
        return torch.cat([out[p * most: p * most + c]
                          for p, c in enumerate(counts)])

    @staticmethod
    def backward(ctx, grad):
        return grad[ctx.lo: ctx.lo + ctx.n], None, None


def gather_rows(mesh: Mesh, x: torch.Tensor,
                counts: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Differentiable :func:`all_gather_rows`: every process's ``x`` along
    dim 0 in process order, ``counts[p]`` rows from process p (the same
    count everywhere when None; uneven blocks are padded for the
    collective and trimmed after it). Its backward returns this process's
    rows of the incoming gradient, which is exact when every process
    computes the same loss from the result. ``x`` itself inside one
    process."""
    if mesh.group is None:
        return x
    counts = (list(counts) if counts is not None
              else [x.shape[0]] * dist.get_world_size(mesh.group))
    if x.shape[0] != counts[mesh.rank]:
        raise ValueError(f"process {mesh.rank} holds {x.shape[0]} rows, "
                         f"not {counts[mesh.rank]}")
    return _GatherRows.apply(x, mesh, counts)


def all_reduce_flat(mesh: Mesh, tensors: Sequence[torch.Tensor]) -> None:
    """Sum each of ``tensors`` over the processes, in place, in one
    collective: the tensors (one dtype, one device) are flattened into one
    bucket, staged through the host under gloo and kept on the card under
    NCCL. A no-op inside one process."""
    if mesh.group is None or not tensors:
        return
    if len({t.dtype for t in tensors}) != 1:
        raise ValueError("all_reduce_flat takes tensors of one dtype")
    home = tensors[0].device
    with torch.no_grad():
        flat = torch.cat([t.reshape(-1) for t in tensors])
        flat = flat.to(_comm_device(mesh, home))
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=mesh.group)
        flat = flat.to(home)
        off = 0
        for t in tensors:
            t.copy_(flat[off: off + t.numel()].view_as(t))
            off += t.numel()


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
    # P2P peers are global ranks; the group may be a slice's subgroup
    nxt = dist.get_global_rank(mesh.group, (rank + 1) % world)
    prv = dist.get_global_rank(mesh.group, (rank - 1) % world)
    ops = [dist.P2POp(dist.isend, send, nxt, mesh.group),
           dist.P2POp(dist.irecv, recv, prv, mesh.group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return ([recv.to(devices[0])]
            + [blocks[j - 1].to(devices[j], non_blocking=True)
               for j in range(1, len(blocks))])


# the subgroups of a hybrid mesh's multi-process dcn slices, by mesh
_SLICE_GROUPS: Dict[Mesh, object] = {}


def slice_group(mesh: Mesh, s: int) -> Tuple[object, np.ndarray, int]:
    """(group, process ids, this process's rank) for collectives that stay
    inside ``dcn`` slice ``s`` of a hybrid mesh: no group when one process
    drives the whole slice; else the slice's own subgroup, with the slice's
    process ids renumbered to ranks in it. The subgroups of every
    multi-process slice are made once per mesh, by all of its processes
    together (``new_subgroups_by_enumeration``): call this collectively.

    Raises ``NotImplementedError`` when a process drives devices of a
    multi-process slice and of another slice: it would have to ring in
    both."""
    pids = mesh.process_ids[s]
    if mesh.group is None:
        return None, np.zeros_like(pids), 0
    slices = [sorted({int(p) for p in mesh.process_ids[i].flat})
              for i in range(mesh.shape["dcn"])]
    shared = [ps for ps in slices if len(ps) > 1]
    for ps in shared:
        if sum(p in other for other in slices for p in ps) != len(ps):
            raise NotImplementedError(
                f"a process drives devices of a multi-process dcn slice "
                f"{ps} and of another slice")
    if shared and mesh not in _SLICE_GROUPS:
        ranks = dist.get_process_group_ranks(mesh.group)
        unique = sorted({tuple(ps) for ps in shared})
        _SLICE_GROUPS[mesh], _ = dist.new_subgroups_by_enumeration(
            [[ranks[p] for p in ps] for ps in unique])
    mine = slices[s]
    if len(mine) == 1:
        return None, np.zeros_like(pids), 0
    renum = {p: i for i, p in enumerate(mine)}
    return (_SLICE_GROUPS[mesh],
            np.vectorize(renum.__getitem__, otypes=[np.int64])(pids),
            renum[mesh.rank])


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
