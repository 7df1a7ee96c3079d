"""Device meshes for single- and multi-device runs.

Counterpart of ``semanticsearch_tpu/core/mesh.py``. As in the JAX package,
one process drives every device of its mesh (a single controller): a
:class:`Mesh` is an array of ``torch.device`` with named axes, and code that
takes a mesh issues each device's work itself and moves data between
devices with explicit copies (``tensor.to(device, non_blocking=True)``, a
peer copy over NVLink between cards of one host). Across processes, each
process drives its own devices and the mesh carries the
``torch.distributed`` group that joins them (``core/distributed.py``).

Axes convention (the JAX package's):
  - ``data``  : batch / corpus-shard axis (pure data parallel; the default)
  - ``model`` : tensor-parallel axis (``parallel/tensor.py``)
  - ``dcn``   : the outer axis of a two-level mesh (:func:`hybrid_mesh`)

A device list may repeat a device: ``make_mesh(MeshSpec(data=4),
devices=[torch.device("cpu")] * 4)`` lays four shards on one CPU, and four
on one card the same way. That is the counterpart of the JAX tests' forced
host device count: every sharded code path (per-shard launches, global row
ids, pad masking, the merges) runs on one device as it would on four.

Row-sharding (``P(axes, None)`` in the JAX package) puts one tensor per
row-shard position, in the axes-major order of the row axes: ("dcn",
"data") on a hybrid mesh, else ("data",). A row shard lives on the first
device of its ``model`` row.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch


@dataclass(frozen=True)
class MeshSpec:
    """Logical mesh shape over the available devices."""

    data: int = -1   # -1 = all remaining devices
    model: int = 1

    def resolve(self, n_devices: int) -> Tuple[int, int]:
        model = max(1, self.model)
        data = self.data if self.data > 0 else max(1, n_devices // model)
        if data * model != n_devices:
            raise ValueError(
                f"mesh {data}x{model} does not cover {n_devices} devices"
            )
        return data, model


class Mesh:
    """Named axes over an object array of ``torch.device``.

    ``shape`` reads like the JAX mesh's (``mesh.shape["data"]``).
    ``process_ids`` (same shape as ``devices``) names the process that
    drives each position; ``group`` is the ``torch.distributed`` group
    joining those processes, ``None`` when the mesh lies inside this
    process. Equal meshes hash equally, so caches keyed on a mesh (the
    encoder cache) find it again."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str],
                 group=None, process_ids: Optional[np.ndarray] = None,
                 rank: int = 0) -> None:
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-d device array for axes "
                             f"{tuple(axis_names)}")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, devices.shape))
        self.group = group
        self.process_ids = (np.zeros(devices.shape, np.int64)
                            if process_ids is None else process_ids)
        self.rank = rank  # this process's id in ``group``

    def _key(self):
        return (tuple(str(d) for d in self.devices.flat), self.axis_names,
                self.devices.shape, tuple(self.process_ids.flat), self.rank,
                id(self.group))

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and self._key() == other._key()

    def __hash__(self) -> int:
        return hash(self._key())

    def __repr__(self) -> str:
        return (f"Mesh({dict(self.shape)}, "
                f"devices={[str(d) for d in self.devices.flat]})")


def make_mesh(spec: MeshSpec = MeshSpec(),
              devices: Optional[Sequence] = None) -> Mesh:
    """A ("data", "model") mesh over ``devices`` (default: every local
    card, else the CPU); a device may appear more than once."""
    devices = ([torch.device(d) for d in devices] if devices is not None
               else _local_devices("cuda" if torch.cuda.is_available()
                                   else "cpu"))
    data, model = spec.resolve(len(devices))
    return Mesh(_device_array(devices, (data, model)), ("data", "model"))


def _device_array(devices: Sequence[torch.device], shape) -> np.ndarray:
    arr = np.empty(len(devices), dtype=object)
    for i, d in enumerate(devices):
        arr[i] = d
    return arr.reshape(shape)


def _local_devices(device="cuda") -> List[torch.device]:
    """Every local device of ``device``'s kind; a device with an index
    (``"cuda:1"``) is that device alone."""
    device = torch.device(device)
    if device.type != "cuda":
        return [torch.device(device.type)]
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu'")
    if device.index is not None:
        return [device]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def local_mesh(device="cuda") -> Mesh:
    """Every local device of ``device``'s kind on the data axis: all the
    cards of this host, or the one CPU (``"cuda:1"``: that card alone)."""
    return make_mesh(MeshSpec(data=-1, model=1), _local_devices(device))


def hybrid_mesh(n_slices: int, devices: Optional[Sequence] = None) -> Mesh:
    """Two-level mesh ("dcn", "data"): the outer ``dcn`` axis crosses slow
    links (hosts), the inner ``data`` axis stays on fast ones. The device
    list is taken in order, slice-major."""
    devices = ([torch.device(d) for d in devices] if devices is not None
               else _local_devices("cuda" if torch.cuda.is_available()
                                   else "cpu"))
    if len(devices) % n_slices:
        raise ValueError(
            f"{len(devices)} devices do not split into {n_slices} slices"
        )
    return Mesh(_device_array(devices, (n_slices, len(devices) // n_slices)),
                ("dcn", "data"))


# ---------------------------------------------------------------- positions

def row_axes(mesh: Mesh) -> Tuple[str, ...]:
    """Row-sharding axes: ("dcn", "data") on a hybrid mesh, else
    ("data",)."""
    return ("dcn", "data") if "dcn" in mesh.axis_names else ("data",)


def n_row_shards(mesh: Mesh) -> int:
    n = 1
    for ax in row_axes(mesh):
        n *= mesh.shape[ax]
    return n


def _row_positions(mesh: Mesh) -> List[Tuple[int, ...]]:
    """Device-array index of every row shard, in row order (the first
    device of each ``model`` row)."""
    axes = row_axes(mesh)
    sizes = [mesh.shape[a] for a in axes]
    out = []
    for flat in range(int(np.prod(sizes))):
        coord = dict(zip(axes, np.unravel_index(flat, sizes)))
        out.append(tuple(int(coord.get(a, 0)) for a in mesh.axis_names))
    return out


def row_devices(mesh: Mesh) -> List[torch.device]:
    """The device of every row shard, in row order (this process's and
    the others')."""
    return [mesh.devices[p] for p in _row_positions(mesh)]


def local_rows(mesh: Mesh) -> List[int]:
    """Row-shard numbers this process drives, ascending: every shard
    inside one process; a contiguous block across processes (global
    meshes are process-major)."""
    return [i for i, p in enumerate(_row_positions(mesh))
            if mesh.process_ids[p] == mesh.rank]


def local_row_devices(mesh: Mesh) -> List[torch.device]:
    rows = row_devices(mesh)
    return [rows[i] for i in local_rows(mesh)]


def split_bounds(n_rows: int, n_parts: int) -> List[int]:
    """The n_parts + 1 row offsets of ``tensor_split(n_parts)`` over
    ``n_rows`` rows: the first ``n_rows % n_parts`` parts take one row
    more."""
    q, r = divmod(n_rows, n_parts)
    return [i * q + min(i, r) for i in range(n_parts + 1)]
