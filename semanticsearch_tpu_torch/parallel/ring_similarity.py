"""Ring-exchange similarity matrix for sentence axes larger than one device.

Counterpart of ``semanticsearch_tpu/parallel/ring_similarity.py``. The
sentence axis is sharded over the mesh ``data`` axis and the (N, N) matrix
is computed in tiles with a ring exchange of the embedding blocks: at step
s every shard holds the block of shard (i - s) mod P, computes one
(n_local x n_local) tile against its own rows, and passes the block to the
next shard (a peer copy inside a process, ``batch_isend_irecv`` across
processes). Every shard ends with its row block of the full matrix.

On a hybrid ("dcn", "data") mesh the ring runs over ``data`` only, inside
one ``dcn`` slice, and ``dcn`` stays replicated, as the JAX ring's
``shard_map(in_specs=P("data", None))`` leaves it (:func:`ring_mesh`). No
row crosses ``dcn``. Each process rings within the slice that holds its
first row device, so the slices compute the same matrix side by side:
the result is the one a ("data",) mesh gives, only the work is repeated
once a slice.

The tile is a plain float32 product with TF32 off, the counterpart of the
JAX tile's ``einsum(..., precision=HIGHEST)``: it is the cross product of
two different blocks, which the Gram kernel (``csrc/similarity.cu``, E·Eᵀ
as a mirrored triangle) does not compute.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import List

import numpy as np
import torch

from ..core.distributed import all_gather_rows, ring_shift, slice_group
from ..core.mesh import Mesh, local_row_devices, local_rows
from .sharding import shard_corpus


@contextmanager
def _full_f32():
    """float32 products without TF32 on the card, restored after."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def ring_mesh(mesh: Mesh) -> Mesh:
    """The ("data", "model") mesh the ring runs over: ``mesh`` itself, or
    on a hybrid ("dcn", "data") mesh the ``dcn`` slice that holds this
    process's first row device, as a (data, 1) mesh of that slice's
    devices. A slice inside this process needs no process group; a slice
    of several processes rings over their group
    (``core.distributed.slice_group``)."""
    if "dcn" not in mesh.axis_names:
        return mesh
    s = local_rows(mesh)[0] // mesh.shape["data"]
    devices = mesh.devices[s].reshape(-1, 1)
    group, pids, rank = slice_group(mesh, s)
    return Mesh(devices, ("data", "model"), group=group,
                process_ids=pids.reshape(-1, 1), rank=rank)


def ring_similarity_matrix(emb_sharded: List[torch.Tensor], mesh: Mesh
                           ) -> List[torch.Tensor]:
    """This process's (n_local, N) float32 row blocks of E·Eᵀ, one per
    shard of ``emb_sharded``, each on its shard's device. Embeddings should
    be L2-normalized (dot == cosine).

    ``emb_sharded`` is ``shard_corpus(E, ring_mesh(mesh))``: on a hybrid
    mesh, the ``data`` shards of this process's ``dcn`` slice, and the
    blocks returned are that slice's rows (``N`` = ``data`` x n_local)."""
    mesh = ring_mesh(mesh)
    n_dev = mesh.shape["data"]
    devices = local_row_devices(mesh)
    mine = local_rows(mesh)
    n_local = emb_sharded[0].shape[0]
    n_total = n_local * n_dev
    own = [e.float() for e in emb_sharded]
    out = [torch.zeros((n_local, n_total), dtype=torch.float32, device=d)
           for d in devices]
    blocks = own
    with _full_f32():
        for s in range(n_dev):
            for j, i in enumerate(mine):
                src = (i - s) % n_dev
                out[j][:, src * n_local: (src + 1) * n_local] = \
                    own[j] @ blocks[j].T
            if s + 1 < n_dev:
                blocks = ring_shift(mesh, blocks, devices)
    return out


def sharded_doc_similarity(embeddings, mesh: Mesh) -> np.ndarray:
    """One long document's (n, n) float32 similarity matrix on the host,
    through the ring, padded to the device count and cropped back.

    The chunking pipeline takes this route for grouping documents of at
    least ``sp_min_sentences`` sentences on a multi-device mesh. On a
    hybrid mesh every ``dcn`` slice computes the whole matrix
    (:func:`ring_mesh`); every process returns the same one."""
    mesh = ring_mesh(mesh)
    emb = torch.as_tensor(embeddings).float()
    n = emb.shape[0]
    pad = (-n) % mesh.shape["data"]
    if pad:
        emb = torch.cat([emb, emb.new_zeros((pad, emb.shape[1]))])
    rows = ring_similarity_matrix(shard_corpus(emb, mesh), mesh)
    S = all_gather_rows(mesh, torch.cat([r.cpu() for r in rows]))
    return S.numpy()[:n, :n]
