"""Sharded exact top-k over a corpus row-sharded on a device mesh.

Counterpart of ``semanticsearch_tpu/parallel/sharding.py``. The corpus
embedding matrix lives row-sharded over the mesh's row axes (one tensor a
shard, ``core/mesh.py``). A query batch is copied to every shard's device;
each shard runs the single-device search on its rows (the hand-written
kernels on a card); the per-shard candidates (score, global id) are
gathered and re-selected, axis by axis from the minor one to the major one.
Communication is O(shards * Q * k), never the corpus.

Every shard's search is issued before any gather waits on it: launches are
asynchronous, and the copies of the candidate lists queue behind them.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from ..core.distributed import all_gather_rows, check_process_major
from ..core.mesh import (Mesh, local_row_devices, local_rows, n_row_shards,
                         row_axes)
from ..ops.topk import (
    _LANE,
    _top_sorted,
    swizzle_corpus,
    topk_scores_chunked,
    topk_scores_fused,
    topk_scores_twopass,
)

# k_local >= 128 takes the column-chunked search up to this many queries,
# the fused kernel above (the single-device engine's rule,
# ``index/engine.py``)
CHUNKED_MAX_QUERIES = 8192

Shards = List[torch.Tensor]


def shard_corpus(emb, mesh: Mesh) -> Shards:
    """This process's row shards of an (N, D) matrix (host or device), each
    on its shard's device, in row order (dcn-major on a hybrid mesh).

    N must be divisible by the shard count; pad with zero rows first
    (:func:`pad_to_shards`) and pass the true row count as ``valid_n`` to
    :func:`sharded_topk` (zero pad rows score 0, which can BEAT real
    candidates with negative cosine, so they are masked, never assumed to
    lose)."""
    emb = torch.as_tensor(emb)
    n = n_row_shards(mesh)
    if emb.shape[0] % n:
        raise ValueError(f"{emb.shape[0]} rows do not split into {n} shards")
    rows = emb.shape[0] // n
    return [emb[i * rows: (i + 1) * rows].to(dev, non_blocking=True)
            for i, dev in zip(local_rows(mesh), local_row_devices(mesh))]


def pad_to_shards(emb, mesh: Mesh, align: int = 1) -> Tuple[torch.Tensor, int]:
    """Zero-pad to a multiple of the shard count (times ``align`` when >
    1); returns (padded, true row count).

    Keep ``align`` at 1: pad rows score 0.0 and make every shard
    over-select ``k + n_pad`` local candidates for exactness, so n_pad must
    stay below the shard count. Each shard's two-pass search pads and masks
    its own segments."""
    emb = torch.as_tensor(emb)
    step = n_row_shards(mesh) * max(1, align)
    n = emb.shape[0]
    pad = (-n) % step
    if pad:
        emb = torch.cat([emb, emb.new_zeros((pad, *emb.shape[1:]))])
    return emb, n


def swizzle_corpus_sharded(corpus_sharded: Shards, mesh: Mesh,
                           block_n: int = 8192) -> Shards:
    """Each shard's own pass-A layout (``ops.topk.swizzle_corpus``, padded
    to a ``block_n`` multiple), on its device, for
    ``sharded_topk(..., corpus_swizzled_sharded=...)``. The Hopper pass A
    reads the natural row layout, so the search only checks its padding;
    the layout stays for callers that hold it."""
    del mesh
    return [swizzle_corpus(c, block_n) for c in corpus_sharded]


def merge_candidates(mesh: Mesh, vals: torch.Tensor, idx: torch.Tensor,
                     k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Re-select this process's stacked shard candidates ``vals``/``idx``
    (n_local, Q, k_in) down to one (Q, k) list, merging axis by axis from
    the minor row axis to the major one: a group of shards that lies in
    this process merges here; the first axis whose groups cross processes
    gathers everything over the group first. Each merge concatenates the
    lists in shard order and keeps a stable top-k, so among equal scores
    the earlier shard's candidate wins, as ``lax.top_k`` gives. The
    two-level merge equals the flat one bit for bit."""
    check_process_major(mesh)
    gathered = mesh.group is None
    q = vals.shape[1]
    for size in reversed([mesh.shape[a] for a in row_axes(mesh)]):
        cnt = vals.shape[0]
        if not gathered and (cnt < size or cnt % size):
            vals = all_gather_rows(mesh, vals)
            idx = all_gather_rows(mesh, idx)
            gathered = True
            cnt = vals.shape[0]
        g, kin = cnt // size, vals.shape[2]
        v = vals.reshape(g, size, q, kin).permute(0, 2, 1, 3) \
            .reshape(g * q, size * kin)
        i = idx.reshape(g, size, q, kin).permute(0, 2, 1, 3) \
            .reshape(g * q, size * kin)
        v, sel = _top_sorted(v, k)
        vals = v.reshape(g, q, k)
        idx = torch.gather(i, 1, sel).reshape(g, q, k)
    if not gathered:  # every axis merged inside this process
        vals = all_gather_rows(mesh, vals)
        idx = all_gather_rows(mesh, idx)
    return vals[0], idx[0]


def _shard_search(q, c_local, k_local, swizzled, block_n, seg_split):
    """One shard's single-device search, routed as the unsharded engine
    routes: the two-pass search below k = 128, the column-chunked one up
    to 8,192 queries, the fused top-k above. Each wrapper launches its
    kernel on a card and runs its plain version for CPU tensors."""
    if k_local < _LANE:
        return topk_scores_twopass(q, c_local, k=k_local, block_n=block_n,
                                   seg_split=seg_split,
                                   corpus_swizzled=swizzled)
    if q.shape[0] <= CHUNKED_MAX_QUERIES:
        return topk_scores_chunked(q, c_local, k=k_local)
    return topk_scores_fused(q, c_local, k=k_local)


def _sharded_topk_impl(queries, corpus_sharded: Shards, mesh: Mesh, k: int,
                       valid_n: int,
                       corpus_swizzled_sharded: Optional[Shards],
                       block_n: int, seg_split: int):
    """Per-shard local top-k, then the axis-by-axis merge. The flat merge
    is the one-axis case."""
    n_shards = n_row_shards(mesh)
    shard_rows = corpus_sharded[0].shape[0]
    n_total = shard_rows * n_shards
    # pad rows (zero vectors, score 0) can outrank real candidates with
    # negative scores INSIDE a shard's local selection; over-select
    # k + n_pad locally so every shard still contributes its true local
    # top-k after the pads mask to -inf (pad_to_shards keeps n_pad below
    # the shard count)
    n_pad = 0 if valid_n < 0 else n_total - valid_n
    k_local = min(shard_rows, k + n_pad)
    lead = corpus_sharded[0].device
    parts_v, parts_i = [], []
    for j, (shard, c_local) in enumerate(zip(local_rows(mesh),
                                             corpus_sharded)):
        dev = c_local.device
        q = torch.as_tensor(queries).to(dev, non_blocking=True) \
            .to(c_local.dtype)
        vals, idx = _shard_search(
            q, c_local, k_local,
            None if corpus_swizzled_sharded is None
            else corpus_swizzled_sharded[j], block_n, seg_split)
        gidx = idx.long() + shard * shard_rows
        if valid_n >= 0:
            vals = torch.where(gidx < valid_n, vals,
                               torch.full_like(vals, -float("inf")))
        parts_v.append(vals.to(lead, non_blocking=True))
        parts_i.append(gidx.to(lead, non_blocking=True))
    vals, gidx = merge_candidates(mesh, torch.stack(parts_v),
                                  torch.stack(parts_i), k)
    return vals, gidx.to(torch.int32)


def sharded_topk(
    queries,
    corpus_sharded: Shards,
    mesh: Mesh,
    k: int = 10,
    valid_n: int = -1,
    corpus_swizzled_sharded: Optional[Shards] = None,
    block_n: int = 8192,
    seg_split: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k over a row-sharded corpus: (values f32, global ids
    int32), each (Q, k), on the first shard's device, the same on every
    process.

    queries:        (Q, D), host or device; copied to every shard.
    corpus_sharded: this process's shards from :func:`shard_corpus`.
    valid_n:        the true corpus size if it was padded (-1: no pad).
    corpus_swizzled_sharded: from :func:`swizzle_corpus_sharded`.
    block_n, seg_split: the two-pass search's segment layout.

    Each shard runs the single-device search that its local depth
    ``k_local = min(shard rows, k + pad rows)`` and the query count pick
    (:func:`_shard_search`).
    """
    assert "dcn" not in mesh.axis_names, (
        "use sharded_topk_2level on ('dcn', 'data') hybrid meshes"
    )
    return _sharded_topk_impl(queries, corpus_sharded, mesh, k, valid_n,
                              corpus_swizzled_sharded, block_n, seg_split)


def sharded_topk_2level(
    queries,
    corpus_sharded: Shards,
    mesh: Mesh,
    k: int = 10,
    valid_n: int = -1,
    corpus_swizzled_sharded: Optional[Shards] = None,
    block_n: int = 8192,
    seg_split: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k over a corpus sharded on a ("dcn", "data") mesh
    (``core.mesh.hybrid_mesh``), row-sharded over both axes, dcn-major.
    The merge is hierarchical: each slice's shards merge first, then one
    list a slice crosses the outer axis, so the slow links carry only
    already-merged candidates. Results equal the flat merge's bit for
    bit."""
    assert "dcn" in mesh.axis_names and "data" in mesh.axis_names, (
        "sharded_topk_2level needs a ('dcn', 'data') mesh; "
        "use sharded_topk on single-slice meshes"
    )
    return _sharded_topk_impl(queries, corpus_sharded, mesh, k, valid_n,
                              corpus_swizzled_sharded, block_n, seg_split)
