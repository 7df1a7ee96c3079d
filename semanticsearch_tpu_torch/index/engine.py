"""Exact-cosine retrieval engine over a device-resident embedding matrix.

Counterpart of ``semanticsearch_tpu/index/engine.py``. On a mesh of more
than one row shard the corpus is row-sharded (``parallel/sharding.py``):
each shard runs the single-device search below on its rows and the
candidates merge (two-level on a ("dcn", "data") mesh). A mesh of one
device takes the unsharded path, so ``mesh=None`` (the local mesh) on a
one-card host changes nothing. On one device the dispatch rule is the JAX
package's:

* k < 128: the two-pass search (:func:`topk_scores_twopass`, whose pass A is
  the hand-written kernel on CUDA);
* k >= 128 with at most :data:`CHUNKED_MAX_QUERIES` queries: the
  column-chunked search;
* k >= 128 with more queries: the fused top-k (:func:`topk_scores_fused`,
  the hand-written kernel ``csrc/topk_fused.cu`` on CUDA).

The Hopper pass A reads the natural row layout, so the index holds no
second, swizzled copy of its corpus.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Optional, Tuple, Union

import numpy as np
import torch

from ..core import profiling
from ..core.config import IndexConfig
from ..core.mesh import Mesh, local_mesh, n_row_shards
from ..ops.topk import (
    topk_scores_chunked,
    topk_scores_fused,
    topk_scores_twopass,
)

# k >= 128: the column-chunked search up to this many queries, the fused
# kernel above (the JAX engine's rule)
CHUNKED_MAX_QUERIES = 8192
# rows normalized at a time into the index's store: a float32 copy of this
# many rows is the build's only scratch
NORMALIZE_ROWS = 1 << 16


@dataclass
class SearchResult:
    scores: np.ndarray   # (Q, k) f32
    indices: np.ndarray  # (Q, k) int32 corpus row ids


class EmbeddingIndex:
    """Exact top-k index over L2-normalized embeddings.

    Usage:
        idx = EmbeddingIndex.build(embeddings, mesh=mesh, cfg=IndexConfig())
        result = idx.search(query_embeddings, k=10)

    ``corpus`` is one tensor, or on a sharded mesh this process's row
    shards (a list, from ``parallel.sharding.shard_corpus``)."""

    def __init__(self, corpus, valid_n: int, cfg: IndexConfig,
                 mesh: Optional[Mesh] = None) -> None:
        self._mesh = mesh
        self._shards = corpus if isinstance(corpus, list) else None
        self._corpus = None if self._shards is not None else corpus
        self._valid_n = valid_n
        self.cfg = cfg

    @classmethod
    def build(
        cls,
        embeddings: Union[np.ndarray, torch.Tensor, Iterable],
        mesh: Optional[Mesh] = None,
        cfg: IndexConfig = IndexConfig(),
        normalize: bool = True,
        device="cuda",
        rows: Optional[int] = None,
    ) -> "EmbeddingIndex":
        """Normalize and place the corpus: over every local device of
        ``device``'s kind when ``mesh`` is None. ``embeddings`` is one (N,
        D) host array or tensor, or on one row shard an iterable of (n_i,
        D) row blocks, taken once each in order (blocks made on demand,
        as a corpus too large for one float32 copy is); ``rows``, their
        total, lets the store be allocated before the first block, and a
        list or tuple of blocks gives it by itself. Rows are normalized in
        float32 a block of at most :data:`NORMALIZE_ROWS` at a time, each
        written into one store in ``cfg.dtype``: the build holds the store
        and one block. The result does not depend on how the rows come
        cut."""
        if mesh is None:
            mesh = local_mesh(device)
        if isinstance(embeddings, np.ndarray):
            embeddings = torch.as_tensor(embeddings)
        if isinstance(embeddings, torch.Tensor) and n_row_shards(mesh) > 1:
            from ..parallel.sharding import pad_to_shards, shard_corpus

            # pad ONLY to the shard count (n_pad < n_shards): every global
            # pad row costs one more local candidate in sharded_topk
            emb, valid_n = pad_to_shards(embeddings, mesh)
            shards = [_normalized(s, cfg, normalize)
                      for s in shard_corpus(emb, mesh)]
            return cls(shards, valid_n, cfg, mesh)
        if isinstance(embeddings, torch.Tensor):
            embeddings, rows = (embeddings,), embeddings.shape[0]
        return cls._build_blocks(embeddings, rows, mesh, cfg, normalize)

    @classmethod
    def _build_blocks(cls, blocks, rows: Optional[int], mesh: Mesh,
                      cfg: IndexConfig, normalize: bool) -> "EmbeddingIndex":
        """:meth:`build` over row blocks, on one row shard."""
        from ..core.mesh import row_devices

        if n_row_shards(mesh) > 1:
            raise NotImplementedError("a corpus in row blocks builds on one "
                                      "row shard")
        if rows is None:
            blocks = list(blocks)
            rows = sum(int(b.shape[0]) for b in blocks)
        dev = row_devices(mesh)[0]
        store, off = None, 0
        for block in blocks:
            block = (block if isinstance(block, torch.Tensor)
                     else torch.as_tensor(np.asarray(block)))
            if store is None:
                store = torch.empty((rows, block.shape[1]),
                                    dtype=getattr(torch, cfg.dtype),
                                    device=dev)
            if off + block.shape[0] > rows:
                raise ValueError(f"row blocks hold more than rows={rows}")
            _normalized(block, cfg, normalize, dev,
                        out=store[off: off + block.shape[0]])
            off += block.shape[0]
        if store is None or off != rows:
            raise ValueError(f"row blocks hold {off} rows, not rows={rows}")
        return cls(store, rows, cfg, mesh)

    @property
    def size(self) -> int:
        return self._valid_n

    @property
    def device(self) -> torch.device:
        return (self._corpus if self._shards is None
                else self._shards[0]).device

    def search(self, queries, k: Optional[int] = None) -> SearchResult:
        vals, idx = self.search_device(queries, k)
        return SearchResult(vals.cpu().numpy(), idx.cpu().numpy())

    def search_device(self, queries, k: Optional[int] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Launch the dense top-k and return DEVICE tensors, with no host
        fetch: CUDA launches are asynchronous, so the caller can run host
        work while the card computes. Accepts host or device queries."""
        k = self.cfg.top_k if k is None else k  # k=0 is a real request
        n_q = len(queries)
        if self._shards is not None:
            from ..parallel.sharding import sharded_topk, sharded_topk_2level

            # ("dcn", "data") meshes merge each slice first
            fn = (sharded_topk_2level if "dcn" in self._mesh.axis_names
                  else sharded_topk)
            with profiling.span("index.search",
                                {"route": "sharded", "Q": n_q, "k": k}):
                return fn(queries, self._shards, self._mesh, k=k,
                          valid_n=self._valid_n,
                          block_n=self.cfg.block_rows,
                          seg_split=self.cfg.seg_split)
        route = ("twopass" if k < 128 else "chunked"
                 if n_q <= CHUNKED_MAX_QUERIES else "fused")
        with profiling.span("index.search", {"route": route, "Q": n_q,
                                             "k": k}):
            q = torch.as_tensor(queries, device=self.device).to(
                self._corpus.dtype)
            if route == "twopass":
                return topk_scores_twopass(
                    q, self._corpus, k=k, block_n=self.cfg.block_rows,
                    valid_n=self._valid_n, seg_split=self.cfg.seg_split)
            if route == "chunked":
                return topk_scores_chunked(q, self._corpus, k=k,
                                           valid_n=self._valid_n)
            return topk_scores_fused(q, self._corpus, k=k,
                                     valid_n=self._valid_n)


def _normalized(emb: torch.Tensor, cfg: IndexConfig, normalize: bool,
                device=None, out: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
    """Rows L2-normalized in float32 (when ``normalize``), stored in
    ``cfg.dtype`` on ``device`` (emb's by default), into ``out`` when it is
    given; :data:`NORMALIZE_ROWS` rows at a time, so the float32 copy is
    never the whole corpus."""
    device = emb.device if device is None else torch.device(device)
    if out is None:
        out = torch.empty(emb.shape, dtype=getattr(torch, cfg.dtype),
                          device=device)
    for s in range(0, emb.shape[0], NORMALIZE_ROWS):
        x = emb[s: s + NORMALIZE_ROWS].to(device)
        if normalize:
            x = x.float()
            x = x / torch.clamp(torch.linalg.norm(x, dim=1, keepdim=True),
                                min=1e-9)
        out[s: s + x.shape[0]] = x
    return out
