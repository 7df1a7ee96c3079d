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
from typing import Optional, Tuple

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
        embeddings: np.ndarray,
        mesh: Optional[Mesh] = None,
        cfg: IndexConfig = IndexConfig(),
        normalize: bool = True,
        device="cuda",
    ) -> "EmbeddingIndex":
        """Normalize and place the corpus (host array or tensor): over
        every local device of ``device``'s kind when ``mesh`` is None."""
        if mesh is None:
            mesh = local_mesh(device)
        emb = (embeddings if isinstance(embeddings, torch.Tensor)
               else torch.as_tensor(np.asarray(embeddings)))
        if n_row_shards(mesh) > 1:
            from ..parallel.sharding import pad_to_shards, shard_corpus

            # pad ONLY to the shard count (n_pad < n_shards): every global
            # pad row costs one more local candidate in sharded_topk
            emb, valid_n = pad_to_shards(emb, mesh)
            shards = [_normalized(s, cfg, normalize)
                      for s in shard_corpus(emb, mesh)]
            return cls(shards, valid_n, cfg, mesh)
        from ..core.mesh import row_devices

        emb = _normalized(emb.to(row_devices(mesh)[0]), cfg, normalize)
        return cls(emb, emb.shape[0], cfg, mesh)

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


def _normalized(emb: torch.Tensor, cfg: IndexConfig, normalize: bool
                ) -> torch.Tensor:
    """Rows L2-normalized in float32 (when ``normalize``), stored in
    ``cfg.dtype``."""
    if normalize:
        emb = emb.float()
        emb = emb / torch.clamp(torch.linalg.norm(emb, dim=1, keepdim=True),
                                min=1e-9)
    return emb.to(getattr(torch, cfg.dtype))
