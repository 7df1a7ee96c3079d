"""Exact-cosine retrieval engine over a device-resident embedding matrix.

Counterpart of ``semanticsearch_tpu/index/engine.py`` on one device. The
dispatch rule is the JAX package's:

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

from ..core.config import IndexConfig
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


def _check_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "a multi-device mesh (sharding over NCCL) is not ported yet: "
            "ROADMAP Queue 1")


class EmbeddingIndex:
    """Exact top-k index over L2-normalized embeddings.

    Usage:
        idx = EmbeddingIndex.build(embeddings, cfg=IndexConfig())
        result = idx.search(query_embeddings, k=10)
    """

    def __init__(self, corpus: torch.Tensor, valid_n: int,
                 cfg: IndexConfig) -> None:
        self._corpus = corpus
        self._valid_n = valid_n
        self.cfg = cfg

    @classmethod
    def build(
        cls,
        embeddings: np.ndarray,
        mesh=None,
        cfg: IndexConfig = IndexConfig(),
        normalize: bool = True,
        device="cuda",
    ) -> "EmbeddingIndex":
        _check_mesh(mesh)
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu'")
        emb = torch.as_tensor(np.asarray(embeddings), device=device)
        if normalize:
            emb = emb.float()
            norm = torch.linalg.norm(emb, dim=1, keepdim=True)
            emb = emb / torch.clamp(norm, min=1e-9)
        emb = emb.to(getattr(torch, cfg.dtype))
        return cls(emb, emb.shape[0], cfg)

    @property
    def size(self) -> int:
        return self._valid_n

    @property
    def device(self) -> torch.device:
        return self._corpus.device

    def search(self, queries, k: Optional[int] = None) -> SearchResult:
        vals, idx = self.search_device(queries, k)
        return SearchResult(vals.cpu().numpy(), idx.cpu().numpy())

    def search_device(self, queries, k: Optional[int] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Launch the dense top-k and return DEVICE tensors, with no host
        fetch: CUDA launches are asynchronous, so the caller can run host
        work while the card computes. Accepts host or device queries."""
        k = self.cfg.top_k if k is None else k  # k=0 is a real request
        q = torch.as_tensor(queries, device=self.device).to(self._corpus.dtype)
        if k < 128:
            return topk_scores_twopass(
                q, self._corpus, k=k, block_n=self.cfg.block_rows,
                valid_n=self._valid_n, seg_split=self.cfg.seg_split)
        if q.shape[0] <= CHUNKED_MAX_QUERIES:
            return topk_scores_chunked(q, self._corpus, k=k,
                                       valid_n=self._valid_n)
        return topk_scores_fused(q, self._corpus, k=k, valid_n=self._valid_n)
