"""Serve-time hybrid query engine: dense top-k + BM25 + RRF over one corpus.

Counterpart of ``semanticsearch_tpu/index/query_engine.py`` on one device.
Each search launches its card work first (query encode, dense top-k), runs
the host BM25 leg while the card computes (CUDA launches are asynchronous
and nothing synchronizes before the host leg), fetches the dense results
last, and fuses both legs by reciprocal rank with k=60.

Not ported yet, each listed in ROADMAP: serve-time adds and removals (the
delta buffer and tombstones), ``compact``, the device BM25 leg, the neural
rerank stage, ``tune_fusion`` and the HTTP server.
"""
from __future__ import annotations

import dataclasses
import json
import os
import pickle
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.config import IndexConfig, RankingConfig
from ..core.logging import get_logger
from ..data.tsv import read_tsv, write_tsv
from .bm25 import BM25Okapi, load_bm25, tokenize
from .builder import load_index
from .engine import EmbeddingIndex, SearchResult
from .rrf import rrf_weights

logger = get_logger("query")

BM25_FILE = "bm25.pkl"
TEXTS_FILE = "texts.tsv"
TOKENIZER_FILE = "tokenizer.json"
FUSION_FILE = "fusion.json"
COMMIT_JOURNAL = "compact.commit.json"


def _pack_scores_indices(vals: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """One (Q, 2k) int32 device tensor, f32 scores bit-cast into [:, :k]:
    the leg's results come back to the host in a single copy."""
    return torch.cat([vals.float().contiguous().view(torch.int32),
                      idx.to(torch.int32)], dim=1)


def _unpack_scores_indices(packed: np.ndarray) -> SearchResult:
    k = packed.shape[1] // 2
    return SearchResult(
        np.ascontiguousarray(packed[:, :k]).view(np.float32),
        packed[:, k:].astype(np.int64),
    )


@dataclass
class Hit:
    chunk_id: str
    score: float
    dense_rank: int = 0
    lexical_rank: int = 0


class HybridQueryEngine:
    """Dense + lexical retrieval with RRF candidate fusion."""

    def __init__(
        self,
        index: EmbeddingIndex,
        chunk_ids: List[str],
        encoder,
        bm25: Optional[BM25Okapi] = None,
        cfg: RankingConfig = RankingConfig(),
    ) -> None:
        if cfg.lexical_device:
            raise NotImplementedError(
                "the device BM25 leg (lexical_device=True) is not ported "
                "yet: ROADMAP Queue 1")
        self.index = index
        self.chunk_ids = chunk_ids
        self.encoder = encoder
        self.bm25 = bm25
        self.cfg = cfg
        self._warned_no_bm25 = False

    # ------------------------------------------------------------- build/load
    @classmethod
    def build(
        cls,
        chunks_tsv: str,
        encoder,
        output_dir: str,
        mesh=None,
        index_cfg: IndexConfig = IndexConfig(),
        rank_cfg: RankingConfig = RankingConfig(),
        text_column: str = "chunk_text",
        limit: Optional[int] = None,
        resume: bool = False,
        device="cuda",
    ) -> "HybridQueryEngine":
        """Embed and persist the dense index AND the BM25 term statistics,
        then serve them from ``device``. ``resume=True`` restarts the embed
        stage from its cursor and skips finished BM25/texts stages."""
        from .builder import build_corpus_index

        build_corpus_index(chunks_tsv, encoder, output_dir,
                           text_column=text_column, limit=limit,
                           resume=resume)
        texts = [r.get(text_column, "")
                 for r in read_tsv(chunks_tsv, limit=limit)]
        bm25_path = os.path.join(output_dir, BM25_FILE)
        bm25 = None
        if resume and os.path.exists(bm25_path):
            bm25 = load_bm25(bm25_path)
            if (bm25.k1, bm25.b, bm25.epsilon) != (
                    rank_cfg.bm25_k1, rank_cfg.bm25_b,
                    rank_cfg.bm25_epsilon):
                logger.warning(
                    "resume: persisted BM25 stats were built with "
                    "k1=%s b=%s eps=%s but rank_cfg asks k1=%s b=%s "
                    "eps=%s — rebuilding the BM25 stage",
                    bm25.k1, bm25.b, bm25.epsilon, rank_cfg.bm25_k1,
                    rank_cfg.bm25_b, rank_cfg.bm25_epsilon)
                bm25 = None
        if bm25 is None:
            bm25 = BM25Okapi(
                [tokenize(t) for t in texts],
                k1=rank_cfg.bm25_k1, b=rank_cfg.bm25_b,
                epsilon=rank_cfg.bm25_epsilon,
            )
            with open(bm25_path, "wb") as f:
                pickle.dump(bm25, f)
        # row-aligned chunk texts (the rerank stage reads them), under the
        # canonical column name that read_tsv maps every chunk-text alias to
        texts_path = os.path.join(output_dir, TEXTS_FILE)
        if not (resume and os.path.exists(texts_path)):
            write_tsv(texts_path, ({"chunk_text": t} for t in texts),
                      ["chunk_text"])
        index, chunk_ids = load_index(output_dir, mesh=mesh, cfg=index_cfg,
                                      device=device)
        return cls(index, chunk_ids, encoder, bm25=bm25, cfg=rank_cfg)

    @classmethod
    def load(
        cls,
        index_dir: str,
        encoder,
        mesh=None,
        index_cfg: IndexConfig = IndexConfig(),
        rank_cfg: RankingConfig = RankingConfig(),
        reranker_dir: Optional[str] = None,
        device="cuda",
    ) -> "HybridQueryEngine":
        """Serve an index directory written by either package."""
        if reranker_dir:
            raise NotImplementedError(
                "the neural rerank stage is not ported yet: ROADMAP Queue 1")
        for name, what in ((COMMIT_JOURNAL, "an interrupted compact"),
                           (TOKENIZER_FILE, "a trained subword tokenizer")):
            if os.path.exists(os.path.join(index_dir, name)):
                raise NotImplementedError(
                    f"{index_dir} holds {what} ({name}), which this package "
                    "does not read yet: ROADMAP Queue 1")
        index, chunk_ids = load_index(index_dir, mesh=mesh, cfg=index_cfg,
                                      device=device)
        bm25_path = os.path.join(index_dir, BM25_FILE)
        bm25 = load_bm25(bm25_path) if os.path.exists(bm25_path) else None
        # a persisted tuned fusion alpha applies unless the caller set one
        fusion_path = os.path.join(index_dir, FUSION_FILE)
        if os.path.exists(fusion_path) and rank_cfg.fusion_alpha is None:
            with open(fusion_path) as f:
                persisted = json.load(f)
            rank_cfg = dataclasses.replace(
                rank_cfg, fusion_alpha=float(persisted["fusion_alpha"]))
            logger.info("using persisted fusion_alpha=%s from %s",
                        rank_cfg.fusion_alpha, fusion_path)
        return cls(index, chunk_ids, encoder, bm25=bm25, cfg=rank_cfg)

    # ------------------------------------------------------------------ query
    def search(
        self,
        queries: Sequence[str],
        k: int = 10,
        candidates: Optional[int] = None,
        hybrid: bool = True,
        rerank_top: int = 0,
    ) -> List[List[Hit]]:
        """Top-k hits per query. ``candidates`` is the per-leg depth before
        fusion (default max(4k, 20))."""
        if not len(queries):
            return []
        state = self._dispatch_legs(queries, k, candidates, hybrid)
        return self._finish_legs(state, k, rerank_top)

    def search_pipelined(
        self,
        query_batches: Sequence[Sequence[str]],
        k: int = 10,
        candidates: Optional[int] = None,
        hybrid: bool = True,
        rerank_top: int = 0,
    ) -> List[List[List[Hit]]]:
        """``search`` over a stream of batches with cross-batch overlap:
        batch i+1's card work is launched BEFORE batch i's results are
        fetched and fused, so batch i's host fusion runs while the card
        works on batch i+1. Returns one ``search``-shaped list per batch."""
        out: List[List[List[Hit]]] = []
        prev = None

        def flush():
            nonlocal prev
            if prev is not None:
                out.append(self._finish_legs(prev, k, rerank_top))
                prev = None

        for qb in query_batches:
            if not len(qb):
                flush()  # keep output order aligned with the input batches
                out.append([])
                continue
            state = self._dispatch_legs(qb, k, candidates, hybrid)
            flush()
            prev = state
        flush()
        return out

    def _dispatch_legs(
        self,
        queries: Sequence[str],
        k: int,
        candidates: Optional[int],
        hybrid: bool,
    ) -> Dict:
        """Phase 1 of ``search``: launch the card work (encode, dense top-k,
        result packing), then run the host BM25 leg while the card
        computes. No result is fetched here."""
        depth = candidates or max(4 * k, 20)
        use_bm25 = hybrid and self.bm25 is not None
        if hybrid and self.bm25 is None and not self._warned_no_bm25:
            logger.warning(
                "hybrid search requested but the index has no BM25 stats "
                "(build with HybridQueryEngine.build); serving dense-only")
            self._warned_no_bm25 = True
        q_tokens = [tokenize(q) for q in queries] if use_bm25 else None
        q_emb = self.encoder.encode_device(list(queries))
        dense_packed = _pack_scores_indices(*self.index.search_device(
            q_emb, k=min(depth, self.index.size)))
        bm_host = None
        if use_bm25:
            bm_host = self.bm25.get_topk_batch(
                q_tokens, min(depth, self.index.size),
                n_threads=self.cfg.resolved_bm25_threads())
        return {
            "queries": queries,
            "depth": depth,
            "dense_packed": dense_packed,
            "bm_host": bm_host,
        }

    def _leg_lists(
        self, state: Dict
    ) -> Tuple[List[List[Tuple[float, int]]],
               Optional[List[List[Tuple[float, int]]]]]:
        """Fetch the dense leg and build per-query (score, row) lists,
        truncated to the search depth. The lexical lists keep positive
        scores only; the second element is None for dense-only searches."""
        depth = state["depth"]
        dense = _unpack_scores_indices(state["dense_packed"].cpu().numpy())
        dense_lists = [
            [(float(s), int(r)) for s, r in zip(dense.scores[qi],
                                                dense.indices[qi])][:depth]
            for qi in range(len(state["queries"]))
        ]
        if state["bm_host"] is None:
            return dense_lists, None
        bm_idx, bm_scores = state["bm_host"]
        lex_lists = [
            [(float(sc), int(row)) for row, sc in zip(bm_idx[qi], bm_scores[qi])
             if sc > 0][:depth]
            for qi in range(len(state["queries"]))
        ]
        return dense_lists, lex_lists

    def _finish_legs(self, state: Dict, k: int, rerank_top: int
                     ) -> List[List[Hit]]:
        """Phase 2 of ``search``: fetch, then RRF-fuse both legs."""
        if rerank_top > 0:
            raise NotImplementedError(
                "rerank_top > 0: the neural rerank stage is not ported yet: "
                "ROADMAP Queue 1")
        dense_lists, lex_lists = self._leg_lists(state)
        w_dense, w_lex = rrf_weights(self.cfg.fusion_alpha)
        per_query: List[List[Hit]] = []
        for qi in range(len(state["queries"])):
            rrf: Dict[int, float] = {}
            dense_rank: Dict[int, int] = {}
            lex_rank: Dict[int, int] = {}
            for rank, (_, row) in enumerate(dense_lists[qi], start=1):
                rrf[row] = rrf.get(row, 0.0) + w_dense / (self.cfg.rrf_k + rank)
                dense_rank[row] = rank
            if lex_lists is not None:
                for rank, (_, row) in enumerate(lex_lists[qi], start=1):
                    rrf[row] = rrf.get(row, 0.0) + w_lex / (self.cfg.rrf_k + rank)
                    lex_rank[row] = rank
            ranked = sorted(rrf.items(), key=lambda kv: (-kv[1], kv[0]))[:k]
            per_query.append([
                Hit(chunk_id=self.chunk_ids[row], score=score,
                    dense_rank=dense_rank.get(row, 0),
                    lexical_rank=lex_rank.get(row, 0))
                for row, score in ranked
            ])
        return per_query
