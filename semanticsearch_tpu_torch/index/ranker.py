"""Hybrid cosine + BM25 + RRF ranking with percentile pos/neg labeling.

The port's copy of ``semanticsearch_tpu/index/ranker.py``, the offline
labeler whose rows ``train/encoder_train.py::pairs_from_labeled_rows``
reads: every distinct text of a batch of query groups embedded in one
``embed_fn`` call, then per group exact cosine, BM25Okapi (epsilon 0.25,
lowercase-split tokens, scores floored at 0, the port's ``index/bm25.py``),
RRF with k = 60 and stable argsort ties (``index/rrf.py``), and labels by
the upper and lower percentile of the fused score within the group; groups
with fewer than ``min_group_size`` chunks are skipped.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from ..core.config import RankingConfig
from .bm25 import BM25Okapi, tokenize
from .rrf import rrf_fuse

EmbedFn = Callable[[Sequence[str]], np.ndarray]


@dataclass
class RankedChunk:
    query_id: str
    chunk_id: str
    chunk_text: str
    cosine_score: float
    bm25_score: float
    rrf_score: float
    label: Optional[int] = None  # 1 pos / 0 neg / None filtered out


@dataclass
class QueryGroup:
    query_id: str
    query_text: str
    chunk_ids: List[str] = field(default_factory=list)
    chunk_texts: List[str] = field(default_factory=list)


def _l2n(x: np.ndarray) -> np.ndarray:
    n = np.linalg.norm(x, axis=-1, keepdims=True)
    return x / np.maximum(n, 1e-9)


def rank_group(
    query_text: str,
    chunk_texts: Sequence[str],
    query_emb: np.ndarray,
    chunk_embs: np.ndarray,
    cfg: RankingConfig = RankingConfig(),
) -> Dict[str, np.ndarray]:
    """Score one query group. Returns cosine/bm25/rrf arrays over the chunks."""
    q = _l2n(query_emb.reshape(1, -1))
    c = _l2n(np.asarray(chunk_embs, dtype=np.float32))
    cosine = (q @ c.T)[0]

    bm25 = BM25Okapi(
        [tokenize(t) for t in chunk_texts],
        k1=cfg.bm25_k1, b=cfg.bm25_b, epsilon=cfg.bm25_epsilon,
    )
    bm25_scores = np.maximum(bm25.get_scores(tokenize(query_text)), 0.0)

    rrf = rrf_fuse([cosine, bm25_scores], k=cfg.rrf_k)
    return {"cosine": cosine, "bm25": bm25_scores, "rrf": rrf}


def percentile_labels(
    rrf_scores: np.ndarray, cfg: RankingConfig = RankingConfig()
) -> np.ndarray:
    """Label 1 for >= upper percentile, 0 for <= lower percentile, -1 filtered.

    Matches the reference's keep/positive rule (rank_chunks_optimized.py:517-526).
    """
    pos_thr = np.percentile(rrf_scores, cfg.upper_percentile)
    neg_thr = np.percentile(rrf_scores, cfg.lower_percentile)
    labels = np.full(len(rrf_scores), -1, dtype=np.int32)
    labels[rrf_scores >= pos_thr] = 1
    labels[(rrf_scores <= neg_thr) & (rrf_scores < pos_thr)] = 0
    return labels


def rank_and_filter_groups(
    groups: Sequence[QueryGroup],
    embed_fn: EmbedFn,
    cfg: RankingConfig = RankingConfig(),
) -> List[RankedChunk]:
    """Rank every query group and keep percentile-labeled chunks.

    One deduplicated embedding batch for all texts, then per-group scoring.
    Output rows are sorted by descending RRF within each group, like the
    reference's sort_values('rrf_score') (rank_chunks_optimized.py:248).
    """
    groups = [g for g in groups if len(g.chunk_texts) >= cfg.min_group_size]
    if not groups:
        return []

    unique_texts: Dict[str, int] = {}
    for g in groups:
        unique_texts.setdefault(g.query_text, len(unique_texts))
        for t in g.chunk_texts:
            unique_texts.setdefault(t, len(unique_texts))
    text_list = list(unique_texts.keys())
    embs = np.asarray(embed_fn(text_list), dtype=np.float32)
    if embs.shape[0] != len(text_list):
        raise RuntimeError(
            f"embed_fn returned {embs.shape[0]} rows for {len(text_list)} texts"
        )

    out: List[RankedChunk] = []
    for g in groups:
        q_emb = embs[unique_texts[g.query_text]]
        c_embs = embs[[unique_texts[t] for t in g.chunk_texts]]
        scores = rank_group(g.query_text, g.chunk_texts, q_emb, c_embs, cfg)
        labels = percentile_labels(scores["rrf"], cfg)
        order = np.argsort(-scores["rrf"], kind="stable")
        for i in order:
            if labels[i] < 0:
                continue
            out.append(
                RankedChunk(
                    query_id=g.query_id,
                    chunk_id=g.chunk_ids[i] if g.chunk_ids else f"{g.query_id}_{i}",
                    chunk_text=g.chunk_texts[i],
                    cosine_score=float(scores["cosine"][i]),
                    bm25_score=float(scores["bm25"][i]),
                    rrf_score=float(scores["rrf"][i]),
                    label=int(labels[i]),
                )
            )
    return out
