"""IR ranking metrics: AP/MAP, MRR, P@k, DCG@k, NDCG@k.

The port's own copy of ``semanticsearch_tpu/train/metrics.py``: relevance
threshold 0 (labels > 0 count as relevant), DCG gain ``2^rel - 1`` with a
natural-log ``ln(rank + 1)`` discount, ties broken by score order
(stable), the mean over queries.
"""
from __future__ import annotations

from typing import Dict, Iterable, Sequence, Tuple

import numpy as np

DEFAULT_METRICS: Tuple[str, ...] = (
    "map", "mrr", "ap",
    "p@1", "p@3", "p@5", "p@10", "p@20",
    "ndcg@1", "ndcg@3", "ndcg@5", "ndcg@10", "ndcg@20",
    "dcg@1", "dcg@3", "dcg@5", "dcg@10", "dcg@20",
)


def _sorted_labels(y_true: np.ndarray, y_score: np.ndarray) -> np.ndarray:
    order = np.argsort(-np.asarray(y_score), kind="stable")
    return np.asarray(y_true, dtype=np.float64)[order]


def average_precision(y_true, y_score, threshold: float = 0.0) -> float:
    rel = _sorted_labels(y_true, y_score) > threshold
    if not rel.any():
        return 0.0
    precisions = np.cumsum(rel) / (np.arange(rel.size) + 1)
    return float(precisions[rel].mean())


def reciprocal_rank(y_true, y_score, threshold: float = 0.0) -> float:
    rel = _sorted_labels(y_true, y_score) > threshold
    hits = np.nonzero(rel)[0]
    return float(1.0 / (hits[0] + 1)) if hits.size else 0.0


def precision_at_k(y_true, y_score, k: int, threshold: float = 0.0) -> float:
    rel = _sorted_labels(y_true, y_score)[:k] > threshold
    return float(rel.sum() / k)


def dcg_at_k(y_true, y_score, k: int, threshold: float = 0.0) -> float:
    labels = _sorted_labels(y_true, y_score)[:k]
    gains = np.where(labels > threshold, np.power(2.0, labels) - 1.0, 0.0)
    discounts = np.log(np.arange(labels.size) + 2.0)
    return float(np.sum(gains / discounts))


def ndcg_at_k(y_true, y_score, k: int) -> float:
    ideal = dcg_at_k(y_true, y_true, k)
    if ideal <= 0:
        return 0.0
    return dcg_at_k(y_true, y_score, k) / ideal


def eval_metric(name: str, y_true, y_score) -> float:
    name = name.lower()
    if name in ("map", "ap"):
        return average_precision(y_true, y_score)
    if name == "mrr":
        return reciprocal_rank(y_true, y_score)
    if "@" in name:
        base, k_str = name.split("@")
        k = int(k_str)
        if base in ("p", "precision"):
            return precision_at_k(y_true, y_score, k)
        if base == "ndcg":
            return ndcg_at_k(y_true, y_score, k)
        if base == "dcg":
            return dcg_at_k(y_true, y_score, k)
    raise ValueError(f"unknown metric {name!r}")


def evaluate_ranking(
    query_ids: Sequence,
    y_true: Sequence[float],
    y_score: Sequence[float],
    metrics: Iterable[str] = DEFAULT_METRICS,
) -> Dict[str, float]:
    """Each metric per query (rows grouped by query id), averaged over the
    queries; a query with no relevant row counts 0 for AP and MRR."""
    qids = np.asarray(query_ids)
    yt = np.asarray(y_true, dtype=np.float64)
    ys = np.asarray(y_score, dtype=np.float64)
    groups: Dict = {}
    for q in np.unique(qids):
        m = qids == q
        groups[q] = (yt[m], ys[m])
    out: Dict[str, float] = {}
    for name in metrics:
        vals = [eval_metric(name, t, s) for t, s in groups.values()]
        out[name] = float(np.mean(vals)) if vals else 0.0
    return out
