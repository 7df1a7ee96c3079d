"""Validation-tuned weighted reciprocal-rank fusion.

The port's own copy of ``semanticsearch_tpu/train/fusion.py``:

    fused(d) = 2*alpha / (k + r_dense(d)) + 2*(1 - alpha) / (k + r_lex(d))

``alpha = 0.5`` (or None) is the unweighted fusion exactly.
:func:`tune_fusion_alpha` grid-searches alpha against a ranking metric on
held-out labels; ``HybridQueryEngine.tune_fusion`` runs the same search
against the live engine legs.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from ..index.rrf import ranks_from_scores, rrf_weights
from .metrics import eval_metric

__all__ = ["DEFAULT_GRID", "rrf_weights", "weighted_rrf", "tune_fusion_alpha"]

DEFAULT_GRID: Tuple[float, ...] = tuple(np.round(np.linspace(0.0, 1.0, 21), 3))


def weighted_rrf(
    dense_scores: np.ndarray,
    lex_scores: np.ndarray,
    alpha: Optional[float] = None,
    k: int = 60,
) -> np.ndarray:
    """Weighted RRF over full per-query score rows: (Q, D) dense and
    lexical score matrices over the same documents -> (Q, D) fused."""
    dense_scores = np.asarray(dense_scores)
    lex_scores = np.asarray(lex_scores)
    if dense_scores.shape != lex_scores.shape:
        raise ValueError(
            f"score shapes differ: {dense_scores.shape} vs {lex_scores.shape}")
    w_d, w_l = rrf_weights(alpha)
    out = np.empty(dense_scores.shape, np.float64)
    for qi in range(dense_scores.shape[0]):
        r_d = ranks_from_scores(dense_scores[qi])
        r_l = ranks_from_scores(lex_scores[qi])
        out[qi] = w_d / (k + r_d) + w_l / (k + r_l)
    return out


def tune_fusion_alpha(
    dense_scores: np.ndarray,
    lex_scores: np.ndarray,
    labels: np.ndarray,
    k: int = 60,
    grid: Sequence[float] = DEFAULT_GRID,
    metric: str = "map",
) -> Tuple[float, float, Dict[float, float]]:
    """Grid-search alpha on a labeled split: ``labels`` (Q, D) binary
    relevance. Returns ``(best_alpha, best_value, {alpha: value})``; ties
    break toward 0.5, the unweighted fusion."""
    labels = np.asarray(labels)
    table: Dict[float, float] = {}
    for alpha in grid:
        fused = weighted_rrf(dense_scores, lex_scores, alpha=alpha, k=k)
        vals = [eval_metric(metric, labels[qi], fused[qi])
                for qi in range(labels.shape[0])]
        table[float(alpha)] = float(np.mean(vals))
    best_alpha = max(table, key=lambda a: (table[a], -abs(a - 0.5)))
    return best_alpha, table[best_alpha], table
