"""Reciprocal-rank fusion of score lists.

rank 1 = highest score, ties broken by position in ``np.argsort(-scores)``
order, fused as ``sum_i 1 / (k + rank_i)`` with k=60.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np


def rrf_weights(alpha: Optional[float]) -> Tuple[float, float]:
    """(dense, lexical) RRF contribution weights for a mixing alpha.

    ``None`` and 0.5 both map to (1.0, 1.0), the unweighted fusion. Other
    alphas weight the legs as ``2*alpha`` / ``2*(1-alpha)``.
    """
    if alpha is None:
        return 1.0, 1.0
    if not 0.0 <= alpha <= 1.0:
        raise ValueError(f"fusion alpha must be in [0, 1], got {alpha}")
    return 2.0 * alpha, 2.0 * (1.0 - alpha)


def ranks_from_scores(scores: np.ndarray) -> np.ndarray:
    """1-based competition-free ranks: position in descending-score order."""
    order = np.argsort(-scores, kind="stable")
    ranks = np.empty_like(order, dtype=np.float64)
    ranks[order] = np.arange(1, len(scores) + 1)
    return ranks


def rrf_fuse(score_lists: Sequence[np.ndarray], k: int = 60) -> np.ndarray:
    """Fuse N score arrays over the same candidates into one RRF score array."""
    if not score_lists:
        raise ValueError("need at least one score list")
    out = np.zeros(len(score_lists[0]), dtype=np.float64)
    for scores in score_lists:
        out += 1.0 / (k + ranks_from_scores(np.asarray(scores)))
    return out
