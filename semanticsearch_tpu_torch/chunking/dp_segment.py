"""Global DP-optimal segmentation over candidate cuts.

The reference ships this as dead code — its cross-encoder/DP splitter config
is never wired through (``Method/Semantic_Splitter_Optimized.py:63-138``,
defect 2 in SURVEY.md §7). Here it is a working refinement stage: given
candidate cuts (e.g. the union of C99 and valley boundaries), dynamic
programming picks the subset maximizing total segment coherence minus a
per-cut penalty. Coherence = mean adjacent-pair cosine within the segment,
O(1) per segment via a prefix sum (the reference recomputed embeddings per
segment, O(n^2) embed calls). An optional cross-encoder pair scorer can be
plugged in via ``pair_scores``. The port's own copy of
``semanticsearch_tpu/chunking/dp_segment.py``.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import numpy as np


def dp_optimal_segmentation(
    adj_sims: Sequence[float],
    candidates: Sequence[int],
    penalty: float = 0.0,
    pair_scores: Optional[np.ndarray] = None,
) -> List[int]:
    """Pick the subset of candidate cuts maximizing sum of segment coherences.

    adj_sims: (n-1,) adjacent-pair affinity (cosine or cross-encoder scores
    via ``pair_scores`` which overrides adj_sims).
    candidates: allowed cut positions in 1..n-1.
    penalty: subtracted per cut — larger => fewer segments.
    Returns the chosen cuts, sorted.
    """
    sims = np.asarray(
        pair_scores if pair_scores is not None else adj_sims, dtype=np.float64
    )
    n = sims.size + 1
    positions = sorted({0, n} | {int(c) for c in candidates if 0 < c < n})
    m = len(positions)
    if m <= 2:
        return []
    prefix = np.concatenate([[0.0], np.cumsum(sims)])

    def coherence(a: int, b: int) -> float:
        # mean adjacent similarity of sentences a..b-1 (pairs a..b-2)
        if b - a <= 1:
            return 0.0
        return float((prefix[b - 1] - prefix[a]) / (b - 1 - a))

    dp = np.full(m, -1e18)
    prev = np.full(m, -1, dtype=int)
    dp[0] = 0.0
    for i in range(1, m):
        for j in range(i):
            score = dp[j] + coherence(positions[j], positions[i])
            if positions[i] != n:
                score -= penalty
            if score > dp[i]:
                dp[i] = score
                prev[i] = j
    cuts: List[int] = []
    cur = m - 1
    while cur > 0:
        p = prev[cur]
        if p < 0:
            break
        if positions[cur] != n:
            cuts.append(positions[cur])
        cur = p
    return sorted(cuts)


def auto_penalty(adj_sims: Sequence[float]) -> float:
    """Penalty scale derived from the signal (no magic constants): half the
    interquartile range of adjacent similarities."""
    arr = np.asarray(adj_sims, dtype=np.float64)
    if arr.size == 0:
        return 0.0
    return float(max(np.percentile(arr, 75) - np.percentile(arr, 25), 0.0)) / 2.0
