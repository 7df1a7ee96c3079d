"""Pair-mode training-batch construction (num_dup / num_neg / resample).

The port's copy of ``semanticsearch_tpu/train/pairs.py`` (host numpy only).

Reproduces MatchZoo's pairwise Dataset semantics as the reference uses them
(``MatchZoo_Tool/train_controller.py:583-634``): for every query, each
positive example is duplicated ``num_dup`` times; each duplicate is grouped
with ``num_neg`` sampled negatives (the pairwise-ranking group is positive
first, negatives after); groups are reshuffled and negatives resampled every
epoch when ``resample=True``. Queries lacking a positive or a negative are
excluded — the pairability constraint the reference checks before training
(``Train_Conv_KNRM[choose].py:55-137``, ``validate_and_clean_tsv.py:117-163``).
Batches have static shape (batch_size * (1 + num_neg), L) for jit stability.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np


@dataclass
class PairDataset:
    """Holds transformed arrays + group structure for pairwise sampling."""

    left: np.ndarray        # (N, L_left) int32
    right: np.ndarray       # (N, L_right) int32
    labels: np.ndarray      # (N,) float
    query_ids: np.ndarray   # (N,) any
    # optional per-row scores from a stronger teacher (e.g. the trained dual
    # encoder's cosine) for margin-MSE distillation (TrainConfig.distill_weight)
    teacher: Optional[np.ndarray] = None   # (N,) float

    def __post_init__(self) -> None:
        self._by_query: Dict = {}
        for i, q in enumerate(self.query_ids):
            self._by_query.setdefault(q, []).append(i)
        self.pairable_queries = [
            q for q, idxs in self._by_query.items()
            if any(self.labels[i] > 0 for i in idxs)
            and any(self.labels[i] <= 0 for i in idxs)
        ]

    def _right_lengths(self) -> np.ndarray:
        """Per-row true right length (non-pad tokens; pad id = 0), cached."""
        if not hasattr(self, "_rlen"):
            self._rlen = (self.right != 0).sum(axis=1).astype(np.int32)
        return self._rlen

    def iter_pair_batches(
        self,
        batch_size: int,
        num_dup: int = 1,
        num_neg: int = 1,
        seed: int = 0,
        epoch: int = 0,
        resample: bool = True,
        length_buckets: Sequence[int] = (),
    ) -> Iterator[Dict[str, np.ndarray]]:
        """Yield batches of pairwise groups.

        Each batch: left/right of shape (batch_size*(1+num_neg), L); within a
        group the positive row comes first. The trailing partial batch is
        FLUSHED, not dropped: it is padded to batch_size with wrap-around
        groups from the same epoch permutation (real pairs, so the gradient
        stays valid and static shapes hold). Dropping it silently ran ZERO
        steps whenever the dataset had fewer groups than batch_size.

        ``length_buckets``: the TPU-idiomatic analog of MatchZoo's per-batch
        dynamic padding (reference ``train_controller.py:53-58``). Groups are
        binned by their max TRUE right length into the smallest bucket that
        fits (e.g. (32, 64) with fixed_length_right=128 gives three static
        shapes: 32, 64, 128); each batch's ``right`` is sliced to its bucket
        width, so short pairs stop paying full-preset-length FLOPs. A
        handful of compiled signatures replaces one; batch order interleaves
        buckets deterministically in (seed, epoch). Only valid for models
        whose parameters are length-independent (every reranker except
        ArcII — see ``length_bucketable``); padding columns are masked, so
        scores are unchanged vs the unsliced batch.
        """
        rng = np.random.default_rng(seed + (epoch if resample else 0))
        groups: List[List[int]] = []
        for q in self.pairable_queries:
            idxs = self._by_query[q]
            pos = [i for i in idxs if self.labels[i] > 0]
            neg = [i for i in idxs if self.labels[i] <= 0]
            for p in pos:
                for _ in range(num_dup):
                    ns = rng.choice(neg, size=num_neg, replace=len(neg) < num_neg)
                    groups.append([p] + list(ns))
        if not groups:
            return
        order = rng.permutation(len(groups))
        group_w = 1 + num_neg
        full_len = self.right.shape[1]
        widths = sorted({min(b, full_len) for b in length_buckets
                         if b > 0}) if length_buckets else []
        if not widths or widths[-1] != full_len:
            widths.append(full_len)

        if len(widths) == 1:
            buckets = {full_len: order}
        else:
            rlen = self._right_lengths()
            # a group's width requirement = its longest right side
            need = rlen[np.asarray(groups)[order]].max(axis=1)
            bucket_of = np.searchsorted(widths, need)  # smallest fitting
            buckets = {
                w: order[bucket_of == wi] for wi, w in enumerate(widths)
            }
            buckets = {w: o for w, o in buckets.items() if o.size}

        # emit batches bucket-round-robin so learning sees all widths
        # interleaved rather than sorted-by-length curriculum
        batch_plans: List = []
        for w, bucket_order in buckets.items():
            for s in range(0, len(bucket_order), batch_size):
                chunk = bucket_order[s: s + batch_size]
                if len(chunk) < batch_size:
                    # pad with wrap-around groups FROM THE SAME BUCKET so
                    # the slice width stays valid
                    chunk = np.concatenate(
                        [chunk, np.resize(bucket_order,
                                          batch_size - len(chunk))]
                    )
                batch_plans.append((w, chunk))
        if len(buckets) > 1:
            batch_plans = [batch_plans[i]
                           for i in rng.permutation(len(batch_plans))]
        for w, chunk in batch_plans:
            sel = [groups[g] for g in chunk]
            rows = np.asarray(sel).reshape(-1)  # (B*group_w,)
            batch = {
                "left": self.left[rows],
                "right": self.right[rows, :w],
                "labels": self.labels[rows].astype(np.float32),
                "group_size": group_w,
            }
            if self.teacher is not None:
                batch["teacher"] = np.asarray(
                    self.teacher, np.float32)[rows]
            yield batch

    def iter_point_batches(
        self, batch_size: int, pad_to_full: bool = True
    ) -> Iterator[Dict[str, np.ndarray]]:
        """Point-mode batches for evaluation (reference test-loader mode,
        ``train_controller.py:605-613``). Pads the final batch (with a mask)
        so every step has static shape."""
        n = self.left.shape[0]
        for s in range(0, n, batch_size):
            e = min(s + batch_size, n)
            idx = np.arange(s, e)
            valid = np.ones(e - s, dtype=bool)
            if pad_to_full and e - s < batch_size:
                pad = batch_size - (e - s)
                idx = np.concatenate([idx, np.zeros(pad, np.int64)])
                valid = np.concatenate([valid, np.zeros(pad, bool)])
            yield {
                "left": self.left[idx],
                "right": self.right[idx],
                "labels": self.labels[idx].astype(np.float32),
                "row_ids": idx,
                "valid": valid,
            }
