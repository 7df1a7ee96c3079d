"""Serve-time incremental index updates: a growable DELTA searched next to
the main index.

Counterpart of ``semanticsearch_tpu/index/delta.py``. New documents land in
a device-resident delta buffer whose capacity doubles as documents arrive;
every query searches main + delta and the engine merges by score.
``HybridQueryEngine.compact`` folds the delta into the persisted layout.

The lexical leg scores delta documents with the MAIN corpus's frozen
statistics (idf / avgdl): scores stay comparable across main and delta
between compactions, at the cost of new vocabulary contributing only a
provisional idf until the next compact.
"""
from __future__ import annotations

from collections import Counter
from typing import List, Sequence, Tuple

import numpy as np
import torch

NEG_INF = -1e30


class DeltaIndex:
    """Growable exact-cosine index for freshly added documents.

    Embeddings must arrive L2-normalized (``SentenceEncoder.encode``
    output). The host buffer doubles in capacity as documents arrive and is
    copied to ``device`` on the first search after an add; the search is a
    float32 matmul masked past the live count and a stable top-k.
    """

    def __init__(self, dim: int, init_capacity: int = 1024,
                 device="cuda") -> None:
        self.dim = dim
        self.capacity = init_capacity
        self.n = 0
        self.device = torch.device(device)
        self._host = np.zeros((init_capacity, dim), np.float32)
        self._device = None  # uploaded on the next search after an add

    def add(self, embeddings: np.ndarray) -> None:
        emb = np.asarray(embeddings, np.float32)
        need = self.n + emb.shape[0]
        if need > self.capacity:
            while self.capacity < need:
                self.capacity *= 2
            grown = np.zeros((self.capacity, self.dim), np.float32)
            grown[: self.n] = self._host[: self.n]
            self._host = grown
        self._host[self.n: need] = emb
        self.n = need
        self._device = None

    def search(self, q_emb, k: int) -> Tuple[np.ndarray, np.ndarray]:
        """(scores (Q,k''), local indices (Q,k'')), k'' being k rounded UP
        to a multiple of 64 and capped at the capacity, never clamped to the
        live count (the JAX package's jit-static k). Rows past the live
        count come back at NEG_INF; callers drop entries <= NEG_INF/2. Ties
        keep the lower row."""
        q = torch.as_tensor(q_emb, device=self.device).float()
        if self.n == 0:
            return (np.zeros((q.shape[0], 0), np.float32),
                    np.zeros((q.shape[0], 0), np.int64))
        k_static = min(self.capacity, ((k + 63) // 64) * 64)
        if self._device is None:
            self._device = torch.from_numpy(self._host).to(self.device)
        scores = q @ self._device.T
        scores[:, self.n:] = NEG_INF
        vals, order = torch.sort(scores, dim=1, descending=True, stable=True)
        return (vals[:, :k_static].cpu().numpy(),
                order[:, :k_static].cpu().numpy().astype(np.int64))


class DeltaBM25:
    """Frozen-statistics BM25 scoring of delta documents (numpy path).

    Holds a CSR over the MAIN index's vocabulary, plus an auxiliary
    vocabulary for terms the main corpus has never seen, with precomputed
    quotients (main avgdl in the length normalizer). Known terms score with
    the main corpus's frozen IDF; new terms get a provisional IDF from their
    delta-document frequency over (main + delta) docs until ``compact``
    recomputes exact statistics.
    """

    def __init__(self, main_bm25) -> None:
        self.bm = main_bm25
        self._main_vocab_size = len(main_bm25.vocab)
        self.new_vocab: dict = {}
        self._new_df: List[int] = []
        self._indptr: List[int] = [0]
        self._termids: List[int] = []
        self._quot: List[float] = []
        self._inv = None

    @property
    def n_docs(self) -> int:
        return len(self._indptr) - 1

    def add(self, docs_tokens: Sequence[Sequence[str]]) -> None:
        bm = self.bm
        base = self._main_vocab_size
        for toks in docs_tokens:
            norm_d = bm.k1 * (
                1.0 - bm.b + bm.b * len(toks) / max(bm.avgdl, 1e-9)
            )
            tf: dict = {}
            for tok in toks:
                tid = bm.vocab.get(tok)
                if tid is None:
                    tid = self.new_vocab.get(tok)
                    if tid is None:
                        tid = base + len(self.new_vocab)
                        self.new_vocab[tok] = tid
                        self._new_df.append(0)
                tf[tid] = tf.get(tid, 0) + 1
            for tid in sorted(tf):
                if tid >= base:
                    self._new_df[tid - base] += 1
                self._termids.append(tid)
                self._quot.append(tf[tid] / (tf[tid] + norm_d))
            self._indptr.append(len(self._termids))
        self._inv = None

    def _lookup(self, tok: str):
        tid = self.bm.vocab.get(tok)
        return tid if tid is not None else self.new_vocab.get(tok)

    def _full_idf(self) -> np.ndarray:
        """Main frozen IDF extended with the provisional new-term IDF (the
        BM25Okapi formula over main+delta doc counts, floored at epsilon
        times the main corpus's pre-floor mean IDF)."""
        bm = self.bm
        if not self.new_vocab:
            return bm.idf.astype(np.float32)
        n_total = bm.n_docs + self.n_docs
        df = np.asarray(self._new_df, np.float64)
        idf_new = np.log(n_total - df + 0.5) - np.log(df + 0.5)
        if bm.idf.size:
            avg = getattr(bm, "avg_idf", None)
            if avg is None:
                avg = float(np.mean(bm.idf))
            floor = float(bm.epsilon) * avg
            idf_new = np.where(idf_new < 0, floor, idf_new)
        return np.concatenate(
            [bm.idf.astype(np.float32), idf_new.astype(np.float32)]
        )

    def _inverted(self):
        """Term -> (delta docs, quotients), built on the first score after
        an add."""
        if self._inv is None:
            termids = np.asarray(self._termids, np.int64)
            docs = np.repeat(np.arange(self.n_docs),
                             np.diff(np.asarray(self._indptr, np.int64)))
            quot = np.asarray(self._quot, np.float32)
            order = np.argsort(termids, kind="stable")
            bounds = np.flatnonzero(np.diff(termids[order])) + 1
            self._inv = {
                int(termids[g[0]]): (docs[g], quot[g])
                for g in np.split(order, bounds) if g.size
            }
        return self._inv

    def score(self, queries_tokens: Sequence[Sequence[str]]) -> np.ndarray:
        """(Q, n_delta) f32 BM25 scores under the main corpus statistics,
        from the native CSR scorer (``bm25_score_batch``): each document
        sums its terms' contributions in term-id order, in f32, as the JAX
        package's scorer does. :meth:`score_plain` is its plain version."""
        from ..native import bm25_score_batch

        nq, nd = len(queries_tokens), self.n_docs
        if nq == 0 or nd == 0:
            return np.zeros((nq, nd), np.float32)
        q_ids: List[int] = []
        q_wts: List[float] = []
        q_indptr = [0]
        for toks in queries_tokens:
            cnt = Counter(tid for tid in map(self._lookup, toks)
                          if tid is not None)
            for tid in sorted(cnt):
                q_ids.append(tid)
                q_wts.append(float(cnt[tid]))
            q_indptr.append(len(q_ids))
        return bm25_score_batch(
            np.asarray(self._indptr, np.int64),
            np.asarray(self._termids, np.int32),
            np.asarray(self._quot, np.float32), self._full_idf(),
            np.asarray(q_indptr, np.int64), np.asarray(q_ids, np.int64),
            np.asarray(q_wts, np.float32), self.bm.k1)

    def score_plain(self, queries_tokens: Sequence[Sequence[str]]
                    ) -> np.ndarray:
        """:meth:`score` in numpy, query by query over the delta's own
        postings."""
        bm = self.bm
        nq, nd = len(queries_tokens), self.n_docs
        out = np.zeros((nq, nd), np.float32)
        if nq == 0 or nd == 0:
            return out
        idf = self._full_idf()
        inv = self._inverted()
        k1p1 = np.float32(bm.k1 + 1.0)
        for qi, toks in enumerate(queries_tokens):
            cnt = Counter(tid for tid in map(self._lookup, toks)
                          if tid is not None)
            for tid in sorted(cnt):
                hit = inv.get(tid)
                if hit is not None:
                    docs, quot = hit
                    out[qi, docs] += ((np.float32(cnt[tid]) * idf[tid])
                                      * k1p1) * quot
        return out
