"""BM25 (Okapi) lexical scoring on the host, numpy path.

Same scoring formula, epsilon floor, f32 operation order and tie rules as
``semanticsearch_tpu/index/bm25.py``, so scores and top-k lists are
identical. The C++ posting-traversal kernels of the JAX package are not part
of this port yet: ``get_topk_batch`` runs the per-query numpy top-k.

:func:`load_bm25` reads a ``bm25.pkl`` written by either package.
"""
from __future__ import annotations

import pickle
from collections import Counter
from typing import Dict, List, Sequence, Tuple

import numpy as np


def tokenize(text: str) -> List[str]:
    """Lowercase + whitespace split."""
    return text.lower().split()


class BM25Okapi:
    """BM25 Okapi over a fixed document collection (k1=1.5, b=0.75,
    epsilon=0.25 by default)."""

    def __init__(
        self,
        corpus_tokens: Sequence[Sequence[str]],
        k1: float = 1.5,
        b: float = 0.75,
        epsilon: float = 0.25,
    ) -> None:
        self.k1 = float(k1)
        self.b = float(b)
        self.epsilon = float(epsilon)
        self.n_docs = len(corpus_tokens)
        self.doc_len = np.array([len(d) for d in corpus_tokens], dtype=np.float32)
        self.avgdl = float(self.doc_len.mean()) if self.n_docs else 0.0

        # vocabulary + per-doc term frequencies in CSR arrays, term ids
        # sorted within each doc
        self.vocab: Dict[str, int] = {}
        indptr = [0]
        indices: List[int] = []
        data: List[int] = []
        df_counter: Dict[int, int] = {}
        for doc in corpus_tokens:
            tf: Dict[int, int] = {}
            for tok in doc:
                tid = self.vocab.setdefault(tok, len(self.vocab))
                tf[tid] = tf.get(tid, 0) + 1
            for tid in sorted(tf):
                indices.append(tid)
                data.append(tf[tid])
                df_counter[tid] = df_counter.get(tid, 0) + 1
            indptr.append(len(indices))
        self._indptr = np.array(indptr, dtype=np.int64)
        self._indices = np.array(indices, dtype=np.int32)
        self._data = np.array(data, dtype=np.float32)

        # idf = ln((N - df + 0.5)/(df + 0.5)); negative idfs are floored to
        # epsilon * (pre-floor mean idf)
        n_vocab = len(self.vocab)
        df = np.zeros(n_vocab, dtype=np.float32)
        for tid, cnt in df_counter.items():
            df[tid] = cnt
        idf = np.log(self.n_docs - df + 0.5) - np.log(df + 0.5)
        self.avg_idf = float(idf.mean()) if n_vocab else 0.0
        idf = np.where(idf < 0, self.epsilon * self.avg_idf, idf)
        self.idf = idf.astype(np.float32)

    def _norm(self) -> np.ndarray:
        """Per-doc length normalizer k1*(1-b+b*dl/avgdl): (n_docs,) f32."""
        return (
            self.k1
            * (1.0 - self.b + self.b * self.doc_len / max(self.avgdl, 1e-9))
        ).astype(np.float32)

    def _ensure_doc_quot(self) -> None:
        """Doc-major per-entry quotient tf/(tf+norm[d]), computed once: the
        contribution is then ((c*idf)*(k1+1)) * quot, one multiply-add per
        posting entry."""
        if getattr(self, "_doc_quot", None) is not None:
            return
        norm = self._norm()
        doc_of_entry = np.repeat(
            np.arange(self.n_docs, dtype=np.int32), np.diff(self._indptr)
        )
        self._doc_quot = (
            self._data / (self._data + norm[doc_of_entry])
        ).astype(np.float32)

    def __setstate__(self, state):
        self.__dict__.update(state)
        for attr in ("_indices", "_inv_docs"):
            a = getattr(self, attr, None)
            if a is not None and a.dtype != np.int32:
                setattr(self, attr, a.astype(np.int32))

    def __getstate__(self):
        # the top-k scratch accumulator is per-process state
        state = dict(self.__dict__)
        state.pop("_acc", None)
        return state

    def _ensure_inverted(self) -> None:
        """Term-major postings, built lazily: per-query cost is then the
        query terms' posting sizes, not the corpus size."""
        if getattr(self, "_inv_indptr", None) is not None:
            return
        self._ensure_doc_quot()
        doc_of_entry = np.repeat(
            np.arange(self.n_docs, dtype=np.int32), np.diff(self._indptr)
        )
        order = np.argsort(self._indices, kind="stable")
        counts = np.bincount(self._indices, minlength=len(self.vocab))
        self._inv_indptr = np.concatenate(
            [[0], np.cumsum(counts)]
        ).astype(np.int64)
        self._inv_docs = doc_of_entry[order]
        self._inv_quot = self._doc_quot[order]

    def get_topk(self, query_tokens: Sequence[str], k: int
                 ) -> Tuple[np.ndarray, np.ndarray]:
        """Top-k (indices, scores) by BM25 over the query terms' postings.
        Ties, including at the k-th boundary, go to the lower document id;
        documents sharing no term score 0 and fill in lowest ids first only
        when fewer than k documents match."""
        self._ensure_inverted()
        k = min(k, self.n_docs)
        if self.n_docs == 0 or k == 0:
            return np.zeros(0, np.int64), np.zeros(0, np.float32)
        if getattr(self, "_acc", None) is None or self._acc.size != self.n_docs:
            self._acc = np.zeros(self.n_docs, dtype=np.float32)
        acc = self._acc
        touched_parts = []
        total_postings = 0
        # sorted-term-id order with the factored contribution: the same f32
        # operation order as get_scores, so boundary ties order identically
        cnt = Counter(
            self.vocab[t] for t in query_tokens if t in self.vocab
        )
        for tid, c in sorted(cnt.items()):
            s, e = self._inv_indptr[tid], self._inv_indptr[tid + 1]
            docs = self._inv_docs[s:e]
            acc[docs] += (
                (c * self.idf[tid]) * np.float32(self.k1 + 1.0)
            ) * self._inv_quot[s:e]
            touched_parts.append(docs)
            total_postings += docs.size
        if not touched_parts:
            idx = np.arange(k, dtype=np.int64)
            return idx, np.zeros(k, np.float32)

        if total_postings * 4 < self.n_docs:
            # sparse path: sort only the touched docs (ascending ids, so a
            # stable sort keeps lower ids first within ties)
            touched = np.unique(np.concatenate(touched_parts))
            scores_t = acc[touched].copy()
            acc[touched] = 0.0
            order_t = np.argsort(-scores_t, kind="stable")[:k]
            idx = touched[order_t].astype(np.int64)
            scores = scores_t[order_t]
            if idx.size < k:
                fill = np.setdiff1d(
                    np.arange(k, dtype=np.int64), idx, assume_unique=False
                )[: k - idx.size]
                idx = np.concatenate([idx, fill])
                scores = np.concatenate(
                    [scores, np.zeros(k - scores.size, np.float32)]
                )
            return idx, scores

        # dense path: argpartition + exact boundary-tie repair (lower ids win)
        part = np.argpartition(-acc, k - 1)[:k]
        vk = float(acc[part].min())
        above = np.nonzero(acc > vk)[0]
        ties = np.nonzero(acc == vk)[0]
        sel = np.concatenate([above, ties[: k - above.size]])
        order_s = np.argsort(-acc[sel], kind="stable")
        idx = sel[order_s].astype(np.int64)
        scores = acc[sel][order_s].astype(np.float32)
        acc.fill(0.0)
        return idx, scores

    def get_topk_batch(
        self,
        queries_tokens: Sequence[Sequence[str]],
        k: int,
        n_threads: int = 1,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Batched top-k: (idx (Q,k) i64, scores (Q,k) f32), one
        :meth:`get_topk` per query. ``n_threads`` is accepted for signature
        parity; the numpy path runs on the calling thread."""
        del n_threads
        k = min(k, self.n_docs)
        nq = len(queries_tokens)
        idx = np.zeros((nq, k), np.int64)
        scores = np.zeros((nq, k), np.float32)
        if k == 0:
            return idx, scores
        for qi, toks in enumerate(queries_tokens):
            idx[qi], scores[qi] = self.get_topk(toks, k)
        return idx, scores

    def get_scores(self, query_tokens: Sequence[str]) -> np.ndarray:
        """BM25 score of the query against every document: (n_docs,) f32."""
        scores = np.zeros(self.n_docs, dtype=np.float32)
        if not self.n_docs:
            return scores
        qids = [self.vocab[t] for t in query_tokens if t in self.vocab]
        if not qids:
            return scores
        # a repeated query term contributes once per occurrence
        cnt = Counter(qids)
        qset = np.array(sorted(cnt), dtype=np.int64)
        qmul = np.array([cnt[t] for t in qset], dtype=np.float32)
        self._ensure_doc_quot()
        k1p1 = np.float32(self.k1 + 1.0)
        for d in range(self.n_docs):
            s, e = self._indptr[d], self._indptr[d + 1]
            ids = self._indices[s:e]
            hit = np.isin(ids, qset)
            if not hit.any():
                continue
            hit_ids = ids[hit]
            w = qmul[np.searchsorted(qset, hit_ids)] * self.idf[hit_ids]
            scores[d] = float(
                np.sum((w * k1p1) * self._doc_quot[s:e][hit])
            )
        return scores


class _BM25Unpickler(pickle.Unpickler):
    """Resolves the JAX package's ``BM25Okapi`` to this module's class, so
    a ``bm25.pkl`` the JAX builder wrote loads without importing it. Every
    other global resolves as usual."""

    _ALIASES = {("semanticsearch_tpu.index.bm25", "BM25Okapi"): BM25Okapi}

    def find_class(self, module, name):
        cls = self._ALIASES.get((module, name))
        return cls if cls is not None else super().find_class(module, name)


def load_bm25(path: str) -> BM25Okapi:
    """Load a persisted BM25 index written by either package. Unpickling
    runs code: only load files this system wrote."""
    with open(path, "rb") as f:
        bm25 = _BM25Unpickler(f).load()
    if not isinstance(bm25, BM25Okapi):
        raise TypeError(f"{path} does not hold a BM25Okapi")
    return bm25
