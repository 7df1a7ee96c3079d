"""BM25 (Okapi) lexical scoring on the host.

Same scoring formula, epsilon floor, f32 operation order and tie rules as
``semanticsearch_tpu/index/bm25.py``, so scores and top-k lists are
identical. The serve-time entry points run the native kernels
(``native/semsearch_native.cpp``): :meth:`BM25Okapi.get_topk_batch` the
threaded posting traversal (unpruned, or MaxScore-pruned), and
:meth:`BM25Okapi.get_scores_batch` the CSR merge-join scorer. The per-query
numpy methods (:meth:`~BM25Okapi.get_topk`, :meth:`~BM25Okapi.get_scores`)
are their plain versions.

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
        # vocabulary + per-doc term frequencies in CSR arrays, term ids
        # sorted within each doc
        vocab: Dict[str, int] = {}
        indptr = [0]
        indices: List[int] = []
        data: List[int] = []
        for doc in corpus_tokens:
            tf: Dict[int, int] = {}
            for tok in doc:
                tid = vocab.setdefault(tok, len(vocab))
                tf[tid] = tf.get(tid, 0) + 1
            for tid in sorted(tf):
                indices.append(tid)
                data.append(tf[tid])
            indptr.append(len(indices))
        self._set_stats(vocab, np.array(indptr, dtype=np.int64),
                        np.array(indices, dtype=np.int32),
                        np.array(data, dtype=np.float32))

    @classmethod
    def from_csr(cls, vocab: Dict[str, int], indptr: np.ndarray,
                 indices: np.ndarray, data: np.ndarray, k1: float = 1.5,
                 b: float = 0.75, epsilon: float = 0.25) -> "BM25Okapi":
        """The statistics of a corpus given as a doc-major term-frequency
        CSR (``indices`` ascending within each document, ``data`` the term
        counts; ``vocab`` maps token -> id), as the constructor would derive
        them from the token lists: a bulk build that skips the Python loop
        over tokens."""
        self = cls.__new__(cls)
        self.k1, self.b, self.epsilon = float(k1), float(b), float(epsilon)
        self._set_stats(vocab, np.asarray(indptr, np.int64),
                        np.asarray(indices, np.int32),
                        np.asarray(data, np.float32))
        return self

    def _set_stats(self, vocab: Dict[str, int], indptr: np.ndarray,
                   indices: np.ndarray, data: np.ndarray) -> None:
        self.vocab = vocab
        self.n_docs = len(indptr) - 1
        lengths = np.diff(indptr)
        self.doc_len = np.zeros(self.n_docs, dtype=np.float32)
        if indices.size:  # a document's length is its summed term counts
            nz = lengths > 0
            self.doc_len[nz] = np.add.reduceat(
                data.astype(np.int64), indptr[:-1][nz])
        self.avgdl = float(self.doc_len.mean()) if self.n_docs else 0.0
        self._indptr = indptr
        self._indices = indices
        self._data = data

        # idf = ln((N - df + 0.5)/(df + 0.5)); negative idfs are floored to
        # epsilon * (pre-floor mean idf)
        n_vocab = len(vocab)
        df = np.bincount(indices, minlength=n_vocab).astype(np.float32)
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
        """Term-major postings and each term's largest contribution (the
        MaxScore bounds), built lazily: per-query cost is then the query
        terms' posting sizes, not the corpus size."""
        if (getattr(self, "_inv_indptr", None) is not None
                and getattr(self, "_inv_ub", None) is not None):
            # a pickle may carry postings without the bounds: rebuild both
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
        # per-term bound: (idf*(k1+1)) times the largest quotient, or the
        # smallest where the epsilon floor leaves idf negative
        if self._inv_docs.size:
            starts = self._inv_indptr[:-1]
            hi = np.maximum.reduceat(self._inv_quot, starts)
            lo = np.minimum.reduceat(self._inv_quot, starts)
            base = (self.idf * (self.k1 + 1.0)).astype(np.float32)
            self._inv_ub = np.where(self.idf >= 0, base * hi,
                                    base * lo).astype(np.float32)
        else:
            self._inv_ub = np.zeros(len(self.vocab), np.float32)

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

    def _query_csr(self, queries_tokens: Sequence[Sequence[str]]
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Each query's known terms, ascending, with their occurrence
        counts: (indptr (Q+1) i64, term ids i64, counts f32)."""
        q_ids: List[int] = []
        q_wts: List[float] = []
        q_indptr = [0]
        vocab = self.vocab
        for toks in queries_tokens:
            cnt = Counter(vocab[t] for t in toks if t in vocab)
            for tid in sorted(cnt):
                q_ids.append(tid)
                q_wts.append(float(cnt[tid]))
            q_indptr.append(len(q_ids))
        return (np.asarray(q_indptr, np.int64), np.asarray(q_ids, np.int64),
                np.asarray(q_wts, np.float32))

    def get_topk_batch(
        self,
        queries_tokens: Sequence[Sequence[str]],
        k: int,
        n_threads: int = 1,
        method: str = "auto",
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Serve-time batched top-k: (idx (Q,k) i64, scores (Q,k) f32), from
        the native posting-traversal kernels, queries spread over
        ``n_threads`` host threads with the GIL released. Equal to
        :meth:`get_topk` query by query (scores, tie and fill rules) except
        where the epsilon-floored IDF goes negative: there the kernels keep
        get_topk's sparse-path order (matched documents before zero-score
        fillers), which get_topk's dense path does not.

        ``method``: "unpruned" streams every query-term posting;
        "maxscore" adds Turtle-Flood upper-bound pruning with the same
        results; "auto" takes MaxScore at 4,000,000 documents or more,
        where the JAX package measured it ahead (1.23-1.47x at 10M documents
        on one thread, a wash or a loss at 1-2M)."""
        from ..native import bm25_topk_batch, bm25_topk_maxscore_batch

        if method not in ("auto", "unpruned", "maxscore"):
            raise ValueError(f"method must be auto|unpruned|maxscore, got "
                             f"{method!r}")
        k = min(k, self.n_docs)
        nq = len(queries_tokens)
        if nq == 0 or k == 0:
            return np.zeros((nq, k), np.int64), np.zeros((nq, k), np.float32)
        if method == "auto":
            method = "maxscore" if self.n_docs >= 4_000_000 else "unpruned"
        self._ensure_inverted()
        q_indptr, q_ids, q_wts = self._query_csr(queries_tokens)
        common = (self._inv_indptr, self._inv_docs, self._inv_quot,
                  self.idf.astype(np.float32))
        tail = (self.n_docs, q_indptr, q_ids, q_wts, self.k1, k, n_threads)
        if method == "maxscore":
            return bm25_topk_maxscore_batch(*common, self._inv_ub, *tail)
        return bm25_topk_batch(*common, *tail)

    def get_topk_batch_plain(
        self, queries_tokens: Sequence[Sequence[str]], k: int
    ) -> Tuple[np.ndarray, np.ndarray]:
        """:meth:`get_topk_batch`'s plain version: one :meth:`get_topk` per
        query."""
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

    def get_scores_batch(self, queries_tokens: Sequence[Sequence[str]]
                         ) -> np.ndarray:
        """BM25 of a batch of queries against every document: (n_queries,
        n_docs) f32, from the native CSR merge-join scorer (one pass over
        the documents for the whole batch). :meth:`get_scores` is its plain
        version, query by query."""
        from ..native import bm25_score_batch

        nq = len(queries_tokens)
        if not self.n_docs or not nq:
            return np.zeros((nq, self.n_docs), dtype=np.float32)
        self._ensure_doc_quot()
        q_indptr, q_ids, q_wts = self._query_csr(queries_tokens)
        return bm25_score_batch(self._indptr, self._indices, self._doc_quot,
                                self.idf.astype(np.float32), q_indptr, q_ids,
                                q_wts, self.k1)


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
