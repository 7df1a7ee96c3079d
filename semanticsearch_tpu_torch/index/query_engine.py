"""Serve-time hybrid query engine: dense top-k + BM25 + RRF over one corpus.

Counterpart of ``semanticsearch_tpu/index/query_engine.py``, on one device
or on the dense index's mesh, which the device BM25 leg shares and
:meth:`HybridQueryEngine.compact` keeps. Each search launches its card work first (query encode, dense top-k, and
under ``RankingConfig.lexical_device`` the device BM25 leg,
``index/bm25_tpu.py``), runs the host lexical work while the card computes
(CUDA launches are asynchronous and nothing synchronizes before it): the
native BM25 top-k, or the device leg's rare-term traversal with its exact
post on a background thread. It fetches the results last and fuses both
legs by reciprocal rank with k=60.

The index is live: :meth:`HybridQueryEngine.add_documents` lands new
documents in a delta buffer searched next to the main index,
:meth:`~HybridQueryEngine.remove_documents` tombstones rows (filtered at
query time with an over-fetch), and :meth:`~HybridQueryEngine.compact`
folds both into the persisted layout through a journaled commit that
:func:`recover_staged_commit` rolls back or forward after a crash.
:meth:`~HybridQueryEngine.tune_fusion` grid-searches the fusion weight on a
labeled split against the live legs.

An engine loaded with ``reranker_dir`` rescores each query's fused head
with a trained neural reranker (``index/rerank_service.py``) when a search
asks for ``rerank_top > 0``, and :meth:`~HybridQueryEngine.tune_rerank_blend`
grid-searches how its ranks blend with the fusion's. An index directory
holding a trained subword vocabulary (``tokenizer.json``) encodes its
queries with it. ``index/server.py`` serves an engine over HTTP, its
coalescing dispatcher driving :meth:`~HybridQueryEngine._dispatch_legs`
and :meth:`~HybridQueryEngine._finish_legs` directly.
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

from ..core import profiling
from ..core.config import IndexConfig, RankingConfig
from ..core.logging import get_logger
from ..data.tsv import read_tsv, write_tsv
from .bm25 import BM25Okapi, load_bm25, tokenize
from .builder import EMB_FILE, IDS_FILE, META_FILE, load_index
from .delta import DeltaBM25, DeltaIndex
from .engine import EmbeddingIndex, SearchResult
from .rrf import rrf_weights

logger = get_logger("query")

BM25_FILE = "bm25.pkl"
TEXTS_FILE = "texts.tsv"
TOKENIZER_FILE = "tokenizer.json"
FUSION_FILE = "fusion.json"
COMMIT_JOURNAL = "compact.commit.json"


def _fsync_path(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def recover_staged_commit(index_dir: str) -> Optional[str]:
    """Crash recovery for :meth:`HybridQueryEngine.compact`'s staged commit.

    The commit protocol: (1) write every new artifact to ``<name>.tmp`` and
    fsync it, (2) durably write the :data:`COMMIT_JOURNAL` listing the
    renames -- the commit point, (3) rename each tmp over its final name,
    (4) fsync the directory and delete the journal. A crash anywhere leaves
    one of two states: journal absent -> the old artifact set is intact
    (stray tmps are deleted); journal present -> every pending rename is
    rolled forward (renames that already happened left no tmp, so the
    roll-forward is idempotent). Called by :meth:`HybridQueryEngine.load`.

    Returns "rolled_forward", "rolled_back", or None (clean directory).
    """
    journal_path = os.path.join(index_dir, COMMIT_JOURNAL)
    if os.path.exists(journal_path):
        with open(journal_path) as f:
            pending = json.load(f)["replaces"]
        for tmp, final in pending:
            # journals store basenames, rejoined to the directory loaded
            tmp = os.path.join(index_dir, os.path.basename(tmp))
            final = os.path.join(index_dir, os.path.basename(final))
            if os.path.exists(tmp):
                os.replace(tmp, final)
        _fsync_path(index_dir)
        os.unlink(journal_path)
        _fsync_path(index_dir)
        logger.warning("recovered interrupted compact in %s: rolled the "
                       "staged commit FORWARD (%d artifacts)",
                       index_dir, len(pending))
        return "rolled_forward"
    # device_bm25.* tmps belong to the lexical-matrix cache builder, which
    # may be writing concurrently in a sibling process: not compact's
    stray = [n for n in os.listdir(index_dir)
             if n.endswith(".tmp") and not n.startswith("device_bm25.")]
    if stray:
        for n in stray:
            os.unlink(os.path.join(index_dir, n))
        logger.warning("recovered interrupted compact in %s: rolled BACK "
                       "(removed %d pre-commit tmp files)",
                       index_dir, len(stray))
        return "rolled_back"
    return None


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


def _finish_lexical(device_bm25, handle, batch: int):
    """The device lexical leg's finish of one batch, under its span."""
    with profiling.span("serve.lexical_finish", {"batch": batch}):
        return device_bm25.finish_topk_batch(handle)


class _SyncLexHandle:
    """The device lexical leg's finish run on the calling thread when
    ``result()`` joins it (``lexical_async_finish = False``)."""

    def __init__(self, device_bm25, handle, batch: int) -> None:
        self._device_bm25 = device_bm25
        self._handle = handle
        self._batch = batch

    def result(self):
        return _finish_lexical(self._device_bm25, self._handle, self._batch)


@dataclass
class Hit:
    chunk_id: str
    score: float
    dense_rank: int = 0
    lexical_rank: int = 0
    rerank_score: Optional[float] = None


class HybridQueryEngine:
    """Dense + lexical retrieval with RRF candidate fusion."""

    def __init__(
        self,
        index: EmbeddingIndex,
        chunk_ids: List[str],
        encoder,
        bm25: Optional[BM25Okapi] = None,
        cfg: RankingConfig = RankingConfig(),
        texts: Optional[List[str]] = None,
        reranker=None,
    ) -> None:
        self.index = index
        self.chunk_ids = chunk_ids
        self.encoder = encoder
        self.bm25 = bm25
        self.cfg = cfg
        self.texts = texts
        self.reranker = reranker
        self._warned_no_bm25 = False
        # serve-time adds: delta rows take global ids from the main index
        # size on; compact() folds them into the persisted layout
        self._delta: Optional[DeltaIndex] = None
        self._delta_bm25: Optional[DeltaBM25] = None
        self._index_dir: Optional[str] = None
        # tombstoned global rows: filtered at query time, dropped by compact
        self._dead: set = set()
        # chunk_id -> rows, built lazily for remove_documents
        self._row_index: Optional[Dict[str, List[int]]] = None
        # the device lexical leg, built on the first hybrid search under
        # cfg.lexical_device for the depth it asked (deeper asks rebuild)
        self._device_bm25 = None
        self._device_bm25_depth = 0
        # one worker runs the device leg's finish (the wait for the card,
        # the native post, host fallbacks) while this thread fetches and
        # fuses; one worker keeps finishes ordered and its stats unraced
        self._lex_executor = None
        self.lexical_async_finish = True
        # batches dispatched: each batch's number joins the spans of its
        # dispatch and its finish, which a pipelined search interleaves
        self._batches = 0

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
        # a trained subword vocabulary is part of the index: queries must
        # encode with the vocabulary the corpus was embedded under
        if hasattr(getattr(encoder, "tokenizer", None), "save"):
            encoder.tokenizer.save(os.path.join(output_dir, TOKENIZER_FILE))
        index, chunk_ids = load_index(output_dir, mesh=mesh, cfg=index_cfg,
                                      device=device)
        engine = cls(index, chunk_ids, encoder, bm25=bm25, cfg=rank_cfg,
                     texts=texts)
        engine._index_dir = output_dir
        return engine

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
        """Serve an index directory written by either package, first
        recovering an interrupted :meth:`compact` there. A trained subword
        vocabulary in the directory (``tokenizer.json``) replaces the
        encoder's tokenizer: queries must encode as the corpus did.
        ``reranker_dir``, a trained reranker checkpoint directory, enables
        the rerank stage of :meth:`search` on ``device``."""
        recover_staged_commit(index_dir)
        tok_path = os.path.join(index_dir, TOKENIZER_FILE)
        if os.path.exists(tok_path):
            from ..models.subword import SubwordTokenizer

            encoder.tokenizer = SubwordTokenizer.load(tok_path)
        index, chunk_ids = load_index(index_dir, mesh=mesh, cfg=index_cfg,
                                      device=device)
        bm25_path = os.path.join(index_dir, BM25_FILE)
        bm25 = load_bm25(bm25_path) if os.path.exists(bm25_path) else None
        texts_path = os.path.join(index_dir, TEXTS_FILE)
        texts = ([r.get("chunk_text", "") for r in read_tsv(texts_path)]
                 if os.path.exists(texts_path) else None)
        reranker = None
        if reranker_dir:
            from .rerank_service import RerankService

            reranker = RerankService.load(reranker_dir, device=device)
        # a persisted tuned fusion alpha and rerank blend apply unless the
        # caller set them; rerank_blend's "unset" is its default 1.0
        fusion_path = os.path.join(index_dir, FUSION_FILE)
        if os.path.exists(fusion_path):
            with open(fusion_path) as f:
                persisted = json.load(f)
            if rank_cfg.fusion_alpha is None:
                rank_cfg = dataclasses.replace(
                    rank_cfg, fusion_alpha=float(persisted["fusion_alpha"]))
                logger.info("using persisted fusion_alpha=%s from %s",
                            rank_cfg.fusion_alpha, fusion_path)
            if (rank_cfg.rerank_blend == 1.0
                    and persisted.get("rerank_blend") is not None):
                rank_cfg = dataclasses.replace(
                    rank_cfg, rerank_blend=float(persisted["rerank_blend"]))
                logger.info("using persisted rerank_blend=%s from %s",
                            rank_cfg.rerank_blend, fusion_path)
        engine = cls(index, chunk_ids, encoder, bm25=bm25, cfg=rank_cfg,
                     texts=texts, reranker=reranker)
        engine._index_dir = index_dir
        return engine

    # ------------------------------------------------- incremental updates
    def add_documents(
        self, chunk_ids: Sequence[str], texts: Sequence[str]
    ) -> None:
        """Add documents at serve time without rebuilding the index: they
        are embedded now and land in the delta buffer searched next to the
        main index; the lexical leg scores them with the main corpus's
        frozen BM25 statistics. Process-local until :meth:`compact`."""
        if len(chunk_ids) != len(texts):
            raise ValueError(f"{len(chunk_ids)} chunk ids vs {len(texts)} "
                             "texts")
        if not texts:
            return
        emb = np.asarray(self.encoder.encode(list(texts)), np.float32)
        if self._delta is None:
            self._delta = DeltaIndex(dim=emb.shape[1],
                                     device=self.index.device)
        self._delta.add(emb)
        if self.bm25 is not None:
            if self._delta_bm25 is None:
                self._delta_bm25 = DeltaBM25(self.bm25)
            self._delta_bm25.add([tokenize(t) for t in texts])
        self.chunk_ids = list(self.chunk_ids) + list(chunk_ids)
        self._row_index = None
        if self.texts is not None:
            self.texts = list(self.texts) + list(texts)

    def remove_documents(self, chunk_ids: Sequence[str]) -> int:
        """Tombstone documents by chunk id; returns how many rows matched.
        Removed rows stop appearing at once (query-time filter with an
        over-fetch); :meth:`compact` drops them physically."""
        if self._row_index is None:
            ri: Dict[str, List[int]] = {}
            for row, cid in enumerate(self.chunk_ids):
                ri.setdefault(cid, []).append(row)
            self._row_index = ri
        hit = 0
        for cid in set(chunk_ids):
            for row in self._row_index.get(cid, ()):
                if row not in self._dead:
                    self._dead.add(row)
                    hit += 1
        return hit

    def compact(self, output_dir: Optional[str] = None) -> None:
        """Fold the delta into the persisted layout and reload.

        Rewrites embeddings.f16.npy / ids.tsv / texts.tsv / meta.json /
        bm25.pkl at ``output_dir`` (default: the directory this engine
        loaded from) with the live main and delta rows, tombstones dropped
        and rows renumbered, rebuilds the BM25 statistics over the live
        corpus, and reloads the dense index. Every artifact is staged as a
        ``.tmp``, fsynced, and committed by a journal (see
        :func:`recover_staged_commit`)."""
        if self._index_dir is None:
            raise ValueError("compact requires the on-disk index layout (an "
                             "engine from build or load)")
        if self.texts is None:
            raise ValueError("compact requires texts (index built without "
                             "texts.tsv)")
        out = output_dir or self._index_dir
        n_delta = self._delta.n if self._delta is not None else 0
        base = self.index.size
        old_emb = np.load(os.path.join(self._index_dir, EMB_FILE),
                          mmap_mode="r")
        os.makedirs(out, exist_ok=True)
        dim = old_emb.shape[1]
        live_mask = np.ones(base + n_delta, dtype=bool)
        if self._dead:
            live_mask[np.fromiter(self._dead, dtype=np.int64)] = False
        live = np.flatnonzero(live_mask)  # ascending row ids
        total = int(live.size)
        emb_tmp = os.path.join(out, EMB_FILE) + ".tmp"
        mm = np.lib.format.open_memmap(emb_tmp, mode="w+", dtype=np.float16,
                                       shape=(total, dim))
        # copy contiguous live runs as bulk slices: O(#tombstones + 1) runs
        if total:
            breaks = np.flatnonzero(np.diff(live) != 1) + 1
            pos = 0
            for si, ei in zip(np.concatenate([[0], breaks]),
                              np.concatenate([breaks, [total]])):
                run_start, run_end = int(live[si]), int(live[ei - 1]) + 1
                n_run = run_end - run_start
                n_main = max(0, min(run_end, base) - run_start)
                if n_main:
                    mm[pos: pos + n_main] = old_emb[run_start: run_start + n_main]
                if n_main < n_run:
                    mm[pos + n_main: pos + n_run] = self._delta._host[
                        max(run_start, base) - base: run_end - base
                    ].astype(np.float16)
                pos += n_run
        mm.flush()
        del mm
        replaces = [(emb_tmp, os.path.join(out, EMB_FILE))]
        live_texts = [self.texts[i] for i in live]

        # main rows keep their ids.tsv metadata (streamed); delta rows get
        # empty query/document ids
        def _id_rows():
            old_iter = read_tsv(os.path.join(self._index_dir, IDS_FILE))
            old_row, old = -1, {}
            for pos, row in enumerate(live):
                while old_row < row:
                    old = next(old_iter, None) or {}
                    old_row += 1
                main = row < base
                yield {"row": str(pos), "chunk_id": self.chunk_ids[row],
                       "query_id": old.get("query_id", "") if main else "",
                       "document_id": old.get("document_id", "")
                       if main else ""}

        ids_tmp = os.path.join(out, IDS_FILE) + ".tmp"
        write_tsv(ids_tmp, _id_rows(),
                  ["row", "chunk_id", "query_id", "document_id"])
        replaces.append((ids_tmp, os.path.join(out, IDS_FILE)))
        texts_tmp = os.path.join(out, TEXTS_FILE) + ".tmp"
        write_tsv(texts_tmp, ({"chunk_text": t} for t in live_texts),
                  ["chunk_text"])
        replaces.append((texts_tmp, os.path.join(out, TEXTS_FILE)))
        meta = {"rows": total, "dim": dim}
        old_meta_path = os.path.join(self._index_dir, META_FILE)
        if os.path.exists(old_meta_path):
            with open(old_meta_path) as f:
                meta = {**json.load(f), **meta}
        meta_tmp = os.path.join(out, META_FILE) + ".tmp"
        with open(meta_tmp, "w") as f:
            json.dump(meta, f)
        replaces.append((meta_tmp, os.path.join(out, META_FILE)))
        self.bm25 = BM25Okapi(
            [tokenize(t) for t in live_texts],
            k1=self.cfg.bm25_k1, b=self.cfg.bm25_b,
            epsilon=self.cfg.bm25_epsilon,
        )
        bm_tmp = os.path.join(out, BM25_FILE) + ".tmp"
        with open(bm_tmp, "wb") as f:
            pickle.dump(self.bm25, f)
        replaces.append((bm_tmp, os.path.join(out, BM25_FILE)))
        # durability: fsync every staged file, then write the journal (the
        # commit point), rename, and clean up
        for tmp, _ in replaces:
            _fsync_path(tmp)
        journal_path = os.path.join(out, COMMIT_JOURNAL)
        journal_tmp = journal_path + ".tmp"  # .tmp: swept by a roll-back
        with open(journal_tmp, "w") as f:
            json.dump({"replaces": [
                [os.path.basename(t), os.path.basename(fn)]
                for t, fn in replaces
            ]}, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(journal_tmp, journal_path)
        _fsync_path(out)
        for tmp, final in replaces:
            os.replace(tmp, final)
        _fsync_path(out)
        os.unlink(journal_path)
        _fsync_path(out)
        self.texts = live_texts
        mesh, idx_cfg = self.index._mesh, self.index.cfg
        device = self.index.device
        # release the old device corpus before loading the compacted one
        self.index = None
        self.index, self.chunk_ids = load_index(out, mesh=mesh, cfg=idx_cfg,
                                                device=device)
        self._delta = None
        self._delta_bm25 = None
        self._dead = set()
        self._device_bm25 = None  # statistics changed: rebuilt on demand
        self._row_index = None
        self._index_dir = out

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
        fusion (default max(4k, 20)).

        ``rerank_top`` > 0 rescores each query's top-``rerank_top`` fused
        candidates with the loaded reranker (one packed scoring of the
        whole batch) and reorders that head; the tail keeps its fusion
        order after it. Requires ``reranker_dir`` at :meth:`load` and the
        index's ``texts.tsv``."""
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
        computes. No result is fetched here. The state carries the batch's
        number (``batch``), which its finish's spans repeat."""
        batch = self._batches
        self._batches += 1
        with profiling.span("serve.dispatch", {"batch": batch}):
            state = self._dispatch(queries, k, candidates, hybrid, batch)
        return state

    def _dispatch(self, queries, k, candidates, hybrid, batch: int) -> Dict:
        depth = candidates or max(4 * k, 20)
        # tombstones: over-fetch so the filtered lists stay full while the
        # tombstones are few; bucketed to 64s as in the JAX package
        fetch = depth
        if self._dead:
            fetch = depth + ((len(self._dead) + 63) // 64) * 64
        use_bm25 = hybrid and self.bm25 is not None
        if hybrid and self.bm25 is None and not self._warned_no_bm25:
            logger.warning(
                "hybrid search requested but the index has no BM25 stats "
                "(build with HybridQueryEngine.build); serving dense-only")
            self._warned_no_bm25 = True
        q_tokens = None
        if use_bm25:
            with profiling.span("serve.tokenize_lexical"):
                q_tokens = [tokenize(q) for q in queries]
        q_emb = self.encoder.encode_device(list(queries))
        dense_packed = _pack_scores_indices(*self.index.search_device(
            q_emb, k=min(fetch, self.index.size)))
        # serve-time adds: the delta buffer, merged by score in _leg_lists
        n_delta = self._delta.n if self._delta is not None else 0
        delta = None
        if n_delta:
            with profiling.span("serve.delta"):
                delta = self._delta.search(q_emb, min(fetch, n_delta))
        bm_host = delta_lex = lex_handle = None
        if use_bm25:
            bm_depth = min(fetch, self.index.size)
            with profiling.span("serve.lexical"):
                if self.cfg.lexical_device:
                    lex_handle = self._start_device_lexical(q_tokens,
                                                            bm_depth, batch)
                else:
                    bm_host = self.bm25.get_topk_batch(
                        q_tokens, bm_depth,
                        n_threads=self.cfg.resolved_bm25_threads())
            if n_delta and self._delta_bm25 is not None:
                with profiling.span("serve.delta_lexical"):
                    delta_lex = self._delta_bm25.score(q_tokens)
        return {
            "batch": batch,
            "queries": queries,
            "depth": depth,
            "use_bm25": use_bm25,
            "base": self.index.size,
            "dense_packed": dense_packed,
            "delta": delta,
            "bm_host": bm_host,
            "lex_handle": lex_handle,
            "delta_lex": delta_lex,
        }

    def _start_device_lexical(self, q_tokens, depth: int, batch: int):
        """Launch the device BM25 leg and hand its finish to the background
        worker; ``_leg_lists`` joins it. The leg is built on first use, and
        rebuilt for a request deeper than the K' it was built for (a
        shallow candidate pool would send every query to the host
        fallback)."""
        if self._device_bm25 is not None and depth > self._device_bm25_depth:
            logger.info("device BM25 rebuilt for depth %d (was %d)", depth,
                        self._device_bm25_depth)
            self._device_bm25 = None
        if self._device_bm25 is None:
            from .bm25_tpu import DeviceBM25

            self._device_bm25_depth = max(self.cfg.lexical_topk_device,
                                          depth)
            self._device_bm25 = DeviceBM25(
                self.bm25,
                n_dense_terms=self.cfg.lexical_dense_terms,
                topk_device=self._device_bm25_depth,
                residual=self.cfg.lexical_residual,
                weights=self.cfg.lexical_weights,
                cache_dir=(self._index_dir if self.cfg.lexical_cache
                           else None),
                # the dense index's mesh: the int8 matrix shards by
                # document columns over the same devices
                mesh=self.index._mesh,
                device=self.index.device,
            )
        leg = self._device_bm25
        handle = leg.start_topk_batch(q_tokens, depth)
        if not self.lexical_async_finish:
            return _SyncLexHandle(leg, handle, batch)
        if self._lex_executor is None:
            from concurrent.futures import ThreadPoolExecutor

            self._lex_executor = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="lex-finish")
        return self._lex_executor.submit(_finish_lexical, leg, handle, batch)

    def _leg_lists(
        self, state: Dict
    ) -> Tuple[List[List[Tuple[float, int]]],
               Optional[List[List[Tuple[float, int]]]]]:
        """Fetch the dense leg and build per-query (score, row) lists:
        delta-merged, tombstone-filtered, truncated to the search depth,
        by descending score. The lexical lists keep positive scores only;
        the second element is None for dense-only searches. Shared by
        ``_finish_legs`` and ``tune_fusion``."""
        depth = state["depth"]
        base = state["base"]
        dense = _unpack_scores_indices(state["dense_packed"].cpu().numpy())
        if state["lex_handle"] is not None:
            # the device leg's finish ran on the worker since dispatch
            state["bm_host"] = state["lex_handle"].result()
            state["lex_handle"] = None
        dense_lists: List[List[Tuple[float, int]]] = []
        lex_lists: Optional[List[List[Tuple[float, int]]]] = (
            [] if state["use_bm25"] else None)
        for qi in range(len(state["queries"])):
            dense_list = list(zip(dense.scores[qi].tolist(),
                                  dense.indices[qi].tolist()))
            if state["delta"] is not None:
                # entries past the delta's live count come back at NEG_INF
                dv, di = state["delta"]
                dense_list += [(v, base + j) for v, j in
                               zip(dv[qi].tolist(), di[qi].tolist())
                               if v > -1e29]
                dense_list.sort(key=lambda sr: (-sr[0], sr[1]))
            if self._dead:
                dense_list = [sr for sr in dense_list
                              if sr[1] not in self._dead]
            dense_lists.append(dense_list[:depth])
            if lex_lists is None:
                continue
            bm_idx, bm_scores = state["bm_host"]
            lex_list = [(float(sc), int(row))
                        for row, sc in zip(bm_idx[qi], bm_scores[qi])
                        if sc > 0]
            if state["delta_lex"] is not None:
                dl = state["delta_lex"][qi]
                lex_list += [(float(dl[j]), base + int(j))
                             for j in np.flatnonzero(dl > 0)]
                lex_list.sort(key=lambda sr: (-sr[0], sr[1]))
            if self._dead:
                lex_list = [sr for sr in lex_list if sr[1] not in self._dead]
            lex_lists.append(lex_list[:depth])
        return dense_lists, lex_lists

    def _finish_legs(self, state: Dict, k: int, rerank_top: int
                     ) -> List[List[Hit]]:
        """Phase 2 of ``search``: fetch, RRF-fuse both legs, and rerank
        the fused head when asked."""
        with profiling.span("serve.finish", {"batch": state["batch"]}):
            return self._finish(state, k, rerank_top)

    def _finish(self, state: Dict, k: int, rerank_top: int
                ) -> List[List[Hit]]:
        queries = state["queries"]
        if rerank_top > 0:
            if self.reranker is None:
                raise ValueError(
                    "rerank_top > 0 but no reranker loaded "
                    "(pass reranker_dir to HybridQueryEngine.load)")
            if self.texts is None:
                raise ValueError(
                    "rerank_top > 0 but the index has no texts.tsv "
                    "(rebuild the index with HybridQueryEngine.build)")
        with profiling.span("serve.lists"):
            dense_lists, lex_lists = self._leg_lists(state)
        with profiling.span("serve.fuse"):
            per_query, rows_per_query = self._fuse(dense_lists, lex_lists,
                                                   k, rerank_top)
        if rerank_top > 0:
            with profiling.span("serve.rerank"):
                self._rerank_heads(queries, per_query, rows_per_query,
                                   rerank_top)
        return [hits[:k] for hits in per_query]

    def _fuse(self, dense_lists, lex_lists, k: int, rerank_top: int):
        """Each query's hits by reciprocal rank over both legs' lists, the
        fused head as deep as ``max(k, rerank_top)``, and their rows."""
        w_dense, w_lex = rrf_weights(self.cfg.fusion_alpha)
        per_query: List[List[Hit]] = []
        rows_per_query: List[List[int]] = []
        for qi in range(len(dense_lists)):
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
            ranked = sorted(rrf.items(), key=lambda kv: (-kv[1], kv[0]))[
                :max(k, rerank_top)]
            per_query.append([
                Hit(chunk_id=self.chunk_ids[row], score=score,
                    dense_rank=dense_rank.get(row, 0),
                    lexical_rank=lex_rank.get(row, 0))
                for row, score in ranked
            ])
            rows_per_query.append([row for row, _ in ranked])
        return per_query, rows_per_query

    def _rerank_heads(self, queries, per_query: List[List[Hit]],
                      rows_per_query: List[List[int]], rerank_top: int
                      ) -> None:
        """Score every query's top-``rerank_top`` hits in one packed call
        and reorder each head in place: by the reranker's scores alone at
        ``rerank_blend`` 1 (a stable sort, so ties keep the fusion order),
        else by a rank-RRF blend of its order with the fusion order."""
        heads = [rows[:rerank_top] for rows in rows_per_query]
        flat_scores = self.reranker.score_pairs(
            [q for q, head in zip(queries, heads) for _ in head],
            [self.texts[row] for head in heads for row in head])
        blend = min(1.0, max(0.0, self.cfg.rerank_blend))
        kk = self.cfg.rrf_k
        off = 0
        for qi, hits in enumerate(per_query):
            n_head = len(heads[qi])
            head = hits[:n_head]
            for j, h in enumerate(head):
                h.rerank_score = float(flat_scores[off + j])
            off += n_head
            if blend >= 1.0:
                order = sorted(range(n_head),
                               key=lambda j: -head[j].rerank_score)
            else:
                # head j's fusion rank is j + 1 by construction
                rr_rank = np.empty(n_head, np.int32)
                rr_rank[np.argsort([-h.rerank_score for h in head],
                                   kind="stable")] = np.arange(1, n_head + 1)
                combined = [blend / (kk + rr_rank[j])
                            + (1.0 - blend) / (kk + j + 1)
                            for j in range(n_head)]
                order = sorted(range(n_head), key=lambda j: (-combined[j], j))
            per_query[qi] = [head[j] for j in order] + hits[n_head:]

    def tune_fusion(
        self,
        queries: Sequence[str],
        relevant_ids: Sequence[Sequence[str]],
        candidates: Optional[int] = None,
        grid: Optional[Sequence[float]] = None,
    ) -> Tuple[float, float, Dict[float, float]]:
        """Grid-search the weighted-RRF mixing alpha on a labeled
        validation split against the live engine legs: one dispatch of the
        whole split, then every alpha re-fuses the fetched rank lists on the
        host.

        ``relevant_ids[i]`` are the chunk_ids relevant to ``queries[i]``.
        Returns ``(best_alpha, best_map, {alpha: map})``; relevant chunks
        missing from both legs' pools count as unretrieved (they divide the
        AP denominator). Ties break toward 0.5, the unweighted fusion.
        Persist the result as ``fusion.json`` beside the index
        (``{"fusion_alpha": best}``) and :meth:`load` applies it."""
        from ..train.fusion import DEFAULT_GRID

        if len(queries) != len(relevant_ids):
            raise ValueError(
                f"{len(queries)} queries vs {len(relevant_ids)} label rows")
        state = self._dispatch_legs(list(queries), k=10,
                                    candidates=candidates, hybrid=True)
        if not state["use_bm25"]:
            raise ValueError(
                "tune_fusion needs a hybrid index (build with --bm25)")
        dense_lists, lex_lists = self._leg_lists(state)
        id_to_row = {cid: row for row, cid in enumerate(self.chunk_ids)}
        rel_rows = [
            {id_to_row[str(c)] for c in rel if str(c) in id_to_row}
            for rel in relevant_ids
        ]
        rrf_k = self.cfg.rrf_k
        table: Dict[float, float] = {}
        for alpha in (grid if grid is not None else DEFAULT_GRID):
            w_dense, w_lex = rrf_weights(float(alpha))
            aps = []
            for qi in range(len(queries)):
                rrf: Dict[int, float] = {}
                for rank, (_, row) in enumerate(dense_lists[qi], start=1):
                    rrf[row] = rrf.get(row, 0.0) + w_dense / (rrf_k + rank)
                for rank, (_, row) in enumerate(lex_lists[qi], start=1):
                    rrf[row] = rrf.get(row, 0.0) + w_lex / (rrf_k + rank)
                ranked = sorted(rrf.items(), key=lambda kv: (-kv[1], kv[0]))
                hits = 0
                ap = 0.0
                for pos, (row, _) in enumerate(ranked, start=1):
                    if row in rel_rows[qi]:
                        hits += 1
                        ap += hits / pos
                aps.append(ap / max(1, len(rel_rows[qi])))
            table[float(alpha)] = float(np.mean(aps)) if aps else 0.0
        best = max(table, key=lambda a: (table[a], -abs(a - 0.5)))
        return best, table[best], table

    def tune_rerank_blend(
        self,
        queries: Sequence[str],
        relevant_ids: Sequence[Sequence[str]],
        rerank_top: int = 20,
        grid: Optional[Sequence[float]] = None,
    ) -> Tuple[float, float, Dict[float, float]]:
        """Grid-search ``RankingConfig.rerank_blend`` on a labeled
        validation split: one dispatch of the split and one packed
        reranker scoring of every query's fused top-``rerank_top``; every
        beta reorders the fetched heads on the host and is scored as MAP,
        relevant chunks outside the fused lists counting as unretrieved
        (as in :meth:`tune_fusion`). Fusion uses the engine's current
        ``cfg.fusion_alpha``: tune the fusion first. Ties break toward
        beta = 1.0, pure rescoring. Returns ``(best_beta, best_map,
        {beta: map})``; persist ``{"rerank_blend": best}`` in the index's
        ``fusion.json`` and :meth:`load` applies it."""
        if self.reranker is None:
            raise ValueError("tune_rerank_blend needs a loaded reranker "
                             "(pass reranker_dir to HybridQueryEngine.load)")
        if self.texts is None:
            raise ValueError("tune_rerank_blend needs the index texts.tsv")
        if len(queries) != len(relevant_ids):
            raise ValueError(
                f"{len(queries)} queries vs {len(relevant_ids)} label rows")
        state = self._dispatch_legs(list(queries), k=rerank_top,
                                    candidates=None,
                                    hybrid=self.bm25 is not None)
        dense_lists, lex_lists = self._leg_lists(state)
        w_dense, w_lex = rrf_weights(self.cfg.fusion_alpha)
        kk = self.cfg.rrf_k
        heads: List[List[int]] = []  # per query: fused rows, fusion order
        tails: List[List[int]] = []
        for qi in range(len(queries)):
            rrf: Dict[int, float] = {}
            for rank, (_, row) in enumerate(dense_lists[qi], start=1):
                rrf[row] = rrf.get(row, 0.0) + w_dense / (kk + rank)
            if lex_lists is not None:
                for rank, (_, row) in enumerate(lex_lists[qi], start=1):
                    rrf[row] = rrf.get(row, 0.0) + w_lex / (kk + rank)
            ranked = [row for row, _ in
                      sorted(rrf.items(), key=lambda kv: (-kv[1], kv[0]))]
            heads.append(ranked[:rerank_top])
            tails.append(ranked[rerank_top:])
        flat_scores = self.reranker.score_pairs(
            [q for q, head in zip(queries, heads) for _ in head],
            [self.texts[row] for head in heads for row in head])
        id_to_row = {cid: row for row, cid in enumerate(self.chunk_ids)}
        rel_rows = [
            {id_to_row[str(c)] for c in rel if str(c) in id_to_row}
            for rel in relevant_ids
        ]
        table: Dict[float, float] = {}
        # a fine 1/16 grid: every beta reorders the same predictions
        default_grid = tuple(round(i / 16, 4) for i in range(17))
        for beta in (grid if grid is not None else default_grid):
            beta = float(beta)
            aps, off = [], 0
            for qi in range(len(queries)):
                head = heads[qi]
                pred = np.asarray(flat_scores[off: off + len(head)],
                                  np.float64)
                off += len(head)
                rr_rank = np.empty(len(head), np.int64)
                rr_rank[np.argsort(-pred, kind="stable")] = \
                    np.arange(1, len(head) + 1)
                combined = [beta / (kk + rr_rank[j]) + (1 - beta) / (kk + j + 1)
                            for j in range(len(head))]
                order = sorted(range(len(head)),
                               key=lambda j: (-combined[j], j))
                full = [head[j] for j in order] + tails[qi]
                hits = 0
                ap = 0.0
                for pos, row in enumerate(full, start=1):
                    if row in rel_rows[qi]:
                        hits += 1
                        ap += hits / pos
                aps.append(ap / max(1, len(rel_rows[qi])))
            table[beta] = float(np.mean(aps)) if aps else 0.0
        best = max(table, key=lambda b: (table[b], -abs(b - 1.0)))
        return best, table[best], table
