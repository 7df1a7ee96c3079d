"""End-to-end chunking pipeline: TSV in -> cleaned -> chunked -> TSV out.

Counterpart of ``semanticsearch_tpu/chunking/pipeline.py``, itself a rebuild
of the reference controller (``data_process/simple_chunk_controller.py:
505-1441``) with the device boundary redrawn: instead of one
SentenceTransformer per worker process embedding one document at a time, ALL
sentences of a row batch are encoded in one large device batch
(``SentenceEncoder.encode_device``), sliced per document on the device for
the batched similarity signals, and copied to the host once. Everything
else — cleaning with the revert guardrail, per-method dispatch,
whole-document fallback chunk, 50k-char truncation, streaming TSV writes,
eval summary — is host-side and keeps the reference's semantics.
"""
from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..core.config import ChunkingConfig, Config
from ..core.logging import get_logger
from ..data.tsv import batched, read_tsv, write_tsv
from ..models.encoder import SentenceEncoder
from ..ops._build import KernelError
from .cleaning import clean_with_guardrail, preclean_text
from .grouping import batched_similarity_matrices, chunk_passage_grouping
from .naive import chunk_by_chars
from .segmenter import extract_sentences
from .splitter import batched_split_signals, chunk_passage_splitter

logger = get_logger("chunking")

BATCH_SIZE = 600           # rows per streaming batch (reference :115)
MAX_CHUNK_CHARS = 50_000   # chunk truncation cap (reference :1098-1100)

CHUNK_COLUMNS = ["query_id", "document_id", "chunk_text", "label"]
MAP_COLUMNS = ["query_id", "document_id", "chunk_id", "sent_indices", "meta"]


@dataclass
class ChunkRunStats:
    rows_in: int = 0
    docs_chunked: int = 0
    chunks_out: int = 0
    fallbacks: int = 0
    elapsed_s: float = 0.0
    chunk_word_counts: List[int] = field(default_factory=list)

    def summary(self) -> Dict:
        words = np.asarray(self.chunk_word_counts or [0], dtype=np.float64)
        return {
            "rows_in": self.rows_in,
            "docs_chunked": self.docs_chunked,
            "chunks_out": self.chunks_out,
            "fallbacks": self.fallbacks,
            "elapsed_s": round(self.elapsed_s, 3),
            "chunks_per_sec": round(self.chunks_out / self.elapsed_s, 2)
            if self.elapsed_s else 0.0,
            "avg_chunks_per_doc": round(
                self.chunks_out / max(1, self.docs_chunked), 3
            ),
            "chunk_words": {
                "mean": float(words.mean()),
                "p10": float(np.percentile(words, 10)),
                "median": float(np.median(words)),
                "p90": float(np.percentile(words, 90)),
                "max": float(words.max()),
            },
        }


class ChunkPipeline:
    """Chunk a 5-column corpus TSV with the configured method.

    The similarity signals run on ``device`` (the encoder's device when an
    encoder is given). ``debug_visuals_docs`` > 0 exports heatmap, signal
    and strip PNGs for the first that many documents into
    ``debug_visuals_dir`` (``chunking/visualize.py``). With a ``mesh`` the
    encoder it builds is data parallel over the mesh (``device`` is the
    mesh's first device), and grouping documents of at least
    ``sp_min_sentences`` sentences take their similarity matrix through the
    ring (``parallel/ring_similarity.py``) when the mesh has more than one
    data shard."""

    def __init__(
        self,
        cfg: Config = Config(),
        encoder: Optional[SentenceEncoder] = None,
        debug_visuals_docs: int = 0,
        debug_visuals_dir: Optional[str] = None,
        ideal_bounds_dir: Optional[str] = None,
        mesh=None,
        device="cuda",
    ) -> None:
        self.cfg = cfg
        self.mesh = mesh  # multi-device: shard encode + SP long-doc sims
        if mesh is not None:
            from ..core.mesh import local_row_devices

            device = local_row_devices(mesh)[0]
        self.encoder = encoder  # lazily built; char method needs none
        self.device = torch.device(device if encoder is None
                                   else encoder.device)
        # Export heatmap/signal/strip PNGs for the first N documents
        # (reference debug visuals, simple_chunk_controller.py:670-1050).
        self.debug_visuals_docs = debug_visuals_docs
        self.debug_visuals_dir = debug_visuals_dir
        self.ideal_bounds_dir = ideal_bounds_dir
        self._visuals_done = 0

    def _get_encoder(self) -> SentenceEncoder:
        if self.encoder is None:
            self.encoder = SentenceEncoder(self.cfg.encoder,
                                           device=self.device, mesh=self.mesh)
        return self.encoder

    # -- per-document chunking given precomputed embeddings ------------------
    def _chunk_doc(
        self,
        doc_id: str,
        sentences: List[str],
        embeddings: Optional[np.ndarray],
        raw_text: str,
        signals=None,
        sim_matrix=None,
    ) -> List[Tuple[str, str, Optional[str]]]:
        ccfg = self.cfg.chunking
        if ccfg.method == "char":
            return chunk_by_chars(
                doc_id, raw_text, ccfg.char_chunk_size, ccfg.char_overlap,
                collect_metadata=ccfg.collect_metadata,
            )
        if not sentences or embeddings is None or len(sentences) == 0:
            return [(f"{doc_id}_fallback", raw_text, None)] if raw_text else []
        if ccfg.method == "grouping":
            return chunk_passage_grouping(
                doc_id, sentences, embeddings, ccfg,
                collect_metadata=ccfg.collect_metadata, seed=self.cfg.seed,
                sim_matrix=sim_matrix, device=self.device,
            )
        return chunk_passage_splitter(
            doc_id, sentences, embeddings, ccfg,
            collect_metadata=ccfg.collect_metadata,
            signals=signals, device=self.device,
        )

    def _precompute_signals(self, embeddings_by_doc, signals_by_doc,
                            sims_by_doc) -> None:
        """Fill per-doc (rank matrix, adj sims) or similarity matrices using
        one batched device call per length bucket.

        ``embeddings_by_doc`` holds each document's (n, d) embeddings, on
        the device or the host. Buckets ladder 8..max_sentences (4096 covers
        the corpus-max 3,939-sentence document without truncation); big
        buckets are sub-batched by an element budget so the (B, L, L)
        intermediates stay bounded.
        """
        ccfg = self.cfg.chunking
        use_signals = ccfg.method == "splitter" and not ccfg.c99_use_local_rank
        use_sims = ccfg.method == "grouping"
        if not (use_signals or use_sims):
            return
        buckets: Dict[int, List[int]] = {}
        for i, emb in enumerate(embeddings_by_doc):
            if emb is None or emb.shape[0] <= 1:
                continue
            n = emb.shape[0]
            bucket = 1 << max(3, (n - 1).bit_length())  # 8,16,...,4096
            buckets.setdefault(bucket, []).append(i)

        n_dev = self.mesh.shape["data"] if self.mesh is not None else 1
        budget_elems = 1 << 26  # ~64M f32 per (B, L, L) intermediate
        for bucket, idxs in buckets.items():
            # SP route: grouping + multi-device mesh + doc ACTUALLY at or
            # beyond the threshold (the bucket is a power-of-two ceiling, so
            # testing it would also catch docs up to 2x shorter)
            if use_sims and n_dev > 1:
                sp_min = ccfg.sp_min_sentences
                long_idxs = [i for i in idxs
                             if embeddings_by_doc[i].shape[0] >= sp_min]
                if long_idxs:
                    from ..parallel import ring_similarity

                    for i in long_idxs:
                        sims_by_doc[i] = ring_similarity.sharded_doc_similarity(
                            embeddings_by_doc[i], self.mesh)
                    idxs = [i for i in idxs if i not in set(long_idxs)]
                    if not idxs:
                        continue
            b_max = max(1, budget_elems // (bucket * bucket))
            for s in range(0, len(idxs), b_max):
                part = idxs[s: s + b_max]
                embs = [embeddings_by_doc[i] for i in part]
                if use_signals:
                    for i, sig in zip(part, batched_split_signals(
                            embs, bucket, device=self.device)):
                        signals_by_doc[i] = sig
                else:
                    for i, S in zip(part, batched_similarity_matrices(
                            embs, bucket, device=self.device)):
                        sims_by_doc[i] = S

    # -- batch processing -----------------------------------------------------
    def _process_batch(
        self, rows: List[Dict[str, str]], stats: ChunkRunStats
    ) -> Iterator[Dict[str, str]]:
        ccfg = self.cfg.chunking
        docs: List[Tuple[Dict, str, List[str]]] = []
        need_embed = ccfg.method in ("splitter", "grouping")
        for row in rows:
            stats.rows_in += 1
            raw = row.get("document", row.get("chunk_text", ""))
            if not raw:
                continue
            text = clean_with_guardrail(raw)
            text = preclean_text(text)
            sentences = extract_sentences(text) if need_embed else []
            if need_embed and len(sentences) > ccfg.max_sentences:
                sentences = sentences[: ccfg.max_sentences]
            docs.append((row, text, sentences))

        embeddings_by_doc: List[Optional[np.ndarray]] = [None] * len(docs)
        signals_by_doc: List = [None] * len(docs)
        sims_by_doc: List = [None] * len(docs)
        if need_embed:
            # ONE device batch for every sentence in the row batch.
            all_sents: List[str] = []
            spans: List[Tuple[int, int]] = []
            for _, _, sentences in docs:
                spans.append((len(all_sents), len(all_sents) + len(sentences)))
                all_sents.extend(sentences)
            device_embs: List[Optional[torch.Tensor]] = [None] * len(docs)
            if all_sents:
                # large device batches: a row batch is thousands of
                # sentences. The embeddings stay on the device for the
                # batched signals and reach the host in one copy.
                embs_dev = self._get_encoder().encode_device(
                    all_sents, batch_size=2048)
                embs = embs_dev.cpu().numpy()
                for i, (s, e) in enumerate(spans):
                    if e > s:
                        embeddings_by_doc[i] = embs[s:e]
                        device_embs[i] = embs_dev[s:e]
            # Batch the per-document similarity/rank math across docs of
            # similar length: one device call per bucket instead of several
            # per document.
            self._precompute_signals(device_embs, signals_by_doc, sims_by_doc)

        for (row, text, sentences), embs, sig, sim in zip(
            docs, embeddings_by_doc, signals_by_doc, sims_by_doc
        ):
            doc_id = row.get("document_id", row.get("query_id", "doc"))
            try:
                chunks = self._chunk_doc(
                    doc_id, sentences, embs, text, signals=sig, sim_matrix=sim
                )
            except (KernelError, NotImplementedError):
                # a kernel that does not build, load, launch or take its
                # input is a fault of the installation, not of the document
                raise
            except Exception as exc:  # degrade-don't-die (reference :725-726)
                logger.warning("chunking failed for %s: %s; falling back", doc_id, exc)
                chunks = [(f"{doc_id}_fallback", text, None)]
            if not chunks:
                continue
            if len(chunks) == 1 and chunks[0][0].endswith("_fallback"):
                stats.fallbacks += 1
            stats.docs_chunked += 1
            if (
                self._visuals_done < self.debug_visuals_docs
                and embs is not None and len(sentences) > 2
            ):
                self._export_visuals(doc_id, embs, chunks)
            for cid, ctext, meta in chunks:
                ctext = ctext[:MAX_CHUNK_CHARS]
                stats.chunks_out += 1
                stats.chunk_word_counts.append(len(ctext.split()))
                yield {
                    "query_id": row.get("query_id", ""),
                    "document_id": doc_id,
                    "chunk_id": cid,
                    "chunk_text": ctext,
                    "label": row.get("label", ""),
                    "meta": meta or "",
                }

    def _export_visuals(self, doc_id: str, embs: np.ndarray,
                        chunks) -> None:
        """The debug PNGs of one chunked document, its groups read from the
        chunks' metadata. A failed plot is logged and skipped; a kernel
        fault is raised."""
        try:
            from .visualize import export_document_debug

            groups = []
            for _, _, meta in chunks:
                if meta:
                    m = json.loads(meta)
                    if m.get("sent_indices"):
                        groups.append(
                            [int(x) for x in m["sent_indices"].split(",")])
            if groups:
                export_document_debug(
                    doc_id, embs, groups, self.debug_visuals_dir or ".",
                    bounds_dir=self.ideal_bounds_dir, device=self.device)
                self._visuals_done += 1
        except (KernelError, NotImplementedError):
            raise
        except Exception as exc:
            logger.debug("debug visuals failed for %s: %s", doc_id, exc)

    def run(
        self,
        input_tsv: str,
        output_dir: str,
        limit: Optional[int] = None,
        write_chunk_map: bool = False,
        write_eval: bool = True,
    ) -> Dict:
        """Stream the corpus, chunk it, write {name}_chunks.tsv + eval + summary.

        The eval TSV carries per-chunk size stats like the reference's
        streaming eval writer (``simple_chunk_controller.py:1198,1216-1345``).
        """
        os.makedirs(output_dir, exist_ok=True)
        name = self.cfg.name
        out_path = os.path.join(output_dir, f"{name}_chunks.tsv")
        map_path = os.path.join(output_dir, f"{name}_chunk_map.tsv")
        eval_path = os.path.join(output_dir, f"{name}_eval.tsv")
        summary_path = os.path.join(output_dir, f"{name}_summary.json")
        stats = ChunkRunStats()
        t0 = time.perf_counter()

        def rows_out() -> Iterator[Dict[str, str]]:
            map_rows: List[Dict[str, str]] = []
            eval_rows: List[Dict[str, str]] = []
            for batch in batched(read_tsv(input_tsv, limit=limit), BATCH_SIZE):
                for out_row in self._process_batch(batch, stats):
                    if write_chunk_map and out_row["meta"]:
                        meta = json.loads(out_row["meta"])
                        map_rows.append({
                            "query_id": out_row["query_id"],
                            "document_id": out_row["document_id"],
                            "chunk_id": out_row["chunk_id"],
                            "sent_indices": meta.get("sent_indices", ""),
                            "meta": out_row["meta"],
                        })
                    if write_eval:
                        text = out_row["chunk_text"]
                        eval_rows.append({
                            "chunk_id": out_row["chunk_id"],
                            "document_id": out_row["document_id"],
                            "n_words": str(len(text.split())),
                            "n_chars": str(len(text)),
                        })
                    yield out_row
            if write_chunk_map and map_rows:
                write_tsv(map_path, map_rows, MAP_COLUMNS)
            if write_eval and eval_rows:
                write_tsv(eval_path, eval_rows,
                          ["chunk_id", "document_id", "n_words", "n_chars"])

        write_tsv(out_path, rows_out(), CHUNK_COLUMNS)
        stats.elapsed_s = time.perf_counter() - t0
        summary = {"config": name, "method": self.cfg.chunking.method,
                   **stats.summary()}
        with open(summary_path, "w") as f:
            json.dump(summary, f, indent=2)
        logger.info("chunk run %s: %s", name, summary)
        summary["output_path"] = out_path
        return summary
