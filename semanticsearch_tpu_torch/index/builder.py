"""Corpus index builder: chunk TSV -> embeddings -> persisted layout.

Counterpart of ``semanticsearch_tpu/index/builder.py``. The on-disk layout
is the same, so either package serves an index the other built:

    {dir}/embeddings.f16.npy   (N, D) float16
    {dir}/ids.tsv              chunk_id + query_id/document_id per row
    {dir}/meta.json            {rows, dim, encoder_config}

The embed stage is restart-safe with ``resume=True``: a cursor
(``build.progress.json``) records how many rows are durably written, and
``meta.json``, written last, marks a finished build.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..core.config import IndexConfig
from ..core.logging import get_logger
from ..data.tsv import batched, read_tsv, write_tsv
from .engine import EmbeddingIndex

logger = get_logger("index")

EMB_FILE = "embeddings.f16.npy"
IDS_FILE = "ids.tsv"
META_FILE = "meta.json"
PROGRESS_FILE = "build.progress.json"


def build_corpus_index(
    chunks_tsv: str,
    encoder,
    output_dir: str,
    text_column: str = "chunk_text",
    batch_size: int = 1024,
    limit: Optional[int] = None,
    resume: bool = False,
) -> Dict:
    """Embed every chunk and persist the layout. Returns meta."""
    os.makedirs(output_dir, exist_ok=True)
    meta_path = os.path.join(output_dir, META_FILE)
    progress_path = os.path.join(output_dir, PROGRESS_FILE)

    n_rows = sum(1 for _ in read_tsv(chunks_tsv, limit=limit))
    if n_rows == 0:
        raise ValueError(f"no rows in {chunks_tsv}")
    dim = encoder.cfg.hidden_dim

    if resume and os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
        if meta.get("rows") == n_rows and meta.get("dim") == dim:
            logger.info("index already complete at %s (%d rows); resume "
                        "skips the build", output_dir, n_rows)
            return meta

    emb_path = os.path.join(output_dir, EMB_FILE)
    start_row = 0
    if resume and os.path.exists(progress_path) and os.path.exists(emb_path):
        with open(progress_path) as f:
            prog = json.load(f)
        if prog.get("n_rows") == n_rows and prog.get("dim") == dim:
            start_row = int(prog.get("rows_done", 0))
            logger.info("resuming embed stage at row %d/%d",
                        start_row, n_rows)
    if start_row > 0:
        mm = np.lib.format.open_memmap(emb_path, mode="r+")
        if mm.shape != (n_rows, dim):
            raise ValueError(f"{emb_path} holds {mm.shape}, expected "
                             f"{(n_rows, dim)}")
    else:
        mm = np.lib.format.open_memmap(
            emb_path, mode="w+", dtype=np.float16, shape=(n_rows, dim))

    def _commit_progress(rows_done: int) -> None:
        tmp = progress_path + ".tmp"
        mm.flush()
        with open(tmp, "w") as f:
            json.dump({"rows_done": rows_done, "n_rows": n_rows,
                       "dim": dim}, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, progress_path)

    row_idx = 0
    checked_col = False
    for batch in batched(read_tsv(chunks_tsv, limit=limit), batch_size):
        if row_idx + len(batch) <= start_row:
            row_idx += len(batch)
            continue
        if not checked_col:
            # a wrong column name would otherwise embed N empty strings
            if text_column not in batch[0]:
                raise KeyError(
                    f"text column {text_column!r} not in {chunks_tsv} "
                    f"(columns: {sorted(batch[0])})")
            checked_col = True
        texts = [r.get(text_column, "") for r in batch]
        embs = encoder.encode(texts, batch_size=batch_size)
        mm[row_idx: row_idx + len(batch)] = embs.astype(np.float16)
        row_idx += len(batch)
        if (row_idx // batch_size) % 16 == 0:
            _commit_progress(row_idx)
            logger.info("indexed %d/%d chunks", row_idx, n_rows)
    mm.flush()

    def id_rows() -> Iterator[Dict[str, str]]:
        for i, r in enumerate(read_tsv(chunks_tsv, limit=limit)):
            yield {
                "row": str(i),
                "chunk_id": r.get("chunk_id", str(i)),
                "query_id": r.get("query_id", ""),
                "document_id": r.get("document_id", ""),
            }

    write_tsv(os.path.join(output_dir, IDS_FILE), id_rows(),
              ["row", "chunk_id", "query_id", "document_id"])
    meta = {
        "rows": n_rows,
        "dim": dim,
        "encoder_config": dataclasses.asdict(encoder.cfg),
    }
    with open(meta_path, "w") as f:
        json.dump(meta, f, indent=2)
    if os.path.exists(progress_path):
        os.unlink(progress_path)
    logger.info("index built: %d rows x %d dims at %s", n_rows, dim, output_dir)
    return meta


def load_index(
    index_dir: str,
    mesh=None,
    cfg: IndexConfig = IndexConfig(),
    device="cuda",
    row_block: int = 1 << 18,
) -> Tuple[EmbeddingIndex, List[str]]:
    """Restore the device-resident index and the chunk-id table, over every
    local device of ``device``'s kind when ``mesh`` is None.

    The float16 file streams to the devices in blocks of ``row_block``
    rows, each shard's rows straight from the memmap to its own device
    (the counterpart of ``jax.make_array_from_callback``); each block is
    normalized in float32 there and stored in ``cfg.dtype``, so no device
    holds the whole corpus and neither host nor device a float32 copy. On
    a sharded mesh the rows pad only to the shard count."""
    from ..core.mesh import (local_mesh, local_row_devices, local_rows,
                             n_row_shards)

    if mesh is None:
        mesh = local_mesh(device)
    with open(os.path.join(index_dir, META_FILE)) as f:
        meta = json.load(f)
    n, dim = meta["rows"], meta["dim"]
    emb = np.load(os.path.join(index_dir, EMB_FILE), mmap_mode="r")
    if emb.shape != (n, dim):
        raise ValueError(f"{EMB_FILE} holds {emb.shape}, meta says {(n, dim)}")
    chunk_ids = [row["chunk_id"]
                 for row in read_tsv(os.path.join(index_dir, IDS_FILE))]
    dtype = getattr(torch, cfg.dtype)
    n_shards = n_row_shards(mesh)
    shard_rows = -(-n // n_shards)
    shards = []
    for shard, dev in zip(local_rows(mesh), local_row_devices(mesh)):
        base = shard * shard_rows
        part = torch.zeros((shard_rows, dim), dtype=dtype, device=dev)
        for s in range(base, min(base + shard_rows, n), row_block):
            e = min(s + row_block, base + shard_rows, n)
            x = torch.from_numpy(np.array(emb[s:e])).to(dev).float()
            x = x / torch.clamp(torch.linalg.norm(x, dim=1, keepdim=True),
                                min=1e-9)
            part[s - base: e - base] = x.to(dtype)
        shards.append(part)
    corpus = shards if n_shards > 1 else shards[0]
    return EmbeddingIndex(corpus, valid_n=n, cfg=cfg, mesh=mesh), chunk_ids
