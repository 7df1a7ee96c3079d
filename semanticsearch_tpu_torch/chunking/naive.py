"""Naive fixed-size character splitter baseline.

Same contract and semantics as the reference baseline
(``Method/Text_Splitter_Char_Naive.py:21-92``): fixed character windows with
optional overlap, (chunk_id, text, metadata_json) triples, whole-text chunk
when chunk_size <= 0. The port's own copy of
``semanticsearch_tpu/chunking/naive.py``.
"""
from __future__ import annotations

import json
from typing import List, Optional, Tuple

Chunk = Tuple[str, str, Optional[str]]


def chunk_by_chars(
    doc_id: str,
    text: str,
    chunk_size: int = 600,
    overlap: int = 0,
    collect_metadata: bool = False,
) -> List[Chunk]:
    if not text:
        return []
    if chunk_size <= 0:
        meta = (
            json.dumps(
                {"chunk_id": f"{doc_id}_chunk0", "start_char": 0,
                 "end_char": len(text), "length": len(text)},
                ensure_ascii=False,
            )
            if collect_metadata else None
        )
        return [(f"{doc_id}_chunk0", text, meta)]

    overlap = max(0, min(overlap, chunk_size - 1))
    step = chunk_size - overlap

    chunks: List[Chunk] = []
    idx = 0
    k = 0
    while idx < len(text):
        end = idx + chunk_size
        piece = text[idx:end]
        cid = f"{doc_id}_chunk{k}"
        meta = None
        if collect_metadata:
            meta = json.dumps(
                {"chunk_id": cid, "start_char": idx,
                 "end_char": min(end, len(text)), "length": len(piece)},
                ensure_ascii=False,
            )
        chunks.append((cid, piece, meta))
        if end >= len(text):
            break
        idx += step
        k += 1
    return chunks
