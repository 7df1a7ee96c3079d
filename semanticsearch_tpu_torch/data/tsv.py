"""TSV streaming IO with column-alias detection.

Rows stream as dicts under canonical column names: every alias in
``CHUNK_TEXT_KEYS`` (``passage``, ``text``) reads back as ``chunk_text``, and
so on, so files written by either package read the same in both.
"""
from __future__ import annotations

import csv
import sys
from typing import Dict, Iterable, Iterator, List, Optional, Sequence

QUERY_TEXT_KEYS = {"query_text", "query", "question"}
CHUNK_TEXT_KEYS = {"chunk_text", "passage", "text"}
QUERY_ID_KEYS = {"query_id", "qid"}
CHUNK_ID_KEYS = {"chunk_id", "cid", "pid"}
DOC_ID_KEYS = {"document_id", "doc_id", "docid"}
DOC_TEXT_KEYS = {"document", "doc_text", "doc"}
LABEL_KEYS = {"label", "score", "target"}

_CANONICAL = {
    "query_text": QUERY_TEXT_KEYS,
    "chunk_text": CHUNK_TEXT_KEYS,
    "query_id": QUERY_ID_KEYS,
    "chunk_id": CHUNK_ID_KEYS,
    "document_id": DOC_ID_KEYS,
    "document": DOC_TEXT_KEYS,
    "label": LABEL_KEYS,
}

csv.field_size_limit(sys.maxsize)


def standardize_header(header: Sequence[str]) -> Dict[str, str]:
    """Map raw column names to canonical names."""
    mapping: Dict[str, str] = {}
    taken = set()
    for col in header:
        low = col.strip().lower()
        for canon, aliases in _CANONICAL.items():
            if low in aliases and canon not in taken:
                mapping[col] = canon
                taken.add(canon)
                break
        else:
            mapping[col] = col.strip()
    return mapping


def read_tsv(path: str, limit: Optional[int] = None) -> Iterator[Dict[str, str]]:
    """Stream rows as dicts with canonical column names. Rows with the wrong
    field count are skipped."""
    with open(path, "r", encoding="utf-8", errors="ignore", newline="") as f:
        reader = csv.reader(f, delimiter="\t", quoting=csv.QUOTE_NONE)
        try:
            header = next(reader)
        except StopIteration:
            return
        mapping = standardize_header(header)
        canon = [mapping[c] for c in header]
        n = len(canon)
        count = 0
        for row in reader:
            if len(row) != n:
                continue
            yield dict(zip(canon, row))
            count += 1
            if limit is not None and count >= limit:
                return


def write_tsv(path: str, rows: Iterable[Dict[str, str]],
              columns: List[str]) -> int:
    """Write rows (dicts) with the given column order. Values are
    tab/newline-sanitized. Returns the row count."""
    n = 0
    with open(path, "w", encoding="utf-8", newline="") as f:
        f.write("\t".join(columns) + "\n")
        for row in rows:
            vals = [
                str(row.get(c, "")).replace("\t", " ").replace("\n", " ")
                .replace("\r", "")
                for c in columns
            ]
            f.write("\t".join(vals) + "\n")
            n += 1
    return n


def batched(iterator: Iterator, batch_size: int) -> Iterator[List]:
    """Yield lists of up to batch_size items."""
    batch: List = []
    for item in iterator:
        batch.append(item)
        if len(batch) >= batch_size:
            yield batch
            batch = []
    if batch:
        yield batch
