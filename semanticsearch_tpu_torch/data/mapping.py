"""Query-text mapping: replace query_id with query_text for training files.

Port of ``data_process/file_mapping.py``: builds query_id -> query_text from
the original 5-column TSV (streaming, first occurrence wins) and rewrites a
(query_id, chunk_text, label) TSV to (query_text, chunk_text, label),
repairing rows whose chunk_text contains raw tabs by re-joining the middle
fields (reference ``:111-127``).

The port's own copy of ``semanticsearch_tpu/data/mapping.py`` (host code):
its outputs are byte-equal to the JAX package's.
"""
from __future__ import annotations

import csv
import sys
from typing import Dict, Optional

from .tsv import read_tsv

csv.field_size_limit(sys.maxsize)


def build_query_map(original_tsv: str) -> Dict[str, str]:
    """query_id -> query_text from the integrated 5-column TSV."""
    out: Dict[str, str] = {}
    for row in read_tsv(original_tsv):
        qid = row.get("query_id")
        qtext = row.get("query_text")
        if qid and qtext and qid not in out:
            out[qid] = qtext
    return out


def add_query_text_to_tsv(
    input_path: str,
    original_tsv: str,
    output_path: Optional[str] = None,
) -> str:
    """Rewrite (query_id, chunk_text, label) -> (query_text, chunk_text, label)."""
    output_path = output_path or input_path.replace(".tsv", "") + "_with_querytext.tsv"
    qmap = build_query_map(original_tsv)
    with open(input_path, "r", encoding="utf-8", errors="ignore", newline="") as f, \
            open(output_path, "w", encoding="utf-8") as out:
        reader = csv.reader(f, delimiter="\t", quoting=csv.QUOTE_NONE)
        header = next(reader, None)
        if header is None:
            return output_path
        out.write("query_text\tchunk_text\tlabel\n")
        for row in reader:
            if len(row) < 3:
                continue
            if len(row) > 3:
                # tab-repair: first field qid, last field label, middle = text
                row = [row[0], " ".join(row[1:-1]), row[-1]]
            qid, chunk_text, label = row
            qtext = qmap.get(qid.strip())
            if not qtext:
                continue
            out.write(f"{qtext}\t{chunk_text}\t{label}\n")
    return output_path
