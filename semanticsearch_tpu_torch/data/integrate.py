"""TREC Robust04-style corpus integration: qrels + topics + raw docs -> 5-col TSV.

Behavioral port of ``data_process/integrate_data.py``: topics parsed from
``<top>`` blocks (query text = description + ". " + narrative, title ignored),
qrels joined with per-document files, tab/newline/quote normalization, the
"This document has no information." filter, dedup by (query_id, document_id)
pair and by content-md5 within query.

The port's own copy of ``semanticsearch_tpu/data/integrate.py`` (host code):
its outputs are byte-equal to the JAX package's.
"""
from __future__ import annotations

import hashlib
import os
import re
from dataclasses import dataclass, field
from typing import Dict, Iterator, Optional

OUTPUT_COLUMNS = ["query_id", "query_text", "document_id", "document", "label"]


def parse_topics(path: str) -> Dict[str, str]:
    """Parse a TREC topics file into {query_id: query_text}."""
    try:
        with open(path, "r", encoding="utf-8", errors="ignore") as f:
            content = f.read()
    except FileNotFoundError:
        return {}
    topics: Dict[str, str] = {}
    for entry in re.findall(r"<top>(.*?)</top>", content, re.DOTALL):
        num = re.search(r"<num>\s*Number:\s*(\d+)", entry)
        if not num:
            continue
        desc = re.search(r"<desc>\s*Description:(.*?)(?=<narr>|\Z)", entry, re.DOTALL)
        narr = re.search(r"<narr>\s*Narrative:(.*?)\Z", entry, re.DOTALL)
        text = (
            (desc.group(1).strip() if desc else "")
            + ". "
            + (narr.group(1).strip() if narr else "")
        )
        text = re.sub(r"\s+", " ", text.replace("\t", " ")).strip()
        topics[num.group(1).strip()] = text
    return topics


def _clean_field(text: str) -> str:
    text = text.replace("\t", " ").replace("\n", " ").replace("\r", "").strip()
    text = re.sub(r"\s+", " ", text)
    text = text.replace('""', '"').replace('"', "'")
    return text


@dataclass
class IntegrationStats:
    written: int = 0
    skipped: Dict[str, int] = field(default_factory=lambda: {
        "no_info": 0, "empty_query": 0, "empty_doc": 0,
        "file_missing": 0, "read_error": 0, "dupe_pair": 0,
        "dupe_content": 0, "missing_topic": 0, "malformed": 0,
    })


def integrate_corpus(
    qrels_path: str,
    topics_path: str,
    docs_dir: str,
    output_path: str,
    min_query_len: int = 1,
    min_doc_len: int = 1,
    dedup_by_pair: bool = True,
    dedup_content_within_query: bool = True,
) -> IntegrationStats:
    """Join qrels + topics + document files into the 5-column TSV."""
    topics = parse_topics(topics_path)
    stats = IntegrationStats()
    seen_pairs = set()
    seen_hash_by_query: Dict[str, set] = {}

    with open(output_path, "w", encoding="utf-8") as out, open(
        qrels_path, "r", encoding="utf-8", errors="ignore"
    ) as qrels:
        out.write("\t".join(OUTPUT_COLUMNS) + "\n")
        for line in qrels:
            parts = line.strip().split()
            if not parts:
                continue
            if len(parts) != 4:
                stats.skipped["malformed"] += 1
                continue
            query_id, _, document_id, label = (p.strip() for p in parts)
            qtext = topics.get(query_id)
            if qtext is None:
                stats.skipped["missing_topic"] += 1
                continue
            qtext = _clean_field(qtext)
            if len(qtext) < min_query_len:
                stats.skipped["empty_query"] += 1
                continue
            pair = (query_id, document_id)
            if dedup_by_pair and pair in seen_pairs:
                stats.skipped["dupe_pair"] += 1
                continue
            doc_path = os.path.join(docs_dir, document_id)
            try:
                with open(doc_path, "r", encoding="utf-8", errors="ignore") as df:
                    doc = df.read()
            except FileNotFoundError:
                stats.skipped["file_missing"] += 1
                continue
            except OSError:
                stats.skipped["read_error"] += 1
                continue
            doc = _clean_field(doc)
            if doc == "This document has no information.":
                stats.skipped["no_info"] += 1
                continue
            if len(doc) < min_doc_len:
                stats.skipped["empty_doc"] += 1
                continue
            if dedup_content_within_query:
                h = hashlib.md5(doc.encode("utf-8", errors="ignore")).hexdigest()
                bucket = seen_hash_by_query.setdefault(query_id, set())
                if h in bucket:
                    stats.skipped["dupe_content"] += 1
                    continue
                bucket.add(h)
            if dedup_by_pair:
                seen_pairs.add(pair)
            out.write(f"{query_id}\t{qtext}\t{document_id}\t{doc}\t{label}\n")
            stats.written += 1
    return stats
