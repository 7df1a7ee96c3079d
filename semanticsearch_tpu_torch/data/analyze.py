"""Corpus and chunk-output statistics.

Ports the reference analyzers (``data_process/analyze_document_lengths.py``,
``analyze_chunks.py``): per-document word/sentence stats with distribution
percentiles, exact sentence-count distribution and length buckets
(``analyze_document_lengths.py:171-215``), optional per-row metrics TSV
(``:158-166``); per-chunk stats with duplicate examples, top tokens, longest
chunks (``analyze_chunks.py:46-125``) and the multi-config ``compare``
ranking (``analyze_chunks.py:127-142``). These double as data-quality
regression checks (SURVEY.md §4: "data-quality reports as tests").

The port's own copy of ``semanticsearch_tpu/data/analyze.py`` (host code):
its outputs are byte-equal to the JAX package's.
"""
from __future__ import annotations

import json
import re
from collections import Counter
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np

from ..chunking.segmenter import extract_sentences
from .tsv import read_tsv

_BUCKETS = [(0, 100), (100, 250), (250, 500), (500, 1000),
            (1000, 2500), (2500, 5000), (5000, 10**12)]

# reference sentence-count buckets (analyze_document_lengths.py:176-186)
_SENT_BUCKETS = [
    ("0", 0, 0), ("1", 1, 1), ("2", 2, 2), ("3", 3, 3),
    ("4-5", 4, 5), ("6-10", 6, 10), ("11-20", 11, 20),
    ("21-50", 21, 50), ("51+", 51, None),
]


def _stats(arr: List[float]) -> Dict[str, float]:
    if not arr:
        return {"count": 0}
    a = np.asarray(arr, dtype=np.float64)
    return {
        "count": int(a.size),
        "mean": float(a.mean()),
        "median": float(np.median(a)),
        "min": float(a.min()),
        "max": float(a.max()),
        "p10": float(np.percentile(a, 10)),
        "p25": float(np.percentile(a, 25)),
        "p75": float(np.percentile(a, 75)),
        "p90": float(np.percentile(a, 90)),
        "std": float(a.std()),
    }


def analyze_documents(
    tsv_path: str,
    text_column: str = "document",
    limit: Optional[int] = None,
    count_sentences: bool = True,
    per_row_output: Optional[str] = None,
) -> Dict:
    """Word/sentence stats over a 5-column corpus TSV.

    Matches the reference report fields (``analyze_document_lengths.py:
    205-215``): summary stats, the EXACT sentence-count distribution, the
    9-way sentence-count buckets, and overall words-per-sentence.
    ``per_row_output`` additionally writes the input rows with appended
    ``word_count`` / ``sentence_count`` / ``avg_words_per_sentence`` columns
    (``:158-166``).
    """
    words: List[float] = []
    sents: List[float] = []
    buckets = Counter()
    out_f = open(per_row_output, "w", encoding="utf-8") if per_row_output \
        else None
    wrote_header = False
    try:
        for row in read_tsv(tsv_path, limit=limit):
            text = row.get(text_column, "")
            w = len(text.split())
            words.append(w)
            s = 0
            if count_sentences:
                s = len(extract_sentences(text))
                sents.append(s)
            for lo, hi in _BUCKETS:
                if lo <= w < hi:
                    buckets[f"{lo}-{hi if hi < 10**12 else 'inf'}"] += 1
                    break
            if out_f is not None:
                if not wrote_header:
                    out_f.write("\t".join(
                        list(row.keys())
                        + ["word_count", "sentence_count",
                           "avg_words_per_sentence"]) + "\n")
                    wrote_header = True
                avg_ws = (w / s) if s else 0.0
                out_f.write("\t".join(
                    [str(v).replace("\t", " ").replace("\n", " ")
                     for v in row.values()]
                    + [str(w), str(s), f"{avg_ws:.2f}"]) + "\n")
    finally:
        if out_f is not None:
            out_f.close()
    out = {
        "word_count_stats": _stats(words),
        "length_buckets": dict(buckets),
    }
    if count_sentences:
        out["sentence_count_stats"] = _stats(sents)
        total_words = sum(words)
        total_sents = sum(sents)
        out["avg_words_per_sentence_overall"] = (
            total_words / total_sents if total_sents else 0.0
        )
        # exact distribution + reference bucket labels
        dist = Counter(int(s) for s in sents)
        out["sentence_count_distribution"] = {
            str(k): v for k, v in sorted(dist.items())
        }
        sbuckets = {label: 0 for label, _, _ in _SENT_BUCKETS}
        for sc in sents:
            for label, lo, hi in _SENT_BUCKETS:
                if sc >= lo and (hi is None or sc <= hi):
                    sbuckets[label] += 1
                    break
        out["sentence_count_buckets"] = sbuckets
    return out


def analyze_chunks(
    tsv_path: str,
    text_column: str = "chunk_text",
    limit: Optional[int] = None,
) -> Dict:
    """Chunk-output stats: per-(query,doc) counts, duplicates, vocab/TTR,
    duplicate/longest-chunk examples and top tokens
    (``analyze_chunks.py:46-125``)."""
    chunk_words: List[float] = []
    chunk_chars: List[float] = []
    chunk_sents: List[float] = []
    per_pair = Counter()
    seen_texts = Counter()
    vocab = Counter()
    top_longest: List[tuple] = []
    n = 0
    for row in read_tsv(tsv_path, limit=limit):
        text = row.get(text_column, "").strip()
        n += 1
        w = len(text.split())
        chunk_words.append(w)
        chunk_chars.append(len(text))
        chunk_sents.append(len(extract_sentences(text)))
        key = (row.get("query_id", ""), row.get("document_id", ""))
        per_pair[key] += 1
        seen_texts[text] += 1
        vocab.update(re.findall(r"[a-z0-9]+", text.lower()))
        if w:
            top_longest.append((w, key[0], key[1],
                                text[:130].replace("\n", " ")))
    top_longest = sorted(top_longest, key=lambda x: -x[0])[:10]
    duplicates = {t: c for t, c in seen_texts.items() if c > 1}
    dup_rows = sum(c - 1 for c in duplicates.values())
    total_tokens = sum(vocab.values())
    return {
        "file": tsv_path,
        "chunks": n,
        "documents": len(per_pair),
        "avg_chunks_per_doc": (n / len(per_pair)) if per_pair else 0.0,
        "word_stats": _stats(chunk_words),
        "char_stats": _stats(chunk_chars),
        "sentence_stats": _stats(chunk_sents),
        "chunks_per_pair": _stats(list(map(float, per_pair.values()))),
        "duplicates_count": len(duplicates),
        "duplicate_ratio": dup_rows / n if n else 0.0,
        "top_duplicates_example": [
            [t[:80].replace("\n", " "), c]
            for t, c in sorted(duplicates.items(), key=lambda kv: -kv[1])[:5]
        ],
        "vocab_size": len(vocab),
        "type_token_ratio": len(vocab) / total_tokens if total_tokens else 0.0,
        "top_tokens": vocab.most_common(20),
        "top_longest_chunks": [
            {"words": w, "query_id": q, "document_id": d, "preview": p}
            for w, q, d, p in top_longest
        ],
    }


def compare_chunk_outputs(files_stats: Sequence[Dict]) -> Dict:
    """Rank several chunking configs' outputs by average chunk size.

    The reference's cross-config ``compare`` (``analyze_chunks.py:127-142``):
    one row per file (chunks, avg words/sentences/chars per chunk), ranked
    by avg words descending.
    """
    if len(files_stats) < 2:
        return {}
    comparison = [
        {
            "file": st.get("file", ""),
            "chunks": st.get("chunks", 0),
            "avg_words": st.get("word_stats", {}).get("mean"),
            "avg_sentences": st.get("sentence_stats", {}).get("mean"),
            "avg_chars": st.get("char_stats", {}).get("mean"),
        }
        for st in files_stats
    ]
    ranked = sorted(comparison, key=lambda x: x["avg_words"] or 0,
                    reverse=True)
    return {"ranking_by_avg_words": ranked}


def analyze_and_compare(
    tsv_paths: Sequence[str],
    text_column: str = "chunk_text",
    limit: Optional[int] = None,
) -> Dict:
    """Analyze several chunk-output files and compare them: the reference's
    multi-file CLI flow (``analyze_chunks.py:152-160``)."""
    stats = [analyze_chunks(p, text_column=text_column, limit=limit)
             for p in tsv_paths]
    return {"files": stats, "comparison": compare_chunk_outputs(stats)}


def save_report(report: Dict, path: str) -> None:
    with open(path, "w") as f:
        json.dump(report, f, indent=2)
