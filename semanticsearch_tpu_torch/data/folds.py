"""Cross-validation fold construction over (query_id, chunk_text, label) rows.

The port's copy of ``semanticsearch_tpu/data/folds.py`` (host numpy only).

Replaces the reference's MatchZoo DataPack builder
(``MatchZoo_Tool/create_matchzoo_datapacks.py:299-738``) with plain TSV folds:
same semantics — seed-42 shuffle, K sequential index folds, fold k's test =
fold k, train = the other K-1 folds — but no .dam pickles; each fold is a TSV
the trainer's Preprocessor + PairDataset consume directly. A ``fold_info.txt``
summary is written like the reference's (``:717-738``).
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List

import numpy as np

from .tsv import read_tsv
from .validate import parse_label

FOLD_COLUMNS = ["query_id", "chunk_text", "label"]


@dataclass
class FoldPaths:
    train: str
    test: str


def _valid_rows(input_path: str, text_column: str):
    """Stream (query_id, chunk_text, label) rows, dropping invalid ones."""
    for row in read_tsv(input_path):
        lab = parse_label(row.get("label", ""))
        text = str(row.get(text_column, "")).strip()
        qid = str(row.get("query_id", "")).strip()
        if lab is None or not text or not qid:
            continue
        yield {"query_id": qid, "chunk_text": text, "label": str(lab)}


def create_cv_folds(
    input_path: str,
    output_dir: str,
    num_folds: int = 5,
    seed: int = 42,
    text_column: str = "chunk_text",
) -> List[FoldPaths]:
    """Split a labeled TSV into K CV folds on disk — two-pass streaming.

    Like the reference's >500MB large-file path
    (``create_matchzoo_datapacks.py:420-520``) but unconditional: pass 1
    counts valid rows, pass 2 streams each row into its fold's test file
    (host memory is O(rows) int8 for the fold-assignment array, never the row
    texts); train files are streamed concatenations of the other K-1 test
    files. Fold MEMBERSHIP matches the in-RAM implementation exactly (same
    seed-42 permutation + sequential position folds); only within-fold row
    order differs (input order instead of shuffled — the pair sampler
    reshuffles every epoch anyway).
    """
    # Pass 1: count valid rows.
    n = sum(1 for _ in _valid_rows(input_path, text_column))
    if n == 0:
        raise ValueError(f"no valid rows in {input_path}")

    # Fold assignment: shuffled position p holds original row order[p];
    # fold k covers positions bounds[k]:bounds[k+1].
    rng = np.random.RandomState(seed)
    order = rng.permutation(n)
    bounds = np.linspace(0, n, num_folds + 1).astype(int)
    fold_of_row = np.empty(n, dtype=np.int8)
    for k in range(num_folds):
        fold_of_row[order[bounds[k]: bounds[k + 1]]] = k

    os.makedirs(output_dir, exist_ok=True)
    test_paths = [
        os.path.join(output_dir, f"fold_{k + 1}_test.tsv")
        for k in range(num_folds)
    ]
    train_paths = [
        os.path.join(output_dir, f"fold_{k + 1}_train.tsv")
        for k in range(num_folds)
    ]
    header = "\t".join(FOLD_COLUMNS) + "\n"

    # Pass 2: stream every row into its fold's test file.
    counts = [0] * num_folds
    test_files = [open(p, "w", encoding="utf-8") for p in test_paths]
    try:
        for f in test_files:
            f.write(header)
        for i, row in enumerate(_valid_rows(input_path, text_column)):
            k = int(fold_of_row[i])
            test_files[k].write(
                f"{row['query_id']}\t{row['chunk_text']}\t{row['label']}\n"
            )
            counts[k] += 1
    finally:
        for f in test_files:
            f.close()

    # Train files: streamed concat of the other K-1 test files (skip headers).
    for k in range(num_folds):
        with open(train_paths[k], "w", encoding="utf-8") as out_f:
            out_f.write(header)
            for j in range(num_folds):
                if j == k:
                    continue
                with open(test_paths[j], encoding="utf-8") as in_f:
                    next(in_f)  # header
                    for line in in_f:
                        out_f.write(line)

    info_lines = [f"rows={n} folds={num_folds} seed={seed}"]
    out: List[FoldPaths] = []
    for k in range(num_folds):
        info_lines.append(
            f"fold_{k + 1}: train={n - counts[k]} test={counts[k]}"
        )
        out.append(FoldPaths(train=train_paths[k], test=test_paths[k]))
    with open(os.path.join(output_dir, "fold_info.txt"), "w") as f:
        f.write("\n".join(info_lines) + "\n")
    return out


def load_fold_rows(path: str) -> Dict[str, List]:
    """Load a fold TSV into parallel lists (query_ids, texts, labels)."""
    qids: List[str] = []
    texts: List[str] = []
    labels: List[float] = []
    queries: List[str] = []
    for row in read_tsv(path):
        lab = parse_label(row.get("label", ""))
        if lab is None:
            continue
        qids.append(row["query_id"])
        queries.append(row.get("query_text", row["query_id"]))
        texts.append(row["chunk_text"])
        labels.append(float(lab))
    return {
        "query_ids": qids,
        "query_texts": queries,
        "chunk_texts": texts,
        "labels": labels,
    }
