"""TSV validation, cleaning, and pairability analysis.

The port's copy of ``semanticsearch_tpu/data/validate.py`` (host numpy only).

Port of ``data_process/validate_and_clean_tsv.py``: two passes — (1) count
label distribution per query to flag queries lacking both a positive and a
negative ("unpairable"); (2) write only well-formed rows (parseable binary
label, non-empty texts). Emits a JSON report and a pairability TSV like the
reference (``:204-224``). Label parsing accepts the reference's token sets
(``create_matchzoo_datapacks.py:33-39``).
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, Optional

from .tsv import read_tsv, write_tsv

POS_TOKENS = {"1", "1.0", "true", "pos", "positive", "yes", "y", "t"}
NEG_TOKENS = {"0", "0.0", "false", "neg", "negative", "no", "n", "f",
              "-1", "-1.0"}


def parse_label(value) -> Optional[int]:
    """Binary label from the reference's accepted token sets; None if invalid."""
    s = str(value).strip().lower()
    if s in POS_TOKENS:
        return 1
    if s in NEG_TOKENS:
        return 0
    try:
        f = float(s)
    except ValueError:
        return None
    if f > 0:
        return 1
    if f <= 0:
        return 0
    return None


@dataclass
class ValidationReport:
    rows_in: int = 0
    rows_kept: int = 0
    dropped: Dict[str, int] = field(default_factory=lambda: {
        "bad_label": 0, "empty_text": 0, "bad_format": 0,
    })
    queries_total: int = 0
    queries_pairable: int = 0
    queries_pos_only: int = 0
    queries_neg_only: int = 0

    def to_dict(self) -> Dict:
        return {
            "rows_in": self.rows_in,
            "rows_kept": self.rows_kept,
            "dropped": self.dropped,
            "queries": {
                "total": self.queries_total,
                "pairable": self.queries_pairable,
                "pos_only": self.queries_pos_only,
                "neg_only": self.queries_neg_only,
            },
        }


def validate_and_clean(
    input_path: str,
    output_path: Optional[str] = None,
    report_path: Optional[str] = None,
    pairability_path: Optional[str] = None,
    text_column: str = "chunk_text",
) -> ValidationReport:
    """Validate rows, write the cleaned TSV + JSON report + pairability table."""
    output_path = output_path or input_path + ".clean.tsv"
    report = ValidationReport()
    label_counts: Dict[str, Dict[str, int]] = {}

    # Pass 1: label distribution per query.
    for row in read_tsv(input_path):
        report.rows_in += 1
        qid = row.get("query_id", "")
        lab = parse_label(row.get("label", ""))
        if lab is None:
            continue
        c = label_counts.setdefault(qid, {"pos": 0, "neg": 0})
        c["pos" if lab == 1 else "neg"] += 1

    report.queries_total = len(label_counts)
    for counts in label_counts.values():
        if counts["pos"] and counts["neg"]:
            report.queries_pairable += 1
        elif counts["pos"]:
            report.queries_pos_only += 1
        elif counts["neg"]:
            report.queries_neg_only += 1

    # Pass 2: write clean rows.
    def clean_rows():
        for row in read_tsv(input_path):
            lab = parse_label(row.get("label", ""))
            if lab is None:
                report.dropped["bad_label"] += 1
                continue
            text = str(row.get(text_column, "")).strip()
            qid = str(row.get("query_id", "")).strip()
            if not text or not qid:
                report.dropped["empty_text"] += 1
                continue
            report.rows_kept += 1
            yield {"query_id": qid, text_column: text, "label": str(lab)}

    write_tsv(output_path, clean_rows(), ["query_id", text_column, "label"])

    # the report is ALWAYS written (default path next to the output)
    report_path = report_path or output_path + ".report.json"
    with open(report_path, "w") as f:
        json.dump(report.to_dict(), f, indent=2)
    if pairability_path or label_counts:
        pairability_path = pairability_path or output_path + ".pairability.tsv"
        write_tsv(
            pairability_path,
            (
                {
                    "query_id": q,
                    "pos": str(c["pos"]),
                    "neg": str(c["neg"]),
                    "pairable": str(int(bool(c["pos"] and c["neg"]))),
                }
                for q, c in sorted(label_counts.items())
            ),
            ["query_id", "pos", "neg", "pairable"],
        )
    return report
