"""Robust04-style document cleaning (host-side).

Behavioral port of the reference controller's cleaning stack
(``data_process/simple_chunk_controller.py:254-458``): speaker-attribution
rewrites (``preprocess_format``), Robust04 metadata stripping with acronym
protection and dash/quote/list normalization (``clean_document_for_spacy``),
and the revert-if->30%-lost guardrail (``validate_cleaned_text``). Also the
lightweight precleaner the chunkers apply themselves
(``Method/Semantic_Splitter_Optimized.py:382-396``). The port's own copy of
``semanticsearch_tpu/chunking/cleaning.py``.
"""
from __future__ import annotations

import re

# Acronyms whose trailing period must not be treated as a sentence boundary
# (same class of tokens the reference protects: South-African/US/intl orgs +
# newswire source tags).
_ACRONYMS = (
    "ANC SAP APLA SACP MK AWB IFP PAC UDF "
    "FBI CIA DEA ATF NSA DHS DOJ DOD "
    "NATO UN EU OSCE CSCE CIS CPRF CPSU "
    "PF DPA BFN CSO FBIS ITAR TASS "
    "COCOM DITA QAP KAM SKAT INPEC"
).split()

_MARK = "\x00DOT\x00"


def preclean_text(text: str) -> str:
    """Light metadata strip used directly by the chunkers."""
    if not isinstance(text, str):
        return ""
    s = text
    s = re.sub(
        r"^Language:\s*\w+\s+Article\s*Type:\s*[^\s\[\]]*\s*(?:\[Text\])?\s*",
        "", s, flags=re.IGNORECASE,
    )
    s = re.sub(
        r"\s*[\"“”']{0,3}\s*Language:\s*\w+\s+Article\s*Type:\s*[A-Za-z0-9\-]+\.?",
        " ", s, flags=re.IGNORECASE,
    )
    s = re.sub(r"\[Article by[^\]]*\]\s*", "", s)
    s = re.sub(r"\[Report by[^\]]*\]\s*", "", s)
    s = re.sub(r"\[From the[^\]]*\]\s*", "", s)
    s = re.sub(r"\[Excerpts?\]\s*", "", s)
    s = re.sub(r"\[Text\]\s*", "", s)
    return re.sub(r"\s+", " ", s).strip()


def preprocess_format(text: str) -> str:
    """Interview-transcript speaker attributions -> narrative quotes."""
    if not isinstance(text, str):
        return ""
    s = text
    # "(Name) Sentence." -> 'Name said: "Sentence."'
    s = re.sub(r"\(([^)]+)\)\s+([A-Z][^.!?]*[.!?])", r'\1 said: "\2"', s)
    s = re.sub(r"\(([^)]+)\)\s+([A-Z][^.!?]+?)(?=\s+\([^)]+\)|$)", r'\1 said: "\2."', s)
    s = re.sub(r"\(Unidentified reporter\)\s+", 'Reporter said: "', s)
    s = re.sub(r"\(Reporter\)\s+", 'Reporter said: "', s)
    s = re.sub(r"Here is a report by ([^:]+):\s+\([^)]+\)\s+", r'Here is a report by \1: "', s)
    # Drop empty "(Name)." speaker markers entirely.
    s = re.sub(r"\([^)]+\)\.\s*", "", s)
    if s.count('"') % 2 == 1:
        s += '"'
    return re.sub(r"\s+", " ", s).strip()


def clean_document(text: str) -> str:
    """Robust04 metadata strip + sentence-boundary normalization."""
    if not isinstance(text, str):
        return ""
    s = text
    # Header metadata.
    s = re.sub(r"^Language:\s*\w+\s+Article Type:\s*[^\s\[\]]*\s*\[Text\]\s*", "", s, flags=re.IGNORECASE)
    s = re.sub(r"^Language:\s*\w+\s+Article Type:\s*[^\s]*\s*", "", s, flags=re.IGNORECASE)
    # Bracketed editorial tags.
    for pat in (
        r"\[Article by[^\]]*\]", r"\[Report by[^\]]*\]", r"\[From the[^\]]*\]",
        r"\[Excerpts?\]", r"\[Text\]", r"\[passage omitted\]",
        r"\[words indistinct\]", r"\[Begin[^\]]*recording\]",
        r"\[end recording\]", r"\[Begin [^\]]*\]", r"\[Interview with[^\]]*\]",
        r"\[reference to[^\]]*\]",
    ):
        s = re.sub(pat + r"\s*", "", s)
    # Short bracket references become parentheticals.
    s = re.sub(r"\[([^\]]{1,30})\]", r"(\1)", s)
    # Residual "Language: X Article Type:Y" fragments anywhere.
    s = re.sub(
        r"\s*[\"“”']{0,3}\s*Language:\s*\w+\s+Article\s*Type:\s*[A-Za-z0-9\-]+\.?\s*",
        " ", s, flags=re.IGNORECASE,
    )
    # Flatten bracket-inside-paren nesting.
    s = re.sub(r"\(\s*([^()]*)\s*\[([^\]]*)\]\s*([^()]*)\)", r"(\1 \2 \3)", s)
    # Protect acronym periods from boundary logic below.
    for ac in _ACRONYMS:
        s = re.sub(rf"\b{ac}\.(?=\s+[A-Za-z]|$)", ac + _MARK, s)
    # Dash normalization: boundary after terminal punctuation, comma
    # mid-sentence, colon for "Location -- Content" datelines.
    s = re.sub(r"([.!?])\s+--\s+([A-Za-z])", r"\1 \2", s)
    s = re.sub(r"([a-zA-Z])\s+--\s+([a-z])", r"\1, \2", s)
    s = re.sub(r"([A-Z][a-zA-Z\s]+)\s+--\s+([A-Z])", r"\1: \2", s)
    # Doubled/nested quotes.
    s = re.sub(r'""([^"]*?)""', r'"\1"', s)
    s = re.sub(r'"([^"]*)"([^"]*)"([^"]*)"', r'"\1\2\3"', s)
    # Numbered lists become sentence boundaries.
    s = re.sub(r"[:;]\s*\d+\)\s*", r". ", s)
    # Whitespace + punctuation spacing.
    s = re.sub(r"\s+", " ", s)
    s = re.sub(r"\s+([.!?])", r"\1", s)
    s = re.sub(r"([.!?])\s*([A-Z])", r"\1 \2", s)
    # (no newline handling here: the \s+ collapse above already removed
    # every newline — matching the reference, which also collapses first)
    # Conservative boundary insertion at big gaps; spurious-period cleanup.
    s = re.sub(r"([a-z])\s{2,}([A-Z][a-z])", r"\1. \2", s)
    s = re.sub(r"([a-z])\.\s+([a-z])", r"\1 \2", s)
    for w in ("the", "in", "of", "and"):
        s = re.sub(rf"\b{w}\.\s+([A-Z])", rf"{w} \1", s)
    s = re.sub(r"\.{2,}", ".", s)
    s = s.replace(_MARK, ".")
    return s.strip()


def validate_cleaned_text(original: str, cleaned: str, max_loss: float = 0.3) -> bool:
    """Guardrail: False (caller should revert) when cleaning changed the char
    or word count by more than ``max_loss`` (reference:
    ``simple_chunk_controller.py:438-458``)."""
    if not original or not cleaned:
        return False
    if abs(len(cleaned) - len(original)) / len(original) > max_loss:
        return False
    wo, wc = len(original.split()), len(cleaned.split())
    if wo and abs(wc - wo) / wo > max_loss:
        return False
    return True


def clean_with_guardrail(text: str) -> str:
    """Full cleaning chain with revert-on-overloss, as the controller applies
    it per document (``simple_chunk_controller.py:641-656``)."""
    cleaned = clean_document(preprocess_format(text))
    return cleaned if validate_cleaned_text(text, cleaned) else text
