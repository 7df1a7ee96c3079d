"""Sentence segmentation (host-side text preprocessing).

Behavioral port of the reference's segmenter contract
(``Tool/Sentence_Segmenter.py:99-177``): sentences of >= 10 chars, long
sentences re-split at punctuation above ``max_sent_length`` chars, every
sentence forced to end with terminal punctuation. spaCy is used when
importable (same model choice the reference auto-downloads); otherwise the
regex path — which the reference also falls back to — is the default.
String work stays on the host; only embeddings touch the device. The port's
own copy of ``semanticsearch_tpu/chunking/segmenter.py``.
"""
from __future__ import annotations

import re
from typing import List

_MIN_SENT_CHARS = 10
_WS_RE = re.compile(r"\s+")
_SPLIT_RE = re.compile(r"(?<=[.!?])\s+(?=[A-Z\"'\(\[0-9])")
_RESPLIT_RE = re.compile(r"(?<=[.!?;])\s+")
_END_PUNCT_RE = re.compile(r"[.!?]$")

_SPACY_NLP = None
_SPACY_TRIED = False


def _get_spacy():
    global _SPACY_NLP, _SPACY_TRIED
    if _SPACY_TRIED:
        return _SPACY_NLP
    _SPACY_TRIED = True
    try:
        import spacy

        nlp = spacy.blank("en")
        nlp.add_pipe("sentencizer")
        nlp.max_length = 10_000_000
        _SPACY_NLP = nlp
    except Exception:
        _SPACY_NLP = None
    return _SPACY_NLP


def _finalize(sent: str, out: List[str], max_sent_length: int) -> None:
    sent = sent.strip()
    if len(sent) < _MIN_SENT_CHARS:
        return
    if len(sent) > max_sent_length:
        for sub in _RESPLIT_RE.split(sent):
            sub = sub.strip()
            if len(sub) < _MIN_SENT_CHARS:
                continue
            # Hard-wrap anything still longer than the cap so a single
            # punctuation-free run can't produce an unbounded sentence.
            while len(sub) > max_sent_length:
                head, sub = sub[:max_sent_length], sub[max_sent_length:]
                out.append(head if _END_PUNCT_RE.search(head) else head + ".")
                sub = sub.strip()
            if len(sub) >= _MIN_SENT_CHARS:
                out.append(sub if _END_PUNCT_RE.search(sub) else sub + ".")
    else:
        out.append(sent if _END_PUNCT_RE.search(sent) else sent + ".")


def split_sentences_regex(text: str, max_sent_length: int = 1000) -> List[str]:
    """Regex sentence splitter (reference fallback semantics)."""
    if not text or not isinstance(text, str) or not text.strip():
        return []
    text = _WS_RE.sub(" ", text.strip())
    out: List[str] = []
    for sent in _SPLIT_RE.split(text):
        _finalize(sent, out, max_sent_length)
    return out


def extract_sentences(text: str, max_sent_length: int = 1000) -> List[str]:
    """Segment text into sentences; spaCy sentencizer if available, else regex."""
    if not text or not isinstance(text, str) or not text.strip():
        return []
    nlp = _get_spacy()
    if nlp is None:
        return split_sentences_regex(text, max_sent_length)
    try:
        doc = nlp(_WS_RE.sub(" ", text.strip()))
        out: List[str] = []
        for sent in doc.sents:
            _finalize(sent.text, out, max_sent_length)
        return out
    except Exception:
        return split_sentences_regex(text, max_sent_length)


def count_tokens(text: str) -> int:
    """Word+punct token count (reference regex fallback semantics)."""
    if not text or not isinstance(text, str):
        return 0
    return len(re.findall(r"\b\w+\b|[^\w\s]", text.strip()))
