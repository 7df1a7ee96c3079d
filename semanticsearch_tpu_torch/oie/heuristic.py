"""Dependency-free heuristic open-information extraction (fallback).

The port's own copy of ``semanticsearch_tpu/oie/heuristic.py`` (host code,
no device work): the same closed verb lists, clause rules and triples, in
the same order.

The reference's triples come from an OpenIE5 Java server that needs a
multi-GB jar and a JVM (``Tool/OIE.py:40-94``); in environments where that
sidecar cannot run, this module keeps the OIE pipeline FUNCTIONAL with a
rule-based subject-verb-object extractor over the same
``{subject, relation, object}`` triple contract (``Tool/OIE.py:99-116``).

It is deliberately modest — pattern-driven clause splitting, no parser:

- a sentence is split at the first VERB GROUP (auxiliary chain + lexical
  verb, detected by a closed auxiliary/common-verb list plus -s/-ed/-ing
  morphology guarded by a noun/adjective stoplist);
- subject = the tokens before the verb group (trimmed of leading
  conjunctions/adverbs), relation = the verb group plus an immediately
  following particle/preposition, object = the remainder;
- clauses after ", which/who/that" yield a secondary triple whose subject
  is the head of the preceding noun phrase.

Every triple's words appear in the sentence: the extractor never invents
tokens.
"""
from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

Triple = Dict[str, str]

# Closed classes for verb-group detection.
_AUX = {
    "is", "are", "was", "were", "be", "been", "being", "am",
    "has", "have", "had", "having",
    "do", "does", "did",
    "will", "would", "shall", "should", "can", "could", "may", "might",
    "must",
}
_COMMON_VERBS = {
    "said", "says", "say", "made", "make", "makes", "took", "take", "takes",
    "went", "go", "goes", "gone", "found", "find", "finds", "gave", "give",
    "gives", "got", "get", "gets", "saw", "see", "sees", "seen", "knew",
    "know", "knows", "known", "became", "become", "becomes", "came", "come",
    "comes", "held", "hold", "holds", "kept", "keep", "keeps", "left",
    "leave", "leaves", "led", "lead", "leads", "met", "meet", "meets",
    "paid", "pay", "pays", "ran", "run", "runs", "set", "sets", "showed",
    "show", "shows", "shown", "told", "tell", "tells", "thought", "think",
    "thinks", "won", "win", "wins", "wrote", "write", "writes", "written",
    "built", "build", "builds", "sent", "send", "sends", "spent", "spend",
    "spends", "lost", "lose", "loses", "meant", "mean", "means", "felt",
    "feel", "feels", "brought", "bring", "brings", "began", "begin",
    "begins", "begun", "grew", "grow", "grows", "grown", "sold", "sell",
    "sells", "bought", "buy", "buys", "caused", "causes", "cause",
    "contains", "contain", "contained", "includes", "include", "included",
    "requires", "require", "required", "provides", "provide", "provided",
    "produces", "produce", "produced", "uses", "use", "used", "carries",
    "carry", "carried", "convert", "converts", "converted",
}
# -s/-ed/-ing candidates that are usually NOT verbs.
_NOT_VERB = {
    "this", "his", "its", "is", "was", "has", "as", "less", "various",
    "previous", "serious", "famous", "nucleus", "analysis", "basis",
    "thus", "plus", "virus", "status", "bonus", "focus", "gas", "bus",
    "news", "series", "species", "united", "red", "good", "old", "bad",
    "thing", "king", "spring", "string", "ring", "wing", "morning",
    "evening", "during", "nothing", "something", "anything", "everything",
    "being", "speed", "hundred", "indeed", "sacred", "hatred", "breed",
    "seed", "need", "feed", "deed", "creed",
}
_PARTICLES = {
    "up", "down", "out", "off", "in", "on", "over", "to", "into", "onto",
    "with", "from", "for", "of", "at", "by", "about", "through", "across",
}
_LEAD_TRIM = {
    "and", "but", "or", "so", "then", "also", "however", "meanwhile",
    "moreover", "thus", "therefore", "yesterday", "today", "tomorrow",
    "now", "here", "there", "finally", "recently", "the",
}
_PRONOUN_ONLY = {"it", "he", "she", "they", "we", "i", "you", "this", "that",
                 "these", "those", "there"}

_WORD_RE = re.compile(r"[A-Za-z][A-Za-z0-9'\-]*|\d[\d.,%]*")
_REL_CLAUSE_RE = re.compile(r",\s*(which|who|that)\s+", re.IGNORECASE)


def _verb_strength(tok: str) -> int:
    """0 = not a verb candidate; 1 = weak morphology (-ing/-s, often a noun);
    2 = strong morphology (-ed/-ate/-ize/-ify); 3 = closed-list verb."""
    low = tok.lower()
    if low in _AUX or low in _COMMON_VERBS:
        return 3
    if low in _NOT_VERB:
        return 0
    if len(low) > 4 and low.endswith(("ed", "ate", "ize", "ify", "ise")):
        return 2
    if len(low) > 5 and low.endswith("ing"):
        return 1
    if (len(low) > 3 and low.endswith("s")
            and not low.endswith(("ss", "us", "is"))):
        return 1
    return 0


def _extend_verb_group(tokens: List[str], i: int) -> int:
    """End of the verb group starting at i: auxiliary chains, negation,
    following verb forms after an auxiliary."""
    n = len(tokens)
    j = i + 1
    while j < n and (
        tokens[j].lower() in ("not", "n't")
        or (tokens[j - 1].lower() in _AUX
            and (_verb_strength(tokens[j]) >= 1
                 or re.search(r"(ed|ing|en)$", tokens[j].lower())))
    ):
        j += 1
    return j


def _find_verb_group(tokens: List[str], start: int = 0
                     ) -> Optional[Tuple[int, int]]:
    """(begin, end) of the best verb group at or after ``start``.

    Plural nouns and gerunds make raw morphology unreliable, so candidates
    rank by strength: if any closed-list or strong-morphology candidate
    exists, the EARLIEST such token wins; only otherwise does a weak
    -ing/-s candidate anchor the clause.
    """
    n = len(tokens)
    first_at = {3: None, 2: None, 1: None}
    for i in range(max(start, 1), n):
        s = _verb_strength(tokens[i])
        if s and first_at[s] is None:
            first_at[s] = i
    for s in (3, 2, 1):
        if first_at[s] is not None:
            i = first_at[s]
            return i, _extend_verb_group(tokens, i)
    return None


def _np_head(tokens: List[str]) -> str:
    """Antecedent for a relative clause: trailing tokens of the preceding
    noun phrase, minus leading determiners."""
    toks = [t for t in tokens if t.lower() not in ("the", "a", "an")]
    if not toks:
        toks = tokens
    return " ".join(toks[-2:])


def _clause_spans(
    tokens: List[str],
) -> Optional[Tuple[Tuple[int, int], Tuple[int, int], Tuple[int, int]]]:
    """SVO spans over ``tokens`` as (subject, relation, object) index
    ranges — the single source of truth for the clause rules (lead-trim,
    12-token subject cap, particle fold, 20-token object cap, pronoun-only
    rejection). ``_clause_triple`` joins these to strings; the neural
    tagger's silver BIO labels (``oie/neural.py``) read them as positions,
    so teacher and student can never drift apart."""
    if len(tokens) < 3:
        return None
    vg = _find_verb_group(tokens)
    if vg is None:
        return None
    b, e = vg
    s0 = 0
    while s0 < b - 1 and tokens[s0].lower() in _LEAD_TRIM:
        s0 += 1
    if b - s0 <= 0 or b - s0 > 12:
        return None
    rel_e, obj_b = e, e
    # fold one particle/preposition into the relation when an object follows
    if obj_b < len(tokens) - 1 and tokens[obj_b].lower() in _PARTICLES:
        rel_e += 1
        obj_b += 1
    if obj_b >= len(tokens):
        return None
    if " ".join(tokens[s0:b]).lower() in _PRONOUN_ONLY:
        return None
    return (s0, b), (b, rel_e), (obj_b, min(len(tokens), obj_b + 20))


def _clause_triple(tokens: List[str]) -> Optional[Triple]:
    spans = _clause_spans(tokens)
    if spans is None:
        return None
    (sa, sb), (ra, rb), (oa, ob) = spans
    return {
        "subject": " ".join(tokens[sa:sb]),
        "relation": " ".join(tokens[ra:rb]),
        "object": " ".join(tokens[oa:ob]),
    }


def extract_triples_heuristic(text: str) -> List[Triple]:
    """Rule-based triples for a paragraph; same contract + exact-duplicate
    filter as the server path (``Tool/OIE.py:251-260``)."""
    from ..chunking.segmenter import extract_sentences

    if not text or not text.strip():
        return []
    triples: List[Triple] = []
    seen = set()

    def add(t: Optional[Triple]) -> None:
        if t is None:
            return
        key = (t["subject"], t["relation"], t["object"])
        if key in seen:
            return
        seen.add(key)
        triples.append(t)

    for sentence in extract_sentences(text):
        # peel ONE relative clause: "X, which V Y, Z" -> main "X Z" +
        # secondary triple (head(X), V, Y)
        rel_subject = None
        rel_clause = None
        m = _REL_CLAUSE_RE.search(sentence)
        if m:
            before = sentence[: m.start()]
            after = sentence[m.end():]
            # the clause runs to its own closing comma (or sentence end)
            cut = after.find(",")
            if cut >= 0:
                rel_clause = after[:cut]
                sentence = before + " " + after[cut + 1:]
            else:
                rel_clause = after
                sentence = before
            rel_subject = _np_head(_tokens(before))

        main_tokens = _tokens(sentence)
        add(_clause_triple(main_tokens))
        if rel_clause and rel_subject:
            clause_tokens = _tokens(rel_clause)
            # the clause may START with its verb ("which carried water"):
            # prepend a dummy subject slot so the i>start guard passes
            vg = _find_verb_group(["_"] + clause_tokens)
            if vg is not None:
                b, e = vg
                rel = clause_tokens[b - 1: e - 1]
                obj = clause_tokens[e - 1:]
                if rel and obj:
                    add({
                        "subject": rel_subject,
                        "relation": " ".join(rel),
                        "object": " ".join(obj[:20]),
                    })
    return triples


def _tokens(text: str) -> List[str]:
    return [t.rstrip(".,") for t in _WORD_RE.findall(text) if t.rstrip(".,")]
