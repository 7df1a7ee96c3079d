"""Corpus-fit subword tokenizer: BPE-trained vocabulary, WordPiece encode.

The port's copy of ``semanticsearch_tpu/models/subword.py``: byte-pair-merge
training over word types (frequency-BPE), then WordPiece greedy
longest-match encoding over the learned vocabulary (continuation pieces
carry a ``##`` prefix). Merges, ids and the saved ``tokenizer.json`` format
are the JAX package's, so a vocabulary trained or saved by either package
encodes alike in both.

Pre-tokenization is the same ``[a-z0-9]+`` ASCII-lowercase rule as the
hashing tokenizer, so the two are interchangeable in ``SentenceEncoder``.
``encode_batch`` runs the native kernel (``native/semsearch_native.cpp::
subword_tokenize_batch``); ``encode_batch_plain`` is its Python plain
version.
"""
from __future__ import annotations

import json
import re
from collections import Counter
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from .tokenizer import _ASCII_LOWER  # ASCII-only lowering: Python and C++
# token streams must agree on non-ASCII input

_TOKEN_RE = re.compile(r"[a-z0-9]+")

PAD_ID = 0
CLS_ID = 1
UNK_ID = 2
_N_SPECIAL = 3

_MAX_PIECE_CHARS = 20  # longest-match window; also caps trainable pieces


class SubwordTokenizer:
    """Greedy longest-match (WordPiece) encoder over a trained vocab.

    ``vocab`` maps piece -> id; continuation pieces are stored with a
    leading ``##``. Ids 0/1/2 are pad/cls/unk. ``encode_batch`` matches the
    :class:`~.tokenizer.HashingTokenizer` contract:
    (ids, mask), both (B, L) int32, optional leading CLS.
    """

    def __init__(
        self,
        vocab: Dict[str, int],
        max_len: int = 256,
        add_cls: bool = True,
    ) -> None:
        self.vocab = vocab
        self.max_len = max_len
        self.add_cls = add_cls
        # ids in self.vocab are already absolute (>= _N_SPECIAL)
        self.vocab_size = (max(vocab.values()) + 1) if vocab else _N_SPECIAL
        self._word_cache: Dict[str, List[int]] = {}

    # ------------------------------------------------------------ encoding
    def tokenize(self, text: str) -> List[str]:
        return _TOKEN_RE.findall(text.translate(_ASCII_LOWER))

    def encode_word(self, word: str) -> List[int]:
        """Greedy longest-match decomposition; whole word -> UNK when any
        position has no matching piece (BERT's rule)."""
        word = word[:256]  # match the C++ kernel's word buffer cap — and
        # truncate BEFORE the cache lookup, or >256-char words would look
        # up under the full key but store under the truncated one (a
        # permanent cache miss re-running the greedy match every time)
        cached = self._word_cache.get(word)
        if cached is not None:
            return cached
        ids: List[int] = []
        pos = 0
        n = len(word)
        while pos < n:
            end = min(n, pos + _MAX_PIECE_CHARS)
            piece_id = None
            while end > pos:
                piece = word[pos:end]
                if pos > 0:
                    piece = "##" + piece
                piece_id = self.vocab.get(piece)
                if piece_id is not None:
                    break
                end -= 1
            if piece_id is None:
                ids = [UNK_ID]
                break
            ids.append(piece_id)
            pos = end
        if len(self._word_cache) < 1_000_000:
            self._word_cache[word] = ids
        return ids

    def encode(self, text: str, max_len: Optional[int] = None) -> List[int]:
        ids: List[int] = [CLS_ID] if self.add_cls else []
        for w in self.tokenize(text):
            ids.extend(self.encode_word(w))
        return ids[: self.max_len if max_len is None else max_len]

    def encode_batch(
        self, texts: Sequence[str], max_len: Optional[int] = None
    ) -> Tuple[np.ndarray, np.ndarray]:
        """(ids, mask) (B, L) int32, L = max_len, from the native kernel."""
        from ..native import subword_tokenize_batch

        return subword_tokenize_batch(texts, self._native_tables(),
                                      max_len or self.max_len, self.add_cls)

    def encode_batch_plain(
        self, texts: Sequence[str], max_len: Optional[int] = None
    ) -> Tuple[np.ndarray, np.ndarray]:
        """:meth:`encode_batch` one text at a time in Python."""
        L = max_len or self.max_len
        ids = np.full((len(texts), L), PAD_ID, dtype=np.int32)
        mask = np.zeros((len(texts), L), dtype=np.int32)
        for i, text in enumerate(texts):
            # the call's length, not self.max_len: the native kernel
            # truncates at L
            enc = self.encode(text, max_len=L)
            ids[i, : len(enc)] = enc
            mask[i, : len(enc)] = 1
        return ids, mask

    def _native_tables(self):
        """Flat (blob, offsets, ids) piece table for the C++ kernel, cached.

        Pieces are passed with their ``##`` prefix intact; the kernel keys
        its hash map on the raw bytes exactly as the Python dict does.
        """
        tables = getattr(self, "_tables", None)
        if tables is None:
            pieces = list(self.vocab.items())
            blobs = [p.encode("utf-8") for p, _ in pieces]
            offsets = np.zeros(len(blobs) + 1, np.int64)
            np.cumsum([len(b) for b in blobs], out=offsets[1:])
            blob = np.frombuffer(b"".join(blobs) + b"\x00", dtype=np.uint8)
            ids = np.asarray([i for _, i in pieces], np.int32)
            tables = (blob, offsets, ids)
            self._tables = tables
        return tables

    # --------------------------------------------------------- persistence
    def save(self, path: str) -> None:
        with open(path, "w", encoding="utf-8") as f:
            json.dump(
                {
                    "format": "semanticsearch_tpu.subword.v1",
                    "max_len": self.max_len,
                    "add_cls": self.add_cls,
                    "vocab": self.vocab,
                },
                f,
            )

    @classmethod
    def load(cls, path: str) -> "SubwordTokenizer":
        with open(path, encoding="utf-8") as f:
            obj = json.load(f)
        return cls(vocab=obj["vocab"], max_len=obj.get("max_len", 256),
                   add_cls=obj.get("add_cls", True))


def _word_symbols(word: str) -> Tuple[str, ...]:
    """Initial symbol sequence: first char bare, rest ##-prefixed (the
    WordPiece convention, so merges produce correctly-prefixed pieces)."""
    return (word[0],) + tuple("##" + c for c in word[1:])


def _merge_symbols(syms: Tuple[str, ...], a: str, b: str) -> Tuple[str, ...]:
    out: List[str] = []
    i = 0
    n = len(syms)
    merged = a + (b[2:] if b.startswith("##") else b)
    while i < n:
        if i + 1 < n and syms[i] == a and syms[i + 1] == b:
            out.append(merged)
            i += 2
        else:
            out.append(syms[i])
            i += 1
    return tuple(out)


def train_bpe(
    texts: Iterable[str],
    vocab_size: int = 8192,
    min_pair_freq: int = 2,
    max_len: int = 256,
    add_cls: bool = True,
) -> SubwordTokenizer:
    """Frequency-BPE over word TYPES (cost scales with the vocabulary of
    distinct words, not corpus tokens).

    Merges the most frequent adjacent symbol pair until ``vocab_size``
    pieces exist (specials + single chars + merges) or no pair clears
    ``min_pair_freq``. Ties break lexicographically for determinism.
    """
    word_counts: Counter = Counter()
    for text in texts:
        # the ENCODE-time rule (ASCII-only lowering), not str.lower():
        # fitting the vocabulary to a token stream the encoder will never
        # produce (e.g. U+212A lowering into ascii 'k') wastes merges and
        # breaks the same-rule claim above
        word_counts.update(
            _TOKEN_RE.findall(str(text).translate(_ASCII_LOWER)))
    return train_bpe_from_counts(
        word_counts, vocab_size=vocab_size, min_pair_freq=min_pair_freq,
        max_len=max_len, add_cls=add_cls,
    )


def train_bpe_from_counts(
    word_counts: Dict[str, int],
    vocab_size: int = 8192,
    min_pair_freq: int = 2,
    max_len: int = 256,
    add_cls: bool = True,
) -> SubwordTokenizer:
    words: List[Tuple[Tuple[str, ...], int]] = [
        (_word_symbols(w), c) for w, c in word_counts.items() if w
    ]
    # alphabet: every single-char symbol (bare + continuation forms)
    pieces: List[str] = sorted({s for syms, _ in words for s in syms})

    # pair statistics + inverted index pair -> word rows containing it
    pair_counts: Counter = Counter()
    pair_words: Dict[Tuple[str, str], set] = {}
    for wi, (syms, cnt) in enumerate(words):
        for p in zip(syms, syms[1:]):
            pair_counts[p] += cnt
            pair_words.setdefault(p, set()).add(wi)

    budget = vocab_size - _N_SPECIAL - len(pieces)
    merges_done = 0
    # lazy max-heap: stale entries (count changed since push) are re-pushed
    # with their current count on pop; a FRESH top is the true argmax
    # (highest count, then lexicographically smallest pair — deterministic)
    import heapq

    heap = [(-c, p) for p, c in pair_counts.items()]
    heapq.heapify(heap)
    while merges_done < budget and heap:
        negc, best = heapq.heappop(heap)
        cur = pair_counts.get(best, 0)
        if cur != -negc:
            if cur >= min_pair_freq:
                heapq.heappush(heap, (-cur, best))
            continue
        if cur < min_pair_freq:
            break  # fresh top: nothing left clears the threshold
        a, b = best
        merged = a + (b[2:] if b.startswith("##") else b)
        if len(merged[2:] if merged.startswith("##") else merged) \
                > _MAX_PIECE_CHARS:
            # unencodable by the longest-match window — drop the pair
            del pair_counts[best]
            pair_words.pop(best, None)
            continue
        pieces.append(merged)
        merges_done += 1
        # update only the words that contain the merged pair
        for wi in pair_words.pop(best, set()):
            syms, cnt = words[wi]
            new_syms = _merge_symbols(syms, a, b)
            if new_syms == syms:
                continue
            for p in zip(syms, syms[1:]):
                pair_counts[p] -= cnt
                if pair_counts[p] <= 0:
                    del pair_counts[p]
                s = pair_words.get(p)
                if s is not None:
                    s.discard(wi)
                    if not s:
                        pair_words.pop(p, None)
            for p in zip(new_syms, new_syms[1:]):
                pair_counts[p] += cnt
                pair_words.setdefault(p, set()).add(wi)
                heapq.heappush(heap, (-pair_counts[p], p))
            words[wi] = (new_syms, cnt)
        pair_counts.pop(best, None)  # fully consumed by the merge

    vocab = {piece: _N_SPECIAL + i for i, piece in enumerate(pieces)}
    return SubwordTokenizer(vocab=vocab, max_len=max_len, add_cls=add_cls)
