"""The hashing word tokenizer, as its contract states it: lowercase the
ASCII letters, take the runs of ``[a-z0-9]`` (each cut at 256 characters),
hash each with 64-bit FNV-1a of its UTF-8 bytes into ``3 + h % (vocab -
3)``, put the [CLS] id 1 first, cut at ``max_len``."""
from __future__ import annotations

import re
from typing import List, Sequence, Tuple

import numpy as np

_WORD = re.compile(r"[a-z0-9]+")
_LOWER = str.maketrans("ABCDEFGHIJKLMNOPQRSTUVWXYZ",
                       "abcdefghijklmnopqrstuvwxyz")
_OFFSET, _PRIME, _MASK = 0xCBF29CE484222325, 0x100000001B3, (1 << 64) - 1
CLS_ID, N_SPECIAL = 1, 3


def _fnv1a(token: str) -> int:
    h = _OFFSET
    for byte in token.encode("utf-8"):
        h = ((h ^ byte) * _PRIME) & _MASK
    return h


def token_ids(text: str, vocab: int, max_len: int) -> List[int]:
    words = [w[:256] for w in _WORD.findall(text.translate(_LOWER))]
    ids = [CLS_ID] + [N_SPECIAL + _fnv1a(w) % (vocab - N_SPECIAL)
                      for w in words]
    return ids[:max_len]


def encode(texts: Sequence[str], vocab: int, max_len: int
           ) -> Tuple[np.ndarray, np.ndarray]:
    """(ids, mask), (len(texts), longest) int64, padded with 0."""
    rows = [token_ids(t, vocab, max_len) for t in texts]
    width = max((len(r) for r in rows), default=1)
    ids = np.zeros((len(rows), width), np.int64)
    mask = np.zeros((len(rows), width), np.int64)
    for i, r in enumerate(rows):
        ids[i, :len(r)] = r
        mask[i, :len(r)] = 1
    return ids, mask


def lengths(texts: Sequence[str], vocab: int, max_len: int) -> np.ndarray:
    """Each text's real token count, [CLS] included."""
    del vocab
    return np.array([min(1 + len(_WORD.findall(t.translate(_LOWER))),
                         max_len) for t in texts], np.int64)
