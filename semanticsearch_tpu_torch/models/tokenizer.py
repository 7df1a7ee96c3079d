"""Tokenizers of the sentence encoder.

The default is a deterministic hashing word tokenizer: lowercase (ASCII
only), split on non-alphanumerics, hash each token with 64-bit FNV-1a into
a fixed id space. ``encode_batch`` runs the native kernel
(``native/semsearch_native.cpp::hash_tokenize_batch``); ``encode`` is the
Python path it is held against. The ids are bit-identical to
``semanticsearch_tpu/models/tokenizer.py``, so an index built by either
package encodes queries the same way here. :func:`load_tokenizer` resolves
a trained subword vocabulary (``models/subword.py``), a local HuggingFace
tokenizer directory, or the hashing tokenizer.
"""
from __future__ import annotations

import functools
import os
import re
from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np

_TOKEN_RE = re.compile(r"[a-z0-9]+")

# ASCII-only lowercasing: str.lower() maps some non-ASCII characters INTO
# ASCII (U+212A KELVIN SIGN -> 'k'), which the byte-level C++ tokenizer of the
# JAX package does not; this table keeps the token streams identical
_ASCII_LOWER = str.maketrans(
    "ABCDEFGHIJKLMNOPQRSTUVWXYZ", "abcdefghijklmnopqrstuvwxyz")

_MAX_TOKEN_CHARS = 256

PAD_ID = 0
CLS_ID = 1
UNK_ID = 2
_N_SPECIAL = 3

_FNV_OFFSET = 0xCBF29CE484222325
_FNV_PRIME = 0x100000001B3
_U64 = (1 << 64) - 1


@functools.lru_cache(maxsize=1 << 16)
def _hash_token(token: str, vocab_size: int) -> int:
    """FNV-1a 64-bit of the token's UTF-8 bytes, folded past the special
    ids. Cached: a corpus repeats a small vocabulary many times, and the
    per-byte Python loop dominates encode time otherwise."""
    h = _FNV_OFFSET
    for byte in token.encode("utf-8"):
        h = ((h ^ byte) * _FNV_PRIME) & _U64
    return _N_SPECIAL + (h % (vocab_size - _N_SPECIAL))


@dataclass
class HashingTokenizer:
    """Deterministic hashing tokenizer with static-length padding."""

    vocab_size: int = 30522
    max_len: int = 256
    add_cls: bool = True

    def tokenize(self, text: str) -> List[str]:
        return [t[:_MAX_TOKEN_CHARS]
                for t in _TOKEN_RE.findall(text.translate(_ASCII_LOWER))]

    def encode(self, text: str, max_len: int | None = None) -> List[int]:
        ids = [_hash_token(t, self.vocab_size) for t in self.tokenize(text)]
        if self.add_cls:
            ids = [CLS_ID] + ids
        return ids[: self.max_len if max_len is None else max_len]

    def encode_batch(
        self, texts: Sequence[str], max_len: int | None = None
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (ids, mask), both (B, L) int32 with static L = max_len,
        from the native kernel (:meth:`encode_batch_plain` is its plain
        version)."""
        from ..native import hash_tokenize_batch

        return hash_tokenize_batch(texts, self.vocab_size,
                                   max_len or self.max_len, self.add_cls)

    def encode_batch_plain(
        self, texts: Sequence[str], max_len: int | None = None
    ) -> Tuple[np.ndarray, np.ndarray]:
        """:meth:`encode_batch` one text at a time in Python."""
        L = max_len or self.max_len
        ids = np.full((len(texts), L), PAD_ID, dtype=np.int32)
        mask = np.zeros((len(texts), L), dtype=np.int32)
        for i, text in enumerate(texts):
            enc = self.encode(text, max_len=L)
            ids[i, : len(enc)] = enc
            mask[i, : len(enc)] = 1
        return ids, mask


def load_tokenizer(
    name_or_path: str | None = None,
    vocab_size: int = 30522,
    max_len: int = 256,
):
    """Resolve a tokenizer: a trained subword vocabulary (an existing
    ``.json`` path, see ``models/subword.py``), a local HuggingFace
    tokenizer directory, or the hashing tokenizer."""
    if name_or_path and name_or_path.endswith(".json") \
            and os.path.exists(name_or_path):
        from .subword import SubwordTokenizer

        tok = SubwordTokenizer.load(name_or_path)
        tok.max_len = max_len
        return tok
    if name_or_path:
        try:
            from transformers import AutoTokenizer

            hf = AutoTokenizer.from_pretrained(name_or_path,
                                               local_files_only=True)
        except Exception:  # not a local HF directory, or no transformers
            hf = None
        if hf is not None:
            return _HFAdapter(hf, max_len)
    return HashingTokenizer(vocab_size=vocab_size, max_len=max_len)


class _HFAdapter:
    """A HuggingFace tokenizer behind the ``encode_batch`` contract."""

    def __init__(self, hf, max_len: int) -> None:
        self.hf = hf
        self.max_len = max_len
        self.vocab_size = hf.vocab_size

    def encode_batch(self, texts, max_len=None):
        out = self.hf(list(texts), padding="max_length", truncation=True,
                      max_length=max_len or self.max_len, return_tensors="np")
        return (out["input_ids"].astype(np.int32),
                out["attention_mask"].astype(np.int32))
