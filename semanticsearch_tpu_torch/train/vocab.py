"""Text preprocessor for the rerankers: vocab build + fixed-length transform.

The port's copy of ``semanticsearch_tpu/train/vocab.py`` (host numpy code):
MatchZoo's ``BasicPreprocessor`` as the reference configures it, truncated
left/right lengths and low-frequency filtering by term or document
frequency. Outputs are padded or truncated to fixed lengths, so every
scoring block has one shape.

Two vocabulary modes: word-level (``fit`` builds a frequency-filtered word
vocab) or subword (pass a trained :class:`~..models.subword.
SubwordTokenizer`): texts encode to its WordPiece ids, so unseen surface
forms decompose into trained pieces instead of collapsing to UNK. Ids,
lengths and the saved ``preprocessor.json`` are the JAX package's, so a
file written by either package loads in both.
"""
from __future__ import annotations

import json
import os
import re
from collections import Counter
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

PAD_ID = 0
UNK_ID = 1

_WORD_RE = re.compile(r"[a-z0-9]+")


def word_tokenize(text: str) -> List[str]:
    return _WORD_RE.findall(str(text).lower())


@dataclass
class Preprocessor:
    """Vocab + fixed-length transform with low-frequency filtering.

    ``subword``: a trained SubwordTokenizer switches encoding to its piece
    ids (pad = 0 there too); ``fit`` becomes a no-op and ``vocab_size`` is
    the tokenizer's. No CLS is emitted: the match-matrix models consume
    content tokens only.
    """

    fixed_length_left: int = 16
    fixed_length_right: int = 128
    filter_low_freq: int = 5
    filter_mode: str = "tf"  # tf | df
    vocab: Dict[str, int] = field(default_factory=dict)
    subword: Optional[object] = None  # SubwordTokenizer

    def fit(self, texts: Sequence[str]) -> "Preprocessor":
        if self.subword is not None:
            return self  # vocabulary comes from the trained tokenizer
        counter: Counter = Counter()
        for text in texts:
            toks = word_tokenize(text)
            if self.filter_mode == "df":
                counter.update(set(toks))
            else:
                counter.update(toks)
        self.vocab = {"<pad>": PAD_ID, "<unk>": UNK_ID}
        for tok, cnt in sorted(counter.items(), key=lambda kv: (-kv[1], kv[0])):
            if cnt >= self.filter_low_freq:
                self.vocab[tok] = len(self.vocab)
        return self

    @property
    def vocab_size(self) -> int:
        if self.subword is not None:
            return self.subword.vocab_size
        return len(self.vocab)

    def _encode(self, text: str, length: int) -> Tuple[np.ndarray, int]:
        if self.subword is not None:
            ids: List[int] = []
            for w in self.subword.tokenize(str(text).lower()):
                ids.extend(self.subword.encode_word(w))
                if len(ids) >= length:
                    break
            ids = ids[:length]
        else:
            ids = [self.vocab.get(t, UNK_ID)
                   for t in word_tokenize(text)][:length]
        arr = np.full(length, PAD_ID, dtype=np.int32)
        arr[: len(ids)] = ids
        return arr, len(ids)

    def transform_pair(
        self, left_texts: Sequence[str], right_texts: Sequence[str]
    ) -> Dict[str, np.ndarray]:
        """Encode query (left) / chunk (right) texts to fixed-shape int32
        id arrays and their lengths."""
        n = len(left_texts)
        if len(right_texts) != n:
            raise ValueError(f"{n} left texts vs {len(right_texts)} right")
        left = np.zeros((n, self.fixed_length_left), np.int32)
        right = np.zeros((n, self.fixed_length_right), np.int32)
        left_len = np.zeros(n, np.int32)
        right_len = np.zeros(n, np.int32)
        for i, (lt, rt) in enumerate(zip(left_texts, right_texts)):
            left[i], left_len[i] = self._encode(lt, self.fixed_length_left)
            right[i], right_len[i] = self._encode(rt, self.fixed_length_right)
        return {
            "left": left, "right": right,
            "left_len": left_len, "right_len": right_len,
        }

    # --- persistence: saved next to the model checkpoint ---
    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        blob = {
            "fixed_length_left": self.fixed_length_left,
            "fixed_length_right": self.fixed_length_right,
            "filter_low_freq": self.filter_low_freq,
            "filter_mode": self.filter_mode,
            "vocab": self.vocab,
        }
        if self.subword is not None:
            blob["subword"] = {
                "max_len": self.subword.max_len,
                "add_cls": self.subword.add_cls,
                "vocab": self.subword.vocab,
            }
        with open(path, "w") as f:
            json.dump(blob, f)

    @classmethod
    def load(cls, path: str) -> "Preprocessor":
        with open(path) as f:
            blob = json.load(f)
        sub = blob.pop("subword", None)
        if sub is not None:
            from ..models.subword import SubwordTokenizer

            blob["subword"] = SubwordTokenizer(
                vocab=sub["vocab"], max_len=sub.get("max_len", 256),
                add_cls=sub.get("add_cls", True),
            )
        return cls(**blob)
