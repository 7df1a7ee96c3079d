"""Seeded traffic and corpus generators, shared by every mix.

A mix is a data file under ``perfbench/traffic/`` (its ``kind`` names the
module in ``perfbench/kinds/``); everything random in a run comes from
here, from the run's ``--seed``, so the same seed gives the same inputs.
Texts are made of the words ``t<rank>`` of a 50,000-word list drawn by a
bounded Zipf law (rank r has weight 1 / r^s): a few frequent words and a
long tail, as in the text a search system indexes. The hashing word
tokenizer reads each ``t<rank>`` as one token.

Every seed gets the same amount of work: the lengths and the word ranks of
a set of texts are drawn once, from a stream that no seed changes, and the
seed only deals them out in another order (which text gets which length,
which token slot which word). So a seed changes the texts but not the
multiset of their lengths or words, and batch sizes, step counts and
arrivals are the mix's own numbers.
"""
from __future__ import annotations

import hashlib
from typing import List, Sequence

import numpy as np


def sub_seed(seed: int, purpose: str) -> int:
    """A 63-bit seed for one purpose of a run (weights, corpus, queries,
    sample), so that each stream is independent and repeatable; ``seed``
    may be any whole number."""
    digest = hashlib.sha256(f"{int(seed)}:{purpose}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def rng_for(seed: int, purpose: str) -> np.random.Generator:
    return np.random.default_rng(sub_seed(seed, purpose))


def zipf_weights(vocab: int, s: float) -> np.ndarray:
    """The bounded Zipf law over ranks 1..vocab, normalized."""
    p = 1.0 / np.arange(1, vocab + 1, dtype=np.float64) ** s
    return p / p.sum()


def word_list(vocab: int) -> np.ndarray:
    return np.array([f"t{r}" for r in range(vocab)], dtype=object)


def draw_ranks(rng: np.random.Generator, cdf: np.ndarray, n: int) -> np.ndarray:
    return np.searchsorted(cdf, rng.random(n), side="right").clip(
        max=cdf.size - 1)


def lognormal_lengths(rng: np.random.Generator, n: int, median: float,
                      sigma: float, lo: int, hi: int) -> np.ndarray:
    """Whole word counts, log-normal around ``median``, clipped to
    [lo, hi]."""
    x = np.exp(rng.normal(np.log(median), sigma, size=n))
    return np.clip(np.rint(x), lo, hi).astype(np.int64)


def uniform_lengths(rng: np.random.Generator, n: int, lo: int, hi: int
                    ) -> np.ndarray:
    """Whole word counts uniform on [lo, hi]."""
    return rng.integers(lo, hi + 1, size=n)


def texts_of(rng: np.random.Generator, words: np.ndarray, cdf: np.ndarray,
             lengths: Sequence[int], shape: np.random.Generator = None
             ) -> List[str]:
    """One text a length: that many words by the Zipf law. With ``shape``
    the words are drawn from it and ``rng`` only shuffles them."""
    lengths = np.asarray(lengths, np.int64)
    if shape is None:
        ranks = draw_ranks(rng, cdf, int(lengths.sum()))
    else:
        ranks = rng.permutation(draw_ranks(shape, cdf, int(lengths.sum())))
    ends = np.cumsum(lengths)
    drawn = words[ranks]
    return [" ".join(drawn[e - n: e]) for n, e in zip(lengths, ends)]


def query_lengths(rng: np.random.Generator, n: int, mix: dict) -> np.ndarray:
    q = mix["query_words"]
    return lognormal_lengths(rng, n, q["median"], q["sigma"], q["min"],
                             q["max"])


def shape_stream(purpose: str) -> np.random.Generator:
    """The stream of lengths and words that every seed shares."""
    return rng_for(0, f"shape:{purpose}")


def dealt_texts(seed: int, purpose: str, mix: dict, lengths_of
                ) -> List[str]:
    """Texts whose lengths (``lengths_of(shape)``) and words come from the
    shared stream, dealt out in the order of ``seed``."""
    shape = shape_stream(purpose)
    rng = rng_for(seed, purpose)
    words = word_list(mix["vocab"])
    cdf = np.cumsum(zipf_weights(mix["vocab"], mix["zipf_s"]))
    lengths = rng.permutation(lengths_of(shape))
    return texts_of(rng, words, cdf, lengths, shape)


def query_batches(seed: int, mix: dict, n_batches: int, batch: int
                  ) -> List[List[str]]:
    """``n_batches`` batches of ``batch`` query texts (the mix's word law
    and length law)."""
    n = n_batches * batch
    texts = dealt_texts(seed, "queries", mix,
                        lambda shape: query_lengths(shape, n, mix))
    return [texts[i * batch: (i + 1) * batch] for i in range(n_batches)]
