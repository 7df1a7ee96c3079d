"""The seeded generators repeat exactly, and differ across seeds."""
import numpy as np
import pytest
import torch

from perfbench import traffic, weights
from perfbench.tests import tiny

MIX = {"vocab": 2000, "zipf_s": 1.1,
       "query_words": {"median": 6, "sigma": 0.5, "min": 2, "max": 32}}
BIG = 2 ** 31 + 12345  # seeds reach past 32 signed bits


@pytest.mark.parametrize("seed", [0, 7, BIG, 2 ** 40 + 1])
def test_queries_repeat(seed):
    a = traffic.query_batches(seed, MIX, 3, 50)
    assert a == traffic.query_batches(seed, MIX, 3, 50)
    assert a != traffic.query_batches(seed + 1, MIX, 3, 50)
    lengths = [len(t.split()) for b in a for t in b]
    assert min(lengths) >= 2 and max(lengths) <= 32


def test_query_lengths_are_the_mix():
    rng = traffic.rng_for(BIG, "queries")
    n = traffic.query_lengths(rng, 20000, MIX)
    assert 5.5 <= np.median(n) <= 6.5
    assert n.min() >= 2 and n.max() <= 32


def test_sub_seeds_differ_by_purpose():
    assert traffic.sub_seed(BIG, "weights") != traffic.sub_seed(BIG, "corpus")
    assert 0 <= traffic.sub_seed(-5, "x") < 2 ** 63


def test_weights_repeat():
    cfg = dict(tiny.CONFIG)
    a = weights.make(cfg, BIG, "cpu")
    b = weights.make(cfg, BIG, "cpu")
    c = weights.make(cfg, BIG + 1, "cpu")
    assert list(a) == [n for n, _ in weights.shapes(cfg)]
    assert all(torch.equal(a[n], b[n]) for n in a)
    assert not torch.equal(a["token_embed.weight"], c["token_embed.weight"])
    w = a["layers.0.mlp_in.weight"]
    assert w.shape == (64, 32) and 0.1 < float(w.std()) < 0.25
