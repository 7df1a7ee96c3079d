"""Weighted RRF, its alpha tuner and the ranking metrics in the port against
the JAX package (``train/fusion.py``, ``train/metrics.py``), on the same
seeded numpy inputs. Both packages compute in float64 numpy with the same
order of operations, so results must be equal exactly."""
import numpy as np
import pytest

from semanticsearch_tpu.train import fusion as jfusion
from semanticsearch_tpu.train import metrics as jmetrics
from semanticsearch_tpu_torch.train import fusion as tfusion
from semanticsearch_tpu_torch.train import metrics as tmetrics


def _legs(seed, nq=12, nd=50, ties=False):
    rng = np.random.default_rng(seed)
    dense = rng.normal(size=(nq, nd))
    lex = rng.normal(size=(nq, nd))
    if ties:  # whole-number scores: many equal ranks in both legs
        dense, lex = np.round(dense * 2), np.round(lex * 2)
    labels = (rng.random((nq, nd)) < 0.1).astype(np.int64)
    labels[:, 0] = 1  # every query has a relevant document
    return dense, lex, labels


def test_default_grid_matches_jax():
    assert tfusion.DEFAULT_GRID == jfusion.DEFAULT_GRID


@pytest.mark.parametrize("alpha", [None, 0.0, 0.3, 0.5, 1.0])
@pytest.mark.parametrize("ties", [False, True])
def test_weighted_rrf_matches_jax(alpha, ties):
    dense, lex, _ = _legs(5, ties=ties)
    np.testing.assert_array_equal(
        tfusion.weighted_rrf(dense, lex, alpha=alpha, k=60),
        jfusion.weighted_rrf(dense, lex, alpha=alpha, k=60))


def test_weighted_rrf_shape_guard():
    with pytest.raises(ValueError, match="score shapes differ"):
        tfusion.weighted_rrf(np.zeros((2, 3)), np.zeros((2, 4)))


@pytest.mark.parametrize("metric", ["map", "mrr", "p@5", "ndcg@10",
                                    "dcg@10"])
def test_tune_fusion_alpha_matches_jax(metric):
    dense, lex, labels = _legs(9)
    # make the dense leg the stronger one, so the tuner moves off 0.5
    dense = dense + 3.0 * labels
    got = tfusion.tune_fusion_alpha(dense, lex, labels, metric=metric)
    want = jfusion.tune_fusion_alpha(dense, lex, labels, metric=metric)
    assert got == want


@pytest.mark.parametrize("metric", ["map", "ap", "mrr", "p@3", "precision@7",
                                    "ndcg@5", "dcg@5"])
def test_eval_metric_matches_jax(metric):
    rng = np.random.default_rng(21)
    for _ in range(20):
        y_true = rng.integers(0, 3, size=30)
        y_score = np.round(rng.normal(size=30), 1)  # with ties
        assert (tmetrics.eval_metric(metric, y_true, y_score)
                == jmetrics.eval_metric(metric, y_true, y_score))


def test_eval_metric_unknown_name():
    with pytest.raises(ValueError, match="unknown metric"):
        tmetrics.eval_metric("recall@5", np.ones(3), np.ones(3))
