"""The port's ops/similarity.py and core/config.py against the JAX package's.

The same numpy inputs go through both. Similarity matrices agree to atol
1e-6 on unit-norm rows (the two frameworks sum a 32- to 128-term f32 dot
product in different orders) and exactly on integer-valued rows, whose sums
are exact in f32. Rank matrices are integers and must be equal, ties
included: both sides sort stably."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semanticsearch_tpu.core import config as jcfg
from semanticsearch_tpu.ops import similarity as jsim
from semanticsearch_tpu_torch.core import config as tcfg
from semanticsearch_tpu_torch.ops import similarity as tsim


def _unit_rows(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _int_rows(rng, n, d):
    return rng.integers(-7, 8, size=(n, d)).astype(np.float32)


def _jax_sim(kind, x):
    if kind == "pallas":
        return np.array(jsim.similarity_matrix_pallas(
            jnp.asarray(x), block=32, interpret=True))
    return np.array(jsim.similarity_matrix(jnp.asarray(x)))


def _torch_sim(kind, x):
    fn = (tsim.similarity_matrix_pallas if kind == "pallas"
          else tsim.similarity_matrix)
    return fn(torch.from_numpy(x)).numpy()


@pytest.mark.parametrize("kind", ["einsum", "pallas"])
@pytest.mark.parametrize("n,d", [(17, 64), (70, 128), (1, 32), (33, 72)])
def test_similarity_matrix_matches_jax(rng, kind, n, d):
    x = _unit_rows(rng, n, d)
    got, want = _torch_sim(kind, x), _jax_sim(kind, x)
    assert got.shape == (n, n) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("kind", ["einsum", "pallas"])
def test_similarity_matrix_exact_on_integer_rows(rng, kind):
    x = _int_rows(rng, 45, 96)
    got = _torch_sim(kind, x)
    np.testing.assert_array_equal(got, _jax_sim(kind, x))
    np.testing.assert_array_equal(got, got.T)


def test_similarity_matrix_takes_a_batch(rng):
    x = _int_rows(rng, 3 * 20, 32).reshape(3, 20, 32)
    x[1, 13:] = 0.0  # a padded document
    got = tsim.similarity_matrix(torch.from_numpy(x)).numpy()
    assert got.shape == (3, 20, 20)
    for b in range(3):
        np.testing.assert_array_equal(
            got[b], tsim.similarity_matrix(torch.from_numpy(x[b])).numpy())
    assert not got[1, 13:].any() and not got[1, :, 13:].any()


def test_plain_version_is_full_f32_whatever_the_global_setting(rng):
    x = torch.from_numpy(_unit_rows(rng, 40, 64))
    want = tsim.similarity_matrix_plain(x)
    assert want.dtype == torch.float32
    exact = (x.double() @ x.double().T).float()
    assert torch.equal(want, exact)
    torch.set_float32_matmul_precision("medium")
    try:
        got = tsim.similarity_matrix_plain(x)
    finally:
        torch.set_float32_matmul_precision("highest")
    assert torch.equal(got, want)


def test_wrapper_rejects_what_it_cannot_take():
    with pytest.raises(ValueError, match="expected"):
        tsim.similarity_matrix(torch.zeros(4))
    x = torch.eye(4)  # ``block`` is the JAX kernel's; accepted and unused
    assert torch.equal(tsim.similarity_matrix_pallas(x, block=0),
                       tsim.similarity_matrix(x))
    with pytest.raises(ValueError, match="tensor on"):
        tsim.similarity_matrix(torch.zeros((4, 4), device="meta"))


def test_l2_normalize_and_adjacent_match_jax(rng):
    x = rng.standard_normal((19, 48)).astype(np.float32)
    x[4] = 0.0  # a zero row stays zero (eps clamp)
    got = tsim.l2_normalize(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jsim.l2_normalize(jnp.asarray(x))), rtol=0, atol=1e-6)
    u = _unit_rows(rng, 23, 64)
    np.testing.assert_allclose(
        tsim.adjacent_similarities(torch.from_numpy(u)).numpy(),
        np.asarray(jsim.adjacent_similarities(jnp.asarray(u))),
        rtol=0, atol=1e-6)


def _tied_matrix(rng, n):
    """A symmetric matrix of a few distinct values: ties in every row and
    column, so only a stable sort reproduces the ranks."""
    s = rng.integers(0, 4, size=(n, n)).astype(np.float32)
    return np.maximum(s, s.T) / 4


@pytest.mark.parametrize("case", ["jax_sim", "ties", "asymmetric"])
def test_rank_matrix_global_equals_jax(rng, case):
    if case == "jax_sim":
        s = _jax_sim("einsum", _unit_rows(rng, 37, 64))
    elif case == "ties":
        s = _tied_matrix(rng, 29)
    else:
        s = rng.standard_normal((21, 21)).astype(np.float32)
    got = tsim.rank_matrix_global(torch.from_numpy(s)).numpy()
    want = np.asarray(jsim.rank_matrix_global(jnp.asarray(s)))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case,mask_size", [("jax_sim", 11), ("jax_sim", 4),
                                            ("ties", 5), ("ties", 1)])
def test_rank_matrix_local_equals_jax(rng, case, mask_size):
    s = (_jax_sim("einsum", _unit_rows(rng, 26, 64)) if case == "jax_sim"
         else _tied_matrix(rng, 18))
    got = tsim.rank_matrix_local(torch.from_numpy(s), mask_size).numpy()
    want = np.asarray(jsim.rank_matrix_local(jnp.asarray(s), mask_size))
    np.testing.assert_array_equal(got, want)


def test_analyze_similarity_distribution_matches_jax(rng):
    s = _jax_sim("einsum", _unit_rows(rng, 15, 32))
    assert (tsim.analyze_similarity_distribution(torch.from_numpy(s))
            == jsim.analyze_similarity_distribution(s))
    assert tsim.analyze_similarity_distribution(s[:1, :1]) == {"count": 0}


@pytest.mark.parametrize("name", ["ChunkingConfig", "TrainConfig", "Config",
                                  "EncoderConfig", "RankingConfig",
                                  "IndexConfig"])
def test_config_defaults_match_jax(name):
    assert (dataclasses.asdict(getattr(tcfg, name)())
            == dataclasses.asdict(getattr(jcfg, name)()))


@pytest.mark.parametrize("name", sorted(tcfg.NAMED_CONFIGS))
def test_named_config_matches_jax(name):
    mine, theirs = tcfg.get_named_config(name), jcfg.get_named_config(name)
    assert mine.name == name
    for f in dataclasses.fields(mine):
        a, b = getattr(mine, f.name), getattr(theirs, f.name)
        if dataclasses.is_dataclass(a):
            a, b = dataclasses.asdict(a), dataclasses.asdict(b)
        assert a == b, f.name


def test_config_registry_and_override():
    assert set(tcfg.NAMED_CONFIGS) == set(jcfg.NAMED_CONFIGS) - {"serve_device"}
    with pytest.raises(KeyError, match="Unknown config"):
        tcfg.get_named_config("serve_device")
    cfg = tcfg.get_named_config("semantic_splitter").override(
        chunking={"collect_metadata": True}, seed=7)
    assert cfg.chunking.collect_metadata and cfg.seed == 7
    assert cfg.chunking.method == "splitter"
    with pytest.raises(KeyError, match="no config field"):
        cfg.override(chunking={"nope": 1})
    assert '"max_sentences": 4096' in cfg.to_json()
