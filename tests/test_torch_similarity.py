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

from _tf32_model import tf32 as _tf32, tf32x3 as _tf32x3


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


def _plan_tiles(plan, b):
    """(first document, ti, tj, documents) of every CTA, decoded as
    csrc/similarity.cu's gram_kernel decodes blockIdx.x, launch by launch
    (65,535 documents each)."""
    tiles, group, pairs = (plan["tiles_per_doc"], plan["docs_per_tile"],
                           plan["pairs"])
    for b0 in range(0, b, 65535):
        nb = min(65535, b - b0)
        if tiles == 1:
            for cta in range(-(-nb // group)):
                doc = b0 + cta * group
                yield doc, 0, 0, min(group, b0 + nb - doc)
            continue
        for cta in range(nb * pairs):
            p, ti = cta % pairs, 0
            while p >= tiles - ti:
                p -= tiles - ti
                ti += 1
            yield b0 + cta // pairs, ti, ti + p, 1


def _stored(plan, n, doc0, ti, tj, docs):
    """(document, i, j) of the elements a CTA stores, i <= j: its tile's
    rows and columns that fall in the same document of the tile, on or above
    that document's diagonal (the kernel's epilogue rule), among those its
    warpgroups compute (at ``wg_cols`` 64 each only its own half)."""
    t = plan["tile"]
    li = ti * t + np.arange(t)[:, None]
    lj = tj * t + np.arange(t)[None, :]
    rd, ri = li // n, li % n
    cd, cj = lj // n, lj % n
    keep = (rd == cd) & (rd < docs) & (ri <= cj)
    if plan["wg_cols"] == 64:
        keep &= (np.arange(t)[:, None] // 64) == (np.arange(t)[None, :] // 64)
    rows, cols = np.nonzero(keep)
    return doc0 + rd[rows, 0], ri[rows, 0], cj[0, cols]


@pytest.mark.parametrize("n", [1, 8, 63, 64, 65, 127, 128, 129, 3939, 4096])
def test_similarity_plan_covers_the_triangle_once(n):
    """Every (ti <= tj) tile pair of every document is one CTA; below 130
    rows every element (i, j) of every document is stored exactly once as
    (i, j) or its mirror; the ring fits 232,448 bytes in both dtypes."""
    b = 5 if n < 1000 else 2
    for dtype in (torch.float32, torch.bfloat16):
        plan = tsim.similarity_plan(b, n, 384, dtype)
        ctas = list(_plan_tiles(plan, b))
        assert len(ctas) == plan["ctas"] and plan["launches"] == 1
        t = plan["tiles_per_doc"]
        assert t == -(-n // 128)
        if t > 1:
            pairs = sorted((doc, ti, tj) for doc, ti, tj, _ in ctas)
            assert pairs == [(doc, ti, tj) for doc in range(b)
                             for ti in range(t) for tj in range(ti, t)]
        else:
            assert plan["docs_per_tile"] == 128 // n
            assert sum(docs for _, _, _, docs in ctas) == b
        assert plan["wg_cols"] == (64 if n in (1, 8, 64) else 128)
        if n < 130:
            count = np.zeros((b, n, n), np.int64)
            for cta in ctas:
                doc, i, j = _stored(plan, n, *cta)
                np.add.at(count, (doc, i, j), 1)
                off = i != j
                np.add.at(count, (doc[off], j[off], i[off]), 1)
            assert (count == 1).all()
        assert plan["smem_bytes"] <= 232448
        assert 1 <= plan["stages"] <= min(8, plan["kchunks"])
        assert plan["stage_bytes"] == ((1 if t == 1 else 2) + (
            1 if dtype == torch.float32 else 0)) * 16384


def test_similarity_plan_ring_pad_and_scratch():
    f32 = tsim.similarity_plan(1, 4096, 384)
    assert (f32["stages"], f32["smem_bytes"], f32["ctas"], f32["kchunks"]) == (
        4, 1152 + 4 * 49152, 32 * 33 // 2, 12)
    assert f32["split"] and f32["scratch_bytes"] == 0  # E read as it is
    short = tsim.similarity_plan(256, 64, 384)
    assert (short["docs_per_tile"], short["ctas"], short["stages"],
            short["wg_cols"]) == (2, 128, 7, 64)
    bf = tsim.similarity_plan(1, 4096, 384, torch.bfloat16)
    assert (bf["kchunks"], bf["stages"], bf["scratch_bytes"]) == (6, 6, 0)
    for d, f32_pad, bf16_pad in [(30, 2, 2), (72, 0, 0), (77, 3, 3),
                                 (100, 0, 4), (384, 0, 0)]:
        a = tsim.similarity_plan(3, 77, d)
        c = tsim.similarity_plan(3, 77, d, torch.bfloat16)
        assert (a["col_pad"], c["col_pad"]) == (f32_pad, bf16_pad)
        assert a["pitch"] % 4 == 0 and c["pitch"] % 8 == 0
        assert a["scratch_bytes"] == (3 * 77 * a["pitch"] * 4 if f32_pad
                                      else 0)
        assert c["scratch_bytes"] == (3 * 77 * c["pitch"] * 2 if bf16_pad
                                      else 0)
    many = tsim.similarity_plan(65535 + 3, 8, 16)
    assert (many["launches"], many["ctas"]) == (2, 4096 + 1)
    with pytest.raises(NotImplementedError, match="float32 or bfloat16"):
        tsim.similarity_plan(1, 8, 16, torch.float16)


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1 + 2.0 ** -10, 1 + 2.0 ** -11, 1 + 3 * 2.0 ** -12,
                      -(1 + 2.0 ** -11), 127.0, -2048.0, 2049.0])
    want = torch.tensor([1.0, 1 + 2.0 ** -10, 1 + 2.0 ** -10, 1 + 2.0 ** -10,
                         -(1 + 2.0 ** -10), 127.0, -2048.0, 2050.0])
    assert torch.equal(_tf32(x), want)


def test_tf32x3_scheme_matches_jax(rng):
    """The split's numerics before the card: exact on integer rows in
    [-127, 127] at d = 384 (hi = x, lo = 0, sums below 2^24), within 1e-5
    of the JAX f32 product on unit rows at d = 384."""
    x = rng.integers(-127, 128, size=(90, 384)).astype(np.float32)
    got = _tf32x3(torch.from_numpy(x))
    assert torch.equal(_tf32(torch.from_numpy(x)), torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), _jax_sim("einsum", x))
    u = _unit_rows(rng, 200, 384)
    got = _tf32x3(torch.from_numpy(u)).numpy()
    np.testing.assert_allclose(got, _jax_sim("einsum", u), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got, got.T)
    # the split itself: x = hi + lo to within 2^-22 |x|
    t = torch.from_numpy(u)
    hi = _tf32(t)
    rest = (t.double() - hi.double() - _tf32(t - hi).double()).abs()
    assert bool((rest <= 2.0 ** -22 * t.double().abs()).all())


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
    assert set(tcfg.NAMED_CONFIGS) == set(jcfg.NAMED_CONFIGS)
    assert tcfg.get_named_config("serve_device").ranking.lexical_device
    with pytest.raises(KeyError, match="Unknown config"):
        tcfg.get_named_config("no_such_config")
    cfg = tcfg.get_named_config("semantic_splitter").override(
        chunking={"collect_metadata": True}, seed=7)
    assert cfg.chunking.collect_metadata and cfg.seed == 7
    assert cfg.chunking.method == "splitter"
    with pytest.raises(KeyError, match="no config field"):
        cfg.override(chunking={"nope": 1})
    assert '"max_sentences": 4096' in cfg.to_json()
