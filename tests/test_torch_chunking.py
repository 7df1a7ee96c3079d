"""The port's chunking modules against the JAX package's, on the CPU.

Host logic (cleaning, segmenter, char splitter, DP segmentation, C99,
valleys, NMS, Louvain, k-means, the grouper's post-processing) is numpy in
both packages and must give equal results on equal inputs. The batched
signals compare exactly on integer-valued embeddings, whose similarity
matrices are exact in f32 on both sides. Group lists compare exactly on
planted-topic embeddings: blocks of near-identical unit vectors, where
within-block similarities are about 0.7 or more and between-block ones
about 0, so no boundary hangs on the last bits of a similarity."""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semanticsearch_tpu.chunking import cleaning as jclean
from semanticsearch_tpu.chunking import dp_segment as jdp
from semanticsearch_tpu.chunking import grouping as jgroup
from semanticsearch_tpu.chunking import naive as jnaive
from semanticsearch_tpu.chunking import segmenter as jseg
from semanticsearch_tpu.chunking import splitter as jsplit
from semanticsearch_tpu.core.config import ChunkingConfig as JChunkingConfig
from semanticsearch_tpu.ops import similarity as jsim
from semanticsearch_tpu_torch.chunking import cleaning as tclean
from semanticsearch_tpu_torch.chunking import dp_segment as tdp
from semanticsearch_tpu_torch.chunking import grouping as tgroup
from semanticsearch_tpu_torch.chunking import naive as tnaive
from semanticsearch_tpu_torch.chunking import segmenter as tseg
from semanticsearch_tpu_torch.chunking import splitter as tsplit
from semanticsearch_tpu_torch.core.config import ChunkingConfig as TChunkingConfig

TEXTS = [
    "Language: Spanish Article Type:BFN [Text] Real content here. More of it "
    "follows in a second sentence! And a third one?",
    "(Gutierrez) The situation is complex. (Reporter) What will you do now",
    "The ANC. announced plans -- and the FBI. replied. Language: Russian "
    "Article Type: CSO More text follows here; 1) first point; 2) second.",
    "[Article by Someone Long Name Here] Hi.",
    "Hi. " + "word " * 300 + "; " + "tail " * 10 + ".",
    "no terminal punctuation at all in this rather plain run of words",
    "",
]


# ------------------------------------------------------- host text modules

@pytest.mark.parametrize("fn", ["preclean_text", "preprocess_format",
                                "clean_document", "clean_with_guardrail"])
def test_cleaning_equals_jax(fn):
    for text in TEXTS + [None]:
        assert getattr(tclean, fn)(text) == getattr(jclean, fn)(text)


def test_validate_cleaned_text_equals_jax():
    for text in TEXTS:
        cleaned = tclean.clean_document(text)
        assert (tclean.validate_cleaned_text(text, cleaned)
                == jclean.validate_cleaned_text(text, cleaned))


@pytest.mark.parametrize("fn", ["split_sentences_regex", "extract_sentences",
                                "count_tokens"])
def test_segmenter_equals_jax(fn):
    for text in TEXTS:
        assert getattr(tseg, fn)(text) == getattr(jseg, fn)(text)
    if fn != "count_tokens":
        long = TEXTS[4]
        assert (getattr(tseg, fn)(long, max_sent_length=500)
                == getattr(jseg, fn)(long, max_sent_length=500))


@pytest.mark.parametrize("size,overlap,meta", [(30, 0, True), (30, 10, False),
                                               (0, 0, True), (7, 50, True)])
def test_chunk_by_chars_equals_jax(size, overlap, meta):
    for text in ("abcdefghij" * 10, "short", ""):
        assert (tnaive.chunk_by_chars("d1", text, size, overlap, meta)
                == jnaive.chunk_by_chars("d1", text, size, overlap, meta))


@pytest.mark.parametrize("penalty", [0.0, 0.05, 0.5])
def test_dp_segmentation_equals_jax(rng, penalty):
    adj = rng.uniform(0.1, 0.9, size=59)
    adj[[14, 29, 44]] = 0.0
    cand = [5, 15, 22, 30, 45, 52, 70]
    assert (tdp.dp_optimal_segmentation(adj, cand, penalty)
            == jdp.dp_optimal_segmentation(adj, cand, penalty))
    assert tdp.auto_penalty(adj) == jdp.auto_penalty(adj)
    assert tdp.auto_penalty([]) == 0.0


# ------------------------------------------------------ planted documents

def _topic_embeddings(rng, sizes, d=64, noise=0.05):
    """Blocks of near-identical unit vectors per topic: known boundaries."""
    out = []
    for s in sizes:
        center = rng.standard_normal(d)
        center /= np.linalg.norm(center)
        out.append(center[None, :] + noise * rng.standard_normal((s, d)))
    emb = np.concatenate(out, axis=0)
    return (emb / np.linalg.norm(emb, axis=1, keepdims=True)).astype(np.float32)


def _jax_rank(emb):
    return np.asarray(jsim.rank_matrix_global(
        jsim.similarity_matrix(jnp.asarray(emb))))


# --------------------------------------------------- splitter's host logic

@pytest.mark.parametrize("stopping,min_chunk", [("gain", 3), ("profile", 3),
                                                ("gain", 6)])
def test_c99_boundaries_equal_jax(rng, stopping, min_chunk):
    R = _jax_rank(_topic_embeddings(rng, [10, 14, 9, 12], noise=0.1))
    got = tsplit.c99_boundaries(R, min_chunk_size=min_chunk, stopping=stopping)
    want = jsplit.c99_boundaries(R, min_chunk_size=min_chunk,
                                 stopping=stopping)
    assert got == want and len(got) >= 1
    gp, gg = tsplit.c99_gain_curve(R, min_chunk)
    wp, wg = jsplit.c99_gain_curve(R, min_chunk)
    np.testing.assert_array_equal(gp, wp)
    np.testing.assert_array_equal(gg, wg)


@pytest.mark.parametrize("spacing,first", [(2, 3), (5, 5), (1, 0)])
def test_valley_boundaries_equal_jax(rng, spacing, first):
    emb = _topic_embeddings(rng, [12, 9, 15, 11], noise=0.15)
    adj = np.sum(emb[:-1] * emb[1:], axis=1)
    assert (tsplit.valley_candidates(adj, 0.12)
            == jsplit.valley_candidates(adj, 0.12))
    got = tsplit.valley_boundaries(adj, 0.12, spacing, first)
    assert got == jsplit.valley_boundaries(adj, 0.12, spacing, first)
    np.testing.assert_array_equal(tsplit.median_smooth(adj, 3),
                                  jsplit.median_smooth(adj, 3))
    np.testing.assert_array_equal(tsplit.robust_sigmoid(adj, 0.1),
                                  jsplit.robust_sigmoid(adj, 0.1))


@pytest.mark.parametrize("spacing", [1, 3, 8])
def test_score_based_nms_equals_jax(rng, spacing):
    bounds = sorted(set(rng.integers(1, 60, size=25).tolist()))
    scores = {b: float(rng.choice([0.5, 0.7, 1.0])) for b in bounds}
    assert (tsplit.score_based_nms(bounds, scores, spacing)
            == jsplit.score_based_nms(bounds, scores, spacing))


# ---------------------------------------------------------- batched signals

def _int_docs(rng, sizes, d=32):
    return [rng.integers(-5, 6, size=(n, d)).astype(np.float32) for n in sizes]


@pytest.mark.parametrize("sizes,bucket", [([5, 12, 9, 16], 16),
                                          ([2, 8, 3], 8), ([33, 17, 64], 64)])
def test_batched_split_signals_equal_jax(rng, sizes, bucket):
    docs = _int_docs(rng, sizes)
    got = tsplit.batched_split_signals(docs, bucket, device="cpu")
    want = jsplit.batched_split_signals(docs, bucket)
    for (R, adj), (Rj, adjj), emb in zip(got, want, docs):
        assert R.dtype == np.float32 and R.shape == (len(emb), len(emb))
        np.testing.assert_array_equal(R, Rj)
        np.testing.assert_allclose(adj, adjj, rtol=0, atol=1e-6)
        # batched equals per-document in the port
        S = tsplit.similarity_matrix(torch.from_numpy(emb))
        np.testing.assert_array_equal(
            R, tsplit.rank_matrix_global(S).numpy())
        np.testing.assert_array_equal(
            adj, tsplit.adjacent_similarities(torch.from_numpy(emb)).numpy())


def test_batched_split_signals_take_tensors_and_no_bucket(rng):
    docs = _int_docs(rng, [7, 11, 4])
    want = tsplit.batched_split_signals(docs, 16, device="cpu")
    got = tsplit.batched_split_signals([torch.from_numpy(e) for e in docs],
                                       device="cpu")
    for (R, adj), (Rw, adjw) in zip(got, want):
        np.testing.assert_array_equal(R, Rw)
        np.testing.assert_array_equal(adj, adjw)
    assert tsplit.batched_split_signals([], 8, device="cpu") == []
    with pytest.raises(ValueError, match="shorter"):
        tsplit.batched_split_signals(docs, 8, device="cpu")


@pytest.mark.parametrize("sizes,bucket", [([4, 11, 7], 16), ([30, 2], 32)])
def test_batched_similarity_matrices_equal_jax(rng, sizes, bucket):
    docs = _int_docs(rng, sizes)
    got = tgroup.batched_similarity_matrices(docs, bucket, device="cpu")
    want = jgroup.batched_similarity_matrices(docs, bucket)
    for S, Sj, emb in zip(got, want, docs):
        np.testing.assert_array_equal(S, Sj)
        np.testing.assert_array_equal(S, emb @ emb.T)
    units = [_topic_embeddings(rng, [n]) for n in sizes]
    for S, Sj in zip(
            tgroup.batched_similarity_matrices(units, bucket, device="cpu"),
            jgroup.batched_similarity_matrices(units, bucket)):
        np.testing.assert_allclose(S, Sj, rtol=0, atol=1e-6)
    assert tgroup.batched_similarity_matrices([], device="cpu") == []


# ------------------------------------------------------------ the splitter

SPLIT_CASES = {
    "auto": dict(auto_params=True),
    "union_weighted": dict(auto_params=False, hybrid_mode="union_weighted"),
    "union": dict(auto_params=False, hybrid_mode="union"),
    "intersection": dict(auto_params=False, hybrid_mode="intersection"),
    "local_rank": dict(auto_params=True, c99_use_local_rank=True),
    "dp_refine": dict(auto_params=True, use_dp_refine=True),
    "profile_softcap": dict(auto_params=False, c99_stopping="profile",
                            soft_cap=12),
}


@pytest.mark.parametrize("case", sorted(SPLIT_CASES))
@pytest.mark.parametrize("precomputed", [False, True])
def test_split_by_embeddings_equals_jax(rng, case, precomputed):
    sizes = [9, 7, 8, 10, 14]
    emb = _topic_embeddings(rng, sizes, noise=0.12)
    kw = SPLIT_CASES[case]
    sig_t = sig_j = None
    if precomputed:
        (sig_t,) = tsplit.batched_split_signals([emb], 64, device="cpu")
        (sig_j,) = jsplit.batched_split_signals([emb], 64)
    got = tsplit.split_by_embeddings(emb, TChunkingConfig(**kw),
                                     signals=sig_t, device="cpu")
    want = jsplit.split_by_embeddings(emb, JChunkingConfig(**kw),
                                      signals=sig_j)
    assert got == want
    assert [i for g in got for i in g] == list(range(sum(sizes)))
    if case == "auto":
        starts = [g[0] for g in got]
        for gold in np.cumsum(sizes)[:-1]:
            assert min(abs(gold - s) for s in starts) <= 2, (starts, sizes)


def test_split_by_embeddings_short_documents():
    one = np.ones((1, 8), np.float32)
    assert tsplit.split_by_embeddings(one, device="cpu") == [[0]]
    assert tsplit.split_by_embeddings(one[:0], device="cpu") == []


@pytest.mark.parametrize("meta", [False, True])
def test_chunk_passage_splitter_equals_jax(rng, meta):
    sentences = [f"Sentence number {i} talks about things." for i in range(30)]
    emb = _topic_embeddings(rng, [15, 15])
    got = tsplit.chunk_passage_splitter("docA", sentences, emb,
                                        collect_metadata=meta, device="cpu")
    want = jsplit.chunk_passage_splitter("docA", sentences, emb,
                                         collect_metadata=meta)
    # the splitter's metadata comes from the host embeddings: equal as is
    assert got == want and len(got) >= 2
    assert tsplit.chunk_passage_splitter(
        "d", sentences[:1], emb[:1], device="cpu") == [
            ("d_chunk0", sentences[0], None)]


# ------------------------------------------------------------- the grouper

def test_sharpen_and_graph_equal_jax(rng):
    emb = _topic_embeddings(rng, [8, 8, 8])
    S = emb @ emb.T
    Ss = tgroup.sharpen_similarity(S)
    np.testing.assert_array_equal(Ss, jgroup.sharpen_similarity(S))
    W = tgroup.build_knn_graph(Ss, 5, 0.3)
    np.testing.assert_array_equal(W, jgroup.build_knn_graph(Ss, 5, 0.3))
    np.testing.assert_array_equal(tgroup.normalized_laplacian(W),
                                  jgroup.normalized_laplacian(W))


@pytest.mark.parametrize("gamma,seed", [(1.0, 0), (0.7, 3), (1.6, 1)])
def test_louvain_labels_equal_jax(rng, gamma, seed):
    emb = _topic_embeddings(rng, [7, 9, 6], noise=0.2)
    A = tgroup.sharpen_similarity(emb @ emb.T)
    got = tgroup.louvain_labels(A, gamma=gamma, seed=seed)
    np.testing.assert_array_equal(
        got, jgroup.louvain_labels(A, gamma=gamma, seed=seed))
    assert len(set(got.tolist())) >= 2
    assert tgroup.louvain_labels(np.zeros((4, 4))) is None


@pytest.mark.parametrize("k,seed", [(2, 0), (3, 1), (4, 7)])
def test_kmeans_equals_jax(rng, k, seed):
    X = np.concatenate([c + 0.1 * rng.standard_normal((15, 3))
                        for c in rng.standard_normal((k, 3)) * 3])
    np.testing.assert_array_equal(tgroup.kmeans(X, k, seed=seed),
                                  jgroup.kmeans(X, k, seed=seed))


def _block_similarity(rng, n, blocks=3, scale=1.0):
    """A sharpened-similarity-like matrix with ``blocks`` planted groups:
    ``blocks`` dominant eigenvalues well clear of the rest."""
    labels = np.arange(n) * blocks // n
    S = np.where(labels[:, None] == labels[None, :], 0.8, 0.1)
    noise = 0.02 * rng.standard_normal((n, n))
    S = scale * (S + 0.5 * (noise + noise.T))
    np.fill_diagonal(S, 0.0)
    return S


@pytest.mark.parametrize("n", [40, 600])
def test_rmt_filter_matches_jax(rng, n):
    """n = 40 takes host LAPACK in both packages; n = 600 the device route:
    ``torch.linalg.eigh`` in f32 at the true n here, ``jnp.linalg.eigh`` in
    f32 padded to 768 there. Compared on the filtered matrix (eigenvector
    signs are free), to atol 1e-4: f32 eigenpairs of a matrix of norm about
    n * 0.1 * 0.8 carry errors of that norm times 1e-7 times a small
    factor."""
    S = _block_similarity(rng, n, scale=0.1 if n >= 512 else 1.0)
    got = tgroup.rmt_filter(S, keep_eigs=3, device="cpu")
    want = jgroup.rmt_filter(S, keep_eigs=3)
    assert got.shape == (n, n)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert np.all(got >= 0) and not np.diag(got).any()


def test_eigh_device_route_reconstructs(rng):
    n = tgroup._EIGH_DEVICE_MIN_N + 83
    A = rng.standard_normal((n, n))
    S = 0.5 * (A + A.T)
    evals, evecs = tgroup._eigh(S, device="cpu")
    assert evals.dtype == np.float32 and evecs.shape == (n, n)
    np.testing.assert_allclose(evals, np.linalg.eigh(S)[0], rtol=1e-4,
                               atol=5e-4)
    np.testing.assert_allclose((evecs * evals) @ evecs.T, S, atol=5e-4)
    small = S[:50, :50]
    np.testing.assert_array_equal(tgroup._eigh(small, device="cpu")[0],
                                  np.linalg.eigh(small)[0])


GROUP_CASES = {
    "auto_spectral": dict(method="grouping"),
    "modularity": dict(method="grouping", engine="modularity"),
    "manual": dict(method="grouping", auto_params=False),
    "manual_caps": dict(method="grouping", auto_params=False, knn_k=4,
                        spectral_kmax=3, cap_soft=6, small_group_min=3),
}


@pytest.mark.parametrize("case", sorted(GROUP_CASES))
def test_group_by_similarity_equals_jax(rng, case):
    emb = _topic_embeddings(rng, [8, 10, 7, 9])
    S = tgroup.sharpen_similarity(emb @ emb.T)
    kw = GROUP_CASES[case]
    got = tgroup.group_by_similarity(S, TChunkingConfig(**kw), seed=0,
                                     device="cpu")
    want = jgroup.group_by_similarity(S, JChunkingConfig(**kw), seed=0)
    assert got == want
    assert sorted(i for g in got for i in g) == list(range(34))


def test_group_by_similarity_device_eigh_route_equals_jax(rng):
    """A document of 520 sentences in four clean topics: the Laplacian's
    eigendecomposition takes the device route in both packages, and the
    four-way split does not hang on its last bits."""
    emb = _topic_embeddings(rng, [130, 130, 130, 130], noise=0.02)
    S = tgroup.sharpen_similarity(emb @ emb.T)
    got = tgroup.group_by_similarity(S, TChunkingConfig(method="grouping"),
                                     device="cpu")
    want = jgroup.group_by_similarity(S, JChunkingConfig(method="grouping"))
    assert got == want
    assert sorted(i for g in got for i in g) == list(range(520))


def _assert_same_metadata(mine, theirs):
    """Chunk metadata: ids, sentence indices and exemplars equal; the
    similarity statistics, printed to 4 decimals from matrices that agree to
    1e-6, within one unit of the last printed digit."""
    if mine is None or theirs is None:
        assert mine is None and theirs is None
        return
    a, b = json.loads(mine), json.loads(theirs)
    assert a.keys() == b.keys()
    for key in a:
        if isinstance(a[key], float):
            assert abs(a[key] - b[key]) <= 1.0001e-4, key
        else:
            assert a[key] == b[key], key


@pytest.mark.parametrize("precomputed", [False, True])
@pytest.mark.parametrize("meta", [False, True])
def test_chunk_passage_grouping_equals_jax(rng, precomputed, meta):
    sentences = [f"Sentence {i} content goes here okay." for i in range(24)]
    emb = _topic_embeddings(rng, [12, 12])
    sim_t = sim_j = None
    if precomputed:
        (sim_t,) = tgroup.batched_similarity_matrices([emb], 32, device="cpu")
        (sim_j,) = jgroup.batched_similarity_matrices([emb], 32)
    got = tgroup.chunk_passage_grouping(
        "docB", sentences, emb, collect_metadata=meta, sim_matrix=sim_t,
        device="cpu")
    want = jgroup.chunk_passage_grouping(
        "docB", sentences, emb, collect_metadata=meta, sim_matrix=sim_j)
    assert len(got) >= 2
    assert [c[:2] for c in got] == [c[:2] for c in want]
    for (_, _, m), (_, _, mj) in zip(got, want):
        _assert_same_metadata(m, mj)
    assert tgroup.chunk_passage_grouping(
        "d", sentences[:1], emb[:1], device="cpu") == [
            ("d_single", sentences[0], None)]
