"""The port's DeviceBM25 (on the CPU) against the JAX package's host BM25.

Every case of ``tests/test_bm25_tpu.py`` that needs no mesh: the port's
device leg must give ``semanticsearch_tpu``'s ``BM25Okapi.get_topk_batch``
ids, tie order and f32 score bits in both weight modes, with and without
the residual matrix, and the engine's ``lexical_device`` leg the JAX
engine's hits."""
import dataclasses
import os

import numpy as np
import pytest
import torch

from semanticsearch_tpu.index.bm25 import BM25Okapi as JBM25
from semanticsearch_tpu_torch import native
from semanticsearch_tpu_torch.core.config import (
    EncoderConfig, RankingConfig, get_named_config,
)
from semanticsearch_tpu_torch.data.tsv import write_tsv
from semanticsearch_tpu_torch.index.bm25 import BM25Okapi, tokenize
from semanticsearch_tpu_torch.index.bm25_tpu import DeviceBM25
from semanticsearch_tpu_torch.index.query_engine import HybridQueryEngine
from semanticsearch_tpu_torch.models.encoder import SentenceEncoder

MODES = [(True, "bf16"), (False, "bf16"), (True, "int8")]


def _zipf_corpus(rng, n_docs, vocab=500, doc_len=(5, 40)):
    words = [f"w{i}" for i in range(vocab)]
    p = 1.0 / np.arange(1, vocab + 1)
    p /= p.sum()
    return [" ".join(rng.choice(words, size=rng.integers(*doc_len), p=p))
            for _ in range(n_docs)]


def _queries(rng, docs, n_queries, terms=(2, 6)):
    qs = []
    for _ in range(n_queries):
        src = docs[rng.integers(len(docs))].split()
        n = min(len(src), rng.integers(*terms))
        qs.append(" ".join(rng.choice(src, size=n)))
    return qs


def _device(docs, **kw):
    bm = BM25Okapi([tokenize(d) for d in docs])
    return bm, DeviceBM25(bm, device="cpu", **kw)


def _assert_host_parity(docs, q_toks, k, got):
    """``got`` equals the JAX package's native host top-k, bit for bit."""
    jbm = JBM25([tokenize(d) for d in docs])
    want_i, want_s = jbm.get_topk_batch(q_toks, k)
    np.testing.assert_array_equal(got[0], want_i)
    np.testing.assert_array_equal(got[1], want_s)


@pytest.mark.parametrize("residual,weights", MODES)
@pytest.mark.parametrize("n_dense_terms", [8, 64, 10_000])
def test_device_bm25_matches_host_exactly(n_dense_terms, residual, weights):
    """Tiny B (most terms rare), mid B and B >= vocab (every term dense)."""
    rng = np.random.default_rng(0)
    docs = _zipf_corpus(rng, 400)
    _, dev = _device(docs, n_dense_terms=n_dense_terms, topk_device=16,
                     query_chunk=32, residual=residual, weights=weights)
    q_toks = [tokenize(q) for q in _queries(rng, docs, 50)]
    _assert_host_parity(docs, q_toks, 10, dev.get_topk_batch(q_toks, 10))
    assert dev.stats["queries"] == 50


@pytest.mark.parametrize("residual,weights", MODES)
def test_device_bm25_edge_queries(residual, weights):
    """OOV-only, empty, repeated stopword-class terms, one frequent term,
    the rarest tail term (fewer matches than k: zero-score fill)."""
    rng = np.random.default_rng(1)
    docs = _zipf_corpus(rng, 100)
    _, dev = _device(docs, n_dense_terms=32, topk_device=8, query_chunk=8,
                     residual=residual, weights=weights)
    q_toks = [["zzz", "not-in-vocab"], [], ["w0", "w0", "w1"],
              tokenize(docs[7])[:1], ["w499"]]
    _assert_host_parity(docs, q_toks, 12, dev.get_topk_batch(q_toks, 12))


def test_device_bm25_certificate_rate():
    """Nearly every query certifies; the residual pass (either weight mode)
    at least as often as the single matrix."""
    rng = np.random.default_rng(2)
    docs = _zipf_corpus(rng, 1000)
    bm = BM25Okapi([tokenize(d) for d in docs])
    q_toks = [tokenize(q) for q in _queries(rng, docs, 200)]
    frac = {}
    for residual, weights in MODES:
        dev = DeviceBM25(bm, n_dense_terms=128, topk_device=32,
                         query_chunk=64, residual=residual, weights=weights,
                         device="cpu")
        dev.get_topk_batch(q_toks, 10)
        frac[residual, weights] = (dev.stats["fallbacks"]
                                   / dev.stats["queries"])
    assert frac[False, "bf16"] < 0.2, frac
    assert frac[True, "bf16"] <= frac[False, "bf16"], frac
    assert frac[True, "int8"] <= frac[False, "bf16"], frac


@pytest.mark.parametrize("weights", ["bf16", "int8"])
def test_device_bm25_query_chunking(weights):
    """Results do not depend on the query_chunk partition (7 pads the
    product's rows to 24, 30 to 32)."""
    rng = np.random.default_rng(3)
    docs = _zipf_corpus(rng, 150)
    bm = BM25Okapi([tokenize(d) for d in docs])
    q_toks = [tokenize(q) for q in _queries(rng, docs, 30)]
    a = DeviceBM25(bm, n_dense_terms=64, query_chunk=7, weights=weights,
                   device="cpu").get_topk_batch(q_toks, 5)
    b = DeviceBM25(bm, n_dense_terms=64, query_chunk=30, weights=weights,
                   device="cpu").get_topk_batch(q_toks, 5)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
    _assert_host_parity(docs, q_toks, 5, a)


@pytest.mark.parametrize("residual,weights", MODES)
@pytest.mark.parametrize("n_docs", [600, 1000])
def test_chunked_scoring_matches_host(n_docs, residual, weights):
    """600 docs pad to 768 columns: one 512-column chunk and a 256-column
    tail; 1000 pad to 1024: two full chunks."""
    rng = np.random.default_rng(7)
    docs = _zipf_corpus(rng, n_docs)
    _, dev = _device(docs, n_dense_terms=64, topk_device=32, query_chunk=16,
                     residual=residual, score_chunk_cols=512,
                     weights=weights)
    q_toks = [tokenize(q) for q in _queries(rng, docs, 30)]
    _assert_host_parity(docs, q_toks, 10, dev.get_topk_batch(q_toks, 10))


def test_block_topk_path_matches_host():
    """5000 docs pad to 5120 columns: the staged block selection runs."""
    rng = np.random.default_rng(13)
    docs = _zipf_corpus(rng, 5000, vocab=1500)
    _, dev = _device(docs, n_dense_terms=256, topk_device=64, query_chunk=64)
    q_toks = [tokenize(q) for q in _queries(rng, docs, 80)]
    got = dev.get_topk_batch(q_toks, 12)
    assert (got[0] < 5000).all()
    _assert_host_parity(docs, q_toks, 12, got)


def test_topk_device_exceeding_score_chunk():
    """K' wider than a score chunk: each chunk selects all its columns."""
    rng = np.random.default_rng(17)
    docs = _zipf_corpus(rng, 700)
    _, dev = _device(docs, n_dense_terms=64, topk_device=300,
                     query_chunk=16, score_chunk_cols=256)
    q_toks = [tokenize(q) for q in _queries(rng, docs, 20)]
    _assert_host_parity(docs, q_toks, 40, dev.get_topk_batch(q_toks, 40))


@pytest.mark.parametrize("post", ["native", "plain"])
def test_pad_columns_in_device_topk_stay_exact(post, monkeypatch):
    """Negative-idf matches rank below the pad columns' exact 0.0, so pads
    enter the device top-K'; the post drops them and bounds every
    non-candidate by 0 + err_ub (not by the masked -inf). Both the native
    post and its numpy version."""
    commons = " ".join(f"c{i}" for i in range(8))
    docs = ["rare rare"] * 20 + [commons] * 250 + ["mid mid"] * 30
    bm, dev = _device(docs, n_dense_terms=10_000, topk_device=64,
                      query_chunk=8, residual=False)
    assert bm.idf[bm.vocab["c0"]] < 0
    if post == "plain":
        def plain(inv_indptr, inv_docs, inv_quot, idf, k1, vals, idx, kp,
                  touch_indptr, touch_docs, q_indptr, q_tids, q_w, err_ub,
                  n_docs, k):
            return dev.device_post_plain(vals, idx, (touch_indptr,
                                                     touch_docs, None),
                                         q_indptr, q_tids, q_w, err_ub, k)
        monkeypatch.setattr(native, "bm25_device_post", plain)
    q_toks = [["rare", "c0"], ["c0", "c1"], ["rare"], ["mid", "c3", "rare"]]
    handle = dev.start_topk_batch(q_toks, 10)
    _, idx = dev._fetch(handle[2][0][2][3], len(q_toks))
    assert (idx >= bm.n_docs).any()  # pads really were selected
    _assert_host_parity(docs, q_toks, 10, dev.finish_topk_batch(handle))


def test_start_finish_interleaved_matches_get_topk_batch():
    rng = np.random.default_rng(3)
    docs = _zipf_corpus(rng, 300)
    _, dev = _device(docs, n_dense_terms=64, topk_device=16, query_chunk=16)
    q_toks = [tokenize(q) for q in _queries(rng, docs, 40)]
    ref_i, ref_s = dev.get_topk_batch(q_toks, 8)
    h1 = dev.start_topk_batch(q_toks[:24], 8)
    h2 = dev.start_topk_batch(q_toks[24:], 8)
    i2, s2 = dev.finish_topk_batch(h2)  # finished out of dispatch order
    i1, s1 = dev.finish_topk_batch(h1)
    np.testing.assert_array_equal(np.vstack([i1, i2]), ref_i)
    np.testing.assert_array_equal(np.vstack([s1, s2]), ref_s)


def test_cache_roundtrip_and_staleness(tmp_path):
    """A second construction memmaps the cached matrix (no rewrite); a new
    corpus in the same directory fails the fingerprint and rebuilds; a
    tampered meta never validates."""
    rng = np.random.default_rng(11)
    docs = _zipf_corpus(rng, 300)
    q_toks = [tokenize(q) for q in _queries(rng, docs, 25)]
    cache = str(tmp_path / "idx")
    bm, dev1 = _device(docs, n_dense_terms=64, topk_device=16,
                       query_chunk=32, cache_dir=cache)
    i1, s1 = dev1.get_topk_batch(q_toks, 10)
    meta_p = os.path.join(cache, DeviceBM25._CACHE_META)
    assert os.path.exists(os.path.join(cache, DeviceBM25._CACHE_CC))
    mtime = os.path.getmtime(meta_p)
    dev2 = DeviceBM25(bm, n_dense_terms=64, topk_device=16, query_chunk=32,
                      cache_dir=cache, device="cpu")
    i2, s2 = dev2.get_topk_batch(q_toks, 10)
    assert os.path.getmtime(meta_p) == mtime
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_array_equal(s1, s2)
    np.testing.assert_array_equal(dev1.scale, dev2.scale)
    docs_b = _zipf_corpus(rng, 300)
    _, dev3 = _device(docs_b, n_dense_terms=64, topk_device=16,
                      query_chunk=32, cache_dir=cache)
    q_b = [tokenize(q) for q in _queries(rng, docs_b, 25)]
    got = dev3.get_topk_batch(q_b, 10)
    _assert_host_parity(docs_b, q_b, 10, got)
    assert os.path.getmtime(meta_p) > mtime
    with open(meta_p, "w") as f:
        f.write("{}")
    _, dev4 = _device(docs_b, n_dense_terms=64, topk_device=16,
                      query_chunk=32, cache_dir=cache)
    np.testing.assert_array_equal(dev4.get_topk_batch(q_b, 10)[0], got[0])


def test_cache_written_by_jax_loads(tmp_path):
    """The cache files are the JAX package's format: a matrix the JAX
    DeviceBM25 persisted loads here unchanged."""
    from semanticsearch_tpu.index.bm25_tpu import DeviceBM25 as JDevice

    rng = np.random.default_rng(12)
    docs = _zipf_corpus(rng, 200)
    cache = str(tmp_path / "idx")
    jdev = JDevice(JBM25([tokenize(d) for d in docs]), n_dense_terms=48,
                   topk_device=16, query_chunk=16, cache_dir=cache)
    meta_p = os.path.join(cache, DeviceBM25._CACHE_META)
    mtime = os.path.getmtime(meta_p)
    _, dev = _device(docs, n_dense_terms=48, topk_device=16, query_chunk=16,
                     cache_dir=cache)
    assert os.path.getmtime(meta_p) == mtime  # loaded, not rebuilt
    np.testing.assert_array_equal(dev.scale, jdev.scale)
    np.testing.assert_array_equal(dev.scale_lo, jdev.scale_lo)
    q_toks = [tokenize(q) for q in _queries(rng, docs, 20)]
    _assert_host_parity(docs, q_toks, 10, dev.get_topk_batch(q_toks, 10))


def test_cache_sweeps_dead_builder_tmps(tmp_path):
    rng = np.random.default_rng(14)
    docs = _zipf_corpus(rng, 120)
    cache = str(tmp_path / "idx")
    os.makedirs(cache)
    base = os.path.join(cache, DeviceBM25._CACHE_CC)
    dead = base + ".999999999.tmp"  # a pid past pid_max: never alive
    live = base + ".1.tmp"          # pid 1: alive on any Linux host
    for path in (dead, live):
        with open(path, "wb") as f:
            f.write(b"x")
    _device(docs, n_dense_terms=32, topk_device=8, query_chunk=16,
            cache_dir=cache)
    assert not os.path.exists(dead)
    assert os.path.exists(live)


def test_refusals():
    bm = BM25Okapi([["a", "b"], ["b"]])
    # a mesh is taken (column sharding, tests/test_torch_sharding.py): the
    # per-shard K' is capped at a shard's columns
    from semanticsearch_tpu_torch.core.mesh import MeshSpec, make_mesh

    mesh = make_mesh(MeshSpec(data=2), [torch.device("cpu")] * 2)
    assert DeviceBM25(bm, mesh=mesh, device="cpu").topk_device == 1
    with pytest.raises(ValueError, match="residual"):
        DeviceBM25(bm, residual=False, weights="int8", device="cpu")
    with pytest.raises(ValueError, match="bf16|int8"):
        DeviceBM25(bm, weights="fp8", device="cpu")


# ------------------------------------------------------------------ engine

ENC = dict(vocab_size=500, hidden_dim=32, num_layers=1, num_heads=2,
           mlp_dim=64, max_len=32, dtype="float32")


def _chunks(tmp_path, docs):
    path = str(tmp_path / "chunks.tsv")
    write_tsv(path, [{"chunk_id": f"c{i}", "query_id": "",
                      "document_id": f"d{i}", "chunk_text": t}
                     for i, t in enumerate(docs)],
              ["chunk_id", "query_id", "document_id", "chunk_text"])
    return path


def _hits(result):
    return [[(h.chunk_id, h.dense_rank, h.lexical_rank, h.score) for h in q]
            for q in result]


def test_engine_device_lexical_matches_jax_engine(tmp_path):
    """``serve_device`` hits equal the JAX engine's under lexical_device and
    the port's own host leg, pipelined and not, synchronous finish too."""
    from semanticsearch_tpu.core.config import EncoderConfig as JCfg
    from semanticsearch_tpu.core.config import RankingConfig as JRank
    from semanticsearch_tpu.index.query_engine import (
        HybridQueryEngine as JEngine)
    from semanticsearch_tpu.models.encoder import SentenceEncoder as JEnc
    from semanticsearch_tpu_torch.models.convert import flax_to_state_dict

    rng = np.random.default_rng(5)
    docs = _zipf_corpus(rng, 80, vocab=150, doc_len=(5, 20))
    chunks = _chunks(tmp_path, docs)
    jenc = JEnc(JCfg(**ENC), seed=2)
    JEngine.build(chunks, jenc, str(tmp_path / "idx"))
    jeng = JEngine.load(str(tmp_path / "idx"), jenc, rank_cfg=JRank(
        lexical_device=True, lexical_dense_terms=32))
    tenc = SentenceEncoder(EncoderConfig(**ENC), device="cpu",
                           state_dict=flax_to_state_dict(jenc.params, 1))
    cfg = get_named_config("serve_device").ranking
    teng = HybridQueryEngine.load(str(tmp_path / "idx"), tenc, device="cpu",
                                  rank_cfg=dataclasses.replace(
                                      cfg, lexical_dense_terms=32))
    host = HybridQueryEngine.load(str(tmp_path / "idx"), tenc, device="cpu")
    queries = _queries(rng, docs, 12) + ["zzz unmatched"]
    want = jeng.search(queries, k=5)
    got = teng.search(queries, k=5)
    assert teng._device_bm25 is not None and teng.cfg.lexical_device
    assert teng._device_bm25.weights == "int8"
    for w, g, h in zip(_hits(want), _hits(got),
                       _hits(host.search(queries, k=5))):
        assert [x[:3] for x in g] == [x[:3] for x in w]
        np.testing.assert_allclose([x[3] for x in g], [x[3] for x in w],
                                   rtol=0, atol=1e-9)
        assert g == h
    piped = teng.search_pipelined([queries[:5], queries[5:]], k=5)
    assert _hits(piped[0] + piped[1]) == _hits(got)
    teng.lexical_async_finish = False
    assert _hits(teng.search(queries, k=5)) == _hits(got)
    assert teng._device_bm25.stats["queries"] == 3 * len(queries)


def test_engine_rebuilds_device_bm25_for_deeper_requests(tmp_path):
    rng = np.random.default_rng(13)
    docs = _zipf_corpus(rng, 250)
    enc = SentenceEncoder(EncoderConfig(**ENC), device="cpu", seed=0)
    cfg = RankingConfig(lexical_device=True, lexical_dense_terms=64,
                        lexical_topk_device=8)
    eng = HybridQueryEngine.build(_chunks(tmp_path, docs), enc,
                                  str(tmp_path / "idx"), rank_cfg=cfg,
                                  device="cpu")
    eng.search([docs[5]], k=3, candidates=8)
    shallow = eng._device_bm25
    assert shallow is not None and eng._device_bm25_depth == 8
    hits = eng.search([docs[5]], k=3, candidates=48)[0]
    assert eng._device_bm25 is not shallow
    assert eng._device_bm25_depth == 48
    assert hits[0].chunk_id == "c5"
    deep = eng._device_bm25
    eng.search([docs[9]], k=3, candidates=8)
    assert eng._device_bm25 is deep


def test_device_bm25_invalidated_by_compact(tmp_path):
    rng = np.random.default_rng(21)
    docs = _zipf_corpus(rng, 30, vocab=100, doc_len=(5, 15))
    enc = SentenceEncoder(EncoderConfig(**ENC), device="cpu", seed=0)
    HybridQueryEngine.build(_chunks(tmp_path, docs), enc,
                            str(tmp_path / "idx"), device="cpu")
    engine = HybridQueryEngine.load(
        str(tmp_path / "idx"), enc, device="cpu",
        rank_cfg=RankingConfig(lexical_device=True, lexical_dense_terms=32))
    engine.search([" ".join(docs[3].split()[:3])], k=3)
    before = engine._device_bm25
    assert before is not None
    engine.add_documents(["c_new"], ["totally fresh glacier words here"])
    engine.compact()
    assert engine._device_bm25 is None
    hits = engine.search(["totally fresh glacier"], k=2)[0]
    assert engine._device_bm25 is not None
    assert engine._device_bm25 is not before
    assert hits[0].chunk_id == "c_new"


def test_cache_through_engine(tmp_path):
    rng = np.random.default_rng(12)
    docs = _zipf_corpus(rng, 200)
    enc = SentenceEncoder(EncoderConfig(**ENC), device="cpu", seed=0)
    cfg = RankingConfig(lexical_device=True, lexical_dense_terms=64,
                        lexical_cache=True)
    eng = HybridQueryEngine.build(_chunks(tmp_path, docs), enc,
                                  str(tmp_path / "idx"), rank_cfg=cfg,
                                  device="cpu")
    r1 = eng.search([docs[3], docs[17]], k=5)
    assert os.path.exists(str(tmp_path / "idx" / "device_bm25.meta.json"))
    eng2 = HybridQueryEngine.load(str(tmp_path / "idx"), enc, rank_cfg=cfg,
                                  device="cpu")
    assert _hits(eng2.search([docs[3], docs[17]], k=5)) == _hits(r1)
