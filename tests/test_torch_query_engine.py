"""The port serves an index the JAX package built, with the same hits.

The JAX ``HybridQueryEngine`` builds the index (float32 encoder and index);
the port loads that directory (its bm25.pkl included) with the encoder
weights converted, on the CPU. Hybrid, dense-only and pipelined searches
must return identical hits: chunk ids, dense and lexical ranks, and RRF
scores to 1e-9."""
import numpy as np
import pytest
import torch

from semanticsearch_tpu.core.config import EncoderConfig as JCfg
from semanticsearch_tpu.core.config import IndexConfig as JIndexCfg
from semanticsearch_tpu.index.query_engine import HybridQueryEngine as JEngine
from semanticsearch_tpu.models.encoder import SentenceEncoder as JEncoder
from semanticsearch_tpu_torch.core.config import EncoderConfig as TCfg
from semanticsearch_tpu_torch.core.config import IndexConfig as TIndexCfg
from semanticsearch_tpu_torch.data.tsv import write_tsv
from semanticsearch_tpu_torch.index.bm25 import load_bm25, tokenize
from semanticsearch_tpu_torch.index.query_engine import (
    HybridQueryEngine as TEngine,
)
from semanticsearch_tpu_torch.models.convert import flax_to_state_dict
from semanticsearch_tpu_torch.models.encoder import SentenceEncoder as TEncoder

ENC = dict(vocab_size=1000, hidden_dim=32, num_layers=2, num_heads=2,
           mlp_dim=64, max_len=64, dtype="float32")
# small blocks so the 60-row corpus spans several segments
IDX = dict(block_rows=256, seg_split=2, dtype="float32")
QUERIES = ["river water flows", "solar energy panel", "old stone bridge",
           "market price of grain", "the quick fox", "zzz unmatched term"]


def _corpus(rng):
    words = ("river water flows stone bridge solar energy panel market "
             "price grain harvest city road train station honey bees "
             "forest tree rain cloud wind mountain valley ship harbor "
             "copper iron gold silver coin bank loan").split()
    rows = []
    for i in range(60):
        n = int(rng.integers(4, 30))
        text = " ".join(rng.choice(words, size=n)) + f" doc{i}"
        rows.append({"chunk_id": f"c{i}", "query_id": "",
                     "document_id": f"d{i // 3}", "chunk_text": text})
    return rows


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    rng = np.random.default_rng(0)
    tmp = tmp_path_factory.mktemp("qe")
    chunks = str(tmp / "chunks.tsv")
    write_tsv(chunks, _corpus(rng),
              ["chunk_id", "query_id", "document_id", "chunk_text"])
    jenc = JEncoder(JCfg(**ENC), seed=5)
    jeng = JEngine.build(chunks, jenc, str(tmp / "idx"),
                         index_cfg=JIndexCfg(**IDX))
    tenc = TEncoder(TCfg(**ENC), device="cpu",
                    state_dict=flax_to_state_dict(jenc.params,
                                                  ENC["num_layers"]))
    teng = TEngine.load(str(tmp / "idx"), tenc, index_cfg=TIndexCfg(**IDX),
                        device="cpu")
    return jeng, teng, str(tmp / "idx")


def _assert_same_hits(j_hits, t_hits):
    assert len(j_hits) == len(t_hits)
    for jq, tq in zip(j_hits, t_hits):
        assert [h.chunk_id for h in tq] == [h.chunk_id for h in jq]
        assert [h.dense_rank for h in tq] == [h.dense_rank for h in jq]
        assert [h.lexical_rank for h in tq] == [h.lexical_rank for h in jq]
        np.testing.assert_allclose([h.score for h in tq],
                                   [h.score for h in jq], rtol=0, atol=1e-9)


@pytest.mark.parametrize("hybrid,k,candidates", [
    (True, 5, None), (True, 10, 25), (False, 5, None), (False, 3, 7)])
def test_search_matches_jax(engines, hybrid, k, candidates):
    jeng, teng, _ = engines
    _assert_same_hits(
        jeng.search(QUERIES, k=k, candidates=candidates, hybrid=hybrid),
        teng.search(QUERIES, k=k, candidates=candidates, hybrid=hybrid))


def test_search_pipelined_matches_jax(engines):
    jeng, teng, _ = engines
    batches = [QUERIES[:2], [], QUERIES[2:5], QUERIES[5:]]
    want = jeng.search_pipelined(batches, k=5)
    got = teng.search_pipelined(batches, k=5)
    assert len(got) == len(want)
    for w, g in zip(want, got):
        _assert_same_hits(w, g)
    # and pipelining changes nothing against one batch at a time
    for b, g in zip(batches, got):
        _assert_same_hits(teng.search(b, k=5), g)


def test_dense_leg_matches_jax_index(engines):
    jeng, teng, _ = engines
    q = np.random.default_rng(1).standard_normal((7, 32)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    want = jeng.index.search(q, k=9)
    got = teng.index.search(torch.from_numpy(q), k=9)
    np.testing.assert_array_equal(got.indices, want.indices)
    np.testing.assert_allclose(got.scores, want.scores, rtol=1e-5, atol=1e-6)


def test_bm25_topk_batch_matches_jax(engines):
    jeng, teng, idx_dir = engines
    toks = [tokenize(q) for q in QUERIES + ["river river river", "doc7"]]
    for k in (1, 5, 60, 100):
        ji, js = jeng.bm25.get_topk_batch(toks, k)
        ti, ts = teng.bm25.get_topk_batch(toks, k)
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(ts, js)
    # the pickle the JAX builder wrote loads as the port's class
    assert type(load_bm25(f"{idx_dir}/bm25.pkl")).__module__.startswith(
        "semanticsearch_tpu_torch")


def test_port_build_round_trips(engines, tmp_path):
    """The port's own build writes a directory it serves identically."""
    jeng, teng, idx_dir = engines
    from semanticsearch_tpu_torch.data.tsv import read_tsv

    chunks = str(tmp_path / "chunks.tsv")
    rows = list(read_tsv(f"{idx_dir}/ids.tsv"))
    texts = [r["chunk_text"] for r in read_tsv(f"{idx_dir}/texts.tsv")]
    write_tsv(chunks, [{"chunk_id": r["chunk_id"], "chunk_text": t}
                       for r, t in zip(rows, texts)],
              ["chunk_id", "chunk_text"])
    built = TEngine.build(chunks, teng.encoder, str(tmp_path / "idx"),
                          index_cfg=TIndexCfg(**IDX), device="cpu")
    loaded = TEngine.load(str(tmp_path / "idx"), teng.encoder,
                          index_cfg=TIndexCfg(**IDX), device="cpu")
    _assert_same_hits(built.search(QUERIES, k=5), loaded.search(QUERIES, k=5))
    _assert_same_hits(teng.search(QUERIES, k=5), loaded.search(QUERIES, k=5))


def test_rerank_stage_serves(engines):
    """The rerank stage: without a reranker ``rerank_top`` raises; with the
    same KNRM weights attached to both engines, the reranked hits and
    scores are the JAX engine's (f32, rtol = atol = 1e-5)."""
    import jax

    from semanticsearch_tpu.core.config import TrainConfig as JTrainCfg
    from semanticsearch_tpu.index.rerank_service import \
        RerankService as JService
    from semanticsearch_tpu.models.rerankers import make_model
    from semanticsearch_tpu.train.vocab import Preprocessor as JPre
    from semanticsearch_tpu_torch.core.config import TrainConfig
    from semanticsearch_tpu_torch.index.rerank_service import RerankService
    from semanticsearch_tpu_torch.models.convert import reranker_state_dict
    from semanticsearch_tpu_torch.train.vocab import Preprocessor as TPre

    jeng, teng, _ = engines
    with pytest.raises(ValueError, match="no reranker"):
        teng.search(QUERIES[:1], rerank_top=3)
    kw = dict(fixed_length_left=6, fixed_length_right=32, filter_low_freq=2)
    jpp, tpp = JPre(**kw).fit(teng.texts), TPre(**kw).fit(teng.texts)
    params = jax.tree.map(np.asarray, make_model(
        "knrm", vocab_size=jpp.vocab_size, embed_dim=8).init(
        jax.random.PRNGKey(4), np.ones((1, 6), np.int32),
        np.ones((1, 32), np.int32))["params"])
    jeng.reranker = JService("knrm", params, jpp,
                             cfg=JTrainCfg(model="knrm", embedding_dim=8))
    teng.reranker = RerankService(
        "knrm", reranker_state_dict("knrm", params), tpp,
        cfg=TrainConfig(model="knrm", embedding_dim=8), device="cpu")
    try:
        want = jeng.search(QUERIES, k=5, rerank_top=8)
        got = teng.search(QUERIES, k=5, rerank_top=8)
    finally:
        jeng.reranker = teng.reranker = None
    for jq, tq in zip(want, got):
        assert [h.chunk_id for h in tq] == [h.chunk_id for h in jq]
        np.testing.assert_allclose([h.rerank_score for h in tq],
                                   [h.rerank_score for h in jq],
                                   rtol=1e-5, atol=1e-5)
