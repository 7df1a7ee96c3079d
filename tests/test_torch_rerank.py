"""The port's rerank stage against the JAX package's, on the CPU.

``RerankService`` packs pairs on the same three-rung block ladder; an
engine loaded with ``reranker_dir`` over a JAX-built index and a
JAX-trained reranker checkpoint answers ``search(rerank_top=N)``,
``search_pipelined`` and ``tune_rerank_blend`` as the JAX engine does.

Tolerance: f32 on both sides, so reranker scores agree to rtol = atol =
1e-5 (summation order only). Hits must come in the JAX order, except that
two hits whose rerank scores lie within that tolerance may swap (a stable
sort of near-ties)."""
import os
import shutil

import jax
import numpy as np
import pytest
from test_query_engine import TINY, _chunks, _train_tiny_reranker

from semanticsearch_tpu.core.config import IndexConfig as JIndexCfg
from semanticsearch_tpu.core.config import TrainConfig as JTrainCfg
from semanticsearch_tpu.data.tsv import read_tsv
from semanticsearch_tpu.index.query_engine import HybridQueryEngine as JEngine
from semanticsearch_tpu.index.rerank_service import \
    RerankService as JService
from semanticsearch_tpu.models.encoder import SentenceEncoder as JEncoder
from semanticsearch_tpu.models.rerankers import make_model as j_make
from semanticsearch_tpu.train.vocab import Preprocessor as JPre
from semanticsearch_tpu_torch.core.config import EncoderConfig as TCfg
from semanticsearch_tpu_torch.core.config import IndexConfig as TIndexCfg
from semanticsearch_tpu_torch.core.config import TrainConfig
from semanticsearch_tpu_torch.index.query_engine import \
    HybridQueryEngine as TEngine
from semanticsearch_tpu_torch.index.rerank_service import (
    SCORE_BATCH, SCORE_BATCH_LARGE, SCORE_BATCH_MID, RerankService,
    _block_size)
from semanticsearch_tpu_torch.models.convert import (flax_to_state_dict,
                                                     reranker_state_dict)
from semanticsearch_tpu_torch.models.encoder import SentenceEncoder as TEncoder
from semanticsearch_tpu_torch.train.vocab import Preprocessor as TPre

TOL = 1e-5
QUERIES = ["fishing quota trawlers", "bees and honey", "solar electricity",
           "roman water city", "zzz unmatched"]
IDX = dict(block_rows=256, seg_split=2, dtype="float32")


def test_score_pairs_block_ladder_consistency():
    """The counterpart of the JAX test of the same name: one LARGE, one
    MID, one SMALL and a padded SMALL block score each row as 200-pair
    calls do, and as the JAX service does."""
    words = [f"w{i}" for i in range(50)]
    texts = [" ".join(words[i % 40: i % 40 + 5]) for i in range(60)]
    kw = dict(fixed_length_left=8, fixed_length_right=24, filter_low_freq=1)
    jpp, tpp = JPre(**kw).fit(texts), TPre(**kw).fit(texts)
    model = j_make("knrm", vocab_size=jpp.vocab_size, embed_dim=16)
    params = jax.tree.map(np.asarray, model.init(
        jax.random.PRNGKey(0), np.zeros((2, 8), np.int32),
        np.zeros((2, 24), np.int32))["params"])
    jsvc = JService("knrm", params, jpp,
                    cfg=JTrainCfg(model="knrm", embedding_dim=16))
    svc = RerankService("knrm", reranker_state_dict("knrm", params), tpp,
                        cfg=TrainConfig(model="knrm", embedding_dim=16),
                        device="cpu")
    assert svc._wire_dtype == np.int16
    n = SCORE_BATCH_LARGE + SCORE_BATCH_MID + SCORE_BATCH + 44
    assert [_block_size(r) for r in (n, n - SCORE_BATCH_LARGE, 300)] == [
        SCORE_BATCH_LARGE, SCORE_BATCH_MID, SCORE_BATCH]
    qs = [texts[i % len(texts)] for i in range(n)]
    cs = [texts[(i * 7 + 3) % len(texts)] for i in range(n)]
    whole = svc.score_pairs(qs, cs)
    assert whole.shape == (n,) and whole.dtype == np.float32
    parts = np.concatenate([svc.score_pairs(qs[s: s + 200], cs[s: s + 200])
                            for s in range(0, n, 200)])
    np.testing.assert_allclose(whole, parts, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(whole, jsvc.score_pairs(qs, cs), rtol=TOL,
                               atol=TOL)
    assert svc.score_pairs([], []).shape == (0,)
    with pytest.raises(ValueError):
        svc.score_pairs(qs[:2], cs[:3])


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """A JAX-built index over the six-chunk corpus, a KNRM reranker the
    JAX trainer wrote (its checkpoint layout as saved here), and the JAX
    and port engines loaded on both."""
    tmp = tmp_path_factory.mktemp("rerank")
    chunks = _chunks(tmp)
    jenc = JEncoder(TINY, seed=0)
    idx = str(tmp / "idx")
    JEngine.build(chunks, jenc, idx, index_cfg=JIndexCfg(**IDX))
    corpus_texts = [r["chunk_text"] for r in read_tsv(chunks)]
    _train_tiny_reranker(tmp / "ckpt", corpus_texts)
    ckpt = str(tmp / "ckpt")
    tenc = TEncoder(TCfg(**{f: getattr(TINY, f) for f in (
        "vocab_size", "hidden_dim", "num_layers", "num_heads", "mlp_dim",
        "max_len", "dtype")}), device="cpu",
        state_dict=flax_to_state_dict(jenc.params, TINY.num_layers))
    jeng = JEngine.load(idx, jenc, index_cfg=JIndexCfg(**IDX),
                        reranker_dir=ckpt)
    teng = TEngine.load(idx, tenc, index_cfg=TIndexCfg(**IDX),
                        reranker_dir=ckpt, device="cpu")
    return {"jenc": jenc, "tenc": tenc, "idx": idx, "ckpt": ckpt,
            "jeng": jeng, "teng": teng, "texts": corpus_texts}


def _assert_same_reranked(j_hits, t_hits):
    assert len(j_hits) == len(t_hits)
    for jq, tq in zip(j_hits, t_hits):
        assert len(jq) == len(tq)
        for jh, th in zip(jq, tq):
            if (jh.rerank_score is None) != (th.rerank_score is None):
                raise AssertionError("rerank_score set on one side only")
            if jh.chunk_id != th.chunk_id:
                # only near-tied rerank scores may swap places
                assert jh.rerank_score is not None
                assert abs(jh.rerank_score - th.rerank_score) <= TOL * (
                    1 + abs(jh.rerank_score))
                continue
            assert (th.dense_rank, th.lexical_rank) == (jh.dense_rank,
                                                        jh.lexical_rank)
            assert abs(th.score - jh.score) <= 1e-9
            if jh.rerank_score is not None:
                np.testing.assert_allclose(th.rerank_score, jh.rerank_score,
                                           rtol=TOL, atol=TOL)


def test_service_load_scores_as_jax(setup):
    jsvc = JService.load(setup["ckpt"])
    svc = RerankService.load(setup["ckpt"], device="cpu")
    assert svc.model_name == jsvc.model_name == "knrm"
    assert svc.pp.vocab == jsvc.pp.vocab
    qs = [q for q in QUERIES for _ in setup["texts"]]
    cs = setup["texts"] * len(QUERIES)
    want = jsvc.score_pairs(qs, cs)
    np.testing.assert_allclose(svc.score_pairs(qs, cs), want, rtol=TOL,
                               atol=TOL)
    assert np.ptp(want) > 0  # a trained model, not a constant


@pytest.mark.parametrize("k,rerank_top", [(6, 4), (6, 100), (3, 6)])
def test_search_with_rerank_matches_jax(setup, k, rerank_top):
    jeng, teng = setup["jeng"], setup["teng"]
    want = jeng.search(QUERIES, k=k, rerank_top=rerank_top)
    got = teng.search(QUERIES, k=k, rerank_top=rerank_top)
    _assert_same_reranked(want, got)
    plain = teng.search(QUERIES, k=max(k, rerank_top))
    for hits, base in zip(got, plain):
        n_head = min(rerank_top, len(base))
        shown = min(n_head, k)
        # the head comes from the fused head's set, the tail keeps the
        # fused order
        head_ids = {h.chunk_id for h in hits[:shown]}
        assert head_ids <= {h.chunk_id for h in base[:n_head]}
        assert len(head_ids) == shown
        assert [h.chunk_id for h in hits[shown:]] == [
            h.chunk_id for h in base[n_head:k]]
        assert all(h.rerank_score is not None for h in hits[:shown])
        assert all(h.rerank_score is None for h in hits[shown:])
        head = [h.rerank_score for h in hits[:shown]]
        assert head == sorted(head, reverse=True)


def test_search_pipelined_with_rerank_matches_jax(setup):
    batches = [QUERIES[:2], [], QUERIES[2:]]
    want = setup["jeng"].search_pipelined(batches, k=5, rerank_top=4)
    got = setup["teng"].search_pipelined(batches, k=5, rerank_top=4)
    assert len(got) == len(want) == 3
    for w, g in zip(want, got):
        _assert_same_reranked(w, g)


def test_rerank_without_reranker_raises(setup):
    bare = TEngine.load(setup["idx"], setup["tenc"],
                        index_cfg=TIndexCfg(**IDX), device="cpu")
    with pytest.raises(ValueError, match="no reranker"):
        bare.search(QUERIES[:1], k=3, rerank_top=2)
    with pytest.raises(ValueError, match="reranker"):
        bare.tune_rerank_blend(QUERIES[:1], [["c1"]])
    assert bare.search(QUERIES[:1], k=3)[0][0].rerank_score is None


def test_persisted_rerank_blend_applies(setup, tmp_path):
    idx = str(tmp_path / "idx")
    shutil.copytree(setup["idx"], idx)
    with open(os.path.join(idx, "fusion.json"), "w") as f:
        f.write('{"fusion_alpha": 0.25, "rerank_blend": 0.375}')
    jeng = JEngine.load(idx, setup["jenc"], index_cfg=JIndexCfg(**IDX),
                        reranker_dir=setup["ckpt"])
    teng = TEngine.load(idx, setup["tenc"], index_cfg=TIndexCfg(**IDX),
                        reranker_dir=setup["ckpt"], device="cpu")
    assert teng.cfg.rerank_blend == jeng.cfg.rerank_blend == 0.375
    assert teng.cfg.fusion_alpha == 0.25
    _assert_same_reranked(jeng.search(QUERIES, k=6, rerank_top=5),
                          teng.search(QUERIES, k=6, rerank_top=5))


def test_tune_rerank_blend_matches_jax(setup):
    labels = [["c1"], ["c5"], ["c2"], ["c3", "c0"], ["nope"]]
    want = setup["jeng"].tune_rerank_blend(QUERIES, labels, rerank_top=4)
    got = setup["teng"].tune_rerank_blend(QUERIES, labels, rerank_top=4)
    assert got[0] == want[0]
    assert list(got[2]) == list(want[2])
    np.testing.assert_allclose(list(got[2].values()),
                               list(want[2].values()), rtol=0, atol=1e-12)
    grid = (0.0, 0.5, 1.0)
    assert list(setup["teng"].tune_rerank_blend(
        QUERIES, labels, rerank_top=3, grid=grid)[2]) == list(grid)
    with pytest.raises(ValueError):
        setup["teng"].tune_rerank_blend(QUERIES, labels[:2])
