"""A live index in the port against the JAX package: serve-time adds and
removals, compaction and its crash recovery, and ``tune_fusion``.

The JAX ``HybridQueryEngine`` builds one index directory (float32 encoder
and index); each test copies it, loads one copy in each package (the port's
encoder takes the converted weights, on the CPU) and applies the same
mutations to both. Hits must be identical: chunk ids, dense and lexical
ranks, RRF scores to 1e-9."""
import json
import os
import shutil

import numpy as np
import pytest
import torch

from semanticsearch_tpu.core.config import EncoderConfig as JCfg
from semanticsearch_tpu.core.config import IndexConfig as JIndexCfg
from semanticsearch_tpu.index import query_engine as jqe
from semanticsearch_tpu.index.delta import DeltaIndex as JDelta
from semanticsearch_tpu.models.encoder import SentenceEncoder as JEncoder
from semanticsearch_tpu_torch.core.config import EncoderConfig as TCfg
from semanticsearch_tpu_torch.core.config import IndexConfig as TIndexCfg
from semanticsearch_tpu_torch.data.tsv import read_tsv, write_tsv
from semanticsearch_tpu_torch.index import engine as tengine
from semanticsearch_tpu_torch.index import query_engine as tqe
from semanticsearch_tpu_torch.index.delta import DeltaIndex as TDelta
from semanticsearch_tpu_torch.models.convert import flax_to_state_dict
from semanticsearch_tpu_torch.models.encoder import SentenceEncoder as TEncoder

ENC = dict(vocab_size=1000, hidden_dim=32, num_layers=1, num_heads=2,
           mlp_dim=64, max_len=32, dtype="float32")
IDX = dict(block_rows=256, seg_split=2, dtype="float32")
N_TOPICS = 8
VOCABS = [[f"topic{t}word{j}" for j in range(6)] for t in range(N_TOPICS)]
COLS = ["chunk_id", "query_id", "document_id", "chunk_text"]


def _text(rng, t):
    return " ".join(rng.choice(VOCABS[t], size=8))


def _query(t):
    return " ".join(VOCABS[t][:3])


@pytest.fixture(scope="module")
def base(tmp_path_factory):
    """A 200-chunk index built by the JAX package, and both encoders."""
    rng = np.random.default_rng(11)
    tmp = tmp_path_factory.mktemp("live")
    rows = [{"chunk_id": f"c{i}", "query_id": f"q{i % 7}",
             "document_id": f"d{i // 2}", "chunk_text": _text(rng, i % N_TOPICS)}
            for i in range(200)]
    chunks = str(tmp / "chunks.tsv")
    write_tsv(chunks, rows, COLS)
    jenc = JEncoder(JCfg(**ENC), seed=3)
    jqe.HybridQueryEngine.build(chunks, jenc, str(tmp / "idx"),
                                index_cfg=JIndexCfg(**IDX))
    tenc = TEncoder(TCfg(**ENC), device="cpu",
                    state_dict=flax_to_state_dict(jenc.params,
                                                  ENC["num_layers"]))
    return str(tmp / "idx"), jenc, tenc


def _engines(base, tmp_path):
    idx, jenc, tenc = base
    jdir, tdir = str(tmp_path / "j"), str(tmp_path / "t")
    shutil.copytree(idx, jdir)
    shutil.copytree(idx, tdir)
    jeng = jqe.HybridQueryEngine.load(jdir, jenc, index_cfg=JIndexCfg(**IDX))
    teng = tqe.HybridQueryEngine.load(tdir, tenc, index_cfg=TIndexCfg(**IDX),
                                      device="cpu")
    return jeng, teng


def _assert_same_hits(j_hits, t_hits):
    assert len(j_hits) == len(t_hits)
    for jq, tq in zip(j_hits, t_hits):
        assert [h.chunk_id for h in tq] == [h.chunk_id for h in jq]
        assert [h.dense_rank for h in tq] == [h.dense_rank for h in jq]
        assert [h.lexical_rank for h in tq] == [h.lexical_rank for h in jq]
        np.testing.assert_allclose([h.score for h in tq],
                                   [h.score for h in jq], rtol=0, atol=1e-9)


def _both(jeng, teng, queries, **kw):
    want, got = jeng.search(queries, **kw), teng.search(queries, **kw)
    _assert_same_hits(want, got)
    return got


QUERIES = [_query(t) for t in range(N_TOPICS)] + [
    "glacier meltwater feeds mountain lake", "honey bees orchard"]
NEW = (["new0", "new1", "new2"],
       ["glacier meltwater feeds mountain lake",
        "honey bees pollinate the orchard flowers",
        " ".join(VOCABS[2][:4]) + " glacier"])


def test_add_documents_and_search_matches_jax(base, tmp_path):
    jeng, teng = _engines(base, tmp_path)
    pre = _both(jeng, teng, QUERIES[-2:], k=3)
    assert all(h.lexical_rank == 0 for h in pre[0])
    for eng in (jeng, teng):
        eng.add_documents(*NEW)
    assert len(teng.chunk_ids) == 203
    hits = _both(jeng, teng, QUERIES, k=5)
    assert hits[8][0].chunk_id == "new0" and hits[8][0].lexical_rank == 1
    d = _both(jeng, teng, QUERIES, k=5, hybrid=False)
    assert d[9][0].chunk_id == "new1"
    _both(jeng, teng, QUERIES, k=10, candidates=30)


def test_remove_and_compact_matches_jax(base, tmp_path):
    jeng, teng = _engines(base, tmp_path)
    top = _both(jeng, teng, QUERIES[:1], k=2)[0]
    victim = top[0].chunk_id
    assert teng.remove_documents([victim]) == jeng.remove_documents([victim])
    assert teng.remove_documents([victim]) == 0
    after = _both(jeng, teng, QUERIES, k=6)
    assert all(victim not in [h.chunk_id for h in q] and len(q) == 6
               for q in after)
    for eng in (jeng, teng):
        eng.add_documents(*NEW)
        eng.remove_documents(["c7", "new2"])
    _both(jeng, teng, QUERIES, k=6)
    _both(jeng, teng, QUERIES, k=6, hybrid=False)
    for eng in (jeng, teng):
        eng.compact()
    assert teng._delta is None and not teng._dead
    assert teng.index.size == jeng.index.size == 200 - 3 + 3
    assert teng.chunk_ids == jeng.chunk_ids
    _both(jeng, teng, QUERIES, k=6)
    tdir = str(tmp_path / "t")
    ids_rows = list(read_tsv(os.path.join(tdir, "ids.tsv")))
    assert ids_rows[1]["document_id"] == "d0" and ids_rows[-1]["query_id"] == ""
    assert [r["chunk_id"] for r in ids_rows] == [
        r["chunk_id"] for r in read_tsv(str(tmp_path / "j" / "ids.tsv"))]
    np.testing.assert_array_equal(
        np.load(os.path.join(tdir, "embeddings.f16.npy")),
        np.load(str(tmp_path / "j" / "embeddings.f16.npy")))
    reloaded = tqe.HybridQueryEngine.load(tdir, teng.encoder,
                                          index_cfg=TIndexCfg(**IDX),
                                          device="cpu")
    _assert_same_hits(jeng.search(QUERIES, k=6), reloaded.search(QUERIES, k=6))
    assert victim not in reloaded.chunk_ids and len(reloaded.texts) == 200


def test_randomized_delta_consistency_matches_jax(base, tmp_path):
    """Random add/remove/compact steps applied to both packages: the same
    hits after every step, and each topic's query surfaces a live document
    of that topic."""
    jeng, teng = _engines(base, tmp_path)
    rng = np.random.default_rng(3)
    live = {f"c{i}": i % N_TOPICS for i in range(200)}
    next_id = 0
    for step in range(6):
        op = rng.choice(["add", "remove", "compact"])
        if op == "add":
            t = int(rng.integers(N_TOPICS))
            cids = [f"n{next_id}", f"n{next_id + 1}"]
            next_id += 2
            texts = [_text(rng, t), _text(rng, t)]
            for eng in (jeng, teng):
                eng.add_documents(cids, texts)
            live.update({c: t for c in cids})
        elif op == "remove":
            cids = [str(c) for c in rng.choice(sorted(live), size=3,
                                               replace=False)]
            for c in cids:
                del live[c]
            assert teng.remove_documents(cids) == jeng.remove_documents(cids)
        else:
            for eng in (jeng, teng):
                eng.compact()
        hits = _both(jeng, teng, QUERIES[:N_TOPICS], k=4)
        for t, qh in enumerate(hits):
            assert live.get(qh[0].chunk_id) == t, (step, op, t)


def test_delta_index_growth_matches_jax(rng):
    d = 16
    jd, td = JDelta(dim=d, init_capacity=4), TDelta(dim=d, init_capacity=4,
                                                     device="cpu")
    for batch in (3, 4, 9, 70):  # capacity doublings and a 64-bucket past 64
        emb = rng.standard_normal((batch, d)).astype(np.float32)
        emb /= np.linalg.norm(emb, axis=1, keepdims=True)
        jd.add(emb)
        td.add(emb)
        q = rng.standard_normal((5, d)).astype(np.float32)
        for k in (4, 65):
            jv, ji = jd.search(q, k=k)
            tv, ti = td.search(torch.from_numpy(q), k=k)
            assert tv.shape == jv.shape and td.capacity == jd.capacity
            live = jv > -1e29
            np.testing.assert_array_equal(live, tv > -1e29)
            np.testing.assert_array_equal(ti[live], ji[live])
            np.testing.assert_allclose(tv, jv, rtol=1e-6, atol=1e-6)
    assert TDelta(dim=d, device="cpu").search(np.zeros((2, d)), 5)[0].shape \
        == (2, 0)


def test_delta_bm25_matches_jax(base, tmp_path):
    jeng, teng = _engines(base, tmp_path)
    for eng in (jeng, teng):
        eng.add_documents(*NEW)
        eng.add_documents(["new3"], ["neverseen topic1word2 topic1word2"])
    toks = [q.lower().split() for q in QUERIES + ["neverseen glacier"]]
    np.testing.assert_array_equal(teng._delta_bm25.score(toks),
                                  jeng._delta_bm25.score(toks))


def _stage_crash(eng, tmp_path, monkeypatch, renames_before_crash):
    """Run compact and kill it after the journal and
    ``renames_before_crash`` artifact renames (None: before the journal)."""
    calls = []
    real = os.replace

    def crashing_replace(src, dst):
        if src.endswith(tqe.COMMIT_JOURNAL + ".tmp"):
            if renames_before_crash is None:
                raise KeyboardInterrupt("crash before the commit point")
        elif len(calls) >= renames_before_crash:
            raise KeyboardInterrupt("crash mid-rename")
        else:
            calls.append(dst)
        real(src, dst)

    monkeypatch.setattr(tqe.os, "replace", crashing_replace)
    with pytest.raises(KeyboardInterrupt):
        eng.compact()
    monkeypatch.undo()


@pytest.mark.parametrize("renames,outcome", [(None, "rolled_back"),
                                              (2, "rolled_forward")])
def test_crash_recovery_matches_jax(base, tmp_path, monkeypatch, renames,
                                    outcome):
    """A compact killed before its commit point rolls back to the old
    index; one killed mid-rename rolls forward to the new one. The port's
    load and the JAX package's recovery agree on both."""
    jeng, teng = _engines(base, tmp_path)
    for eng in (jeng, teng):
        eng.add_documents(*NEW)
        eng.remove_documents(["c3"])
    tdir = str(tmp_path / "t")
    _stage_crash(teng, tmp_path, monkeypatch, renames)
    assert os.path.exists(os.path.join(tdir, tqe.COMMIT_JOURNAL)) == (
        renames is not None)
    crashed = str(tmp_path / "crashed")
    shutil.copytree(tdir, crashed)
    assert jqe.recover_staged_commit(crashed) == outcome
    reloaded = tqe.HybridQueryEngine.load(tdir, teng.encoder,
                                          index_cfg=TIndexCfg(**IDX),
                                          device="cpu")
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(crashed))
    assert tqe.recover_staged_commit(tdir) is None
    if outcome == "rolled_forward":
        jeng.compact()
        assert reloaded.chunk_ids == jeng.chunk_ids
        _assert_same_hits(jeng.search(QUERIES, k=5),
                          reloaded.search(QUERIES, k=5))
    else:
        fresh = jqe.HybridQueryEngine.load(str(base[0]), base[1],
                                           index_cfg=JIndexCfg(**IDX))
        assert reloaded.chunk_ids == fresh.chunk_ids
        _assert_same_hits(fresh.search(QUERIES, k=5),
                          reloaded.search(QUERIES, k=5))


def test_tune_fusion_matches_jax(base, tmp_path):
    jeng, teng = _engines(base, tmp_path)
    for eng in (jeng, teng):
        eng.add_documents(*NEW)
        eng.remove_documents(["c0", "c9"])
    queries = QUERIES + ["topic3word5 topic4word0", "bees flowers"]
    relevant = [[f"c{t}", f"c{t + 8}", f"c{t + 16}"] for t in range(N_TOPICS)]
    relevant += [["new0"], ["new1"], ["c3", "c4"], ["new1", "zzz"]]
    for kw in ({}, {"candidates": 30, "grid": (0.0, 0.3, 0.5, 0.9, 1.0)}):
        want = jeng.tune_fusion(queries, relevant, **kw)
        got = teng.tune_fusion(queries, relevant, **kw)
        assert got[0] == want[0] and got[1] == want[1]
        assert got[2] == want[2]
    with open(str(tmp_path / "t" / tqe.FUSION_FILE), "w") as f:
        json.dump({"fusion_alpha": got[0]}, f)
    tuned = tqe.HybridQueryEngine.load(str(tmp_path / "t"), teng.encoder,
                                       index_cfg=TIndexCfg(**IDX),
                                       device="cpu")
    assert tuned.cfg.fusion_alpha == got[0]


def test_tune_fusion_requires_bm25(base, tmp_path):
    _, teng = _engines(base, tmp_path)
    teng.bm25 = None
    with pytest.raises(ValueError, match="hybrid index"):
        teng.tune_fusion(["bees"], [["c5"]])
    with pytest.raises(ValueError, match="label rows"):
        teng.tune_fusion(["bees", "ants"], [["c5"]])


def test_fused_engine_path_matches_jax(base, tmp_path, monkeypatch):
    """k >= 128 with more queries than the engine's chunked-search limit
    (lowered here) runs the fused top-k; hits equal the JAX engine's, with
    tombstones adding their over-fetch."""
    jeng, teng = _engines(base, tmp_path)
    calls = []
    real = tengine.topk_scores_fused

    def spy(q, corpus, k, valid_n=-1):
        calls.append((q.shape[0], k))
        return real(q, corpus, k, valid_n=valid_n)

    monkeypatch.setattr(tengine, "CHUNKED_MAX_QUERIES", 4)
    monkeypatch.setattr(tengine, "topk_scores_fused", spy)
    queries = QUERIES * 2
    _both(jeng, teng, queries, k=40)  # depth 160
    for eng in (jeng, teng):
        eng.remove_documents(["c1", "c2"])
        eng.add_documents(*NEW)
    hits = _both(jeng, teng, queries, k=40, hybrid=False)
    assert calls == [(20, 160), (20, 200)]  # 160 + the 64-bucketed over-fetch
    assert all(len(q) == 40 for q in hits)
