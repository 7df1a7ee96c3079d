"""The port's corpus-sharded exact top-k (``parallel/sharding.py``), the
sharded ``EmbeddingIndex`` / ``load_index`` and the column-sharded device
BM25 against the JAX package's on its 8-device CPU mesh.

The port's meshes repeat the CPU device (``make_mesh(..., devices=[cpu] *
n)``), the counterpart of the forced host device count. The same seeded
numpy inputs go through both; ids and their order (ties included) must be
equal, scores within 1e-6. JAX takes its reference scan or reaches its
kernels the way its own tests do (``use_pallas=True, interpret=True``); the
port always routes each shard through its kernels' wrappers, which run
their plain versions on the CPU.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semanticsearch_tpu.core.mesh import MeshSpec as JMeshSpec
from semanticsearch_tpu.core.mesh import hybrid_mesh as jhybrid_mesh
from semanticsearch_tpu.core.mesh import make_mesh as jmake_mesh
from semanticsearch_tpu.parallel import sharding as js
from semanticsearch_tpu_torch.core.mesh import (MeshSpec, hybrid_mesh,
                                                 local_mesh, make_mesh,
                                                 row_devices)
from semanticsearch_tpu_torch.parallel import sharding as ts

CPU = torch.device("cpu")
TOL = 1e-6


def tmesh(n: int):
    return make_mesh(MeshSpec(data=n), [CPU] * n)


def _unit(x):
    """Rows scaled to unit length (cosine scores, as the index holds)."""
    x = np.asarray(x, np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _jax_topk(mesh, corpus, queries, k, two_level=False, **kw):
    emb, valid = js.pad_to_shards(jnp.asarray(corpus), mesh)
    emb = js.shard_corpus(emb, mesh)
    fn = js.sharded_topk_2level if two_level else js.sharded_topk
    v, i = fn(jnp.asarray(queries), emb, mesh, k=k, valid_n=valid, **kw)
    return np.asarray(v), np.asarray(i)


# the JAX route options; the port picks each shard's route itself
JAX_ONLY = ("use_pallas", "impl", "interpret")


def _port_topk(mesh, corpus, queries, k, two_level=False, **kw):
    kw = {key: v for key, v in kw.items() if key not in JAX_ONLY}
    emb, valid = ts.pad_to_shards(torch.from_numpy(corpus), mesh)
    fn = ts.sharded_topk_2level if two_level else ts.sharded_topk
    v, i = fn(torch.from_numpy(queries), ts.shard_corpus(emb, mesh), mesh,
              k=k, valid_n=valid, **kw)
    return v.numpy(), i.numpy()


def _assert_same(got, want):
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=TOL)


ROUTES = {
    "ref": {},
    "twopass": dict(use_pallas=True, impl="twopass", interpret=True,
                    block_n=256),
}


def test_mesh_construction():
    m = make_mesh(MeshSpec(data=2, model=4), [CPU] * 8)
    assert m.shape == {"data": 2, "model": 4}
    assert m.axis_names == ("data", "model")
    assert m == make_mesh(MeshSpec(data=2, model=4), [CPU] * 8)
    assert hash(m) == hash(make_mesh(MeshSpec(data=2, model=4), [CPU] * 8))
    h = hybrid_mesh(2, [CPU] * 8)
    assert h.shape == {"dcn": 2, "data": 4}
    assert len(row_devices(h)) == 8 and len(row_devices(m)) == 2
    assert local_mesh("cpu").shape == {"data": 1, "model": 1}
    with pytest.raises(ValueError, match="does not cover"):
        make_mesh(MeshSpec(data=3), [CPU] * 8)
    with pytest.raises(ValueError, match="slices"):
        hybrid_mesh(3, [CPU] * 8)


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_sharded_topk_230_rows_8_shards(mesh8, route):
    rng = np.random.default_rng(0)
    corpus = _unit(rng.standard_normal((230, 128)))
    queries = _unit(rng.standard_normal((5, 128)))
    kw = ROUTES[route]
    _assert_same(_port_topk(tmesh(8), corpus, queries, 10, **kw),
                 _jax_topk(mesh8, corpus, queries, 10, **kw))


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_sharded_topk_ties_keep_jax_order(mesh8, route):
    """Integer rows with many duplicates: every tie resolves as JAX's
    per-shard selection and ``lax.top_k`` merge resolve it."""
    rng = np.random.default_rng(1)
    base = rng.integers(-2, 3, size=(12, 16)).astype(np.float32)
    corpus = base[rng.integers(0, 12, size=203)]
    queries = rng.integers(-1, 2, size=(4, 16)).astype(np.float32)
    kw = ROUTES[route]
    _assert_same(_port_topk(tmesh(8), corpus, queries, 9, **kw),
                 _jax_topk(mesh8, corpus, queries, 9, **kw))


def test_sharded_topk_wide_k_takes_chunked_route(mesh8, monkeypatch):
    """k_local >= 128 with few queries: each shard runs the column-chunked
    search, as the JAX shard does."""
    calls = []
    orig = ts.topk_scores_chunked

    def spy(q, c, k):
        calls.append(k)
        return orig(q, c, k)

    monkeypatch.setattr(ts, "topk_scores_chunked", spy)
    rng = np.random.default_rng(2)
    corpus = _unit(rng.standard_normal((8 * 300, 64)))
    queries = _unit(rng.standard_normal((3, 64)))
    kw = dict(use_pallas=True, impl="twopass", interpret=True)
    _assert_same(_port_topk(tmesh(8), corpus, queries, 130, **kw),
                 _jax_topk(mesh8, corpus, queries, 130, **kw))
    assert calls == [130] * 8


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_sharded_topk_negative_scores_with_padding(mesh8, route):
    """A query pointing away from every row: its true top-k is negative,
    where the zero pad rows (score 0) would win if they were not masked."""
    rng = np.random.default_rng(3)
    corpus = _unit(rng.standard_normal((357, 32)) + 2.0)
    queries = _unit(np.concatenate([rng.standard_normal((2, 32)),
                                    -corpus.sum(axis=0, keepdims=True)]))
    kw = ROUTES[route]
    got = _port_topk(tmesh(8), corpus, queries, 5, **kw)
    _assert_same(got, _jax_topk(mesh8, corpus, queries, 5, **kw))
    assert (got[1] < 357).all() and (got[0][2] < 0).all()


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_sharded_topk_2level_equals_flat(mesh8, route):
    """(dcn 2, data 4): the two-level merge equals JAX's and the port's
    flat merge bit for bit."""
    rng = np.random.default_rng(4)
    corpus = _unit(rng.standard_normal((777, 64)))
    queries = _unit(rng.standard_normal((3, 64)))
    kw = ROUTES[route]
    two = _port_topk(hybrid_mesh(2, [CPU] * 8), corpus, queries, 7,
                     two_level=True, **kw)
    _assert_same(two, _jax_topk(jhybrid_mesh(2), corpus, queries, 7,
                                two_level=True, **kw))
    flat = _port_topk(tmesh(8), corpus, queries, 7, **kw)
    np.testing.assert_array_equal(two[1], flat[1])
    np.testing.assert_array_equal(two[0], flat[0])


def test_sharded_topk_skewed_layout(mesh8):
    """Every top-k row on one shard: the merge carries that shard's whole
    candidate list over every other shard's."""
    rng = np.random.default_rng(5)
    skew = rng.standard_normal((64, 32)).astype(np.float32) * 0.01
    skew[:5] = _unit(rng.standard_normal((5, 32)) + 3.0)
    queries = _unit(rng.standard_normal((3, 32)) * 0.1 + 1.0)
    got = _port_topk(tmesh(8), skew, queries, 5)
    _assert_same(got, _jax_topk(mesh8, skew, queries, 5))
    assert (np.sort(got[1], axis=1) == np.arange(5)).all()


def test_sharded_topk_on_fewer_shards(mesh8):
    """A 4-shard mesh of the port against JAX's mesh of 4 of its devices."""
    rng = np.random.default_rng(6)
    corpus = _unit(rng.standard_normal((101, 32)))
    queries = _unit(rng.standard_normal((3, 32)))
    jm = jmake_mesh(JMeshSpec(data=4), devices=jax.devices("cpu")[:4])
    _assert_same(_port_topk(tmesh(4), corpus, queries, 5),
                 _jax_topk(jm, corpus, queries, 5))


def test_cached_swizzle_unaligned_shards(mesh8):
    """Each shard's own pass-A layout, shards not block-aligned, global pad
    rows against negative scores: equal to JAX's cached-swizzle search."""
    rng = np.random.default_rng(7)
    n, d, k, block_n = 357, 32, 5, 128
    corpus = _unit(rng.standard_normal((n, d)))
    queries = _unit(np.concatenate([rng.standard_normal((2, d)),
                                    -corpus.sum(axis=0, keepdims=True)]))
    kw = dict(use_pallas=True, impl="twopass", interpret=True,
              block_n=block_n)
    jemb, jvalid = js.pad_to_shards(jnp.asarray(corpus), mesh8)
    jemb = js.shard_corpus(jemb, mesh8)
    want = js.sharded_topk(
        jnp.asarray(queries), jemb, mesh8, k=k, valid_n=jvalid,
        corpus_swizzled_sharded=js.swizzle_corpus_sharded(jemb, mesh8,
                                                          block_n), **kw)
    m = tmesh(8)
    temb, tvalid = ts.pad_to_shards(torch.from_numpy(corpus), m)
    assert temb.shape[0] - tvalid < 8
    shards = ts.shard_corpus(temb, m)
    assert shards[0].shape[0] % block_n != 0
    swz = ts.swizzle_corpus_sharded(shards, m, block_n)
    assert all(s.shape[0] == block_n for s in swz)
    got = ts.sharded_topk(torch.from_numpy(queries), shards, m, k=k,
                          valid_n=tvalid, corpus_swizzled_sharded=swz,
                          block_n=block_n)
    _assert_same((got[0].numpy(), got[1].numpy()),
                 (np.asarray(want[0]), np.asarray(want[1])))


# ------------------------------------------------------------------ engine

def test_embedding_index_build_on_mesh(mesh8):
    from semanticsearch_tpu.index.engine import EmbeddingIndex as JIndex
    from semanticsearch_tpu_torch.index.engine import EmbeddingIndex

    rng = np.random.default_rng(8)
    emb = rng.standard_normal((123, 16)).astype(np.float32)
    q = _unit(rng.standard_normal((6, 16)))
    idx = EmbeddingIndex.build(emb, mesh=tmesh(8), device="cpu")
    assert len(idx._shards) == 8 and idx._corpus is None
    assert 8 * idx._shards[0].shape[0] - idx.size < 8
    want = JIndex.build(emb, mesh=mesh8)
    for k in (3, 10, 100):
        got, ref = idx.search(q, k=k), want.search(q, k=k)
        np.testing.assert_array_equal(got.indices, ref.indices)
        np.testing.assert_allclose(got.scores, ref.scores, rtol=0, atol=TOL)
    # a one-device mesh is the unsharded path
    single = EmbeddingIndex.build(emb, mesh=tmesh(1), device="cpu")
    assert single._shards is None
    np.testing.assert_array_equal(single.search(q, k=5).indices,
                                  idx.search(q, k=5).indices)


def _jax_index(tmp_path, n=150):
    """A JAX-built index directory (the JAX builder and encoder) and its
    encoder's weights converted for the port."""
    from semanticsearch_tpu.core.config import EncoderConfig as JCfg
    from semanticsearch_tpu.index.query_engine import (
        HybridQueryEngine as JEngine)
    from semanticsearch_tpu.models.encoder import SentenceEncoder as JEnc
    from semanticsearch_tpu_torch.core.config import EncoderConfig
    from semanticsearch_tpu_torch.data.tsv import write_tsv
    from semanticsearch_tpu_torch.models.convert import flax_to_state_dict
    from semanticsearch_tpu_torch.models.encoder import SentenceEncoder

    enc_kw = dict(vocab_size=500, hidden_dim=32, num_layers=1, num_heads=2,
                  mlp_dim=64, max_len=32, dtype="float32")
    rng = np.random.default_rng(9)
    words = [f"w{i}" for i in range(150)]
    p = 1.0 / np.arange(1, 151)
    p /= p.sum()
    docs = [" ".join(rng.choice(words, size=rng.integers(5, 20), p=p))
            for _ in range(n)]
    path = str(tmp_path / "chunks.tsv")
    write_tsv(path, [{"chunk_id": f"c{i}", "query_id": "",
                      "document_id": f"d{i}", "chunk_text": t}
                     for i, t in enumerate(docs)],
              ["chunk_id", "query_id", "document_id", "chunk_text"])
    jenc = JEnc(JCfg(**enc_kw), seed=2)
    JEngine.build(path, jenc, str(tmp_path / "idx"))
    tenc = SentenceEncoder(EncoderConfig(**enc_kw), device="cpu",
                           state_dict=flax_to_state_dict(jenc.params, 1))
    queries = [" ".join(docs[i].split()[:4]) for i in range(0, n, 13)]
    return str(tmp_path / "idx"), jenc, tenc, queries


def test_load_index_of_jax_index_on_mesh(tmp_path, mesh8):
    """Each shard's rows come from the memmap onto its device; the search
    equals JAX's ``load_index`` on its mesh."""
    from semanticsearch_tpu.index.builder import load_index as jload
    from semanticsearch_tpu_torch.index.builder import EMB_FILE, load_index

    idx_dir, jenc, tenc, queries = _jax_index(tmp_path)
    jidx, jids = jload(idx_dir, mesh=mesh8)
    tidx, tids = load_index(idx_dir, mesh=tmesh(8), device="cpu")
    assert tids == jids and tidx.size == 150
    rows = np.concatenate([s.float().numpy() for s in tidx._shards])
    f16 = np.load(f"{idx_dir}/{EMB_FILE}").astype(np.float32)
    want = f16 / np.maximum(np.linalg.norm(f16, axis=1, keepdims=True), 1e-9)
    # the index holds bfloat16 rows (IndexConfig's default dtype)
    np.testing.assert_allclose(rows[:150], want, rtol=0, atol=2.0 ** -8)
    assert rows.shape[0] == 152 and not rows[150:].any()
    q = tenc.encode(queries)
    for k in (5, 20):
        got, ref = tidx.search(q, k=k), jidx.search(q, k=k)
        np.testing.assert_array_equal(got.indices, ref.indices)
        np.testing.assert_allclose(got.scores, ref.scores, rtol=0, atol=TOL)


def _hits(result):
    return [[(h.chunk_id, h.dense_rank, h.lexical_rank) for h in q]
            for q in result]


def test_hybrid_engine_serve_device_on_mesh(tmp_path, mesh8):
    """``serve_device`` on a 4-shard mesh: the dense index and the device
    BM25 leg both sharded; hits equal the JAX engine's on its mesh, and the
    mesh survives ``compact``."""
    from semanticsearch_tpu.core.config import RankingConfig as JRank
    from semanticsearch_tpu.index.query_engine import (
        HybridQueryEngine as JEngine)
    from semanticsearch_tpu_torch.core.config import get_named_config
    from semanticsearch_tpu_torch.index.query_engine import (
        HybridQueryEngine)

    idx_dir, jenc, tenc, queries = _jax_index(tmp_path)
    jm = jmake_mesh(JMeshSpec(data=4), devices=jax.devices("cpu")[:4])
    jeng = JEngine.load(idx_dir, jenc, mesh=jm, rank_cfg=JRank(
        lexical_device=True, lexical_dense_terms=32))
    cfg = get_named_config("serve_device").ranking
    m = tmesh(4)
    teng = HybridQueryEngine.load(idx_dir, tenc, mesh=m, rank_cfg=
                                  dataclasses.replace(
                                      cfg, lexical_dense_terms=32))
    want = jeng.search(queries, k=5)
    got = teng.search(queries, k=5)
    assert _hits(got) == _hits(want)
    leg = teng._device_bm25
    assert leg is not None and leg.mesh is m and len(leg._CTs) == 4
    assert teng.index._mesh is m and len(teng.index._shards) == 4
    teng.add_documents(["c_new"], ["glacier fresh words"])
    teng.compact()
    assert teng.index._mesh is m and len(teng.index._shards) == 4
    assert teng.search(["glacier fresh words"], k=1)[0][0].chunk_id == \
        "c_new"


@pytest.mark.parametrize("residual,weights",
                         [(True, "bf16"), (False, "bf16"), (True, "int8")])
def test_device_bm25_column_sharded_equals_unsharded(residual, weights):
    """Every list and score of the 4-way column-sharded leg equals the
    unsharded leg's and the host top-k's, bit for bit."""
    from semanticsearch_tpu_torch.index.bm25 import BM25Okapi
    from semanticsearch_tpu_torch.index.bm25_tpu import DeviceBM25

    rng = np.random.default_rng(10)
    words = [f"w{i}" for i in range(300)]
    p = 1.0 / np.arange(1, 301) ** 1.1
    p /= p.sum()
    docs = [list(rng.choice(words, size=rng.integers(5, 30), p=p))
            for _ in range(1000)]
    bm = BM25Okapi(docs)
    qs = [list(rng.choice(words, size=rng.integers(2, 6), p=p))
          for _ in range(40)]
    kw = dict(n_dense_terms=64, topk_device=32, residual=residual,
              weights=weights, device="cpu", score_chunk_cols=256,
              query_chunk=16)
    one = DeviceBM25(bm, **kw)
    four = DeviceBM25(bm, mesh=tmesh(4), **kw)
    assert [c.shape[0] for c in four._CTs] == [256] * 4
    a, b = one.get_topk_batch(qs, 10), four.get_topk_batch(qs, 10)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
    host = bm.get_topk_batch(qs, 10)
    np.testing.assert_array_equal(b[0], host[0])
    np.testing.assert_array_equal(b[1], host[1])
