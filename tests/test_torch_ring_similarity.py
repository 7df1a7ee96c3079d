"""The port's ring-exchange similarity (``parallel/ring_similarity.py``)
against the JAX package's ring on its CPU mesh, and the chunking
pipeline's sequence-parallel route, on ("data", "model") meshes and on
hybrid ("dcn", "data") ones, where the ring runs over ``data`` inside one
``dcn`` slice.

The port's meshes repeat the CPU device; the same seeded numpy embeddings
go through both rings; the matrices agree within 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from semanticsearch_tpu.core.mesh import MeshSpec as JMeshSpec
from semanticsearch_tpu.core.mesh import hybrid_mesh as jhybrid_mesh
from semanticsearch_tpu.core.mesh import make_mesh as jmake_mesh
from semanticsearch_tpu.parallel import ring_similarity as jring
from semanticsearch_tpu_torch.core.mesh import MeshSpec, hybrid_mesh, make_mesh
from semanticsearch_tpu_torch.parallel import ring_similarity as tring
from semanticsearch_tpu_torch.parallel.sharding import shard_corpus

CPU = torch.device("cpu")
TOL = 1e-6


def tmesh(n: int):
    return make_mesh(MeshSpec(data=n), [CPU] * n)


def jmesh(n: int):
    return jmake_mesh(JMeshSpec(data=n), devices=jax.devices("cpu")[:n])


def _unit_rows(rng, n, d=32):
    emb = rng.standard_normal((n, d)).astype(np.float32)
    return emb / np.linalg.norm(emb, axis=1, keepdims=True)


def _jax_ring(emb, n_dev):
    mesh = jmesh(n_dev)
    sharded = jax.device_put(jnp.asarray(emb),
                             NamedSharding(mesh, P("data", None)))
    return np.asarray(jring.ring_similarity_matrix(sharded, mesh))


def _port_ring(emb, n_dev):
    mesh = tmesh(n_dev)
    rows = tring.ring_similarity_matrix(
        shard_corpus(torch.from_numpy(emb), mesh), mesh)
    assert len(rows) == n_dev
    return torch.cat(rows).numpy()


@pytest.mark.parametrize("n_dev", [1, 2, 4, 8])
def test_ring_matches_jax_ring_at_every_device_count(n_dev):
    rng = np.random.default_rng(n_dev)
    emb = _unit_rows(rng, n_dev * 6)
    got = _port_ring(emb, n_dev)
    np.testing.assert_allclose(got, _jax_ring(emb, n_dev), rtol=0, atol=TOL)
    np.testing.assert_allclose(got, emb @ emb.T, rtol=0, atol=TOL)


def test_ring_rowblocks_match_per_tile():
    """Each (local x block) tile is one product of the same operands."""
    rng = np.random.default_rng(0)
    n_local = 4
    emb = _unit_rows(rng, 8 * n_local)
    S = _port_ring(emb, 8)
    for i in range(8):
        for j in range(8):
            a = emb[i * n_local: (i + 1) * n_local]
            b = emb[j * n_local: (j + 1) * n_local]
            np.testing.assert_allclose(
                S[i * n_local: (i + 1) * n_local,
                  j * n_local: (j + 1) * n_local], a @ b.T, rtol=0, atol=TOL)


@pytest.mark.parametrize("n", [1, 3, 5, 17, 63, 65, 203])
def test_sharded_doc_similarity_nondivisible_counts(mesh8, n):
    """Padded to the device count and cropped back, equal to JAX's."""
    rng = np.random.default_rng(n)
    emb = _unit_rows(rng, n)
    got = tring.sharded_doc_similarity(emb, tmesh(8))
    assert got.shape == (n, n) and got.dtype == np.float32
    np.testing.assert_allclose(got, jring.sharded_doc_similarity(emb, mesh8),
                               rtol=0, atol=TOL)


def test_sharded_doc_similarity_degenerate_rows(mesh8):
    """Identical rows and a zero row: the pad never leaks into the crop."""
    emb = np.ones((10, 16), np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    emb[7] = 0.0
    got = tring.sharded_doc_similarity(emb, tmesh(8))
    assert got.shape == (10, 10)
    np.testing.assert_allclose(got, jring.sharded_doc_similarity(emb, mesh8),
                               rtol=0, atol=TOL)
    assert np.all(got[7] == 0.0) and np.all(got[:, 7] == 0.0)


def test_ring_takes_device_tensors_of_a_model_axis_mesh():
    """A (data 2, model 2) mesh rings over ``data``; bf16 input widens."""
    rng = np.random.default_rng(3)
    emb = _unit_rows(rng, 12)
    mesh = make_mesh(MeshSpec(data=2, model=2), [CPU] * 4)
    got = tring.sharded_doc_similarity(
        torch.from_numpy(emb).to(torch.bfloat16), mesh)
    e16 = torch.from_numpy(emb).to(torch.bfloat16).float().numpy()
    np.testing.assert_allclose(got, e16 @ e16.T, rtol=0, atol=TOL)


@pytest.mark.parametrize("n", [16, 17, 203])
def test_sharded_doc_similarity_on_a_hybrid_mesh_matches_jax(n):
    """(dcn 2, data 4): the ring runs over ``data`` in one slice; at n
    divisible by the data size and not, equal to JAX's replicated
    ``shard_map`` on its own hybrid mesh and to E·Eᵀ."""
    rng = np.random.default_rng(100 + n)
    emb = _unit_rows(rng, n)
    got = tring.sharded_doc_similarity(emb, hybrid_mesh(2, [CPU] * 8))
    want = jring.sharded_doc_similarity(emb, jhybrid_mesh(2))
    assert got.shape == (n, n)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    np.testing.assert_allclose(got, emb @ emb.T, rtol=0, atol=TOL)


@pytest.mark.parametrize("n_slices,n_dev", [(2, 8), (4, 8), (2, 4)])
def test_ring_rowblocks_on_a_hybrid_mesh(n_slices, n_dev):
    """The ring's mesh is slice 0's ``data`` devices; its row blocks are
    the JAX ring's row blocks on the same hybrid mesh and E·Eᵀ's."""
    rng = np.random.default_rng(n_slices * n_dev)
    mesh = hybrid_mesh(n_slices, [CPU] * n_dev)
    data = n_dev // n_slices
    rmesh = tring.ring_mesh(mesh)
    assert rmesh.shape == {"data": data, "model": 1}
    assert rmesh.group is None
    emb = _unit_rows(rng, data * 5)
    rows = tring.ring_similarity_matrix(
        shard_corpus(torch.from_numpy(emb), rmesh), mesh)
    assert len(rows) == data and all(r.shape == (5, data * 5) for r in rows)
    got = torch.cat(rows).numpy()
    jmesh_ = jhybrid_mesh(n_slices, jax.devices("cpu")[:n_dev])
    want = np.asarray(jring.ring_similarity_matrix(jax.device_put(
        jnp.asarray(emb), NamedSharding(jmesh_, P("data", None))), jmesh_))
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    np.testing.assert_allclose(got, emb @ emb.T, rtol=0, atol=TOL)


def _tiny_encoder():
    from semanticsearch_tpu_torch.core.config import EncoderConfig
    from semanticsearch_tpu_torch.models.encoder import SentenceEncoder

    return SentenceEncoder(EncoderConfig(
        vocab_size=1024, hidden_dim=32, num_layers=1, num_heads=2,
        mlp_dim=64, max_len=16, dtype="float32"), device="cpu")


def _sp_doc(rng, n):
    words = [f"w{i}" for i in range(30)]
    return " ".join(f"Topic{i // 16} " + " ".join(rng.choice(words, size=4))
                    + "." for i in range(n))


def _sp_run(tmp_path, monkeypatch, enc, mesh, docs, tag):
    """Grouping with ``sp_min_sentences`` 64 through the port's pipeline on
    ``mesh`` (None: one device), a spy counting the ring's documents;
    returns (summary, chunk map, the ring's calls)."""
    from semanticsearch_tpu_torch.chunking.pipeline import ChunkPipeline
    from semanticsearch_tpu_torch.core.config import get_named_config

    calls = []
    orig = tring.sharded_doc_similarity

    def spy(emb, m):
        calls.append(emb.shape[0])
        return orig(emb, m)

    monkeypatch.setattr(tring, "sharded_doc_similarity", spy)
    tsv = tmp_path / "c.tsv"
    tsv.write_text("query_id\tquery_text\tdocument_id\tdocument\tlabel\n"
                   + "".join(f"q1\tq\td{i + 1}\t{d}\t{int(i == 0)}\n"
                             for i, d in enumerate(docs)))
    cfg = get_named_config("semantic_grouping").override(
        chunking={"sp_min_sentences": 64, "collect_metadata": True})
    kw = {"mesh": mesh} if mesh is not None else {"device": "cpu"}
    out = tmp_path / tag
    summary = ChunkPipeline(cfg, encoder=enc, **kw).run(
        str(tsv), str(out), write_chunk_map=True)
    monkeypatch.setattr(tring, "sharded_doc_similarity", orig)
    return summary, _chunk_map(out / f"{cfg.name}_chunk_map.tsv"), calls


def _chunk_map(path):
    from semanticsearch_tpu_torch.data.tsv import read_tsv

    return [(r["document_id"], r["chunk_id"], r["sent_indices"])
            for r in read_tsv(str(path))]


def test_pipeline_sp_route_engages_on_mesh(tmp_path, monkeypatch):
    """Grouping on a 4-shard mesh with ``sp_min_sentences`` lowered: the
    long document's matrix comes through the ring (a spy counts it), the
    short one's through the batched Gram matrix, and the chunks equal the
    single-device pipeline's."""
    rng = np.random.default_rng(1)
    docs = [_sp_doc(rng, 70), _sp_doc(rng, 20)]
    enc = _tiny_encoder()
    summary, mesh_map, calls = _sp_run(tmp_path, monkeypatch, enc, tmesh(4),
                                       docs, "mesh")
    assert summary["docs_chunked"] == 2 and summary["fallbacks"] == 0
    assert calls == [70]
    _, one_map, one_calls = _sp_run(tmp_path, monkeypatch, enc, None, docs,
                                    "one")
    assert one_calls == []
    assert mesh_map == one_map
    assert {d for d, _, _ in one_map} == {"d1", "d2"}


@pytest.mark.parametrize("n_slices,n_dev", [(2, 8), (2, 4)])
def test_pipeline_sp_route_on_a_hybrid_mesh_matches_jax(
        tmp_path, monkeypatch, n_slices, n_dev):
    """Grouping on a (dcn, data) mesh: the 70-sentence document goes
    through the ring (no ``ValueError`` for the ``dcn`` axis), and the
    chunk map equals the JAX pipeline's on a JAX hybrid mesh of as many
    devices and the single-device port's. Both pipelines embed with one
    set of converted weights."""
    from semanticsearch_tpu.chunking.pipeline import ChunkPipeline as JPipeline
    from semanticsearch_tpu.core.config import get_named_config as j_named
    from test_torch_chunk_pipeline import _topic_doc

    jenc, tenc = _converted_encoders()
    rng = np.random.default_rng(38)
    docs = [_topic_doc(rng, [20, 25, 25]), _topic_doc(rng, [9, 11])]
    summary, mesh_map, calls = _sp_run(
        tmp_path, monkeypatch, tenc, hybrid_mesh(n_slices, [CPU] * n_dev),
        docs, "hybrid")
    assert summary["docs_chunked"] == 2 and summary["fallbacks"] == 0
    assert calls == [70]
    _, one_map, _ = _sp_run(tmp_path, monkeypatch, tenc, None, docs, "one")
    cfg = j_named("semantic_grouping").override(
        chunking={"sp_min_sentences": 64, "collect_metadata": True})
    jcalls = []
    jorig = jring.sharded_doc_similarity

    def jspy(emb, m):
        jcalls.append(np.asarray(emb).shape[0])
        return jorig(emb, m)

    monkeypatch.setattr(jring, "sharded_doc_similarity", jspy)
    JPipeline(cfg, encoder=jenc,
              mesh=jhybrid_mesh(n_slices, jax.devices("cpu")[:n_dev])).run(
        str(tmp_path / "c.tsv"), str(tmp_path / "jax"), write_chunk_map=True)
    assert jcalls == [70]
    jax_map = _chunk_map(tmp_path / "jax" / f"{cfg.name}_chunk_map.tsv")
    assert mesh_map == jax_map == one_map
    assert len({c for d, c, _ in mesh_map if d == "d1"}) > 1


def _converted_encoders():
    """A JAX encoder and the port's from one ``model.init`` tree."""
    from semanticsearch_tpu.core.config import EncoderConfig as JEncoderConfig
    from semanticsearch_tpu.models.encoder import (
        SentenceEncoder as JEncoder, SentenceTransformerModel as JModel)
    from semanticsearch_tpu_torch.core.config import EncoderConfig
    from semanticsearch_tpu_torch.models.convert import flax_to_state_dict
    from semanticsearch_tpu_torch.models.encoder import SentenceEncoder
    from test_torch_chunk_pipeline import TINY

    cfg = JEncoderConfig(**TINY, attention="stock")
    params = jax.tree.map(np.asarray, JModel(cfg).init(
        jax.random.PRNGKey(5), jnp.zeros((1, 16), jnp.int32),
        jnp.ones((1, 16), jnp.int32))["params"])
    return (JEncoder(cfg, params=params),
            SentenceEncoder(EncoderConfig(**TINY, attention="stock"),
                            device="cpu", state_dict=flax_to_state_dict(
                                params, TINY["num_layers"])))
