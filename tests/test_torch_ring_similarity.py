"""The port's ring-exchange similarity (``parallel/ring_similarity.py``)
against the JAX package's ring on its CPU mesh, and the chunking
pipeline's sequence-parallel route.

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
from semanticsearch_tpu.core.mesh import make_mesh as jmake_mesh
from semanticsearch_tpu.parallel import ring_similarity as jring
from semanticsearch_tpu_torch.core.mesh import MeshSpec, make_mesh
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


def _tiny_encoder():
    from semanticsearch_tpu_torch.core.config import EncoderConfig
    from semanticsearch_tpu_torch.models.encoder import SentenceEncoder

    return SentenceEncoder(EncoderConfig(
        vocab_size=1024, hidden_dim=32, num_layers=1, num_heads=2,
        mlp_dim=64, max_len=16, dtype="float32"), device="cpu")


def test_pipeline_sp_route_engages_on_mesh(tmp_path, monkeypatch):
    """Grouping on a 4-shard mesh with ``sp_min_sentences`` lowered: the
    long document's matrix comes through the ring (a spy counts it), the
    short one's through the batched Gram matrix, and the chunks equal the
    single-device pipeline's."""
    from semanticsearch_tpu_torch.chunking.pipeline import ChunkPipeline
    from semanticsearch_tpu_torch.core.config import get_named_config
    from semanticsearch_tpu_torch.data.tsv import read_tsv

    calls = []
    orig = tring.sharded_doc_similarity

    def spy(emb, mesh):
        calls.append(emb.shape[0])
        return orig(emb, mesh)

    monkeypatch.setattr(tring, "sharded_doc_similarity", spy)
    rng = np.random.default_rng(1)
    words = [f"w{i}" for i in range(30)]

    def doc(n):
        return " ".join(f"Topic{i // 16} "
                        + " ".join(rng.choice(words, size=4)) + "."
                        for i in range(n))

    tsv = tmp_path / "c.tsv"
    tsv.write_text("query_id\tquery_text\tdocument_id\tdocument\tlabel\n"
                   f"q1\tq\td1\t{doc(70)}\t1\n"
                   f"q1\tq\td2\t{doc(20)}\t0\n")
    cfg = get_named_config("semantic_grouping").override(
        chunking={"sp_min_sentences": 64, "collect_metadata": True})
    enc = _tiny_encoder()
    out_mesh, out_one = tmp_path / "mesh", tmp_path / "one"
    summary = ChunkPipeline(cfg, encoder=enc, mesh=tmesh(4)).run(
        str(tsv), str(out_mesh), write_chunk_map=True)
    assert summary["docs_chunked"] == 2 and summary["fallbacks"] == 0
    assert calls == [70]
    ChunkPipeline(cfg, encoder=enc, device="cpu").run(
        str(tsv), str(out_one), write_chunk_map=True)

    def chunk_map(out):
        return [(r["document_id"], r["chunk_id"], r["sent_indices"]) for r in
                read_tsv(str(out / f"{cfg.name}_chunk_map.tsv"))]

    assert chunk_map(out_mesh) == chunk_map(out_one)
    assert {d for d, _, _ in chunk_map(out_one)} == {"d1", "d2"}
