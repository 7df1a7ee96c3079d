"""The chunking slice as a whole: one TSV through both ``ChunkPipeline``s.

Both pipelines embed with the same weights (the flax parameters converted by
``models/convert.py``), in float32 on the CPU, and must write the same chunk
ids and texts. The documents carry planted topics: every sentence of a topic
repeats the same five topic words and adds one filler word, which puts
same-topic similarities near 0.95 and cross-topic ones near 0.6. Cuts inside
a topic (the soft cap forces some) fall on small differences between filler
words, so the corpus seed is one whose cuts are all well separated, and the
margin is checked, not assumed: on this corpus the two encoders' embeddings
differ by less than 1e-6 per component, and every method's chunks stay the
same when every component is moved by noise of 1e-4, a hundred times
that."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semanticsearch_tpu.chunking.pipeline import ChunkPipeline as JPipeline
from semanticsearch_tpu.core.config import (
    EncoderConfig as JEncoderConfig, get_named_config as j_named)
from semanticsearch_tpu.models.encoder import (
    SentenceEncoder as JEncoder, SentenceTransformerModel as JModel)
from semanticsearch_tpu_torch.chunking import pipeline as tpipeline
from semanticsearch_tpu_torch.chunking import splitter as tsplitter
from semanticsearch_tpu_torch.chunking.pipeline import (
    ChunkPipeline as TPipeline)
from semanticsearch_tpu_torch.core.config import (
    EncoderConfig as TEncoderConfig, get_named_config as t_named)
from semanticsearch_tpu_torch.data.tsv import read_tsv, write_tsv
from semanticsearch_tpu_torch.models.convert import flax_to_state_dict
from semanticsearch_tpu_torch.models.encoder import SentenceEncoder as TEncoder
from semanticsearch_tpu_torch.ops._build import KernelError

TINY = dict(vocab_size=1024, hidden_dim=32, num_layers=1, num_heads=2,
            mlp_dim=64, max_len=16, dtype="float32")
COLUMNS = ["query_id", "query_text", "document_id", "document", "label"]


@pytest.fixture(scope="module")
def encoders():
    cfg = JEncoderConfig(**TINY, attention="stock")
    params = jax.tree.map(np.asarray, JModel(cfg).init(
        jax.random.PRNGKey(5), jnp.zeros((1, 16), jnp.int32),
        jnp.ones((1, 16), jnp.int32))["params"])
    jenc = JEncoder(cfg, params=params)
    tenc = TEncoder(TEncoderConfig(**TINY, attention="stock"), device="cpu",
                    state_dict=flax_to_state_dict(params, TINY["num_layers"]))
    return jenc, tenc


def _topic_doc(rng, sizes):
    """Sentences in planted topics: five words fixed per topic and one
    filler word per sentence, never the same twice in a document (two equal
    sentences would tie exactly, and a tie falls either way on the last bit
    of a sum)."""
    sents = []
    fillers = iter(rng.permutation(1000))
    for t, size in enumerate(sizes):
        topic = " ".join(f"t{t}x{j}{rng.integers(1000)}" for j in range(5))
        sents.extend(f"Topic {topic} f{next(fillers)}." for _ in range(size))
    return " ".join(sents)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    rng = np.random.default_rng(38)
    layouts = [[12, 9, 14], [20, 25], [7, 8, 6, 9], [30], [16, 16, 16, 12],
               [5, 4], [40, 38, 45], [1]]
    rows = [{"query_id": f"q{i // 3}", "query_text": f"query {i // 3}",
             "document_id": f"d{i}", "document": _topic_doc(rng, sizes),
             "label": str(i % 2)} for i, sizes in enumerate(layouts)]
    rows.append({"query_id": "q9", "query_text": "empty", "document_id": "d9",
                 "document": "", "label": "0"})
    path = tmp_path_factory.mktemp("corpus") / "corpus.tsv"
    write_tsv(str(path), rows, COLUMNS)
    return str(path), [sum(s) for s in layouts]


def _chunks(path):
    return [(r["query_id"], r["document_id"], r["chunk_text"], r["label"])
            for r in read_tsv(path)]


def _chunk_map(out_dir, name):
    return [(r["document_id"], r["chunk_id"], r["sent_indices"])
            for r in read_tsv(f"{out_dir}/{name}_chunk_map.tsv")]


@pytest.mark.parametrize("name", [
    "semantic_splitter", "semantic_splitter_dp", "semantic_splitter_union",
    "semantic_splitter_intersection", "semantic_grouping",
    "semantic_grouping_modularity", "text_splitter_char"])
def test_pipeline_writes_the_same_chunks_as_jax(tmp_path, encoders, corpus,
                                                name):
    jenc, tenc = encoders
    tsv, n_sents = corpus
    over = {"chunking": {"collect_metadata": True}}
    js = JPipeline(j_named(name).override(**over), encoder=jenc).run(
        tsv, str(tmp_path / "jax"), write_chunk_map=True)
    ts = TPipeline(t_named(name).override(**over), encoder=tenc).run(
        tsv, str(tmp_path / "torch"), write_chunk_map=True)
    assert _chunks(ts["output_path"]) == _chunks(js["output_path"])
    assert (_chunk_map(tmp_path / "torch", name)
            == _chunk_map(tmp_path / "jax", name))
    for key in ("config", "method", "rows_in", "docs_chunked", "chunks_out",
                "fallbacks", "avg_chunks_per_doc", "chunk_words"):
        assert ts[key] == js[key], key
    assert ts["rows_in"] == 9 and ts["docs_chunked"] == 8
    assert ts["fallbacks"] == 0 and ts["chunks_out"] > 8
    if name != "text_splitter_char":
        covered = {}
        for doc, _, idx in _chunk_map(tmp_path / "torch", name):
            covered.setdefault(doc, []).extend(int(x) for x in idx.split(","))
        assert ([sorted(covered[f"d{i}"]) for i in range(len(n_sents) - 1)]
                == [list(range(n)) for n in n_sents[:-1]])
    with open(tmp_path / "torch" / f"{name}_summary.json") as f:
        assert json.load(f)["chunks_out"] == ts["chunks_out"]


class _NoisyEncoder:
    """The encoder with every embedding component moved by N(0, 1e-4)."""

    def __init__(self, encoder) -> None:
        self.cfg, self.device, self._encoder = (
            encoder.cfg, encoder.device, encoder)
        self._gen = torch.Generator().manual_seed(3)

    def encode_device(self, texts, batch_size: int = 256):
        emb = self._encoder.encode_device(texts, batch_size)
        return emb + 1e-4 * torch.randn(emb.shape, generator=self._gen)


@pytest.mark.parametrize("name", [
    "semantic_splitter", "semantic_splitter_dp", "semantic_splitter_union",
    "semantic_splitter_intersection", "semantic_grouping",
    "semantic_grouping_modularity"])
def test_chunks_keep_a_wide_margin(tmp_path, encoders, corpus, name):
    jenc, tenc = encoders
    tsv, _ = corpus
    sents = [s for row in read_tsv(tsv)
             for s in tpipeline.extract_sentences(row["document"])]
    assert np.abs(tenc.encode(sents) - jenc.encode(sents)).max() < 1e-6
    cfg = t_named(name)
    clean = TPipeline(cfg, encoder=tenc).run(tsv, str(tmp_path / "clean"))
    noisy = TPipeline(cfg, encoder=_NoisyEncoder(tenc)).run(
        tsv, str(tmp_path / "noisy"))
    assert _chunks(noisy["output_path"]) == _chunks(clean["output_path"])


def test_pipeline_is_deterministic_and_lazy_about_its_encoder(tmp_path,
                                                              encoders,
                                                              corpus):
    _, tenc = encoders
    tsv, _ = corpus
    cfg = t_named("semantic_splitter")
    a = TPipeline(cfg, encoder=tenc).run(tsv, str(tmp_path / "a"))
    b = TPipeline(cfg, encoder=tenc).run(tsv, str(tmp_path / "b"), limit=3)
    with open(a["output_path"], "rb") as fa, open(b["output_path"], "rb") as fb:
        first, second = fa.read(), fb.read()
    assert first.startswith(second) and b["rows_in"] == 3
    char = TPipeline(t_named("text_splitter_char"), device="cpu")
    assert char.run(tsv, str(tmp_path / "c"))["chunks_out"] >= 8
    assert char.encoder is None


def test_per_document_route_without_precomputed_signals(tmp_path, encoders,
                                                        corpus):
    """``c99_use_local_rank`` skips the batched signals: every document
    computes its own similarity and local rank matrix. The local rank counts
    strict ``<`` between similarities of near-identical sentences, so here
    both pipelines get the very same embeddings (the JAX encoder's)."""
    jenc, tenc = encoders
    tsv, _ = corpus

    class SameEmbeddings:
        cfg, device = tenc.cfg, tenc.device

        def encode_device(self, texts, batch_size: int = 256):
            return torch.from_numpy(np.array(jenc.encode(texts)))

    over = {"chunking": {"c99_use_local_rank": True}}
    js = JPipeline(j_named("semantic_splitter").override(**over),
                   encoder=jenc).run(tsv, str(tmp_path / "jax"), limit=5)
    ts = TPipeline(t_named("semantic_splitter").override(**over),
                   encoder=SameEmbeddings()).run(tsv, str(tmp_path / "torch"),
                                                 limit=5)
    assert _chunks(ts["output_path"]) == _chunks(js["output_path"])


@pytest.mark.parametrize("error,raised", [
    (KernelError("nvcc failed"), True),
    (NotImplementedError("the similarity kernel takes float32"), True),
    (ValueError("a fault of this document"), False)])
def test_kernel_errors_are_raised_not_turned_into_fallback_chunks(
        monkeypatch, tmp_path, encoders, corpus, error, raised):
    """On the per-document route the similarity matrix is computed inside
    the pipeline's degrade-don't-die ``try``: a document's own failure
    becomes a whole-document fallback chunk, a kernel's does not."""
    _, tenc = encoders
    tsv, _ = corpus

    def failing(emb):
        raise error

    monkeypatch.setattr(tsplitter, "similarity_matrix", failing)
    pipe = TPipeline(t_named("semantic_splitter").override(
        chunking={"c99_use_local_rank": True}), encoder=tenc)
    if raised:
        with pytest.raises(type(error)):
            pipe.run(tsv, str(tmp_path), limit=3)
    else:
        summary = pipe.run(tsv, str(tmp_path), limit=3)
        assert summary["fallbacks"] == summary["docs_chunked"] > 0


def test_bucket_ladder_and_element_budget(monkeypatch, encoders):
    """One batched call per (bucket, sub-batch): buckets 8, 16, ..., and at
    most 2^26 // bucket^2 documents per call."""
    _, tenc = encoders
    calls = []

    def spy(embs, bucket, device):
        calls.append((bucket, len(embs)))
        return [(None, None)] * len(embs)

    monkeypatch.setattr(tpipeline, "batched_split_signals", spy)
    pipe = TPipeline(t_named("semantic_splitter"), encoder=tenc)
    lengths = [1, 2, 8, 9, 16, 17, 100, 128, 129, 3939, 4096, 2049, 4000,
               2500]
    embs = [None] + [torch.zeros((n, 4)) for n in lengths]
    out = [None] * len(embs)
    pipe._precompute_signals(embs, out, [None] * len(embs))
    assert calls == [(8, 2), (16, 2), (32, 1), (128, 2), (256, 1),
                     (4096, 4), (4096, 1)]
    assert out[0] is None and out[1] is None and out[2] == (None, None)


def test_unported_options_raise(encoders):
    _, tenc = encoders
    # a mesh is taken (the SP route, tests/test_torch_ring_similarity.py)
    from semanticsearch_tpu_torch.core.mesh import MeshSpec, make_mesh

    mesh = make_mesh(MeshSpec(data=2), [torch.device("cpu")] * 2)
    assert TPipeline(encoder=tenc, mesh=mesh).mesh is mesh
    # the debug visuals are ported (tests/test_torch_data_tools.py)
    assert TPipeline(encoder=tenc, debug_visuals_docs=1).debug_visuals_docs \
        == 1
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TPipeline(t_named("semantic_splitter"))._get_encoder()


def test_3939_sentence_doc_chunks_without_truncation(tmp_path, encoders):
    _, tenc = encoders
    n_sents = 3939  # the reference corpus maximum
    rng = np.random.default_rng(0)
    words = [f"w{i}" for i in range(50)]
    # a topic shift every 400 sentences gives the splitter real boundaries
    sents = [f"Topic{i // 400} " + " ".join(rng.choice(words, size=5)) + "."
             for i in range(n_sents)]
    tsv = tmp_path / "corpus.tsv"
    write_tsv(str(tsv), [{"query_id": "q1", "query_text": "long doc query",
                          "document_id": "d1", "document": " ".join(sents),
                          "label": "1"}], COLUMNS)
    cfg = t_named("semantic_splitter").override(
        chunking={"collect_metadata": True})
    summary = TPipeline(cfg, encoder=tenc).run(str(tsv), str(tmp_path),
                                               write_chunk_map=True)
    assert summary["docs_chunked"] == 1
    assert summary["fallbacks"] == 0
    assert summary["chunks_out"] > 1
    covered = []
    for _, _, idx in _chunk_map(tmp_path, cfg.name):
        covered.extend(int(x) for x in idx.split(","))
    assert sorted(covered) == list(range(n_sents))
