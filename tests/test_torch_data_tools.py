"""The port's host data tools, profiler hooks and debug visuals against the
JAX package's.

``data/integrate.py`` over the Robust04-style fixture
(``tests/fixtures/robust04_sgml.py``), ``data/mapping.py`` and the
``data/analyze.py`` reports write byte-equal files and equal results in
both packages. ``core/profiling.py``'s ``StepTimer`` keeps the JAX timer's
summary, and ``trace`` writes a Chrome trace. ``chunking/visualize.py``
writes its three PNGs (matplotlib is installed here), and
``ChunkPipeline(debug_visuals_docs=N)`` exports them for N documents."""
import dataclasses
import json
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "fixtures"))

from robust04_sgml import write_fixture  # noqa: E402

from semanticsearch_tpu.chunking import visualize as jviz  # noqa: E402
from semanticsearch_tpu.core.profiling import StepTimer as JTimer  # noqa: E402
from semanticsearch_tpu.data import analyze as ja  # noqa: E402
from semanticsearch_tpu.data import integrate as ji  # noqa: E402
from semanticsearch_tpu.data import mapping as jm  # noqa: E402
from semanticsearch_tpu_torch.chunking import visualize as tviz  # noqa: E402
from semanticsearch_tpu_torch.core import profiling as tprof  # noqa: E402
from semanticsearch_tpu_torch.data import analyze as ta  # noqa: E402
from semanticsearch_tpu_torch.data import integrate as ti  # noqa: E402
from semanticsearch_tpu_torch.data import mapping as tm  # noqa: E402
from semanticsearch_tpu_torch.data.tsv import write_tsv  # noqa: E402


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def robust(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("robust04"))
    paths = write_fixture(root, n_distractors=12)
    out = {}
    for name, mod in (("jax", ji), ("port", ti)):
        out[name] = os.path.join(root, f"integrated_{name}.tsv")
        out[name + "_stats"] = mod.integrate_corpus(
            paths["qrels"], paths["topics"], paths["docs_dir"], out[name])
    return {**paths, **out}


def test_integrate_corpus_byte_equal(robust):
    assert _bytes(robust["port"]) == _bytes(robust["jax"])
    assert dataclasses.asdict(robust["port_stats"]) == dataclasses.asdict(
        robust["jax_stats"])
    assert robust["port_stats"].written == robust["expected_written"]
    assert ti.parse_topics(robust["topics"]) == ji.parse_topics(
        robust["topics"])
    assert ti.parse_topics(robust["topics"] + ".missing") == {}


@pytest.mark.parametrize("flags", [
    dict(dedup_by_pair=False), dict(dedup_content_within_query=False),
    dict(min_query_len=60, min_doc_len=400)])
def test_integrate_options_byte_equal(robust, tmp_path, flags):
    args = (robust["qrels"], robust["topics"], robust["docs_dir"])
    js = ji.integrate_corpus(*args, str(tmp_path / "j.tsv"), **flags)
    ts = ti.integrate_corpus(*args, str(tmp_path / "t.tsv"), **flags)
    assert _bytes(tmp_path / "t.tsv") == _bytes(tmp_path / "j.tsv")
    assert dataclasses.asdict(ts) == dataclasses.asdict(js)


def test_mapping_byte_equal(robust, tmp_path):
    assert tm.build_query_map(robust["port"]) == jm.build_query_map(
        robust["jax"])
    qids = sorted(tm.build_query_map(robust["port"]))
    rng = np.random.default_rng(3)
    chunks = tmp_path / "chunks.tsv"
    with open(chunks, "w") as f:
        f.write("query_id\tchunk_text\tlabel\n")
        for i in range(40):
            qid = qids[i % len(qids)] if i % 7 else "999"  # 999: unmapped
            text = " ".join(rng.choice(["alpha", "beta", "gamma"], 5))
            if i % 5 == 0:
                text = text.replace(" ", "\t", 2)  # the tab repair
            f.write(f"{qid}\t{text}\t{i % 2}\n")
        f.write("short\trow\n")
    outs = [mod.add_query_text_to_tsv(str(chunks), robust["port"],
                                      str(tmp_path / f"{name}.tsv"))
            for name, mod in (("j", jm), ("t", tm))]
    assert _bytes(outs[1]) == _bytes(outs[0])
    # the default output path
    assert tm.add_query_text_to_tsv(str(chunks), robust["port"]) == \
        str(tmp_path / "chunks_with_querytext.tsv")


def test_analyze_documents_byte_equal(robust, tmp_path):
    reports = []
    for name, mod in (("j", ja), ("t", ta)):
        rows = str(tmp_path / f"rows_{name}.tsv")
        rep = mod.analyze_documents(robust["port"], per_row_output=rows)
        mod.save_report(rep, str(tmp_path / f"rep_{name}.json"))
        reports.append(rep)
    assert reports[1] == reports[0]
    assert _bytes(tmp_path / "rows_t.tsv") == _bytes(tmp_path / "rows_j.tsv")
    assert _bytes(tmp_path / "rep_t.json") == _bytes(tmp_path / "rep_j.json")
    assert ta.analyze_documents(robust["port"], limit=5,
                                count_sentences=False) == \
        ja.analyze_documents(robust["port"], limit=5, count_sentences=False)


def test_analyze_chunks_and_compare_byte_equal(tmp_path):
    rng = np.random.default_rng(1)
    words = ["alpha", "beta", "gamma", "delta", "river", "stone", "dup"]
    paths = []
    for f in range(3):
        rows = [{"query_id": f"q{i % 3}", "document_id": f"d{i % 5}",
                 "chunk_text": ("dup text here." if i % 6 == 0 else
                                ". ".join(" ".join(rng.choice(words, 4))
                                          for _ in range(1 + i % 3)))}
                for i in range(20 + 5 * f)]
        p = str(tmp_path / f"c{f}.tsv")
        write_tsv(p, rows, ["query_id", "document_id", "chunk_text"])
        paths.append(p)
    j, t = ja.analyze_and_compare(paths), ta.analyze_and_compare(paths)
    assert t == j
    ja.save_report(j, str(tmp_path / "j.json"))
    ta.save_report(t, str(tmp_path / "t.json"))
    assert _bytes(tmp_path / "t.json") == _bytes(tmp_path / "j.json")
    assert ta.analyze_chunks(paths[0], limit=7) == ja.analyze_chunks(
        paths[0], limit=7)
    assert ta.compare_chunk_outputs(t["files"][:1]) == {}


def test_step_timer_summary_and_trace(tmp_path):
    jt, tt = JTimer(), tprof.StepTimer()
    for timer in (jt, tt):
        for name in ("encode", "encode", "search"):
            with timer.phase(name):
                pass
    js, ts = jt.summary(), tt.summary()
    assert set(ts) == set(js) == {"encode", "search"}
    for name in js:
        assert set(ts[name]) == set(js[name])
        assert ts[name]["count"] == js[name]["count"]
        assert ts[name]["mean_s"] == pytest.approx(
            ts[name]["total_s"] / ts[name]["count"])
    # CPU tensors, alone or nested, ask for no synchronize
    block = {"a": [torch.ones(2), (torch.zeros(1), 3)], "b": None}
    assert tprof._cuda_devices(block) == set()
    with tt.phase("fetch", block_on=block):
        pass
    assert tt.summary()["fetch"]["count"] == 1
    with pytest.raises(KeyError):  # an error inside still records the phase
        with tt.phase("fails"):
            raise KeyError("x")
    assert tt.summary()["fails"]["count"] == 1

    with tprof.trace(str(tmp_path / "prof")):
        torch.ones(8, 8) @ torch.ones(8, 8)
    with open(tmp_path / "prof" / "trace.json") as f:
        assert "traceEvents" in json.load(f)


def _topic_embeddings(rng, sizes, d=32, noise=0.05):
    out = []
    for s in sizes:
        center = rng.standard_normal(d)
        out.append(center / np.linalg.norm(center)
                   + noise * rng.standard_normal((s, d)))
    emb = np.concatenate(out)
    return (emb / np.linalg.norm(emb, axis=1, keepdims=True)).astype(
        np.float32)


def test_visual_exports(tmp_path):
    emb = _topic_embeddings(np.random.default_rng(0), [8, 8])
    groups = [list(range(8)), list(range(8, 16))]
    (tmp_path / "docV.bounds").write_text("4 8\n")
    paths = tviz.export_document_debug("docV", emb, groups,
                                       str(tmp_path / "viz"),
                                       bounds_dir=str(tmp_path),
                                       device="cpu")
    assert set(paths) == {"heatmap", "signals", "strip"}
    for key, p in paths.items():
        assert p is not None and os.path.getsize(p) > 0, key
        with open(p, "rb") as f:
            assert f.read(8) == b"\x89PNG\r\n\x1a\n", key
    assert np.array_equal(tviz.groups_to_labels(groups + [[99]], 16),
                          jviz.groups_to_labels(groups + [[99]], 16))
    for doc in ("docV", "missing"):
        assert tviz.load_ideal_bounds(str(tmp_path), doc) == \
            jviz.load_ideal_bounds(str(tmp_path), doc)
    (tmp_path / "bad.bounds").write_text("3 x")
    assert tviz.load_ideal_bounds(str(tmp_path), "bad") is None


def test_pipeline_debug_visuals(tmp_path):
    from semanticsearch_tpu_torch.chunking.pipeline import ChunkPipeline
    from semanticsearch_tpu_torch.core.config import (EncoderConfig,
                                                      get_named_config)
    from semanticsearch_tpu_torch.models.encoder import SentenceEncoder

    rng = np.random.default_rng(2)
    words = [f"w{i}" for i in range(30)]
    rows = [{"query_id": "q", "query_text": "q", "document_id": f"d{d}",
             "document": " ".join(
                 f"Topic{s // 4} " + " ".join(rng.choice(words, 5)) + "."
                 for s in range(12)), "label": "1"}
            for d in range(3)]
    tsv = str(tmp_path / "corpus.tsv")
    write_tsv(tsv, rows, ["query_id", "query_text", "document_id",
                          "document", "label"])
    enc = SentenceEncoder(EncoderConfig(vocab_size=200, hidden_dim=16,
                                        num_layers=1, num_heads=2,
                                        mlp_dim=32, max_len=32),
                          device="cpu")
    viz = tmp_path / "viz"
    # the chunks' metadata carries the sentence groups the strips draw
    cfg = get_named_config("semantic_splitter").override(
        chunking={"collect_metadata": True})
    plain = ChunkPipeline(cfg, encoder=enc).run(tsv, str(tmp_path / "a"))
    summary = ChunkPipeline(cfg, encoder=enc, debug_visuals_docs=2,
                            debug_visuals_dir=str(viz)).run(
        tsv, str(tmp_path / "b"))
    assert sorted(os.listdir(viz)) == sorted(
        f"d{d}_{kind}.png" for d in (0, 1)
        for kind in ("heatmap", "signals", "strip"))
    # the visuals change no chunk
    assert _bytes(summary["output_path"]) == _bytes(plain["output_path"])
