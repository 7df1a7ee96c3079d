"""The port's ``semsearch-torch`` CLI against the JAX package's
``semsearch``.

Each subcommand runs through both ``main`` functions (the port's with
``--device cpu``) on the same inputs. Where a subcommand embeds, both load
one encoder checkpoint the JAX ``save_encoder`` wrote (``--encoder-ckpt``),
because flax's and torch's random initialisations differ. Their JSON lines
on stdout, exit codes and output files are equal: byte for byte for text
files, hits and ranks exactly; timings (``elapsed_s``, ``chunks_per_sec``),
output paths and float32 products (embeddings, losses, rerank scores) are
the exceptions, each with its tolerance below. An index the JAX CLI built
is extended by the port's ``index-add`` and searched by the port's
``search`` with the JAX CLI's hits. The training and OIE subcommands are in
``tests/test_torch_cli_train.py``."""
import json
import os
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semanticsearch_tpu.cli.main import main as jmain
from semanticsearch_tpu.core.config import EncoderConfig as JCfg
from semanticsearch_tpu.models.encoder import SentenceEncoder as JEncoder
from semanticsearch_tpu.models.encoder import SentenceTransformerModel as JModel
from semanticsearch_tpu.train.encoder_train import load_encoder as jload
from semanticsearch_tpu.train.encoder_train import save_encoder as jsave
from semanticsearch_tpu_torch.cli.main import main as tmain_raw
from semanticsearch_tpu_torch.data.tsv import write_tsv

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "fixtures"))
from robust04_sgml import write_fixture  # noqa: E402
from test_torch_chunk_pipeline import TINY as CHUNK_TINY  # noqa: E402
from test_torch_chunk_pipeline import _topic_doc  # noqa: E402

ENC = dict(vocab_size=500, hidden_dim=32, num_layers=1, num_heads=2,
           mlp_dim=64, max_len=32, dtype="float32")
TIMING = ("elapsed_s", "chunks_per_sec", "output_path")
SCORE_TOL = 1e-5   # float32 products in each framework's own order

_TEXTS = [
    "solar panels convert sunlight into electricity",
    "the fishing quota for trawlers was reduced",
    "bees pollinate flowers and produce honey",
    "volcanic eruption spewed lava and ash across the island",
    "the ancient aqueduct carried water to the roman city",
    "high speed trains run between the two capital stations",
]


def tmain(argv):
    return tmain_raw(["--device", "cpu"] + list(argv))


def _run(main, argv, capsys):
    """(exit code, stdout) of one CLI call."""
    capsys.readouterr()
    rc = main(argv)
    return rc, capsys.readouterr().out


def _last_json(out):
    return json.loads(out.strip().splitlines()[-1])


def _both(argv_j, argv_t, capsys):
    """Run the JAX and the port CLI; return their (rc, stdout) pairs."""
    return _run(jmain, argv_j, capsys), _run(tmain, argv_t, capsys)


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def _files_equal(a, b, names):
    for name in names:
        assert _bytes(os.path.join(a, name)) == _bytes(os.path.join(b, name)), \
            name


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ckpt") / "enc")
    jsave(JEncoder(JCfg(**ENC), seed=7), path)
    return path


@pytest.fixture()
def chunks(tmp_path):
    p = str(tmp_path / "chunks.tsv")
    write_tsv(p, [{"chunk_id": f"c{i}", "chunk_text": t}
                  for i, t in enumerate(_TEXTS)],
              ["chunk_id", "chunk_text"])
    return p


@pytest.fixture()
def corpus(tmp_path):
    rng = np.random.default_rng(0)
    words = ("river water stone bridge solar energy market grain harvest "
             "city road train station honey bees forest").split()
    rows = [{"query_id": f"q{i % 3}", "query_text": f"query about {w}",
             "document_id": f"d{i}",
             "document": " ".join(
                 f"Topic{s // 3} " + " ".join(rng.choice(words, 6)) + "."
                 for s in range(9)),
             "label": str(i % 2)}
            for i, w in enumerate(words[:9])]
    p = str(tmp_path / "corpus.tsv")
    write_tsv(p, rows, ["query_id", "query_text", "document_id", "document",
                        "label"])
    return p


def test_chunk_char_equal(corpus, tmp_path, capsys):
    args = ["chunk", "-i", corpus, "--config", "text_splitter_char",
            "--limit", "7"]
    (rj, oj), (rt, ot) = _both(args + ["-o", str(tmp_path / "j")],
                               args + ["-o", str(tmp_path / "t")], capsys)
    assert rj == rt == 0
    sj, st = _last_json(oj), _last_json(ot)
    assert {k: v for k, v in st.items() if k not in TIMING} == \
        {k: v for k, v in sj.items() if k not in TIMING}
    assert sj["rows_in"] == 7 and sj["chunks_out"] >= 7
    assert sorted(os.listdir(tmp_path / "t")) == sorted(
        os.listdir(tmp_path / "j"))
    _files_equal(tmp_path / "j", tmp_path / "t",
                 ["text_splitter_char_chunks.tsv",
                  "text_splitter_char_eval.tsv"])


@pytest.fixture(scope="module")
def chunk_case(tmp_path_factory):
    """The planted-topic corpus and encoder of
    ``tests/test_torch_chunk_pipeline.py``, whose cuts sit far from ties,
    with the encoder saved by the JAX ``save_encoder``."""
    tmp = tmp_path_factory.mktemp("chunk")
    cfg = JCfg(**CHUNK_TINY, attention="stock")
    params = jax.tree.map(np.asarray, JModel(cfg).init(
        jax.random.PRNGKey(5), jnp.zeros((1, 16), jnp.int32),
        jnp.ones((1, 16), jnp.int32))["params"])
    jsave(JEncoder(cfg, params=params), str(tmp / "enc"))
    rng = np.random.default_rng(38)
    layouts = [[12, 9, 14], [20, 25], [7, 8, 6, 9], [30], [16, 16, 16, 12],
               [5, 4], [40, 38, 45], [1]]
    rows = [{"query_id": f"q{i // 3}", "query_text": f"query {i // 3}",
             "document_id": f"d{i}", "document": _topic_doc(rng, sizes),
             "label": str(i % 2)} for i, sizes in enumerate(layouts)]
    write_tsv(str(tmp / "corpus.tsv"), rows,
              ["query_id", "query_text", "document_id", "document", "label"])
    return str(tmp / "corpus.tsv"), str(tmp / "enc")


@pytest.mark.parametrize("config", ["semantic_splitter", "semantic_grouping"])
def test_chunk_semantic_equals_jax_pipeline(chunk_case, tmp_path, capsys,
                                            config):
    """``chunk --encoder-ckpt`` chunks with that encoder: the JAX
    ``ChunkPipeline`` given the same encoder writes the same files. (The
    JAX CLI's ``chunk`` accepts ``--encoder-ckpt`` but builds a random-init
    encoder, so its semantic output cannot be the reference.)"""
    from semanticsearch_tpu.chunking.pipeline import ChunkPipeline
    from semanticsearch_tpu.core.config import get_named_config

    tsv, enc = chunk_case
    rc, out = _run(tmain, ["chunk", "-i", tsv, "-o", str(tmp_path / "t"),
                           "--config", config, "--chunk-map",
                           "--encoder-ckpt", enc, "--set",
                           "chunking.collect_metadata=True"], capsys)
    assert rc == 0
    st = _last_json(out)
    sj = ChunkPipeline(
        get_named_config(config).override(
            chunking={"collect_metadata": True}),
        encoder=jload(enc)).run(tsv, str(tmp_path / "j"),
                                write_chunk_map=True)
    assert {k: v for k, v in st.items() if k not in TIMING} == \
        {k: v for k, v in sj.items() if k not in TIMING}
    assert st["chunks_out"] > 8 and st["fallbacks"] == 0
    _files_equal(tmp_path / "j", tmp_path / "t",
                 [f"{config}_{kind}.tsv" for kind in ("chunks", "eval",
                                                       "chunk_map")])


def test_validate_and_folds_equal(tmp_path, capsys):
    p = str(tmp_path / "labeled.tsv")
    write_tsv(p, [{"query_id": f"q{i % 3}", "chunk_text": f"text {i}",
                   "label": ["1", "0", "yes", "bad"][i % 4]}
                  for i in range(24)], ["query_id", "chunk_text", "label"])
    (rj, oj), (rt, ot) = _both(
        ["validate", "-i", p, "-o", str(tmp_path / "j.tsv")],
        ["validate", "-i", p, "-o", str(tmp_path / "t.tsv")], capsys)
    assert rj == rt == 0
    assert {k: v for k, v in _last_json(ot).items() if k != "output"} == \
        {k: v for k, v in _last_json(oj).items() if k != "output"}
    assert _bytes(tmp_path / "t.tsv") == _bytes(tmp_path / "j.tsv")
    (rj, oj), (rt, ot) = _both(
        ["folds", "-i", p, "-o", str(tmp_path / "cv"), "--num-folds", "3"],
        ["folds", "-i", p, "-o", str(tmp_path / "cv_t"), "--num-folds",
         "3"], capsys)
    assert rj == rt == 0
    fj, ft = _last_json(oj)["folds"], _last_json(ot)["folds"]
    assert len(ft) == len(fj) == 3
    for a, b in zip(fj, ft):
        for key in ("train", "test"):
            assert _bytes(b[key]) == _bytes(a[key])


def test_data_subcommands_equal(corpus, tmp_path, capsys):
    root = str(tmp_path / "robust")
    paths = write_fixture(root, n_distractors=8)
    outs = []
    for name, main in (("j", jmain), ("t", tmain)):
        rc, out = _run(main, ["integrate", "--qrels", paths["qrels"],
                              "--topics", paths["topics"], "--docs",
                              paths["docs_dir"], "--output",
                              str(tmp_path / f"int_{name}.tsv")], capsys)
        assert rc == 0
        outs.append(_last_json(out))
    assert outs[1] == outs[0]
    assert _bytes(tmp_path / "int_t.tsv") == _bytes(tmp_path / "int_j.tsv")

    integrated = str(tmp_path / "int_j.tsv")
    for argv in (["analyze", "documents", "-i", integrated],
                 ["analyze", "chunks", "-i", corpus, integrated],
                 ["analyze", "chunks", "-i", integrated, "--limit", "5"]):
        (rj, oj), (rt, ot) = _both(argv, argv, capsys)
        assert rj == rt == 0 and ot == oj
    for name, main in (("j", jmain), ("t", tmain)):
        assert main(["analyze", "documents", "-i", integrated,
                     "-o", str(tmp_path / f"rep_{name}.json"),
                     "--per-row-output",
                     str(tmp_path / f"rows_{name}.tsv")]) == 0
        labeled = tmp_path / f"labeled_{name}.tsv"
        with open(labeled, "w") as f:
            f.write("query_id\tchunk_text\tlabel\n")
            f.write("301\tsome\ttext with a tab\t1\n302\tplain\t0\n9\tx\t1\n")
        assert main(["mapping", "-i", str(labeled), "--original",
                     integrated]) == 0
    capsys.readouterr()
    for a, b in (("rep_t.json", "rep_j.json"), ("rows_t.tsv", "rows_j.tsv"),
                 ("labeled_t_with_querytext.tsv",
                  "labeled_j_with_querytext.tsv")):
        assert _bytes(tmp_path / a) == _bytes(tmp_path / b)


def _index_dirs_equal(j, t):
    """Every file the two builds wrote is equal: the text files byte for
    byte, the BM25 statistics as objects, the float16 embeddings within one
    float16 step of the float32 products' rounding."""
    assert sorted(os.listdir(t)) == sorted(os.listdir(j))
    _files_equal(j, t, [n for n in os.listdir(j)
                        if n.endswith((".tsv", ".json"))])
    ej = np.load(os.path.join(j, "embeddings.f16.npy")).astype(np.float32)
    et = np.load(os.path.join(t, "embeddings.f16.npy")).astype(np.float32)
    np.testing.assert_allclose(et, ej, atol=2 ** -10, rtol=0)
    from semanticsearch_tpu_torch.index.bm25 import load_bm25

    bj, bt = (load_bm25(os.path.join(d, "bm25.pkl")) for d in (j, t))
    q = [["fishing", "quota"], ["honey", "bees", "zzz"]]
    for a, b in zip(bj.get_topk_batch(q, 4), bt.get_topk_batch(q, 4)):
        assert np.array_equal(a, b)


def test_index_add_search_equal(chunks, ckpt, tmp_path, capsys):
    """index --bm25 -> index-add -> search: the JAX CLI throughout, the
    port's throughout, and the JAX CLI's index extended and searched by the
    port's, all with the same stdout; the two builds' files are equal."""
    enc = ["--encoder-ckpt", ckpt]
    add = str(tmp_path / "add.tsv")
    write_tsv(add, [{"chunk_id": "cNEW",
                     "passage": "glacier meltwater feeds mountain lake"},
                    {"chunk_id": "cNEW2",
                     "passage": "the fishing fleet returned to harbor"}],
              ["chunk_id", "passage"])
    queries = ["glacier meltwater mountain", "fishing quota trawlers",
               "honey bees"]
    runs = {}
    for name, build, extend in (("jax", jmain, jmain), ("port", tmain, tmain),
                                ("mixed", jmain, tmain)):
        idx = str(tmp_path / f"idx_{name}")
        out = [_run(build, ["index", "-i", chunks, "-o", idx, "--bm25"]
                    + enc, capsys)]
        if name != "mixed":
            shutil.copytree(idx, idx + "_built")
        out.append(_run(extend, ["index-add", "-i", add, "--index-dir", idx,
                                 "--text-column", "passage"] + enc, capsys))
        out.append(_run(extend, ["search", "--index-dir", idx, "-k", "3"]
                        + queries + enc, capsys))
        out.append(_run(extend, ["search", "--index-dir", idx, "-k", "2",
                                 "--dense-only", "--device-bm25"] + queries
                        + enc, capsys))
        runs[name] = out
    for name in ("port", "mixed"):
        assert runs[name] == runs["jax"], name
    assert _last_json(runs["jax"][1][1]) == {
        "rows_before": 6, "rows_added": 2, "rows_total": 8}
    top = _last_json(runs["jax"][2][1])[0]["hits"][0]
    assert top["chunk_id"] == "cNEW" and top["lexical_rank"] == 1
    _index_dirs_equal(str(tmp_path / "idx_jax_built"),
                      str(tmp_path / "idx_port_built"))
    # the port's compacted index (after index-add) against the JAX one's
    _index_dirs_equal(str(tmp_path / "idx_jax"), str(tmp_path / "idx_port"))

    # the embeddings-only index: the same meta line
    (rj, oj), (rt, ot) = _both(
        ["index", "-i", chunks, "-o", str(tmp_path / "dj"), "--batch-size",
         "4"] + enc,
        ["index", "-i", chunks, "-o", str(tmp_path / "dt"), "--batch-size",
         "4"] + enc, capsys)
    assert rj == rt == 0 and ot == oj


def test_search_through_local_mesh(chunks, ckpt, tmp_path, capsys,
                                   monkeypatch):
    """``search`` loads its engine on ``local_mesh("cpu")`` (the JAX CLI
    passes ``local_mesh()``, 8 CPU devices here); with the CLI's mesh
    swapped for a 4-shard one, dense and device-BM25 legs sharded, the hits
    stay the JAX CLI's."""
    from semanticsearch_tpu_torch.cli import main as tcli
    from semanticsearch_tpu_torch.core.mesh import (MeshSpec, local_mesh,
                                                     make_mesh)
    from semanticsearch_tpu_torch.index.query_engine import HybridQueryEngine

    enc = ["--encoder-ckpt", ckpt]
    idx = str(tmp_path / "idx")
    assert _run(jmain, ["index", "-i", chunks, "-o", idx, "--bm25"] + enc,
                capsys)[0] == 0
    queries = ["glacier meltwater mountain", "fishing quota trawlers",
               "honey bees"]
    meshes = []
    load = HybridQueryEngine.load.__func__

    def spy(cls, *args, **kw):
        meshes.append(kw.get("mesh"))
        return load(cls, *args, **kw)

    monkeypatch.setattr(HybridQueryEngine, "load", classmethod(spy))
    for extra in ([], ["--device-bm25"]):
        argv = ["search", "--index-dir", idx, "-k", "3"] + queries + extra \
            + enc
        want = _run(jmain, argv, capsys)
        assert _run(tmain, argv, capsys) == want
        assert meshes[-1] == local_mesh("cpu")
        with monkeypatch.context() as m:
            m.setattr(tcli, "_local_mesh", lambda args: make_mesh(
                MeshSpec(data=4), [torch.device("cpu")] * 4))
            assert _run(tmain, argv, capsys) == want
        assert meshes[-1].shape["data"] == 4
    assert len(meshes) == 4


def test_index_add_refusals_equal(chunks, ckpt, tmp_path, capsys):
    enc = ["--encoder-ckpt", ckpt]
    for name, main in (("j", jmain), ("t", tmain)):
        assert main(["index", "-i", chunks, "-o", str(tmp_path / name)]
                    + enc) == 0
    runs = []
    for name, main in (("j", jmain), ("t", tmain)):
        # built without --bm25: no texts.tsv to compact
        runs.append(_run(main, ["index-add", "-i", chunks, "--index-dir",
                                str(tmp_path / name)] + enc, capsys))
        # another encoder config than the one that built the index
        runs.append(_run(main, ["index-add", "-i", chunks, "--index-dir",
                                str(tmp_path / name), "--set",
                                "encoder.hidden_dim=16", "--set",
                                "encoder.num_heads=2", "--set",
                                "encoder.num_layers=1", "--set",
                                "encoder.vocab_size=64"], capsys))
    assert runs[2:] == runs[:2]
    assert runs[0][0] == runs[1][0] == 1
    assert "texts.tsv" in _last_json(runs[0][1])["error"]
    assert "mismatch" in _last_json(runs[1][1])["error"]


def test_tune_fusion_equal(chunks, ckpt, tmp_path, capsys):
    enc = ["--encoder-ckpt", ckpt]
    val = str(tmp_path / "val.tsv")
    write_tsv(val, [{"query_id": "q0", "query_text": "fishing quota trawlers",
                     "chunk_id": "c1", "label": "1"},
                    {"query_id": "q1", "query_text": "bees honey",
                     "chunk_id": "c2", "label": "1"},
                    {"query_id": "q1", "query_text": "bees honey",
                     "chunk_id": "c0", "label": "0"},
                    {"query_id": "q2", "query_text": "roman water",
                     "chunk_id": "c4", "label": "1"}],
              ["query_id", "query_text", "chunk_id", "label"])
    runs = []
    for name, main in (("j", jmain), ("t", tmain)):
        idx = str(tmp_path / name)
        assert main(["index", "-i", chunks, "-o", idx, "--bm25"] + enc) == 0
        runs.append([
            _run(main, ["tune-fusion", "--index-dir", idx, "-i", val,
                        "--rerank-top", "4"] + enc, capsys),
            _run(main, ["tune-fusion", "--index-dir", idx, "-i", val,
                        "--save", "--candidates", "5"] + enc, capsys),
            _run(main, ["search", "--index-dir", idx, "-k", "2",
                        "fishing quota trawlers", "roman water"] + enc,
                 capsys)])
    jr, tr = runs
    assert tr[0] == jr[0] and jr[0][0] == 1
    assert "--reranker" in _last_json(jr[0][1])["error"]
    sj, st = _last_json(jr[1][1]), _last_json(tr[1][1])
    assert st.pop("saved").endswith("/t/fusion.json")
    assert sj.pop("saved").endswith("/j/fusion.json")
    assert st == sj and sj["queries"] == 3
    assert _bytes(tmp_path / "t" / "fusion.json") == \
        _bytes(tmp_path / "j" / "fusion.json")
    assert tr[2] == jr[2]


def test_rank_equal(corpus, ckpt, tmp_path, capsys):
    enc = ["--encoder-ckpt", ckpt]
    chunk_args = ["chunk", "-i", corpus, "--config", "text_splitter_char"]
    assert jmain(chunk_args + ["-o", str(tmp_path / "ch")]) == 0
    chunked = str(tmp_path / "ch" / "text_splitter_char_chunks.tsv")
    outs = []
    for name, main in (("j", jmain), ("t", tmain)):
        rc, out = _run(main, ["rank", "-i", chunked, "-o",
                              str(tmp_path / f"rank_{name}.tsv"),
                              "--original", corpus, "--group-batch", "2",
                              "--in-memory"]
                       + enc, capsys)
        assert rc == 0
        outs.append(_last_json(out))
    assert outs[1]["ranked_rows"] == outs[0]["ranked_rows"] > 0
    assert _bytes(tmp_path / "rank_t.tsv") == _bytes(tmp_path / "rank_j.tsv")
    full = [np.genfromtxt(tmp_path / f"rank_{n}_rrf_filtered_full.tsv",
                          delimiter="\t", dtype=str, skip_header=1)
            for n in ("j", "t")]
    assert np.array_equal(full[1][:, [0, 1, 2, 6]], full[0][:, [0, 1, 2, 6]])
    np.testing.assert_allclose(full[1][:, 3:6].astype(float),
                               full[0][:, 3:6].astype(float),
                               atol=SCORE_TOL + 1e-6)


def test_device_flag():
    with pytest.raises(SystemExit):
        tmain_raw(["--device", "tpu", "validate", "-i", "x"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tmain_raw(["index", "-i", "x.tsv", "-o", "y"])
