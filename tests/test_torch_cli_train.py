"""The port's training and OIE subcommands against the JAX CLI's.

``train-encoder`` (MLM, then contrastive training with re-mining) from one
encoder checkpoint the JAX ``save_encoder`` wrote gives the JAX CLI's JSON
line, its losses within 1e-4 relative, and a checkpoint the JAX package
loads; ``train-tokenizer`` writes the same ``tokenizer.json``. Subcommands
that train from a random initialisation (``train``, ``oie-train``) run on
the port and hand their checkpoints to the JAX CLI's ``evaluate``,
``search --rerank`` and ``oie --extractor neural``, which must agree with
the port's. ``oie --extractor heuristic`` writes the JAX CLI's files."""
import json
import os

import numpy as np
import pytest

from semanticsearch_tpu.cli.main import main as jmain
from semanticsearch_tpu.train.encoder_train import load_encoder as jload
from semanticsearch_tpu_torch.data.tsv import write_tsv
from test_torch_cli import (SCORE_TOL, _both, _bytes, _last_json,  # noqa: F401
                            _run, chunks, ckpt, tmain)

LOSS_RTOL = 1e-4   # float32 training steps, as tests/test_torch_encoder_train


def test_train_encoder_and_tokenizer_equal(tmp_path, ckpt, capsys):
    rows = []
    for t in range(2):
        for i in range(6):
            rows.append({"query_id": f"q{t}", "query_text": f"query topic{t}",
                         "chunk_text": f"chunk{t} item{i} alpha beta",
                         "label": "1"})
            rows.append({"query_id": f"q{t}", "query_text": f"query topic{t}",
                         "chunk_text": f"offtopic{1 - t} item{i} gamma",
                         "label": "0"})
    p = str(tmp_path / "labeled.tsv")
    write_tsv(p, rows, ["query_id", "query_text", "chunk_text", "label"])
    outs = []
    for name, main in (("j", jmain), ("t", tmain)):
        rc, out = _run(main, [
            "train-encoder", "-i", p, "-o", str(tmp_path / f"enc_{name}"),
            "--epochs", "2", "--mine-rounds", "2", "--batch-size", "8",
            "--mlm-epochs", "1", "--encoder-ckpt", ckpt], capsys)
        assert rc == 0
        outs.append(_last_json(out))
    oj, ot = outs
    for key in [k for k in oj if "loss" in k]:
        np.testing.assert_allclose(ot.pop(key), oj.pop(key), rtol=LOSS_RTOL)
    assert ot.pop("checkpoint") != oj.pop("checkpoint")
    assert ot == oj and oj["mine_rounds"] == 2 and oj["pairs"] == 12
    assert np.isfinite(jload(str(tmp_path / "enc_t")).encode(
        ["query topic0"])).all()

    for name, main in (("j", jmain), ("t", tmain)):
        rc, out = _run(main, ["train-tokenizer", "-i", p, "-o",
                              str(tmp_path / f"tok_{name}.json"), "--column",
                              "chunk_text", "--vocab-size", "64",
                              "--min-pair-freq", "1"], capsys)
        assert rc == 0
        outs.append(_last_json(out))
    assert outs[3]["vocab_size"] == outs[2]["vocab_size"]
    assert outs[3]["pieces"] == outs[2]["pieces"]
    assert _bytes(tmp_path / "tok_t.json") == _bytes(tmp_path / "tok_j.json")
    # a trained vocabulary through --tokenizer: the same index lines
    (rj, oj2), (rt, ot2) = _both(
        ["index", "-i", p, "-o", str(tmp_path / "ij"), "--tokenizer",
         str(tmp_path / "tok_j.json"), "--set", "encoder.hidden_dim=16",
         "--set", "encoder.num_layers=1", "--set", "encoder.num_heads=2"],
        ["index", "-i", p, "-o", str(tmp_path / "it"), "--tokenizer",
         str(tmp_path / "tok_j.json"), "--set", "encoder.hidden_dim=16",
         "--set", "encoder.num_layers=1", "--set", "encoder.num_heads=2"],
        capsys)
    assert rj == rt == 0
    mj, mt = _last_json(oj2), _last_json(ot2)
    assert mt == mj and mj["encoder_config"]["vocab_size"] == \
        outs[2]["vocab_size"]


def test_train_evaluate_and_rerank_search(chunks, ckpt, tmp_path, capsys):
    """The port's CV training writes per-fold checkpoints that both CLIs'
    ``evaluate`` and ``search --rerank`` read alike."""
    rng = np.random.default_rng(1)
    rows = []
    for q in range(6):
        for d in range(4):
            lab = 1 if d < 2 else 0
            words = ([f"tok{q}"] * 3 if lab else
                     [f"z{rng.integers(100)}" for _ in range(3)])
            rows.append({"query_id": f"q{q}", "query_text": f"tok{q} q",
                         "chunk_text": " ".join(words) + " filler words",
                         "label": str(lab)})
    p = str(tmp_path / "labeled.tsv")
    write_tsv(p, rows, ["query_id", "chunk_text", "label"])
    assert tmain(["folds", "-i", p, "-o", str(tmp_path / "cv"),
                  "--num-folds", "2"]) == 0
    sets = ["--set", "train.epochs=1", "--set", "train.batch_size=2",
            "--set", "train.optimizer=adam",
            "--set", "train.learning_rate=0.01",
            "--set", "train.embedding_dim=8",
            "--set", "train.filter_low_freq=1"]
    rc, out = _run(tmain, ["train", "--models", "knrm", "--folds-dir",
                           str(tmp_path / "cv"), "--num-folds", "2",
                           "--output-dir", str(tmp_path / "models"),
                           "--csv", str(tmp_path / "cv.csv")] + sets, capsys)
    assert rc == 0 and "knrm" in out
    assert os.path.getsize(tmp_path / "cv.csv") > 0
    ev = ["evaluate", "--model-dirs", str(tmp_path / "models" / "knrm"),
          "--folds-dir", str(tmp_path / "cv"), "--num-folds", "2"]
    (rj, oj), (rt, ot) = _both(ev, ev, capsys)
    assert rj == rt == 0
    ej, et = json.loads(oj), json.loads(ot)
    assert set(et) == set(ej) == {"knrm"}
    assert set(et["knrm"]) == set(ej["knrm"]) and "map" in ej["knrm"]
    for metric in ej["knrm"]:
        for stat in ("mean", "std"):
            assert et["knrm"][metric][stat] == pytest.approx(
                ej["knrm"][metric][stat], abs=1e-6), metric
    missing = ["evaluate", "--model-dirs", str(tmp_path / "nope"),
               "--folds-dir", str(tmp_path / "cv")]
    assert _both(missing, missing, capsys) == ((1, "{}\n"), (1, "{}\n"))

    enc = ["--encoder-ckpt", ckpt]
    results = []
    for name, main in (("j", jmain), ("t", tmain)):
        idx = str(tmp_path / f"idx_{name}")
        assert main(["index", "-i", chunks, "-o", idx, "--bm25"] + enc) == 0
        rc, out = _run(main, ["search", "--index-dir", idx, "-k", "4",
                              "--rerank", str(tmp_path / "models" / "knrm" /
                                              "fold_1"),
                              "--rerank-top", "5", "tok0 honey",
                              "fishing quota"] + enc, capsys)
        assert rc == 0
        results.append(_last_json(out))
    for qj, qt in zip(*results):
        assert [h["chunk_id"] for h in qt["hits"]] == \
            [h["chunk_id"] for h in qj["hits"]]
        for hj, ht in zip(qj["hits"], qt["hits"]):
            rs_j, rs_t = hj.pop("rerank_score"), ht.pop("rerank_score")
            assert rs_t == pytest.approx(rs_j, abs=SCORE_TOL)
            assert ht == hj


def test_oie_subcommands(tmp_path, capsys):
    """``oie --extractor heuristic`` writes the JAX CLI's files; a tagger
    that the port's ``oie-train`` wrote enriches alike through both CLIs."""
    p = str(tmp_path / "chunks.tsv")
    write_tsv(p, [{"chunk_id": f"c{i}",
                   "chunk_text": f"The old engineer carried the bridge "
                                 f"number {i}. The mayor signed it."}
                  for i in range(24)], ["chunk_id", "chunk_text"])
    outs = []
    for name, main in (("j", jmain), ("t", tmain)):
        rc, out = _run(main, ["oie", "-i", p, "-o",
                              str(tmp_path / f"h_{name}.tsv"), "--extractor",
                              "heuristic", "--sidecar",
                              str(tmp_path / f"h_{name}.json")], capsys)
        assert rc == 0
        outs.append(_last_json(out)["enriched_rows"])
    assert outs == [24, 24]
    for ext in ("tsv", "json"):
        assert _bytes(tmp_path / f"h_t.{ext}") == \
            _bytes(tmp_path / f"h_j.{ext}")

    model_dir = str(tmp_path / "oie_model")
    rc, out = _run(tmain, ["oie-train", "-i", p, "-o", model_dir,
                           "--epochs", "4", "--hidden-dim", "32",
                           "--num-layers", "1", "--num-heads", "2",
                           "--bpe-vocab", "128"], capsys)
    assert rc == 0
    blob = _last_json(out)
    assert blob["model_dir"] == model_dir and blob["texts"] == 24
    for name, main in (("j", jmain), ("t", tmain)):
        rc, out = _run(main, ["oie", "-i", p, "-o",
                              str(tmp_path / f"n_{name}.tsv"), "--extractor",
                              "neural", "--model-dir", model_dir,
                              "--self-check", "0.3"], capsys)
        assert rc == 0 and _last_json(out)["enriched_rows"] == 24
    assert _bytes(tmp_path / "n_t.tsv") == _bytes(tmp_path / "n_j.tsv")
