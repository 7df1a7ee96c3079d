"""Cross-validated evaluation, folds, validation and the labeling ranker in
the port against the JAX package's.

Fold files and the validation outputs are byte-equal; ``CVEvaluator``
(KNRM, 2 folds, 1 epoch; both packages start each fold from the tree the
JAX init gives it) reaches metrics within 1e-6; ``evaluate_saved_model``
of a JAX-written checkpoint equals JAX's to 1e-6; the ``encoder:`` scheme
reads a JAX-saved encoder's table bit for bit and warm-starts the
cross-encoder from its float32 masters; ``rank_and_filter_groups`` with
one shared ``embed_fn`` gives equal rows; the comparison CSV and table are
equal."""
import os
import sys

import numpy as np
import pytest
import torch

from semanticsearch_tpu.core.config import EncoderConfig as JEncCfg
from semanticsearch_tpu.core.config import TrainConfig as JTrainConfig
from semanticsearch_tpu.data import folds as jfolds
from semanticsearch_tpu.data import validate as jvalidate
from semanticsearch_tpu.index import ranker as jranker
from semanticsearch_tpu.models.encoder import SentenceEncoder as JEncoder
from semanticsearch_tpu.models.subword import train_bpe as j_train_bpe
from semanticsearch_tpu.train import embeddings as jemb
from semanticsearch_tpu.train import encoder_train as jenc_train
from semanticsearch_tpu.train import evaluate as jev
from semanticsearch_tpu_torch.core.config import TrainConfig
from semanticsearch_tpu_torch.data import folds as tfolds
from semanticsearch_tpu_torch.data import validate as tvalidate
from semanticsearch_tpu_torch.data.tsv import write_tsv
from semanticsearch_tpu_torch.index import ranker as tranker
from semanticsearch_tpu_torch.models.convert import reranker_state_dict
from semanticsearch_tpu_torch.models.rerankers import (make_model,
                                                       transfer_from_encoder)
from semanticsearch_tpu_torch.models.subword import SubwordTokenizer
from semanticsearch_tpu_torch.train import evaluate as tev
from semanticsearch_tpu_torch.train import trainer as ttr
from semanticsearch_tpu_torch.train.vocab import Preprocessor

WORDS = [f"w{i}" for i in range(40)]


@pytest.fixture(scope="module")
def labeled(tmp_path_factory):
    rng = np.random.default_rng(2)
    rows = []
    for q in range(12):
        for d in range(5):
            rows.append({"query_id": f"q{q}",
                         "chunk_text": " ".join(rng.choice(WORDS, 8)),
                         "label": ["1", "yes", "0", "neg", "-1"][d]})
    rows.append({"query_id": "q0", "chunk_text": "bad", "label": "maybe"})
    rows.append({"query_id": "", "chunk_text": "no query", "label": "1"})
    path = str(tmp_path_factory.mktemp("data") / "labeled.tsv")
    write_tsv(path, rows, ["query_id", "chunk_text", "label"])
    return path


def _files(d):
    return {f: open(os.path.join(d, f), "rb").read()
            for f in sorted(os.listdir(d))}


def test_folds_and_validation_byte_equal(labeled, tmp_path):
    mine = tfolds.create_cv_folds(labeled, str(tmp_path / "t"), num_folds=3)
    theirs = jfolds.create_cv_folds(labeled, str(tmp_path / "j"),
                                    num_folds=3)
    assert len(mine) == len(theirs) == 3
    assert _files(tmp_path / "t") == _files(tmp_path / "j")
    assert (tfolds.load_fold_rows(mine[0].train)
            == jfolds.load_fold_rows(theirs[0].train))
    for mod, d in ((tvalidate, "vt"), (jvalidate, "vj")):
        os.makedirs(tmp_path / d)
        rep = mod.validate_and_clean(labeled, str(tmp_path / d / "c.tsv"))
        assert rep.rows_in == 62 and rep.rows_kept == 60
    assert _files(tmp_path / "vt") == _files(tmp_path / "vj")
    for v in ("1", "t", "0.5", "-1", "no", "x", ""):
        assert tvalidate.parse_label(v) == jvalidate.parse_label(v)


def _record_inits(monkeypatch):
    """JAX's init_params records each fold's tree; the port's returns the
    recorded tree of the same fold, converted."""
    trees = []
    j_init = jev.RerankTrainer.init_params

    def j_recording(self, dataset, seed=None):
        trees.append(j_init(self, dataset, seed))
        return trees[-1]

    def t_replay(self, dataset, seed=None):
        return reranker_state_dict(self._model_name, trees.pop(0),
                                   **self._model_kwargs)

    monkeypatch.setattr(jev.RerankTrainer, "init_params", j_recording)
    monkeypatch.setattr(ttr.RerankTrainer, "init_params", t_replay)


@pytest.mark.parametrize("layout", ["npz", "orbax"])
def test_cv_run_model_and_saved_model_match_jax(labeled, tmp_path,
                                                monkeypatch, layout):
    folds = tfolds.create_cv_folds(labeled, str(tmp_path / "f"), 2)
    base = dict(model="knrm", epochs=1, batch_size=4, embedding_dim=8,
                optimizer="adam", learning_rate=0.01, filter_low_freq=1,
                fixed_length_left=4, fixed_length_right=10)
    kw = {"kernel_num": 5}
    _record_inits(monkeypatch)
    with monkeypatch.context() as m:
        if layout == "npz":
            m.setitem(sys.modules, "orbax.checkpoint", None)
        jres = jev.CVEvaluator(folds).run_model(
            "knrm", JTrainConfig(**base), kw, output_dir=str(tmp_path / "j"))
    tres = tev.CVEvaluator(folds, device="cpu").run_model(
        "knrm", TrainConfig(**base), kw, output_dir=str(tmp_path / "t"))
    assert len(tres.per_fold) == len(jres.per_fold) == 2
    for mine, theirs in zip(tres.per_fold, jres.per_fold):
        assert mine.keys() == theirs.keys()
        for k in mine:
            np.testing.assert_allclose(mine[k], theirs[k], rtol=1e-6)
    for h_t, h_j in zip(tres.train_history, jres.train_history):
        np.testing.assert_allclose(h_t[0]["loss"], h_j[0]["loss"],
                                   rtol=1e-4)
    for k, fold in enumerate(folds, 1):
        ckpt = str(tmp_path / "j" / "knrm" / f"fold_{k}")
        mine = tev.evaluate_saved_model(ckpt, fold.test, device="cpu")
        theirs = jev.evaluate_saved_model(ckpt, fold.test)
        for key in theirs:
            np.testing.assert_allclose(mine[key], theirs[key], rtol=1e-6)
        # and the port's own checkpoint of the same fold
        own = tev.evaluate_saved_model(
            str(tmp_path / "t" / "knrm" / f"fold_{k}"), fold.test,
            device="cpu")
        for key in own:
            np.testing.assert_allclose(own[key], tres.per_fold[k - 1][key],
                                       rtol=1e-12)
    assert (tev.format_comparison_table([tres])
            .split("\n")[0] == jev.format_comparison_table([jres])
            .split("\n")[0])
    jev.write_comparison_csv([jres], str(tmp_path / "j.csv"))
    tev.write_comparison_csv([tres], str(tmp_path / "t.csv"))
    assert (open(tmp_path / "j.csv").read().split("\n")[0]
            == open(tmp_path / "t.csv").read().split("\n")[0])


def test_comparison_outputs_equal(tmp_path):
    per_fold = [{"map": 0.5, "ndcg@5": 0.25}, {"map": 0.75, "ndcg@5": 0.5}]
    t = [tev.CVResult("knrm", per_fold), tev.CVResult("esim", per_fold[:1])]
    j = [jev.CVResult("knrm", per_fold), jev.CVResult("esim", per_fold[:1])]
    assert tev.format_comparison_table(t) == jev.format_comparison_table(j)
    tev.write_comparison_csv(t, str(tmp_path / "t.csv"))
    jev.write_comparison_csv(j, str(tmp_path / "j.csv"))
    assert open(tmp_path / "t.csv").read() == open(tmp_path / "j.csv").read()


def test_encoder_scheme_reads_the_f32_table(tmp_path):
    texts = ["w1 w2 w3 w4", "w2 w5 w6", "w7 w1 w9 w2"] * 4
    tok = j_train_bpe(texts, vocab_size=64, max_len=32)
    # bf16 compute on f32 parameters
    cfg = JEncCfg(vocab_size=tok.vocab_size, hidden_dim=16, num_layers=2,
                  num_heads=2, mlp_dim=32, max_len=32)
    enc = JEncoder(cfg, tokenizer=tok, seed=3)
    path = str(tmp_path / "enc")
    jenc_train.save_encoder(enc, path)
    want = jemb.encoder_token_embeddings(jenc_train.load_encoder(path))
    sub = SubwordTokenizer.load(os.path.join(path, "tokenizer.json"))
    pp = Preprocessor(fixed_length_left=4, fixed_length_right=8,
                      subword=sub)
    tcfg = TrainConfig(model="cross_encoder", embedding_dim=16,
                       embedding_init_path="encoder:" + path)
    kw = {"num_layers": 2, "num_heads": 2, "mlp_dim": 32}
    emb, warm = tev.CVEvaluator._embedding_init("cross_encoder", tcfg, kw,
                                                pp, sub)
    assert emb.dtype == np.float32 and np.array_equal(emb, want)
    fresh = make_model("cross_encoder", vocab_size=tok.vocab_size,
                       embed_dim=16, **kw)
    started = warm(fresh.state_dict())
    from semanticsearch_tpu_torch.train.encoder_train import load_encoder

    masters = load_encoder(path, device="cpu").master
    assert masters.layers[0].mlp_in.weight.dtype == torch.float32
    ref = transfer_from_encoder(fresh, masters)
    for k in ref:
        assert torch.equal(started[k], ref[k]), k
    with pytest.raises(ValueError, match="subword"):
        tev.CVEvaluator._embedding_init("knrm", tcfg, {}, pp, None)


def test_rank_and_filter_groups_equal():
    rng = np.random.default_rng(5)
    groups_t, groups_j = [], []
    for q in range(4):
        chunks = [" ".join(rng.choice(WORDS, int(rng.integers(3, 9))))
                  for _ in range(int(rng.integers(1, 9)))]
        args = (f"q{q}", " ".join(rng.choice(WORDS, 3)),
                [f"c{q}_{i}" for i in range(len(chunks))], chunks)
        groups_t.append(tranker.QueryGroup(*args))
        groups_j.append(jranker.QueryGroup(*args))
    table = {}

    def embed_fn(texts):
        for t in texts:
            table.setdefault(t, rng.normal(size=6).astype(np.float32))
        return np.stack([table[t] for t in texts])

    mine = tranker.rank_and_filter_groups(groups_t, embed_fn)
    theirs = jranker.rank_and_filter_groups(groups_j, embed_fn)
    assert len(mine) > 0
    assert [vars(r) for r in mine] == [vars(r) for r in theirs]
    scores = rng.normal(size=10)
    assert np.array_equal(tranker.percentile_labels(scores),
                          jranker.percentile_labels(scores))
