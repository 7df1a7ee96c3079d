"""Contrastive encoder training in the port against the JAX package's.

Both packages start from one converted float32 flax tree with dropout 0
and train on the same pairs: per-epoch losses agree to 1e-4 relative, with
and without hard negatives, under stock attention and under flash (the JAX
kernel in interpret mode, as its own tests run it). Parameters agree to
1e-5 absolute after 6 AdamW steps, but for the attention key biases: their
true gradient is zero (a softmax does not see a constant added to a row of
scores), so each framework's gradient there is float32 rounding noise,
which Adam divides by its own root mean square into a step of up to the
learning rate; they agree to twice the learning rates summed. The
pair builders, the mining inputs and the mined negatives are equal, and
checkpoints move both ways (the port's npz write read by JAX's
``load_encoder``; JAX's npz and orbax writes read by the port) with
bit-equal parameters and encodings. A bf16 encoder holds the loss only
(2e-2 relative: bf16 activations round at 2^-8 in each framework's own
order)."""
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semanticsearch_tpu.core.config import EncoderConfig as JCfg
from semanticsearch_tpu.models.encoder import SentenceEncoder as JEncoder
from semanticsearch_tpu.models.encoder import SentenceTransformerModel as JModel
from semanticsearch_tpu.train import encoder_train as jt
from semanticsearch_tpu_torch.core.checkpoint import restore_checkpoint
from semanticsearch_tpu_torch.core.config import EncoderConfig as TCfg
from semanticsearch_tpu_torch.models.convert import (encoder_flax_tree,
                                                     flax_to_state_dict)
from semanticsearch_tpu_torch.models.encoder import SentenceEncoder as TEncoder
from semanticsearch_tpu_torch.train import encoder_train as tt
from semanticsearch_tpu_torch.train.optim import warmup_cosine_decay_schedule

SMALL = dict(vocab_size=300, hidden_dim=32, num_layers=2, num_heads=4,
             mlp_dim=64, max_len=64)
TRAIN = dict(epochs=2, batch_size=8, learning_rate=1e-3, max_len_query=16,
             max_len_chunk=32, seed=5)
PARAM_ATOL = 1e-5


@pytest.fixture(scope="module")
def tree():
    cfg = JCfg(**SMALL, attention="stock")
    return jax.tree.map(np.asarray, JModel(cfg).init(
        jax.random.PRNGKey(11), jnp.zeros((1, 16), jnp.int32),
        jnp.ones((1, 16), jnp.int32))["params"])


def _words(rng, n):
    letters = np.array(list("abcdefgh"))
    vocab = ["".join(rng.choice(letters, 4)) for _ in range(60)]
    return " ".join(rng.choice(vocab, n))


@pytest.fixture(scope="module")
def rows():
    rng = np.random.default_rng(4)
    out = []
    for q in range(7):
        qt = _words(rng, 4)
        for c in range(4):
            out.append({"query_id": f"q{q}", "query_text": qt,
                        "chunk_text": _words(rng, int(rng.integers(5, 30))),
                        "label": "1" if c < 2 else "0"})
    return out


def _pair(tree, dtype="float32", attention="stock"):
    j = JEncoder(JCfg(**SMALL, dtype=dtype, attention=attention),
                 params=tree)
    t = TEncoder(TCfg(**SMALL, dtype=dtype, attention=attention),
                 device="cpu",
                 state_dict=flax_to_state_dict(tree, SMALL["num_layers"]))
    return j, t


def _lr_sum(n_pairs):
    steps = -(-n_pairs // TRAIN["batch_size"]) * TRAIN["epochs"]
    sched = warmup_cosine_decay_schedule(
        0.0, TRAIN["learning_rate"], max(1, int(steps * 0.05)),
        max(2, steps), TRAIN["learning_rate"] * 0.1)
    return sum(sched(i) for i in range(steps))


def _assert_params_close(j, t, atol, key_bias_atol):
    got = encoder_flax_tree(t.master.state_dict(), SMALL["num_layers"],
                            SMALL["num_heads"])
    flat, _ = jax.tree_util.tree_flatten_with_path(got)
    for (path, g), w in zip(flat, jax.tree.leaves(j.params)):
        name = jax.tree_util.keystr(path)
        tol = key_bias_atol if "['key']['bias']" in name else atol
        assert np.abs(g - np.asarray(w)).max() <= tol, name


def test_pair_builders_equal(rows):
    assert tt.pairs_from_labeled_rows(rows) == jt.pairs_from_labeled_rows(rows)
    pairs, _ = tt.pairs_from_labeled_rows(rows)
    assert (tt.mining_inputs_from_labeled_rows(rows, pairs)
            == jt.mining_inputs_from_labeled_rows(rows, pairs))


@pytest.mark.parametrize("attention,hard", [("stock", True),
                                            ("stock", False),
                                            ("flash", True)])
def test_fit_matches_jax(tree, rows, attention, hard):
    pairs, negs = tt.pairs_from_labeled_rows(rows)
    j, t = _pair(tree, attention=attention)
    cfg_j = jt.ContrastiveConfig(**TRAIN, use_hard_negatives=hard)
    cfg_t = tt.ContrastiveConfig(**TRAIN, use_hard_negatives=hard)
    hj = jt.ContrastiveEncoderTrainer(j, cfg_j).fit(pairs, negs)
    ht = tt.ContrastiveEncoderTrainer(t, cfg_t).fit(pairs, negs)
    for a, b in zip(ht, hj):
        assert a["epoch"] == b["epoch"]
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-4)
    _assert_params_close(j, t, PARAM_ATOL, 2 * _lr_sum(len(pairs)))
    # the serving module took the trained masters
    texts = [p[1] for p in pairs[:5]]
    np.testing.assert_allclose(t.encode(texts), j.encode(texts), atol=1e-3)


def test_mining_matches_jax(tree, rows):
    pairs, negs = tt.pairs_from_labeled_rows(rows)
    corpus, relevant = tt.mining_inputs_from_labeled_rows(rows, pairs)
    j, t = _pair(tree)
    queries = [p[0] for p in pairs]
    for floor in (0, 2):
        assert (tt.mine_hard_negatives(t, queries, corpus, relevant, floor)
                == jt.mine_hard_negatives(j, queries, corpus, relevant,
                                          floor))
    cfg = dict(TRAIN, epochs=1)
    hj = jt.fit_with_mining(j, jt.ContrastiveConfig(**cfg), pairs, corpus,
                            relevant, negs, rounds=2)
    ht = tt.fit_with_mining(t, tt.ContrastiveConfig(**cfg), pairs, corpus,
                            relevant, negs, rounds=2)
    assert [r["round"] for r in ht] == [r["round"] for r in hj] == [0, 1]
    for a, b in zip(ht, hj):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-4)


def test_bf16_loss_matches_jax(tree, rows):
    pairs, negs = tt.pairs_from_labeled_rows(rows)
    j, t = _pair(tree, dtype="bfloat16")
    cfg = dict(TRAIN, epochs=1)
    hj = jt.ContrastiveEncoderTrainer(j, jt.ContrastiveConfig(**cfg)).fit(
        pairs, negs)
    ht = tt.ContrastiveEncoderTrainer(t, tt.ContrastiveConfig(**cfg)).fit(
        pairs, negs)
    np.testing.assert_allclose(ht[0]["loss"], hj[0]["loss"], rtol=2e-2)
    # the masters stayed float32 and moved off the bf16 grid
    w = t.master.layers[0].mlp_in.weight
    assert w.dtype == torch.float32
    assert not torch.equal(w, w.to(torch.bfloat16).float())
    assert t.model.layers[0].mlp_in.weight.dtype == torch.bfloat16


def _leaves_equal(a, b):
    la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert np.array_equal(np.asarray(x), np.asarray(y))


def test_port_save_loads_in_jax(tree, tmp_path):
    _, t = _pair(tree)
    tt.save_encoder(t, str(tmp_path))
    with open(tmp_path / "format.json") as f:
        assert json.load(f)["format"] == "npz"
    loaded = jt.load_encoder(str(tmp_path))
    _leaves_equal(loaded.params, tree)
    texts = ["abcd efgh", "a b c d e f", "hgfe"]
    j = JEncoder(JCfg(**SMALL, dtype="float32"), params=tree)
    assert np.array_equal(loaded.encode(texts), j.encode(texts))
    again = tt.load_encoder(str(tmp_path), device="cpu")
    assert np.array_equal(again.encode(texts), t.encode(texts))


@pytest.mark.parametrize("layout", ["npz", "orbax"])
def test_jax_save_loads_in_port(tree, tmp_path, monkeypatch, layout):
    from semanticsearch_tpu.models.subword import train_bpe

    tok = train_bpe(["abcd efgh abcd", "efgh hgfe dcba"] * 3,
                    vocab_size=SMALL["vocab_size"], max_len=SMALL["max_len"])
    j = JEncoder(JCfg(**SMALL, dtype="float32"), params=tree, tokenizer=tok)
    with monkeypatch.context() as m:
        if layout == "npz":
            m.setitem(sys.modules, "orbax.checkpoint", None)
        jt.save_encoder(j, str(tmp_path))
    assert os.path.isdir(tmp_path / "state") == (layout == "orbax")
    t = tt.load_encoder(str(tmp_path), device="cpu")
    _leaves_equal(encoder_flax_tree(t.master.state_dict(),
                                    SMALL["num_layers"], SMALL["num_heads"]),
                  tree)
    assert t.tokenizer.vocab == tok.vocab
    ref = TEncoder(TCfg(**SMALL, dtype="float32"), device="cpu",
                   tokenizer=t.tokenizer,
                   state_dict=flax_to_state_dict(
                       restore_checkpoint(str(tmp_path))["params"],
                       SMALL["num_layers"]))
    texts = ["abcd efgh", "dcba hgfe abcd"]
    assert np.array_equal(t.encode(texts), ref.encode(texts))
    np.testing.assert_allclose(t.encode(texts), j.encode(texts), atol=1e-4)
