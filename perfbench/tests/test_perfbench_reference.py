"""The plain reference against the program, at a small size on the CPU:
the same weights, corpus and texts give the same answers."""
import numpy as np
import pytest
import torch

from perfbench import traffic, weights
from perfbench.kinds import common
from perfbench.reference import encoder as ref_encoder
from perfbench.reference import precision as P
from perfbench.reference import search as ref_search
from perfbench.reference import tokenizer as ref_tok
from perfbench.reference import train as ref_train
from perfbench.tests import tiny

MIX = {"vocab": 2000, "zipf_s": 1.1,
       "query_words": {"median": 6, "sigma": 0.5, "min": 2, "max": 32}}


def _cfg(dtype="float32"):
    import json
    cfg = json.loads((tiny.REPO / "perfbench/configs/minilm-l6-f32.json")
                     .read_text())
    cfg.update(tiny.CONFIG, dtype=dtype, attention="stock")
    cfg["index"].update(tiny.INDEX, dtype=dtype)
    return cfg


def _texts(n=40, seed=3):
    return [t for b in traffic.query_batches(seed, MIX, 1, n) for t in b] + [
        "Upper CASE words, punctuation!  and 123 numbers", "x"]


def test_tokenizer_matches_the_program():
    from semanticsearch_tpu_torch.models.tokenizer import HashingTokenizer

    texts = _texts()
    tok = HashingTokenizer(vocab_size=1000, max_len=16)
    ids, mask = tok.encode_batch(texts, max_len=16)
    for t, i, m in zip(texts, ids, mask):
        assert ref_tok.token_ids(t, 1000, 16) == list(i[m > 0])
    assert list(ref_tok.lengths(texts, 1000, 16)) == list(mask.sum(1))


def test_encoder_matches_the_program():
    cfg = _cfg()
    w = weights.make(cfg, 11, "cpu")
    enc = common.port_encoder(cfg, w, "cpu")
    texts = _texts()
    got = enc.encode_device(texts)
    ref = ref_encoder.encode(cfg, w, texts, "f64")
    assert float((got.double() - ref).norm(dim=1).max()) < 1e-5
    assert float((ref.norm(dim=1) - 1).abs().max()) < 1e-12


@pytest.mark.parametrize("prec,lo,hi", [("tf32", 1e-5, 1e-2),
                                        ("fp8", 1e-3, 0.5)])
def test_controls_are_coarser(prec, lo, hi):
    cfg = _cfg()
    w = weights.make(cfg, 11, "cpu")
    texts = _texts()
    ref = ref_encoder.encode(cfg, w, texts, "f64")
    ctl = ref_encoder.encode(cfg, w, texts, prec)
    gap = float((ctl.double() - ref).norm(dim=1).max())
    assert lo < gap < hi


def test_rounding():
    x = torch.tensor([1.0 + 2 ** -12, 1.0 + 2 ** -9, 3.0])
    assert P.round_tf32(x).tolist() == [1.0, 1.0 + 2 ** -9, 3.0]
    y = torch.linspace(-2, 2, 101)
    r = P.round_fp8(y)
    assert float((r - y).abs().max()) <= 2 * 2 ** -4  # 3 mantissa bits
    a = torch.randn(4, 8, requires_grad=True)
    P.operand(a, "fp8").sum().backward()
    assert torch.equal(a.grad, torch.ones_like(a))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_search_matches_the_program(dtype):
    from semanticsearch_tpu_torch.index.engine import EmbeddingIndex

    cfg = _cfg(dtype)
    raw = common.corpus_rows(cfg, 5, "cpu")
    index = EmbeddingIndex.build(raw, cfg=common.index_config(cfg),
                                 device="cpu")
    q = torch.nn.functional.normalize(torch.randn(16, 32), dim=1)
    v, i = index.search_device(q, k=10)
    rows = ref_search.stored_rows(raw, dtype)
    rv, ri = ref_search.topk(q, rows, dtype, 10)
    assert torch.equal(i.long(), ri)
    best, at = ref_search.judge(q, rows, dtype, i, 10)
    assert float((best - at).abs().max()) == 0
    assert float((v.double() - at).abs().max()) < 1e-6
    assert torch.allclose(best, rv)


def test_training_step_matches_the_program():
    from semanticsearch_tpu_torch.train.encoder_train import (
        ContrastiveConfig, ContrastiveEncoderTrainer)

    cfg = _cfg()
    cfg["max_position_embeddings"] = 48
    w = weights.make(cfg, 4, "cpu")
    enc = common.port_encoder(cfg, w, "cpu")
    tc = {"learning_rate": 3e-4, "warmup_frac": 0.05, "weight_decay": 0.01,
          "temperature": 0.05, "symmetric": True, "max_len_query": 16,
          "max_len_chunk": 48}
    rng = traffic.rng_for(1, "x")
    words = traffic.word_list(2000)
    cdf = np.cumsum(traffic.zipf_weights(2000, 1.1))
    q = traffic.texts_of(rng, words, cdf, rng.integers(2, 8, 16))
    p = traffic.texts_of(rng, words, cdf, rng.integers(4, 40, 16))
    n = traffic.texts_of(rng, words, cdf, rng.integers(4, 40, 16))
    trainer = ContrastiveEncoderTrainer(enc, ContrastiveConfig(
        epochs=1, batch_size=8, seed=0, **{k: v for k, v in tc.items()
                                           if k != "learning_rate"},
        learning_rate=tc["learning_rate"]))
    hist = trainer.fit(list(zip(q, p)), n)
    order = np.random.default_rng(0).permutation(16)
    steps = [([q[i] for i in order[s:s + 8]],
              [p[i] for i in order[s:s + 8]] + [n[i] for i in order[s:s + 8]])
             for s in (0, 8)]
    losses, g1, after = ref_train.train(cfg, w, steps, tc, 2)
    assert abs(hist[0]["loss"] - np.mean(losses)) < 1e-5 * abs(losses[0])
    norms = {k: float(g.norm()) for k, g in g1.items()}
    med = np.median(list(norms.values()))
    for name, prm in enc.master.named_parameters():
        if norms[name] < 1e-3 * med:  # moved by round-off alone (key biases)
            continue
        d_ref = (after[name] - w[name].double()).norm()
        d_port = (prm.detach().double() - w[name].double()).norm()
        assert abs(float(d_port - d_ref)) <= 1e-3 * float(d_ref) + 1e-9, name


def test_schedule_is_optax():
    from semanticsearch_tpu_torch.train.optim import (
        warmup_cosine_decay_schedule)

    s = warmup_cosine_decay_schedule(0.0, 3e-4, 7, 140, 3e-5)
    for c in (0, 3, 7, 50, 139, 200):
        assert ref_train.schedule(c, 3e-4, 140, 0.05) == pytest.approx(
            s(c), rel=1e-6, abs=1e-12)
