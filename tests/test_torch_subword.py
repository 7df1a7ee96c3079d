"""The port's subword tokenizer against the JAX package's.

``train_bpe`` learns the same merges (the same vocabulary, piece for piece
and id for id), ``encode_batch`` gives the same ids, the saved
``tokenizer.json`` reads in both packages, and a port engine serves a
JAX-built index directory that holds one with the JAX engine's hits."""
import json

import numpy as np
import pytest

from semanticsearch_tpu.core.config import EncoderConfig as JCfg
from semanticsearch_tpu.index.query_engine import HybridQueryEngine as JEngine
from semanticsearch_tpu.models import subword as jsub
from semanticsearch_tpu.models.encoder import SentenceEncoder as JEncoder
from semanticsearch_tpu_torch.core.config import EncoderConfig as TCfg
from semanticsearch_tpu_torch.data.tsv import write_tsv
from semanticsearch_tpu_torch.index.query_engine import (
    TOKENIZER_FILE, HybridQueryEngine as TEngine,
)
from semanticsearch_tpu_torch.models import subword as tsub
from semanticsearch_tpu_torch.models.convert import flax_to_state_dict
from semanticsearch_tpu_torch.models.encoder import SentenceEncoder as TEncoder
from semanticsearch_tpu_torch.models.tokenizer import (
    HashingTokenizer, load_tokenizer,
)


def _texts(seed, n=300, vocab=400):
    rng = np.random.default_rng(seed)
    stems = ["".join(rng.choice(list("abcdefghijklmnop"),
                                size=int(rng.integers(3, 9))))
             for _ in range(vocab)]
    suffixes = ["", "s", "ing", "ed", "er", "ly"]
    p = 1.0 / np.arange(1, vocab + 1) ** 1.1
    p /= p.sum()
    return [" ".join(stems[t] + suffixes[int(rng.integers(6))]
                     for t in rng.choice(vocab, size=int(rng.integers(3, 25)),
                                         p=p))
            + (" Café NAÏVE 東京 K" if i % 17 == 0 else "")
            for i in range(n)]


@pytest.mark.parametrize("seed,vocab_size,min_pair_freq", [
    (0, 300, 2), (1, 800, 2), (2, 2000, 1), (3, 120, 5)])
def test_train_bpe_learns_the_jax_merges(seed, vocab_size, min_pair_freq):
    texts = _texts(seed)
    mine = tsub.train_bpe(texts, vocab_size=vocab_size,
                          min_pair_freq=min_pair_freq)
    theirs = jsub.train_bpe(texts, vocab_size=vocab_size,
                            min_pair_freq=min_pair_freq)
    assert mine.vocab == theirs.vocab
    assert mine.vocab_size == theirs.vocab_size


def test_train_from_counts_matches_jax():
    counts = {"lower": 5, "lowest": 2, "newer": 6, "wider": 3, "new": 9,
              "x" * 40: 4, "": 3}
    mine = tsub.train_bpe_from_counts(counts, vocab_size=60)
    assert mine.vocab == jsub.train_bpe_from_counts(counts,
                                                    vocab_size=60).vocab
    # no piece longer than the longest-match window
    assert max(len(p.lstrip("#")) for p in mine.vocab) <= tsub._MAX_PIECE_CHARS


@pytest.mark.parametrize("max_len,add_cls", [(64, True), (5, False)])
def test_encode_batch_gives_the_jax_ids(max_len, add_cls):
    texts = _texts(4, n=120)
    jtok = jsub.train_bpe(texts[:80], vocab_size=500, max_len=max_len,
                          add_cls=add_cls)
    tok = tsub.SubwordTokenizer(dict(jtok.vocab), max_len=max_len,
                                add_cls=add_cls)
    queries = texts[80:] + ["", "unseen qqqzzz words", "a" * 400]
    for got, want in zip(tok.encode_batch(queries),
                         jtok.encode_batch(queries)):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(tok.encode_batch(queries, max_len=max_len + 7),
                         tok.encode_batch_plain(queries,
                                                max_len=max_len + 7)):
        np.testing.assert_array_equal(got, want)
    assert tok.encode_word("qqqzzz") == jtok.encode_word("qqqzzz")


def test_tokenizer_json_reads_in_both_packages(tmp_path):
    texts = _texts(5, n=60)
    mine = tsub.train_bpe(texts, vocab_size=300, max_len=40, add_cls=False)
    mine.save(str(tmp_path / "port.json"))
    theirs = jsub.SubwordTokenizer.load(str(tmp_path / "port.json"))
    assert theirs.vocab == mine.vocab and theirs.max_len == 40
    assert theirs.add_cls is False
    theirs.save(str(tmp_path / "jax.json"))
    back = tsub.SubwordTokenizer.load(str(tmp_path / "jax.json"))
    assert back.vocab == mine.vocab
    with open(tmp_path / "jax.json") as f:
        assert json.load(f)["format"] == "semanticsearch_tpu.subword.v1"
    for got, want in zip(back.encode_batch(texts), theirs.encode_batch(texts)):
        np.testing.assert_array_equal(got, want)


def test_load_tokenizer_resolves_each_kind(tmp_path):
    tok = tsub.train_bpe(_texts(6, n=40), vocab_size=200)
    tok.save(str(tmp_path / "tok.json"))
    got = load_tokenizer(str(tmp_path / "tok.json"), max_len=17)
    assert isinstance(got, tsub.SubwordTokenizer) and got.max_len == 17
    assert got.vocab == tok.vocab
    for name in (None, str(tmp_path / "missing.json"),
                 str(tmp_path / "not_a_tokenizer_dir")):
        fallback = load_tokenizer(name, vocab_size=777, max_len=9)
        assert isinstance(fallback, HashingTokenizer)
        assert (fallback.vocab_size, fallback.max_len) == (777, 9)


ENC = dict(hidden_dim=32, num_layers=1, num_heads=2, mlp_dim=64, max_len=32,
           dtype="float32")


def test_port_serves_a_jax_index_with_its_tokenizer(tmp_path):
    """The JAX engine builds over a trained vocabulary and persists it; the
    port loads the directory with an encoder that carries the hashing
    tokenizer, swaps in ``tokenizer.json`` and answers with the JAX
    engine's hits."""
    texts = _texts(7, n=50)
    jtok = jsub.train_bpe(texts, vocab_size=400)
    rows = [{"chunk_id": f"c{i}", "query_id": "", "document_id": f"d{i}",
             "chunk_text": t} for i, t in enumerate(texts)]
    chunks = str(tmp_path / "chunks.tsv")
    write_tsv(chunks, rows, ["chunk_id", "query_id", "document_id",
                             "chunk_text"])
    jcfg = JCfg(vocab_size=jtok.vocab_size, **ENC)
    jenc = JEncoder(jcfg, seed=3, tokenizer=jtok)
    jeng = JEngine.build(chunks, jenc, str(tmp_path / "idx"))
    assert (tmp_path / "idx" / TOKENIZER_FILE).exists()
    tenc = TEncoder(TCfg(vocab_size=jtok.vocab_size, **ENC), device="cpu",
                    state_dict=flax_to_state_dict(jenc.params, 1))
    assert isinstance(tenc.tokenizer, HashingTokenizer)
    teng = TEngine.load(str(tmp_path / "idx"), tenc, device="cpu")
    assert isinstance(tenc.tokenizer, tsub.SubwordTokenizer)
    assert tenc.tokenizer.vocab == jtok.vocab
    queries = [" ".join(t.split()[:4]) for t in texts[:12]] + ["zzz qqq"]
    for jq, tq in zip(jeng.search(queries, k=5), teng.search(queries, k=5)):
        assert [h.chunk_id for h in tq] == [h.chunk_id for h in jq]
        assert [h.dense_rank for h in tq] == [h.dense_rank for h in jq]
        assert [h.lexical_rank for h in tq] == [h.lexical_rank for h in jq]
        np.testing.assert_allclose([h.score for h in tq],
                                   [h.score for h in jq], rtol=0, atol=1e-9)


def test_port_build_persists_its_tokenizer(tmp_path):
    texts = _texts(8, n=30)
    tok = tsub.train_bpe(texts, vocab_size=300)
    rows = [{"chunk_id": f"c{i}", "chunk_text": t}
            for i, t in enumerate(texts)]
    chunks = str(tmp_path / "chunks.tsv")
    write_tsv(chunks, rows, ["chunk_id", "chunk_text"])
    cfg = TCfg(vocab_size=tok.vocab_size, **ENC)
    enc = TEncoder(cfg, device="cpu", seed=1, tokenizer=tok)
    built = TEngine.build(chunks, enc, str(tmp_path / "idx"), device="cpu")
    saved = tsub.SubwordTokenizer.load(str(tmp_path / "idx" / TOKENIZER_FILE))
    assert saved.vocab == tok.vocab
    fresh = TEncoder(cfg, device="cpu", seed=1)
    loaded = TEngine.load(str(tmp_path / "idx"), fresh, device="cpu")
    q = [" ".join(t.split()[:3]) for t in texts[:6]]
    assert [[h.chunk_id for h in r] for r in loaded.search(q, k=4)] == \
        [[h.chunk_id for h in r] for r in built.search(q, k=4)]
    assert loaded.search(q[:1], k=1)[0][0].chunk_id == "c0"
