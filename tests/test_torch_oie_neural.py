"""The port's neural OIE tagger against the JAX package's.

Both taggers start from one flax ``model.init`` tree (converted by
``models/convert.py::oie_tagger_state_dict``) on the same seeded corpus:
- silver BIO tags and their decoding are equal;
- logits agree to rtol = atol = 1e-5, and tags are equal wherever the
  top-two logit margin exceeds 1e-4 (float32 sums in each framework's own
  order);
- ``fit_silver`` gives per-epoch losses within 1e-4 relative over 3 epochs
  at hidden 32 and one layer (the same rng draws, batches and Adam), with
  the hash tokenizer and with a trained BPE vocabulary;
- checkpoints move both ways bit for bit (the port's npz write read by the
  JAX ``NeuralOIE.load``; JAX's npz and orbax writes read by the port);
- ``teacher_agreement``, ``extract`` and the neural enrich path are equal
  on a JAX-trained tagger loaded in both;
- the enrich self-check gate's three modes act as the JAX package's."""
import logging
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semanticsearch_tpu.oie import client as jc
from semanticsearch_tpu.oie import neural as jn
from semanticsearch_tpu.oie.heuristic import _tokens
from semanticsearch_tpu_torch.data.tsv import read_tsv, write_tsv
from semanticsearch_tpu_torch.models.convert import (oie_tagger_flax_tree,
                                                     oie_tagger_state_dict)
from semanticsearch_tpu_torch.oie import client as tc
from semanticsearch_tpu_torch.oie import neural as tn

TINY = dict(hidden_dim=32, num_layers=1, num_heads=2, mlp_dim=64,
            max_len=48, max_words=24, vocab_size=512, epochs=3,
            batch_size=32, seed=0)
LOSS_RTOL = 1e-4
LOGIT_TOL = 1e-5
MARGIN = 1e-4

_ADJ = ["old", "young", "tired", "famous", "local", "senior"]
_SUB = ["engineer", "farmer", "pilot", "teacher", "mayor", "doctor"]
_VERB = ["carried", "approved", "built", "painted", "visited", "repaired",
         "signed", "planted", "walks", "is reviewing"]
_OBJ = ["bridge", "budget", "house", "letter", "garden", "engine",
        "contract", "orchard"]


def _corpus(n, seed):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        s = (f"The {rng.choice(_ADJ)} {rng.choice(_SUB)} "
             f"{rng.choice(_VERB)} the {rng.choice(_OBJ)}.")
        if i % 4 == 0:  # teacher-negative sentences for the sampler
            s += " Blue cold green sky."
        if i % 5 == 0:
            s += f" It {rng.choice(_VERB)} fast."
        out.append(s)
    return out


def _cfgs(**over):
    kw = {**TINY, **over}
    return jn.NeuralOIEConfig(**kw), tn.NeuralOIEConfig(**kw)


def _tree(jcfg, tokenizer=None):
    return jax.tree.map(np.asarray,
                        jn.NeuralOIE(jcfg, tokenizer=tokenizer).params)


def _pair(over=None, tokenizers=(None, None)):
    jcfg, tcfg = _cfgs(**(over or {}))
    tree = _tree(jcfg, tokenizers[0])
    j = jn.NeuralOIE(jcfg, tokenizer=tokenizers[0], params=tree)
    t = tn.NeuralOIE(tcfg, tokenizer=tokenizers[1],
                     state_dict=oie_tagger_state_dict(tree), device="cpu")
    return j, t, tree


def test_silver_tags_and_decode_equal():
    texts = _corpus(40, 1) + ["The committee, which met on Tuesday, "
                              "approved the budget.", "short one", ""]
    from semanticsearch_tpu_torch.chunking.segmenter import extract_sentences

    n_pos = 0
    for text in texts:
        for sentence in extract_sentences(text):
            words = _tokens(sentence)
            tags = tn.silver_bio_tags(words)
            assert tags == jn.silver_bio_tags(words)
            assert tn.silver_spans(words) == jn.silver_spans(words)
            if tags is not None:
                n_pos += 1
                assert tn.decode_bio(words, tags) == jn.decode_bio(words,
                                                                   tags)
    assert n_pos > 30
    rng = np.random.default_rng(0)
    words = [f"w{i}" for i in range(12)]
    for _ in range(200):  # arbitrary tag strings, ids out of range included
        tags = rng.integers(-1, 9, size=12).tolist()
        assert tn.decode_bio(words, tags) == jn.decode_bio(words, tags)
    assert tn.BIO_TAGS == jn.BIO_TAGS


def test_converter_round_trip_bit_equal():
    jcfg, _ = _cfgs(num_layers=2)
    tree = _tree(jcfg)
    back = oie_tagger_flax_tree(oie_tagger_state_dict(tree), 2,
                                TINY["num_heads"])
    la, lb = jax.tree.leaves(tree), jax.tree.leaves(back)
    assert jax.tree.structure(tree) == jax.tree.structure(back)
    assert all(np.array_equal(a, b) for a, b in zip(la, lb))
    with pytest.raises(ValueError):
        oie_tagger_state_dict({"tag_head": tree["tag_head"]})


def _logits_both(j, t, sentences):
    ids, mask, starts, nwords = j._batch_arrays(sentences)
    t_arrays = t._batch_arrays(sentences)
    for a, b in zip((ids, mask, starts, nwords), t_arrays):
        assert np.array_equal(a, b)
    jl = np.asarray(j.model.apply({"params": j.params}, jnp.asarray(ids),
                                  jnp.asarray(mask)))
    with torch.no_grad():
        tl = t._logits(dict(t.model.named_parameters()),
                       torch.from_numpy(ids.astype(np.int64)),
                       torch.from_numpy(mask.astype(np.int64))).numpy()
    return jl, tl, starts, nwords


def _assert_tags_equal_off_ties(jl, jtags, ttags, starts, nwords):
    """Tags equal at every word whose top-two logit margin exceeds
    MARGIN; returns the count of such words."""
    checked = 0
    for i, (a, b) in enumerate(zip(jtags, ttags)):
        w = jl[i, starts[i, :nwords[i]]]
        top2 = np.sort(w, axis=-1)[:, -2:]
        clear = (top2[:, 1] - top2[:, 0]) > MARGIN
        assert np.array_equal(np.asarray(a)[clear], np.asarray(b)[clear])
        checked += int(clear.sum())
    return checked


@pytest.mark.parametrize("hash_tokenizer", [True, False])
def test_logits_and_tags_match_jax(hash_tokenizer):
    texts = _corpus(30, 2)
    toks = (None, None)
    if not hash_tokenizer:
        from semanticsearch_tpu.models.subword import train_bpe as jbpe
        from semanticsearch_tpu_torch.models.subword import train_bpe as tbpe

        toks = (jbpe(texts, vocab_size=200, max_len=TINY["max_len"]),
                tbpe(texts, vocab_size=200, max_len=TINY["max_len"]))
        assert toks[0].vocab == toks[1].vocab
    j, t, _ = _pair(tokenizers=toks)
    sentences = [_tokens(s) for text in texts for s in text.split(". ")]
    sentences = [w for w in sentences if len(w) >= 3]
    jl, tl, starts, nwords = _logits_both(j, t, sentences)
    np.testing.assert_allclose(tl, jl, rtol=LOGIT_TOL, atol=LOGIT_TOL)
    # batches of 8 with the last one padded, as both packages pad
    jtags = j.tag_sentences(sentences, batch_size=8)
    ttags = t.tag_sentences(sentences, batch_size=8)
    assert [len(x) for x in ttags] == [len(x) for x in jtags]
    assert all(x.dtype == np.int32 for x in ttags)
    assert _assert_tags_equal_off_ties(jl, jtags, ttags, starts, nwords) \
        > 0.9 * sum(nwords)
    assert t.tag_sentences([]) == []


@pytest.mark.parametrize("hash_tokenizer", [True, False])
def test_fit_silver_losses_match_jax(hash_tokenizer):
    corpus = _corpus(100, 0)
    toks = (None, None)
    if not hash_tokenizer:
        from semanticsearch_tpu.models.subword import train_bpe as jbpe
        from semanticsearch_tpu_torch.models.subword import train_bpe as tbpe

        toks = (jbpe(corpus, vocab_size=160, max_len=TINY["max_len"]),
                tbpe(corpus, vocab_size=160, max_len=TINY["max_len"]))
    j, t, _ = _pair(tokenizers=toks)
    jh, th = j.fit_silver(corpus), t.fit_silver(corpus)
    assert [r["epoch"] for r in th] == [0, 1, 2]
    jl = np.array([r["loss"] for r in jh])
    tl = np.array([r["loss"] for r in th])
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL, atol=0)
    assert tl[-1] < tl[0]
    # no gradient is left on the parameters
    assert all(p.grad is None for p in t.model.parameters())


def test_fit_silver_refuses_an_empty_corpus():
    _, tcfg = _cfgs()
    with pytest.raises(ValueError, match="no trainable sentences"):
        tn.NeuralOIE(tcfg, device="cpu").fit_silver(["", "one two"])


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A tagger trained by the JAX package on a BPE vocabulary, saved in
    the npz layout."""
    path = str(tmp_path_factory.mktemp("oie") / "jax_npz")
    cfg = jn.NeuralOIEConfig(**{**TINY, "epochs": 6})
    with pytest.MonkeyPatch.context() as m:
        m.setitem(sys.modules, "orbax.checkpoint", None)
        j = jn.train_neural_oie(_corpus(120, 1), cfg=cfg, save_dir=path,
                                bpe_vocab_size=256)
    return j, path


def _leaves_equal(a, b):
    la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert np.array_equal(np.asarray(x), np.asarray(y))


def test_jax_save_loads_in_port(trained, tmp_path):
    j, npz_path = trained
    for path in (npz_path, str(tmp_path / "orbax")):
        if path != npz_path:
            j.save(path)
            assert os.path.isdir(os.path.join(path, "state"))
        t = tn.NeuralOIE.load(path, device="cpu")
        assert t.cfg == tn.NeuralOIEConfig(**vars(j.cfg))
        assert t.tokenizer.vocab == j.tokenizer.vocab
        _leaves_equal(oie_tagger_flax_tree(t.model.state_dict(),
                                           TINY["num_layers"],
                                           TINY["num_heads"]), j.params)


def test_port_save_loads_in_jax(trained, tmp_path):
    j, npz_path = trained
    t = tn.NeuralOIE.load(npz_path, device="cpu")
    t.save(str(tmp_path / "port"))
    back = jn.NeuralOIE.load(str(tmp_path / "port"))
    _leaves_equal(back.params, j.params)
    assert back.tokenizer.vocab == j.tokenizer.vocab
    again = tn.NeuralOIE.load(str(tmp_path / "port"), device="cpu")
    for a, b in zip(again.model.state_dict().values(),
                    t.model.state_dict().values()):
        assert torch.equal(a, b)


def test_extract_and_teacher_agreement_match_jax(trained):
    j, path = trained
    t = tn.NeuralOIE.load(path, device="cpu")
    held_out = _corpus(24, 99) + ["", "   "]
    got = t.extract(held_out, batch_size=16)
    assert got == j.extract(held_out, batch_size=16)
    words = {w for text in held_out for w in _tokens(text)}
    assert any(got)
    for triples in got:  # the contract: every emitted word is in the text
        for tr in triples:
            for field in ("subject", "relation", "object"):
                assert set(tr[field].split()) <= words
    for texts, kw in ((_corpus(32, 7), {}), (_corpus(80, 8), {"sample": 16,
                                                              "seed": 3}),
                      ([], {}), (["blue cold green."], {})):
        assert t.teacher_agreement(texts, **kw) == \
            j.teacher_agreement(texts, **kw)
    assert t.teacher_agreement(_corpus(32, 7))["n_teacher_sentences"] > 0


def test_enrich_neural_byte_equal(trained, tmp_path):
    _, path = trained
    rows = [{"chunk_id": f"c{i}", "chunk_text": text}
            for i, text in enumerate(_corpus(10, 4) + [""])]
    src = tmp_path / "chunks.tsv"
    write_tsv(str(src), rows, ["chunk_id", "chunk_text"])
    jc.enrich_chunk_tsv(str(src), str(tmp_path / "j.tsv"),
                        extractor="neural", model_dir=path, batch_size=4,
                        json_sidecar=str(tmp_path / "j.json"))
    tc.enrich_chunk_tsv(str(src), str(tmp_path / "t.tsv"),
                        extractor="auto", model_dir=path, batch_size=4,
                        json_sidecar=str(tmp_path / "t.json"), device="cpu")
    for ext in ("tsv", "json"):
        with open(tmp_path / f"t.{ext}", "rb") as a, \
                open(tmp_path / f"j.{ext}", "rb") as b:
            assert a.read() == b.read()


def test_enrich_self_check_gate(trained, tmp_path, monkeypatch, caplog):
    """Below the agreement floor the enrich run warns, falls back to the
    heuristic, or aborts."""
    _, path = trained
    rows = [{"chunk_id": "c0",
             "chunk_text": "The old engineer carried the bridge."}]
    src, out = tmp_path / "chunks.tsv", tmp_path / "enriched.tsv"
    write_tsv(str(src), rows, ["chunk_id", "chunk_text"])
    monkeypatch.setattr(
        tn.NeuralOIE, "teacher_agreement",
        lambda self, texts, sample=64, seed=0: {
            "agreement": 0.1, "n_teacher_sentences": 20, "n_sampled": 40})
    pkg_logger = logging.getLogger("semsearch")
    pkg_logger.addHandler(caplog.handler)
    kw = dict(extractor="neural", model_dir=path, device="cpu")
    try:
        with pytest.raises(RuntimeError, match="teacher-agreement"):
            tc.enrich_chunk_tsv(str(src), str(out), on_low_agreement="error",
                                **kw)
        with caplog.at_level(logging.WARNING):
            assert tc.enrich_chunk_tsv(str(src), str(out),
                                       on_low_agreement="fallback", **kw) == 1
        assert any("OFF-DOMAIN" in r.message for r in caplog.records)
        jc.enrich_chunk_tsv(str(src), str(tmp_path / "heur.tsv"),
                            extractor="heuristic")
        with open(out, "rb") as a, open(tmp_path / "heur.tsv", "rb") as b:
            assert a.read() == b.read()  # the run used the heuristic
        caplog.clear()
        with caplog.at_level(logging.WARNING):
            assert tc.enrich_chunk_tsv(str(src), str(out), **kw) == 1
        assert any("OFF-DOMAIN" in r.message for r in caplog.records)
        assert "raw_oie_data" in next(read_tsv(str(out)))
        caplog.clear()
        with caplog.at_level(logging.WARNING):
            tc.enrich_chunk_tsv(str(src), str(out), self_check=0.0, **kw)
        assert not any("OFF-DOMAIN" in r.message for r in caplog.records)
    finally:
        pkg_logger.removeHandler(caplog.handler)


def test_unported_and_missing_device_raise(tmp_path):
    _, tcfg = _cfgs()
    # a mesh is taken (tests/test_torch_tensor_parallel.py tags on one)
    from semanticsearch_tpu_torch.core.mesh import MeshSpec, make_mesh

    mesh = make_mesh(MeshSpec(data=2), [torch.device("cpu")] * 2)
    assert len(tn.NeuralOIE(tcfg, mesh=mesh)._data_devices) == 2
    with pytest.raises(FileNotFoundError, match="neural-oie metadata"):
        tn.NeuralOIE.load(str(tmp_path), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tn.NeuralOIE(tcfg)
