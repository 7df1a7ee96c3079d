"""The port's reranker Preprocessor against the JAX package's.

Word mode (tf and df filtering) and subword mode: ``fit`` builds the same
vocabulary, ``transform_pair`` gives the same int32 ids and lengths
(truncation, unknown words, empty and non-ASCII texts included), and each
package's ``save`` loads in the other."""
import json

import numpy as np
import pytest

from semanticsearch_tpu.models.subword import train_bpe as j_train_bpe
from semanticsearch_tpu.train.vocab import Preprocessor as JPre
from semanticsearch_tpu.train.vocab import word_tokenize as j_word_tokenize
from semanticsearch_tpu_torch.models.subword import train_bpe as t_train_bpe
from semanticsearch_tpu_torch.train.vocab import PAD_ID, UNK_ID
from semanticsearch_tpu_torch.train.vocab import Preprocessor as TPre
from semanticsearch_tpu_torch.train.vocab import \
    word_tokenize as t_word_tokenize


def _texts(seed, n=60):
    rng = np.random.default_rng(seed)
    words = ["river", "rivers", "water", "flows", "Stone", "bridge", "solar",
             "panel", "grain", "market", "x9", "42", "héllo", "naïve"]
    return [" ".join(rng.choice(words, size=int(rng.integers(0, 40))))
            + (" ,.!?" if i % 3 else "") for i in range(n)]


def _assert_same_transform(jp, tp, lefts, rights):
    want = jp.transform_pair(lefts, rights)
    got = tp.transform_pair(lefts, rights)
    assert set(got) == set(want)
    for key in want:
        assert got[key].dtype == want[key].dtype == np.int32
        np.testing.assert_array_equal(got[key], want[key])


@pytest.mark.parametrize("mode,freq", [("tf", 1), ("tf", 5), ("df", 3)])
def test_word_mode_fit_and_transform(mode, freq):
    texts = _texts(0)
    kw = dict(fixed_length_left=6, fixed_length_right=17,
              filter_low_freq=freq, filter_mode=mode)
    jp, tp = JPre(**kw).fit(texts), TPre(**kw).fit(texts)
    assert tp.vocab == jp.vocab and tp.vocab_size == jp.vocab_size
    assert tp.vocab["<pad>"] == PAD_ID and tp.vocab["<unk>"] == UNK_ID
    lefts = _texts(1, 30) + ["", "unseen words only"]
    rights = _texts(2, 30) + ["river " * 40, ""]
    _assert_same_transform(jp, tp, lefts, rights)
    for t in lefts + rights:
        assert t_word_tokenize(t) == j_word_tokenize(t)


@pytest.fixture(scope="module")
def tokenizers():
    corpus = _texts(3, 200)
    j_tok = j_train_bpe(corpus, vocab_size=80, max_len=32)
    t_tok = t_train_bpe(corpus, vocab_size=80, max_len=32)
    assert t_tok.vocab == j_tok.vocab
    return j_tok, t_tok


def test_subword_mode_transform(tokenizers):
    j_tok, t_tok = tokenizers
    kw = dict(fixed_length_left=5, fixed_length_right=23)
    jp, tp = JPre(subword=j_tok, **kw), TPre(subword=t_tok, **kw)
    assert tp.fit(["ignored"]) is tp and tp.vocab == {}
    assert tp.vocab_size == jp.vocab_size
    _assert_same_transform(jp, tp, _texts(4, 30) + ["RIVERS"],
                           _texts(5, 30) + ["Waterflows"])


@pytest.mark.parametrize("subword", [False, True])
def test_save_and_load_both_ways(tmp_path, tokenizers, subword):
    j_tok, t_tok = tokenizers
    texts = _texts(6)
    kw = dict(fixed_length_left=7, fixed_length_right=19, filter_low_freq=2,
              filter_mode="df")
    jp = JPre(subword=j_tok if subword else None, **kw).fit(texts)
    tp = TPre(subword=t_tok if subword else None, **kw).fit(texts)
    jp.save(str(tmp_path / "j" / "preprocessor.json"))
    tp.save(str(tmp_path / "t" / "preprocessor.json"))
    with open(tmp_path / "j" / "preprocessor.json") as f:
        j_blob = json.load(f)
    with open(tmp_path / "t" / "preprocessor.json") as f:
        assert json.load(f) == j_blob
    t_from_j = TPre.load(str(tmp_path / "j" / "preprocessor.json"))
    j_from_t = JPre.load(str(tmp_path / "t" / "preprocessor.json"))
    assert (t_from_j.subword is not None) == subword
    if subword:
        assert type(t_from_j.subword).__module__.startswith(
            "semanticsearch_tpu_torch")
    lefts, rights = _texts(7, 20), _texts(8, 20)
    _assert_same_transform(jp, t_from_j, lefts, rights)
    _assert_same_transform(j_from_t, tp, lefts, rights)
