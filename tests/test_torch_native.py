"""The port's native host kernels against the JAX package's native library
and against the port's own numpy versions.

Same seeded inputs through ``semanticsearch_tpu.native`` and
``semanticsearch_tpu_torch.native``: equal ids, equal tie order, equal f32
bits. The library builds here with the host ``g++``; the last tests build
it into a fresh directory from two processes at once, and with a compiler
that fails."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from semanticsearch_tpu import native as jnative
from semanticsearch_tpu.index.bm25 import BM25Okapi as JBM25
from semanticsearch_tpu.models.subword import train_bpe as j_train_bpe
from semanticsearch_tpu.models.tokenizer import HashingTokenizer as JHash
from semanticsearch_tpu_torch import native
from semanticsearch_tpu_torch.index.bm25 import BM25Okapi, tokenize
from semanticsearch_tpu_torch.index.bm25_tpu import DeviceBM25
from semanticsearch_tpu_torch.models.subword import SubwordTokenizer
from semanticsearch_tpu_torch.models.tokenizer import HashingTokenizer

_ROOT = Path(__file__).resolve().parent.parent

TEXTS = [
    "Hello, World!",
    "MiXeD CaSe 123 tokens-with-dashes",
    "",
    "unicode café naïve 東京 text",
    "x" * 500,                      # one run past the 256-byte token cap
    "Kelvin K İstanbul",        # str.lower() would map these INTO ascii
    "  leading and trailing spaces  ",
    "a1b2c3 " * 40,                  # more tokens than max_len
    "antidisestablishmentarianism supercalifragilistic " + "q" * 300,
]


@pytest.fixture(scope="module")
def jlib():
    if not jnative.ensure_built() or jnative.get_lib() is None:
        pytest.fail("the JAX package's native library did not build")
    return jnative


def _zipf_docs(rng, n_docs, vocab, s=1.1, doc_len=(3, 40)):
    words = [f"z{i}" for i in range(vocab)]
    p = 1.0 / np.arange(1, vocab + 1) ** s
    p /= p.sum()
    return [[words[t] for t in rng.choice(vocab, size=rng.integers(*doc_len),
                                          p=p)] for _ in range(n_docs)]


@pytest.mark.parametrize("max_len,add_cls", [(32, True), (8, False),
                                             (300, True)])
def test_hash_tokenizer_matches_jax_and_plain(jlib, max_len, add_cls):
    before = native.HASH_TOKENIZE_CALLS
    got = native.hash_tokenize_batch(TEXTS, 5000, max_len, add_cls)
    assert native.HASH_TOKENIZE_CALLS == before + 1
    want = jlib.hash_tokenize_batch(TEXTS, 5000, max_len, add_cls)
    tok = HashingTokenizer(vocab_size=5000, max_len=max_len, add_cls=add_cls)
    plain = tok.encode_batch_plain(TEXTS)
    jplain = JHash(vocab_size=5000, max_len=max_len, add_cls=add_cls)
    for a, b, c in zip(got, want, plain):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    np.testing.assert_array_equal(tok.encode_batch(TEXTS)[0], got[0])
    # the JAX Python path too, text by text
    for i, t in enumerate(TEXTS):
        enc = jplain.encode(t, max_len=max_len)
        assert got[0][i, :len(enc)].tolist() == enc


@pytest.mark.parametrize("max_len,add_cls", [(48, True), (6, False)])
def test_subword_tokenizer_matches_jax_and_plain(jlib, max_len, add_cls):
    rng = np.random.default_rng(3)
    corpus = [" ".join(d) for d in _zipf_docs(rng, 200, 300)]
    corpus += ["playing played player plays replay", "naïve café 東京"]
    jtok = j_train_bpe(corpus, vocab_size=400, max_len=max_len,
                       add_cls=add_cls)
    tok = SubwordTokenizer(dict(jtok.vocab), max_len=max_len,
                           add_cls=add_cls)
    texts = TEXTS + corpus[:20] + ["replaying unseenword z1z2z3", "Z0 z1"]
    before = native.SUBWORD_TOKENIZE_CALLS
    got = tok.encode_batch(texts)
    assert native.SUBWORD_TOKENIZE_CALLS == before + 1
    want = jlib.subword_tokenize_batch(texts, jtok._native_tables(), max_len,
                                       add_cls)
    plain = tok.encode_batch_plain(texts)
    for a, b, c in zip(got, want, plain):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    assert (got[0] == 2).any()  # some word decomposed to UNK


def _corpora():
    rng = np.random.default_rng(11)
    zipf = _zipf_docs(rng, 1500, 400, s=1.3, doc_len=(5, 30))
    vocab = [f"t{i}" for i in range(12)]
    base = [[vocab[j] for j in rng.integers(0, 12, size=6)]
            for _ in range(60)]
    ties = [list(d) for d in base for _ in range(4)]  # every doc 4 times
    negidf = [["common1", "common2", "common3"][: 2 + (i % 2)]
              for i in range(40)]
    return {"zipf": zipf, "ties": ties, "negidf": negidf}


CORPORA = _corpora()


def _queries(name, rng, n):
    docs = CORPORA[name]
    qs = []
    for _ in range(n):
        src = docs[rng.integers(len(docs))]
        qs.append(list(rng.choice(src, size=min(len(src),
                                                int(rng.integers(1, 6))))))
    return qs + [["not_in_vocab"], [], [docs[0][0]] * 3 + [docs[1][-1]]]


@pytest.mark.parametrize("name", sorted(CORPORA))
def test_bm25_score_batch_matches_jax_and_plain(jlib, name):
    docs = CORPORA[name]
    bm, jbm = BM25Okapi(docs), JBM25(docs)
    qs = _queries(name, np.random.default_rng(5), 25)
    before = native.BM25_SCORE_CALLS
    got = bm.get_scores_batch(qs)
    assert native.BM25_SCORE_CALLS == before + 1
    np.testing.assert_array_equal(got, jbm.get_scores_batch(qs))
    for qi, q in enumerate(qs):
        np.testing.assert_array_equal(got[qi], bm.get_scores(q))


@pytest.mark.parametrize("method", ["unpruned", "maxscore", "auto"])
@pytest.mark.parametrize("name", sorted(CORPORA))
@pytest.mark.parametrize("k", [1, 15, 50])
def test_bm25_topk_matches_jax_and_plain(jlib, name, method, k):
    """Both top-k kernels (and "auto", unpruned at this size), including
    MaxScore's hard cases: 4-way duplicated documents (a crowded
    threshold), Zipf stopword postings, k past the matched set (the fill
    path), and a corpus whose epsilon-floored IDF goes negative, where the
    kernels keep get_topk's sparse-path order (matched before fill)."""
    docs = CORPORA[name]
    bm, jbm = BM25Okapi(docs), JBM25(docs)
    qs = _queries(name, np.random.default_rng(k), 30)
    counter = ("BM25_TOPK_MAXSCORE_CALLS" if method == "maxscore"
               else "BM25_TOPK_CALLS")
    before = getattr(native, counter)
    gi, gs = bm.get_topk_batch(qs, k, n_threads=3, method=method)
    assert getattr(native, counter) == before + 1
    ji, js = jbm.get_topk_batch(qs, k, n_threads=2, method=method)
    np.testing.assert_array_equal(gi, ji)
    np.testing.assert_array_equal(gs, js)
    if name == "negidf":
        assert (bm.idf < 0).any()
    pi, ps = bm.get_topk_batch_plain(qs, k)
    k_eff = min(k, len(docs))
    for qi, q in enumerate(qs):
        if all(bm.idf[bm.vocab[t]] > 0 for t in q if t in bm.vocab):
            np.testing.assert_array_equal(gi[qi], pi[qi])
            np.testing.assert_array_equal(gs[qi], ps[qi])
            continue
        # a non-positive idf: get_topk's sparse-path contract
        full = bm.get_scores(q)
        touched = sorted({d for d, doc in enumerate(docs)
                          if any(t in doc for t in q if t in bm.vocab)})
        order = sorted(touched, key=lambda d: (-full[d], d))[:k_eff]
        fill = [d for d in range(len(docs)) if d not in order]
        np.testing.assert_array_equal(gi[qi], (order + fill)[:k_eff])
        np.testing.assert_array_equal(
            gs[qi], np.asarray([full[d] for d in order]
                               + [0.0] * (k_eff - len(order)), np.float32))


def test_bm25_topk_rejects_unknown_method():
    with pytest.raises(ValueError, match="method"):
        BM25Okapi([["a"]]).get_topk_batch([["a"]], 1, method="fast")


@pytest.mark.parametrize("weights,residual", [("int8", True), ("bf16", True),
                                              ("bf16", False)])
def test_rare_touch_and_device_post_match_plain(jlib, weights, residual):
    """bm25_rare_touch and bm25_device_post against DeviceBM25's numpy
    versions and the JAX library, on one dispatched chunk: equal touch
    lists and bits, equal certified rows and equal flags."""
    docs = CORPORA["zipf"]
    bm = BM25Okapi(docs)
    dev = DeviceBM25(bm, n_dense_terms=24, topk_device=16, query_chunk=64,
                     residual=residual, weights=weights, device="cpu")
    qs = _queries("zipf", np.random.default_rng(2), 60)[:64]
    full, err_ubs, touch, result = dev._dispatch_chunk(qs, 10)
    q_indptr, q_tids, q_w = full
    r_indptr, r_tids, r_w = dev._split(qs)[2]
    plain = dev.rare_touch_plain(r_indptr, r_tids, r_w)
    cap = int(np.sum(bm._inv_indptr[r_tids + 1] - bm._inv_indptr[r_tids]))
    jtouch = jlib.bm25_rare_touch(bm._inv_indptr, bm._inv_docs, bm._inv_quot,
                                  bm.idf, bm.k1, r_indptr, r_tids, r_w, cap)
    n = int(touch[0][-1])
    assert n > 0 and int(plain[0][-1]) == n
    np.testing.assert_array_equal(touch[0], plain[0])
    np.testing.assert_array_equal(touch[0], jtouch[0])
    for a, b in ((touch[1][:n], plain[1]), (touch[2][:n], plain[2]),
                 (touch[1][:n], jtouch[1][:n]), (touch[2][:n], jtouch[2][:n])):
        np.testing.assert_array_equal(a, b)
    vals, idx = dev._fetch(result, len(qs))
    args = (vals, idx, dev.topk_device, touch[0].copy(), touch[1][:n].copy(),
            q_indptr, q_tids, q_w, err_ubs, bm.n_docs, 10)
    before = native.BM25_DEVICE_POST_CALLS
    gi, gs, gf = native.bm25_device_post(bm._inv_indptr, bm._inv_docs,
                                         bm._inv_quot, bm.idf, bm.k1, *args)
    assert native.BM25_DEVICE_POST_CALLS == before + 1
    ji, js, jf = jlib.bm25_device_post(bm._inv_indptr, bm._inv_docs,
                                       bm._inv_quot, bm.idf, bm.k1, *args)
    pi, ps, pf = dev.device_post_plain(vals, idx, touch, q_indptr, q_tids,
                                       q_w, err_ubs, 10)
    for a, b in ((gi, ji), (gs, js), (gf, jf), (gf, pf)):
        np.testing.assert_array_equal(a, b)
    ok = gf == 0
    assert ok.sum() > len(qs) // 2
    np.testing.assert_array_equal(gi[ok], pi[ok])
    np.testing.assert_array_equal(gs[ok], ps[ok])
    hi, hs = bm.get_topk_batch_plain(qs, 10)
    np.testing.assert_array_equal(gi[ok], hi[ok])
    np.testing.assert_array_equal(gs[ok], hs[ok])


_BUILD = """
import sys
from pathlib import Path
from semanticsearch_tpu_torch import native
native.BUILD_DIR = Path(sys.argv[1])
ids, _ = native.hash_tokenize_batch(["hello world"], 5000, 4, True)
print(native.get_lib()._name, ids.tolist())
"""


def test_two_processes_building_at_once_both_load(tmp_path):
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD, str(tmp_path)],
                              cwd=_ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], [e for _, e in outs]
    want = HashingTokenizer(vocab_size=5000, max_len=4).encode_batch_plain(
        ["hello world"])[0].tolist()
    paths = set()
    for out, _ in outs:
        path, ids = out.strip().split(" ", 1)
        assert ids == str(want)
        paths.add(path)
    assert len(paths) == 1
    (lib,) = paths
    assert Path(lib).parent == tmp_path and Path(lib).exists()
    assert not list(tmp_path.glob("*.tmp"))


def test_failed_build_raises_instead_of_falling_back(tmp_path, monkeypatch):
    monkeypatch.setenv("CXX", "false")
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(native.NativeError, match="false failed"):
        native.get_lib()
    with pytest.raises(native.NativeError):
        HashingTokenizer(vocab_size=100).encode_batch(["a b"])
    with pytest.raises(native.NativeError):
        BM25Okapi([["a"], ["b"]]).get_topk_batch([["a"]], 1)
    assert not list(tmp_path.glob("*.so")) and not list(
        tmp_path.glob("*.tmp"))


def test_library_name_hashes_source_compiler_and_flags(monkeypatch):
    a = native._target()
    assert a.parent == native.BUILD_DIR
    assert a.name.startswith("libsemsearch_native-")
    monkeypatch.setenv("CXX", "clang++")
    b = native._target()
    monkeypatch.delenv("CXX")
    monkeypatch.setattr(native, "CXX_FLAGS", native.CXX_FLAGS + ["-g"])
    c = native._target()
    monkeypatch.setattr(native, "_cpu_id", lambda: "another cpu")
    assert len({a, b, c, native._target()}) == 4


def test_wrappers_take_only_their_dtypes():
    bm = BM25Okapi([["a", "b"], ["b"]])
    with pytest.raises(TypeError, match="int32"):
        native.bm25_score_batch(bm._indptr, bm._indices.astype(np.int64),
                                np.ones(3, np.float32), bm.idf,
                                np.zeros(2, np.int64), np.zeros(1, np.int64),
                                np.ones(1, np.float32), 1.5)


def test_pickled_indexes_coerce_ids_to_int32(tmp_path):
    """A bm25.pkl with int64 id arrays (an older layout of either package)
    loads with int32 ids, as the native kernels take."""
    import pickle

    from semanticsearch_tpu_torch.index.bm25 import load_bm25

    jbm = JBM25([tokenize("a b c"), tokenize("b c d"), tokenize("e")])
    jbm._ensure_inverted()
    jbm._indices = jbm._indices.astype(np.int64)
    jbm._inv_docs = jbm._inv_docs.astype(np.int64)
    with open(tmp_path / "bm25.pkl", "wb") as f:
        pickle.dump(jbm, f)
    bm = load_bm25(str(tmp_path / "bm25.pkl"))
    assert bm._indices.dtype == np.int32 and bm._inv_docs.dtype == np.int32
    ji, js = JBM25([tokenize("a b c"), tokenize("b c d"),
                    tokenize("e")]).get_topk_batch([["b", "e"]], 3)
    gi, gs = bm.get_topk_batch([["b", "e"]], 3)
    np.testing.assert_array_equal(gi, ji)
    np.testing.assert_array_equal(gs, js)
    assert os.path.getsize(tmp_path / "bm25.pkl") > 0
