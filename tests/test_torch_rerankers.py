"""The port's eight rerankers and matching ops against the JAX package's.

Each JAX model is initialised from a seed (``model.init``); its flax tree
goes through ``reranker_state_dict`` into the port's module, and both
score the same seeded id batches. Everything is float32 on the CPU, where
the two packages differ only in summation order (XLA vs ATen einsums,
convolutions and LSTM steps): scores agree to rtol = atol = 1e-5, about a
hundred f32 ulps at the scores' scale. The batches hold rows whose right
side is all padding (masked maxima fall to -1e9, so those scores are
~1e8 and the relative tolerance is the binding one), an MVLSTM row with
fewer valid cells than ``top_k``, and Conv-KNRM's n = 2 convolution, whose
SAME padding is (0, 1)."""
import copy
import functools

import jax
import numpy as np
import pytest
import torch

from semanticsearch_tpu.models.encoder import \
    SentenceTransformerModel as JModel
from semanticsearch_tpu.models.rerankers import make_model as j_make
from semanticsearch_tpu.models.rerankers import \
    transfer_from_encoder as j_transfer
from semanticsearch_tpu.models.rerankers.base import MLPHead as JMLPHead
from semanticsearch_tpu.ops import matching as jm
from semanticsearch_tpu_torch.core.config import EncoderConfig as TCfg
from semanticsearch_tpu_torch.models.convert import (flax_to_state_dict,
                                                     reranker_flax_tree,
                                                     reranker_state_dict)
from semanticsearch_tpu_torch.models.encoder import SentenceTransformerModel
from semanticsearch_tpu_torch.models.rerankers import make_model as t_make
from semanticsearch_tpu_torch.models.rerankers import \
    transfer_from_encoder as t_transfer
from semanticsearch_tpu_torch.models.rerankers.base import MLPHead
from semanticsearch_tpu_torch.models.rerankers.conv2d_models import (
    _adaptive_max_pool_2d, _bins)
from semanticsearch_tpu_torch.ops import matching as tm

V, D, L, R = 60, 12, 9, 20
RTOL = ATOL = 1e-5

MODELS = {
    "knrm": {"kernel_num": 7},
    "conv_knrm": {"filters": 8, "kernel_num": 5, "max_ngram": 3},
    "arcii": {"kernel_1d_count": 4, "kernel_2d_count": (5, 6)},
    "esim": {"hidden_size": 7},
    "match_lstm": {"hidden_size": 6},
    "match_pyramid": {"kernel_count": (3, 4), "dpool_size": (3, 4)},
    "mvlstm": {"hidden_size": 5, "top_k": 10, "mlp_hidden": 6},
    "cross_encoder": {"num_layers": 2, "num_heads": 2, "mlp_dim": 16,
                      "max_positions": 32},
}


def _ids(seed, n=7, left=L, right=R):
    rng = np.random.default_rng(seed)
    lefts = rng.integers(1, V, (n, left)).astype(np.int32)
    rights = rng.integers(1, V, (n, right)).astype(np.int32)
    for i in range(n):  # ragged true lengths, pads at the end
        lefts[i, int(rng.integers(1, left + 1)):] = 0
        rights[i, int(rng.integers(1, right + 1)):] = 0
    rights[1] = 0            # a right side that is all padding
    lefts[2, 1:] = 0         # one left token x two right tokens: 2 cells,
    rights[2, 2:] = 0        # fewer than MVLSTM's top_k
    lefts[3, 0] = 0          # a pad inside the left side
    return lefts, rights


def _jax_scores(name, kw, seed, lefts, rights):
    """The JAX model's seeded parameters (numpy) and its scores; init and
    apply jitted (one compile each instead of op-by-op dispatch)."""
    jmodel = j_make(name, vocab_size=V, embed_dim=D, **kw)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(seed), lefts,
                                  rights)["params"]
    scores = jax.jit(jmodel.apply)({"params": params}, lefts, rights)
    return jax.tree.map(np.asarray, params), np.asarray(scores)


def _port(name, params, kw):
    model = t_make(name, vocab_size=V, embed_dim=D, **kw).eval()
    model.load_state_dict(reranker_state_dict(name, params, **kw))
    return model


def _score(model, lefts, rights):
    with torch.no_grad():
        return model(torch.from_numpy(lefts).long(),
                     torch.from_numpy(rights).long()).numpy()


@pytest.mark.parametrize("name", sorted(MODELS))
def test_reranker_matches_jax(name):
    kw = MODELS[name]
    lefts, rights = _ids(11)
    params, want = _jax_scores(name, kw, 3, lefts, rights)
    model = _port(name, params, kw)
    got = _score(model, lefts, rights)
    assert got.shape == want.shape == (len(lefts),)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    # the inverse conversion gives the flax tree back, bit for bit
    back = reranker_flax_tree(model)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for b, p in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        assert np.array_equal(b, p)


def test_match_pyramid_bins_round_half_to_even():
    """h = 5 into 2 bins: round(2.5) = 2, so [0, 2) and [2, 5), where
    adaptive_max_pool2d would take [0, 3) and [2, 5)."""
    assert _bins(5, 2) == [(0, 2), (2, 5)]
    assert _bins(7, 3) == [(0, 2), (2, 5), (5, 7)]
    x = torch.arange(5 * 7, dtype=torch.float32).reshape(1, 1, 5, 7)
    x[0, 0, 2, 0] = 100.0  # row 2 belongs to the second bin only
    pooled = _adaptive_max_pool_2d(x, (2, 3))
    assert float(pooled[0, 0, 0, 0]) == float(x[0, 0, :2, :2].max())
    assert float(pooled[0, 0, 1, 0]) == 100.0
    assert not torch.equal(pooled,
                           torch.nn.functional.adaptive_max_pool2d(x, (2, 3)))
    kw = {"kernel_count": (3, 4), "dpool_size": (2, 3)}
    lefts, rights = _ids(5, left=5, right=7)
    params, want = _jax_scores("match_pyramid", kw, 1, lefts, rights)
    got = _score(_port("match_pyramid", params, kw), lefts, rights)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("k,sigma,exact", [(21, 0.1, 0.001), (11, 0.1, 0.001),
                                           (5, 0.2, 0.01)])
def test_kernel_mus_sigmas(k, sigma, exact):
    jmu, jsig = jm.kernel_mus_sigmas(k, sigma, exact)
    tmu, tsig = tm.kernel_mus_sigmas(k, sigma, exact)
    np.testing.assert_allclose(tmu.numpy(), np.asarray(jmu), rtol=0,
                               atol=1e-7)
    np.testing.assert_array_equal(tsig.numpy(), np.asarray(jsig))


def test_cosine_match_matrix_with_a_zero_row():
    rng = np.random.default_rng(2)
    a = rng.standard_normal((3, 5, 8)).astype(np.float32)
    b = rng.standard_normal((3, 6, 8)).astype(np.float32)
    a[0, 2] = 0.0  # an exactly-zero embedding row (a zeroed pad row)
    b[1, 0] = 0.0
    want = np.asarray(jm.cosine_match_matrix(a, b))
    got = tm.cosine_match_matrix(torch.from_numpy(a), torch.from_numpy(b))
    assert torch.isfinite(got).all()
    assert float(got[0, 2].abs().max()) == 0.0
    assert float(got[1, :, 0].abs().max()) == 0.0
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_kernel_pooling_and_topk_flat():
    rng = np.random.default_rng(4)
    mm = rng.uniform(-1, 1, (4, 5, 7)).astype(np.float32)
    lm = (rng.random((4, 5)) < 0.7).astype(np.float32)
    rmask = (rng.random((4, 7)) < 0.7).astype(np.float32)
    rmask[2] = 0.0
    mus, sigmas = jm.kernel_mus_sigmas(11, 0.1, 0.001)
    want = np.asarray(jm.kernel_pooling(mm, lm, rmask, mus, sigmas))
    tmus, tsig = tm.kernel_mus_sigmas(11, 0.1, 0.001)
    got = tm.kernel_pooling(torch.from_numpy(mm), torch.from_numpy(lm),
                            torch.from_numpy(rmask), tmus, tsig)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert float(got[2].abs().max()) == 0.0  # masks inside every sum
    vals = rng.standard_normal((3, 4, 6)).astype(np.float32)
    np.testing.assert_array_equal(
        tm.topk_flat(torch.from_numpy(vals), 5).numpy(),
        np.asarray(jm.topk_flat(vals, 5)))


def test_mlp_head_matches_jax():
    x = np.random.default_rng(6).standard_normal((4, 9)).astype(np.float32)
    jhead = JMLPHead(hidden=(5, 3))
    params = jax.tree.map(np.asarray,
                          jhead.init(jax.random.PRNGKey(0), x)["params"])
    head = MLPHead(9, hidden=(5, 3)).eval()
    from semanticsearch_tpu_torch.models.convert import _convert, _links

    head.load_state_dict(_convert(_links(head), params))
    with torch.no_grad():
        got = head(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jhead.apply(
        {"params": params}, x)), rtol=RTOL, atol=ATOL)


ENC = dict(vocab_size=V, hidden_dim=D, num_layers=2, num_heads=2, mlp_dim=16,
           max_len=24, dtype="float32")
CE = {"num_layers": 2, "num_heads": 2, "mlp_dim": 16, "max_positions": 32}


@functools.lru_cache(maxsize=None)
def _jax_trees():
    """The JAX encoder's and cross-encoder's seeded trees (numpy)."""
    from semanticsearch_tpu.core.config import EncoderConfig as JCfg

    ids = np.ones((2, 8), np.int32)
    enc = jax.jit(JModel(JCfg(**ENC)).init)(jax.random.PRNGKey(2), ids,
                                            ids)["params"]
    ce = jax.jit(j_make("cross_encoder", vocab_size=V, embed_dim=D,
                        **CE).init)(jax.random.PRNGKey(9),
                                    *_ids(8, left=4, right=6))["params"]
    return jax.tree.map(np.asarray, enc), jax.tree.map(np.asarray, ce)


def _port_encoder(params, **over):
    cfg = {**ENC, **over}
    model = SentenceTransformerModel(TCfg(**cfg))
    model.load_state_dict(flax_to_state_dict(params, cfg["num_layers"]))
    return model


def test_transfer_from_encoder_matches_jax():
    enc_params, params = _jax_trees()
    enc = _port_encoder(enc_params)
    model = _port("cross_encoder", params, CE)
    want = reranker_state_dict("cross_encoder", jax.tree.map(
        np.asarray, j_transfer(params, enc_params)), **CE)
    got = t_transfer(model, enc)
    assert set(got) == set(want)
    for key in want:
        assert torch.equal(got[key], want[key]), key
    # neither module changed
    assert torch.equal(model.state_dict()["embedding.weight"],
                       torch.tensor(params["embedding"]["embedding"]))


def _mismatch(kind):
    """(JAX encoder tree, port encoder, JAX cross-encoder tree, port
    cross-encoder) differing from the matched pair in one respect."""
    enc_params, params = _jax_trees()
    enc_params, params = copy.deepcopy(enc_params), copy.deepcopy(params)
    enc_over, ce_over = {}, {}
    if kind == "vocab":  # token table shape
        table = enc_params["token_embed"]["embedding"]
        enc_params["token_embed"]["embedding"] = np.vstack([table, table[:1]])
        enc_over = {"vocab_size": V + 1}
    elif kind == "layers":  # the encoder stops before layer_1
        del enc_params["layer_1"]
        enc_over = {"num_layers": 1}
    elif kind == "heads":  # (D, 2, D/2) query/key/value kernels as 4 heads
        for layer in ("layer_0", "layer_1"):
            mha = params[layer]["MultiHeadDotProductAttention_0"]
            for n in ("query", "key", "value"):
                mha[n]["kernel"] = mha[n]["kernel"].reshape(D, 4, -1)
                mha[n]["bias"] = mha[n]["bias"].reshape(4, -1)
            mha["out"]["kernel"] = mha["out"]["kernel"].reshape(4, -1, D)
        ce_over = {"num_heads": 4}
    elif kind == "mlp":  # an MLP of 20 instead of 16
        for layer in ("layer_0", "layer_1"):
            blk = params[layer]
            blk["Dense_0"]["kernel"] = np.pad(blk["Dense_0"]["kernel"],
                                              ((0, 0), (0, 4)))
            blk["Dense_0"]["bias"] = np.pad(blk["Dense_0"]["bias"], (0, 4))
            blk["Dense_1"]["kernel"] = np.pad(blk["Dense_1"]["kernel"],
                                              ((0, 4), (0, 0)))
        ce_over = {"mlp_dim": 20}
    return (enc_params, _port_encoder(enc_params, **enc_over), params,
            _port("cross_encoder", params, {**CE, **ce_over}))


@pytest.mark.parametrize("kind", ["vocab", "layers", "heads", "mlp"])
def test_transfer_from_encoder_mismatches_raise(kind):
    enc_params, enc, params, model = _mismatch(kind)
    with pytest.raises(ValueError):
        j_transfer(params, enc_params)
    with pytest.raises(ValueError):
        t_transfer(model, enc)
