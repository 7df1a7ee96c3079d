"""The port's sentence encoder against the JAX package's, with the JAX
parameters converted by models/convert.py. float32 throughout; embeddings
agree to rtol = atol = 1e-4 (the two frameworks sum in different orders,
and the stock paths differ in LayerNorm's variance formula). One device's
forwards run packed (texts' real tokens end to end): against the padded
forward of the same model to 1e-6 in float32 and 2e-2 in bfloat16 (the
bf16 tolerance of the encoder's training tests: activations round at 2^-8,
and the two layouts sum attention's keys in different orders)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semanticsearch_tpu.core.config import EncoderConfig as JCfg
from semanticsearch_tpu.models.encoder import (
    SentenceEncoder as JEncoder,
    SentenceTransformerModel as JModel,
)
from semanticsearch_tpu_torch.core.config import EncoderConfig as TCfg
from semanticsearch_tpu_torch.models import encoder as encoder_mod
from semanticsearch_tpu_torch.models.convert import flax_to_state_dict
from semanticsearch_tpu_torch.models.encoder import (
    SentenceEncoder as TEncoder,
    SentenceTransformerModel as TModel,
    use_flash,
)
from semanticsearch_tpu_torch.models.tokenizer import HashingTokenizer
from semanticsearch_tpu_torch.ops.flash_attention import Varlen

SMALL = dict(vocab_size=512, hidden_dim=64, num_layers=2, num_heads=4,
             mlp_dim=128, max_len=256, dtype="float32")
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def jax_params():
    cfg = JCfg(**SMALL, attention="stock")
    return jax.tree.map(np.asarray, JModel(cfg).init(
        jax.random.PRNGKey(3), jnp.zeros((1, 64), jnp.int32),
        jnp.ones((1, 64), jnp.int32))["params"])


@pytest.mark.parametrize("attention", ["stock", "flash"])
def test_forward_matches_jax(rng, jax_params, attention):
    b, t = 3, 128
    ids = rng.integers(3, SMALL["vocab_size"], size=(b, t)).astype(np.int32)
    mask = np.zeros((b, t), np.int32)
    for i, n in enumerate((128, 70, 5)):
        mask[i, :n] = 1
    jcfg = JCfg(**SMALL, attention=attention)
    want = JModel(jcfg).apply({"params": jax_params}, jnp.asarray(ids),
                              jnp.asarray(mask))
    model = TModel(TCfg(**SMALL, attention=attention))
    model.load_state_dict(flax_to_state_dict(jax_params, SMALL["num_layers"]))
    got = model(torch.from_numpy(ids).long(), torch.from_numpy(mask))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    tokens = model(torch.from_numpy(ids).long(), torch.from_numpy(mask),
                   return_tokens=True)
    want_tokens = JModel(jcfg).apply({"params": jax_params}, jnp.asarray(ids),
                                     jnp.asarray(mask), return_tokens=True)
    np.testing.assert_allclose(tokens.detach().numpy(),
                               np.asarray(want_tokens), **TOL)


@pytest.mark.parametrize("lengths", [(256, 64, 3), (200, 1, 129)])
def test_flash_forward_with_dead_key_blocks_matches_jax(rng, jax_params,
                                                        lengths):
    """The flash path at T = 256, where rows of 64, 3 or 1 real tokens
    leave whole 64-key blocks without a real key (blocks the kernel skips):
    embeddings and token states match the JAX encoder's."""
    b, t = len(lengths), 256
    ids = rng.integers(3, SMALL["vocab_size"], size=(b, t)).astype(np.int32)
    mask = (np.arange(t)[None, :] < np.asarray(lengths)[:, None]).astype(
        np.int32)
    jcfg = JCfg(**SMALL, attention="flash")
    model = TModel(TCfg(**SMALL, attention="flash"))
    model.load_state_dict(flax_to_state_dict(jax_params, SMALL["num_layers"]))
    for tokens in (False, True):
        want = JModel(jcfg).apply({"params": jax_params}, jnp.asarray(ids),
                                  jnp.asarray(mask), return_tokens=tokens)
        got = model(torch.from_numpy(ids).long(), torch.from_numpy(mask),
                    return_tokens=tokens)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   **TOL)


def test_encode_buckets_match_jax(jax_params):
    """Texts of every bucket (64/128/256) in mixed order: reassembly keeps
    input order, and embeddings match the JAX encoder's."""
    words = [f"w{i}" for i in range(400)]
    lengths = [3, 200, 90, 10, 250, 60, 120, 1]
    texts = [" ".join(words[j % 400] for j in range(i, i + n))
             for i, n in enumerate(lengths)]
    jenc = JEncoder(JCfg(**SMALL, attention="stock"), params=jax_params)
    tenc = TEncoder(TCfg(**SMALL, attention="stock"), device="cpu",
                    state_dict=flax_to_state_dict(jax_params,
                                                  SMALL["num_layers"]))
    np.testing.assert_allclose(tenc.encode(texts, batch_size=2),
                               jenc.encode(texts), **TOL)
    assert tenc.encode_device(texts).device.type == "cpu"


def _texts_of(lengths):
    """Texts of exactly these word counts (a word a token)."""
    words = [f"w{i}" for i in range(400)]
    return [" ".join(words[(5 * i + j) % 400] for j in range(n))
            for i, n in enumerate(lengths)]


@pytest.mark.parametrize("attention", ["stock", "flash"])
def test_packed_encode_matches_jax(jax_params, attention):
    """One device's forwards run packed, three texts a forward in input
    order over lengths that the buckets would split: ``encode`` and
    ``encode_device`` match the JAX encoder row by row."""
    texts = _texts_of([3, 200, 90, 10, 250, 60, 120, 1, 64, 65])
    jenc = JEncoder(JCfg(**SMALL, attention=attention), params=jax_params)
    tenc = TEncoder(TCfg(**SMALL, attention=attention), device="cpu",
                    state_dict=flax_to_state_dict(jax_params,
                                                  SMALL["num_layers"]))
    want = jenc.encode(texts)
    before = encoder_mod.PACKED_FORWARDS
    np.testing.assert_allclose(tenc.encode(texts, batch_size=3), want,
                               **TOL)
    got = tenc.encode_device(texts, batch_size=3)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert encoder_mod.PACKED_FORWARDS - before == 2 * 4


PACKED_LENGTHS = [1, 2, 63, 64, 65, 256, 7, 130]


@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("pooling", ["mean", "cls"])
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-6), ("bfloat16", 2e-2)])
def test_packed_forward_matches_padded(dtype, tol, pooling, normalize):
    """The packed forward of texts of 1, 2, 63, 64, 65, 256, 7 and 130
    tokens equals the padded forward of the same model at T = 256, with and
    without a text of no token among them: packed under mean pooling (the
    empty text pools to 0), padded under cls pooling (the empty text's first
    position is a pad, which packing has no place for) and then bit for
    bit."""
    cfg = TCfg(**dict(SMALL, dtype=dtype), pooling=pooling,
               normalize=normalize, attention="flash")
    tok = HashingTokenizer(vocab_size=SMALL["vocab_size"], max_len=256,
                           add_cls=False)
    enc = TEncoder(cfg, device="cpu", seed=5, tokenizer=tok)
    for lengths in (PACKED_LENGTHS, PACKED_LENGTHS[:3] + [0]
                    + PACKED_LENGTHS[3:]):
        texts = _texts_of(lengths)
        ids, mask = tok.encode_batch(texts, max_len=256)
        assert mask.sum(axis=1).tolist() == lengths
        with torch.no_grad():
            want = enc.model(torch.from_numpy(ids).long(),
                             torch.from_numpy(mask)).numpy()
        before = encoder_mod.PACKED_FORWARDS
        got = enc.encode_device(texts, batch_size=len(texts)).numpy()
        packed = pooling == "mean" or 0 not in lengths
        assert encoder_mod.PACKED_FORWARDS - before == int(packed)
        if packed:
            np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
        else:
            np.testing.assert_array_equal(got, want)
        if 0 in lengths and pooling == "mean":
            assert not got[3].any()


def test_tokenizer_ids_match_jax():
    from semanticsearch_tpu.models.tokenizer import HashingTokenizer as JTok

    texts = ["The quick brown fox, 42 times!", "KKelvin ünïcode mix",
             "", "a" * 300 + " b"]
    for L in (8, 64):
        got = HashingTokenizer(vocab_size=30522).encode_batch(texts, L)
        want = JTok(vocab_size=30522).encode_batch(texts, L)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_attention_rule():
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    base = TCfg()
    assert not use_flash(base, cuda)  # auto below max_len 1024: stock
    assert use_flash(dataclasses.replace(base, max_len=1024), cuda)
    assert not use_flash(dataclasses.replace(base, max_len=1024), cpu)
    assert not use_flash(
        dataclasses.replace(base, max_len=1024, dropout_rate=0.1), cuda)
    assert use_flash(dataclasses.replace(base, attention="flash"), cpu)
    assert not use_flash(dataclasses.replace(base, attention="stock",
                                             max_len=1024), cuda)


def test_cuda_default_without_card_is_an_error():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TEncoder(TCfg(**SMALL))


class _Failing(torch.nn.Module):
    """The encoder's model, raising ``error`` on batches of more than
    ``limit`` texts; counts the batch sizes it ran."""

    def __init__(self, model, limit, error):
        super().__init__()
        self.model, self.limit, self.error = model, limit, error
        self.sizes = []

    def forward(self, ids, mask):
        rows = mask.rows if isinstance(mask, Varlen) else ids.shape[0]
        if rows > self.limit:
            raise self.error
        self.sizes.append(rows)
        return self.model(ids, mask)

    def packs(self, lens):
        return self.model.packs(lens)


def _oom_texts():
    words = [f"w{i}" for i in range(300)]
    return [" ".join(words[(7 * i + j) % 300] for j in range(n))
            for i, n in enumerate([5, 70, 9, 3, 100, 40, 2, 80, 11, 6, 90,
                                   30, 4, 65, 8, 50, 7, 1, 33, 12])]


@pytest.mark.parametrize("entry,where", [("encode", "launch"),
                                         ("encode", "fetch"),
                                         ("encode_device", "launch")])
def test_out_of_memory_halves_the_batch(entry, where, monkeypatch):
    """A forward pass out of device memory above 2 texts, raised at the
    launch or (``encode``, asynchronous launches) only at the fetch of an
    earlier batch: the bucket restarts from the failed batch at half the
    size, down to 2, and the embeddings equal an unfailing run at 2."""
    enc = TEncoder(TCfg(**SMALL), device="cpu", seed=4)
    texts = _oom_texts()
    want = enc.encode(texts, batch_size=2)
    oom = torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to "
                                      "allocate 2.00 GiB")
    if where == "launch":
        enc.model = _Failing(enc.model, 2, oom)
    else:
        fetch = enc._fetch

        def late_oom(emb):  # the failure of a launch, surfacing at its sync
            if emb.shape[0] > 2:
                raise RuntimeError("CUDA error: out of memory")
            return fetch(emb)
        monkeypatch.setattr(enc, "_fetch", late_oom)
    got = getattr(enc, entry)(texts, batch_size=8)
    got = got if isinstance(got, np.ndarray) else got.numpy()
    np.testing.assert_array_equal(got, want)
    if where == "launch":
        assert max(enc.model.sizes) == 2


@pytest.mark.parametrize("entry", ["encode", "encode_device"])
def test_other_errors_propagate(entry):
    enc = TEncoder(TCfg(**SMALL), device="cpu", seed=4)
    enc.model = _Failing(enc.model, 2, ValueError("bad shapes"))
    with pytest.raises(ValueError, match="bad shapes"):
        getattr(enc, entry)(_oom_texts(), batch_size=8)
    # out of memory at a batch of one text cannot halve: it propagates
    enc.model = _Failing(enc.model.model, 0, torch.cuda.OutOfMemoryError(
        "out of memory"))
    with pytest.raises(torch.cuda.OutOfMemoryError):
        getattr(enc, entry)(_oom_texts(), batch_size=8)
