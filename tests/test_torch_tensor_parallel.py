"""Tensor- and data-parallel encoders and trainers in the port
(``parallel/tensor.py``, ``SentenceEncoder(mesh=...)``) against the JAX
package's on its CPU mesh.

Both packages start from one converted float32 flax tree. On a (data 2,
model 4) mesh the parameter layout matches JAX's parameter by parameter;
TP encodings agree with JAX's TP encode and with the port's single-device
encode to 2e-5 (JAX's own tolerance); one TP contrastive run and one
data-parallel MLM run give JAX's losses to 1e-4 relative and its masters to
1e-5 (the attention key biases to twice the summed learning rates: their
true gradient is zero, see tests/test_torch_encoder_train.py). The port's
meshes repeat the CPU device.
"""
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semanticsearch_tpu.core.config import EncoderConfig as JCfg
from semanticsearch_tpu.core.mesh import MeshSpec as JMeshSpec
from semanticsearch_tpu.core.mesh import make_mesh as jmake_mesh
from semanticsearch_tpu.models.encoder import SentenceEncoder as JEncoder
from semanticsearch_tpu.models.encoder import SentenceTransformerModel as JModel
from semanticsearch_tpu.train import encoder_train as jt
from semanticsearch_tpu.train import mlm_pretrain as jm
from semanticsearch_tpu_torch.core.config import EncoderConfig as TCfg
from semanticsearch_tpu_torch.core.mesh import MeshSpec, make_mesh
from semanticsearch_tpu_torch.models import encoder as tencoder
from semanticsearch_tpu_torch.models.convert import (_stack_links,
                                                     encoder_flax_tree,
                                                     flax_to_state_dict)
from semanticsearch_tpu_torch.models.encoder import SentenceEncoder as TEncoder
from semanticsearch_tpu_torch.parallel.tensor import (encoder_param_specs,
                                                      shard_encoder_params)
from semanticsearch_tpu_torch.train import encoder_train as tt
from semanticsearch_tpu_torch.train import mlm_pretrain as tm
from semanticsearch_tpu_torch.train.optim import warmup_cosine_decay_schedule

CPU = torch.device("cpu")
CFG = dict(vocab_size=512, hidden_dim=64, num_layers=2, num_heads=4,
           mlp_dim=128, max_len=32, dtype="float32")
TEXTS = [f"alpha beta gamma delta token {i} epsilon" for i in range(8)]
ATOL = 2e-5
PARAM_ATOL = 1e-5


def tmesh(data, model=1):
    return make_mesh(MeshSpec(data=data, model=model), [CPU] * (data * model))


def jmesh(data, model=1):
    return jmake_mesh(JMeshSpec(data=data, model=model),
                      devices=jax.devices("cpu")[:data * model])


@pytest.fixture(scope="module")
def tree():
    return jax.tree.map(np.asarray, JModel(JCfg(**CFG, attention="stock"))
                        .init(jax.random.PRNGKey(3),
                              jnp.zeros((1, 16), jnp.int32),
                              jnp.ones((1, 16), jnp.int32))["params"])


def _port(tree, mesh=None, **cfg):
    return TEncoder(TCfg(**{**CFG, **cfg}), device="cpu", mesh=mesh,
                    state_dict=flax_to_state_dict(tree, CFG["num_layers"]))


def _subtree(params, path):
    for key in path:
        params = params[key]
    return params


def test_tp_param_layout_matches_jax(tree):
    jenc = JEncoder(JCfg(**CFG), mesh=jmesh(2, 4), params=tree)
    tenc = _port(tree, tmesh(2, 4))
    assert tenc._tp == 4
    params = dict(tenc.model.named_parameters())
    specs = encoder_param_specs(params)
    leaf = {"ln": ("scale", "bias"), "embed": ("embedding",)}
    checked = 0
    for path, prefix, kind, _ in _stack_links("token_embed",
                                              CFG["num_layers"],
                                              CFG["num_heads"]):
        node = _subtree(jenc.params, path)
        for t_leaf, j_leaf in zip(("weight", "bias"),
                                  leaf.get(kind, ("kernel", "bias"))):
            name = f"{prefix}.{t_leaf}"
            j_arr = node[j_leaf]
            assert ("model" in tuple(j_arr.sharding.spec)) == \
                ("model" in specs[name]), name
            assert tenc._tp_shards[(0, 0)][name].numel() == \
                j_arr.addressable_shards[0].data.size, name
            checked += 1
    assert checked == len(params)
    # each model row's slices tile its parameters
    for name, p in params.items():
        if "model" in specs[name]:
            dim = specs[name].index("model")
            for i in range(2):
                torch.testing.assert_close(torch.cat(
                    [tenc._tp_shards[(i, j)][name] for j in range(4)], dim),
                    p, rtol=0, atol=0)
    assert specs["layers.0.attn.query.weight"] == ("model", None)
    assert tenc._tp_shards[(0, 0)]["layers.0.attn.query.weight"].shape == \
        (16, 64)
    assert specs["layers.0.attn.out.weight"] == (None, "model")
    assert specs["layers.0.mlp_in.weight"] == ("model", None)
    assert specs["layers.0.mlp_out.weight"] == (None, "model")
    assert specs["token_embed.weight"] == (None, None)


def test_tp_encode_matches_jax_and_single_device(tree):
    want = JEncoder(JCfg(**CFG), mesh=jmesh(2, 4), params=tree).encode(TEXTS)
    tp = _port(tree, tmesh(2, 4))
    got = tp.encode(TEXTS)
    assert got.shape == (8, 64)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got, _port(tree).encode(TEXTS), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(tp.encode_device(TEXTS[:5]).numpy(), got[:5],
                               rtol=0, atol=0)


def test_dp_encode_splits_rows_over_shards(tree, monkeypatch):
    """(data 4): one forward a shard on its row slice (flash counted a
    slice), the batch padded to the shard count, equal to one device."""
    calls = []
    orig = tencoder.flash_attention

    def spy(q, k, v, mask):
        calls.append(q.shape[0])
        return orig(q, k, v, mask)

    monkeypatch.setattr(tencoder, "flash_attention", spy)
    dp = _port(tree, tmesh(4), attention="flash")
    assert dp._n_data == 4 and dp._tp == 1 and dp.sharded
    got = dp.encode(TEXTS[:6])
    assert calls == [2] * (4 * CFG["num_layers"])
    np.testing.assert_allclose(got, _port(tree, attention="flash")
                               .encode(TEXTS[:6]), rtol=0, atol=1e-6)
    want = JEncoder(JCfg(**CFG), mesh=jmesh(4), params=tree).encode(TEXTS)
    np.testing.assert_allclose(_port(tree, tmesh(4)).encode(TEXTS), want,
                               rtol=0, atol=ATOL)


def test_tp_indivisible_config_falls_back_to_replication(caplog):
    cfg = TCfg(vocab_size=128, hidden_dim=48, num_layers=1, num_heads=3,
               mlp_dim=96, max_len=16, dtype="float32")
    mesh = tmesh(2, 4)
    enc = TEncoder(cfg, mesh=mesh, seed=0)
    assert enc._tp == 1
    params = dict(enc.model.named_parameters())
    with caplog.at_level(logging.WARNING):
        logging.getLogger("semsearch").addHandler(caplog.handler)
        try:
            shards = shard_encoder_params(params, mesh, cfg)
        finally:
            logging.getLogger("semsearch").removeHandler(caplog.handler)
    assert any("replicating" in r.message for r in caplog.records)
    assert len(shards) == 8
    for name, p in params.items():
        assert shards[(1, 3)][name].shape == p.shape
    out = enc.encode(TEXTS[:4])
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, TEncoder(cfg, device="cpu", seed=0)
                               .encode(TEXTS[:4]), rtol=0, atol=1e-6)


def test_tp_dropout_draws_the_single_device_masks(tree):
    """In training, the TP forward draws each dropout mask at full width in
    the single-device order, so a seeded step sees the same masks."""
    tp = _port(tree, tmesh(1, 4), dropout_rate=0.25)
    one = _port(tree, dropout_rate=0.25)
    ids, mask = one.tokenizer.encode_batch(TEXTS, max_len=16)
    ids = torch.from_numpy(ids.astype(np.int64))
    mask = torch.from_numpy(mask.astype(np.int64))
    outs = [enc.train_forward(ids, mask,
                              dict(enc.master.named_parameters()),
                              generator=torch.Generator().manual_seed(7))
            for enc in (tp, one)]
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=ATOL)


def _lr_sum(steps, lr):
    sched = warmup_cosine_decay_schedule(0.0, lr, max(1, int(steps * 0.05)),
                                         max(2, steps), lr * 0.1)
    return sum(sched(i) for i in range(steps))


def _assert_masters_close(jenc, tenc, key_bias_atol):
    got = encoder_flax_tree(tenc.master.state_dict(), CFG["num_layers"],
                            CFG["num_heads"])
    flat, _ = jax.tree_util.tree_flatten_with_path(got)
    for (path, g), w in zip(flat, jax.tree.leaves(jenc.params)):
        name = jax.tree_util.keystr(path)
        tol = key_bias_atol if "['key']['bias']" in name else PARAM_ATOL
        assert np.abs(g - np.asarray(w)).max() <= tol, name


def test_tp_contrastive_training_matches_jax(tree):
    """Three steps on (data 2, model 4): losses and updated masters equal
    JAX's TP run; the loss trajectory equals the port's one-device run."""
    kw = dict(epochs=3, batch_size=8, max_len_query=16, max_len_chunk=32,
              use_hard_negatives=False, seed=0, learning_rate=1e-3)
    pairs = [(f"query number {i}", f"chunk body text {i} {i}")
             for i in range(8)]
    jenc = JEncoder(JCfg(**CFG), mesh=jmesh(2, 4), params=tree)
    hj = jt.ContrastiveEncoderTrainer(jenc, jt.ContrastiveConfig(**kw)).fit(
        list(pairs))
    tenc = _port(tree, tmesh(2, 4))
    ht = tt.ContrastiveEncoderTrainer(tenc, tt.ContrastiveConfig(**kw)).fit(
        list(pairs))
    np.testing.assert_allclose([h["loss"] for h in ht],
                               [h["loss"] for h in hj], rtol=1e-4)
    assert ht[2]["loss"] < ht[0]["loss"]
    _assert_masters_close(jenc, tenc, 2 * _lr_sum(3, 1e-3))
    one = _port(tree)
    h1 = tt.ContrastiveEncoderTrainer(one, tt.ContrastiveConfig(**kw)).fit(
        list(pairs))
    np.testing.assert_allclose([h["loss"] for h in ht],
                               [h["loss"] for h in h1], atol=1e-4)
    # the served slices follow the trained masters
    np.testing.assert_allclose(tenc.encode(TEXTS), one.encode(TEXTS),
                               rtol=0, atol=ATOL)


def test_dp_mlm_training_matches_jax(tree):
    """Two epochs of MLM on (data 4): losses and masters equal JAX's run on
    a 4-device data mesh."""
    texts = [f"w{i % 7} x{i % 5} y{i % 3} z{i} the corpus" for i in range(16)]
    kw = dict(epochs=2, batch_size=8, max_len=32, learning_rate=1e-3,
              seed=3)
    jenc = JEncoder(JCfg(**CFG), mesh=jmesh(4), params=tree)
    hj = jm.MLMPretrainer(jenc, jm.MLMConfig(**kw)).fit(texts)
    tenc = _port(tree, tmesh(4))
    ht = tm.MLMPretrainer(tenc, tm.MLMConfig(**kw)).fit(texts)
    np.testing.assert_allclose([h["loss"] for h in ht],
                               [h["loss"] for h in hj], rtol=1e-4)
    _assert_masters_close(jenc, tenc, 2 * _lr_sum(4, 1e-3))


def test_load_encoder_on_mesh(tree, tmp_path):
    one = _port(tree)
    tt.save_encoder(one, str(tmp_path / "enc"))
    tp = tt.load_encoder(str(tmp_path / "enc"), device="cpu",
                         mesh=tmesh(2, 4))
    assert tp._tp == 4
    np.testing.assert_allclose(tp.encode(TEXTS), one.encode(TEXTS), rtol=0,
                               atol=ATOL)
    assert tencoder.get_encoder(TCfg(**CFG), "cpu", mesh=tmesh(2)) is \
        tencoder.get_encoder(TCfg(**CFG), "cpu", mesh=tmesh(2))


def test_neural_oie_tags_on_mesh_equal_single_device():
    from semanticsearch_tpu_torch.oie import neural as tn

    cfg = tn.NeuralOIEConfig(hidden_dim=32, num_layers=1, num_heads=2,
                             mlp_dim=64, max_len=32, max_words=16,
                             vocab_size=512)
    one = tn.NeuralOIE(cfg, device="cpu")
    meshed = tn.NeuralOIE(cfg, state_dict=one.model.state_dict(),
                          mesh=tmesh(4))
    assert len(meshed._data_devices) == 4
    rng = np.random.default_rng(0)
    words = [f"w{i}" for i in range(40)]
    sents = [list(rng.choice(words, size=rng.integers(3, 12)))
             for _ in range(11)]
    got = meshed.tag_sentences(sents, batch_size=6)  # rounded up to 8
    want = one.tag_sentences(sents, batch_size=6)
    assert len(got) == len(want) == 11
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
