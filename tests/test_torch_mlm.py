"""MLM pretraining in the port against the JAX package's: the host
corruption draws the same positions and ids from the same generator (bit
for bit), and two epochs from one converted float32 tree give the same
losses to 1e-4 relative."""
import jax
import jax.numpy as jnp
import numpy as np

from semanticsearch_tpu.core.config import EncoderConfig as JCfg
from semanticsearch_tpu.models.encoder import SentenceEncoder as JEncoder
from semanticsearch_tpu.models.encoder import SentenceTransformerModel as JModel
from semanticsearch_tpu.train import mlm_pretrain as jm
from semanticsearch_tpu_torch.core.config import EncoderConfig as TCfg
from semanticsearch_tpu_torch.models.convert import flax_to_state_dict
from semanticsearch_tpu_torch.models.encoder import SentenceEncoder as TEncoder
from semanticsearch_tpu_torch.train import mlm_pretrain as tm

SMALL = dict(vocab_size=200, hidden_dim=32, num_layers=2, num_heads=4,
             mlp_dim=64, max_len=64, dtype="float32", attention="stock")


def _encoders():
    tree = jax.tree.map(np.asarray, JModel(JCfg(**SMALL)).init(
        jax.random.PRNGKey(2), jnp.zeros((1, 16), jnp.int32),
        jnp.ones((1, 16), jnp.int32))["params"])
    return (JEncoder(JCfg(**SMALL), params=tree),
            TEncoder(TCfg(**SMALL), device="cpu",
                     state_dict=flax_to_state_dict(tree,
                                                   SMALL["num_layers"])))


def _texts(n=21):
    rng = np.random.default_rng(8)
    words = ["".join(rng.choice(list("abcdefg"), 3)) for _ in range(50)]
    return [" ".join(rng.choice(words, int(rng.integers(1, 40))))
            for _ in range(n)] + [""]


def test_corrupt_is_bit_equal():
    j, t = _encoders()
    ids, mask = t.tokenizer.encode_batch(_texts()[:8], max_len=32)
    mask[3] = 0  # a row with no real token
    got = tm.MLMPretrainer(t)._corrupt(np.random.default_rng(1), ids, mask, 5)
    want = jm.MLMPretrainer(j)._corrupt(np.random.default_rng(1), ids, mask,
                                        5)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)


def test_fit_matches_jax():
    j, t = _encoders()
    cfg = dict(epochs=2, batch_size=8, max_len=32, learning_rate=1e-3,
               seed=3)
    hj = jm.MLMPretrainer(j, jm.MLMConfig(**cfg)).fit(_texts())
    ht = tm.MLMPretrainer(t, tm.MLMConfig(**cfg)).fit(_texts())
    assert len(ht) == len(hj) == 2
    for a, b in zip(ht, hj):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-4)
