"""The port's flash attention against the JAX package's, on the same numpy
inputs: JAX ``flash_attention(..., interpret=True)`` against the port's
plain version (what a CPU tensor runs), rtol = atol = 2e-5 as in
test_flash_attention.py; gradients of the autograd Function against JAX's
custom_vjp at the JAX gradient test's 1e-4."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semanticsearch_tpu.ops.flash_attention import flash_attention as jflash
from semanticsearch_tpu_torch.ops import flash_attention as tfa


def _inputs(rng, b, h, t, dh, masked_tail=True):
    q, k, v = (rng.standard_normal((b, h, t, dh)).astype(np.float32)
               for _ in range(3))
    mask = np.ones((b, t), np.float32)
    if masked_tail:
        mask[:, t - t // 4:] = 0.0
    return q, k, v, mask


@pytest.mark.parametrize("b,h,t,dh,block", [
    (2, 4, 128, 32, 128),   # single kv block
    (2, 2, 256, 32, 128),   # streamed kv blocks
    (1, 2, 64, 16, 128),    # t < block
])
def test_flash_matches_jax(rng, b, h, t, dh, block):
    q, k, v, mask = _inputs(rng, b, h, t, dh)
    mask[0, :] = 0.0  # one row with every key masked: the mean of V
    want = jflash(*(jnp.asarray(x) for x in (q, k, v, mask)), block, block,
                  True)
    got = tfa.flash_attention(*(torch.from_numpy(x) for x in (q, k, v, mask)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(got.numpy()[0], v[0].mean(axis=1, keepdims=True)
                               .repeat(t, axis=1), rtol=2e-5, atol=2e-5)
    assert tfa.FLASH_LAUNCHES == 0  # CPU tensors take the plain version


def test_flash_gradients_match_jax(rng):
    b, h, t, dh = 1, 2, 128, 16
    q, k, v, mask = _inputs(rng, b, h, t, dh)

    def loss(q_, k_, v_):
        return jnp.sum(jflash(q_, k_, v_, jnp.asarray(mask), 128, 128,
                              True) ** 2)

    want = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    (tfa.flash_attention(tq, tk, tv, torch.from_numpy(mask)) ** 2).sum(
    ).backward()
    for g, w in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)
