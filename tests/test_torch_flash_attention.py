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


def _block_mask(t, spans):
    """(t,) mask with 1 on each [lo, hi) span: whole 64-key blocks between
    the spans hold no real key."""
    m = np.zeros(t, np.float32)
    for lo, hi in spans:
        m[lo:hi] = 1.0
    return m


@pytest.mark.parametrize("b,h,t,dh,rows", [
    # the encoder's layout: (B, T, H, Dh) tensors seen as (B, H, T, Dh)
    (2, 4, 128, 32, [[(0, 128)], [(0, 40)]]),
    # dead blocks trailing, leading and between live ones; a row with
    # every key masked (the mean of V)
    (4, 2, 256, 16, [[(0, 64)], [(200, 250)], [(0, 30), (192, 220)], []]),
    (3, 3, 192, 64, [[(5, 6)], [], [(64, 192)]]),
    (2, 2, 64, 32, [[(0, 3)], []]),  # the chunking batch's one block
])
def test_flash_transposed_views_match_jax(rng, b, h, t, dh, rows):
    q, k, v = (rng.standard_normal((b, t, h, dh)).astype(np.float32)
               for _ in range(3))
    mask = np.stack([_block_mask(t, spans) for spans in rows])
    want = jflash(*(jnp.asarray(np.ascontiguousarray(x.transpose(0, 2, 1, 3)))
                    for x in (q, k, v)), jnp.asarray(mask), 64, 64, True)
    views = [torch.from_numpy(x).transpose(1, 2) for x in (q, k, v)]
    assert not views[0].is_contiguous()
    got = tfa.flash_attention(*views, torch.from_numpy(mask))
    assert got.shape == (b, h, t, dh)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
    for i, spans in enumerate(rows):
        if not spans:  # every key masked: the mean of V over all keys
            np.testing.assert_allclose(
                got.numpy()[i], np.broadcast_to(
                    v[i].mean(axis=0)[:, None, :], (h, t, dh)),
                rtol=2e-5, atol=2e-5)
    # the same as on contiguous copies of the views
    same = tfa.flash_attention(*(x.contiguous() for x in views),
                               torch.from_numpy(mask))
    np.testing.assert_array_equal(got.numpy(), same.numpy())
    assert tfa.FLASH_LAUNCHES == 0


@pytest.mark.parametrize("b,h,t,dh", [
    (2, 8, 96, 48),   # hidden 384 over 8 heads at max_len 96
    (3, 2, 32, 24),
    (2, 3, 128, 80),
    (1, 2, 100, 20),  # a T the JAX kernel takes as one block
])
def test_flash_padded_heads_match_jax(rng, monkeypatch, b, h, t, dh):
    """A head width the kernel lacks goes through the pad-and-slice route
    on the CPU too: the plain version sees q, k, v padded with zero columns
    to the next of 16/32/64/128 and the real width's scale, and the sliced
    result equals JAX's kernel in interpret mode (2e-5)."""
    q, k, v = (rng.standard_normal((b, t, h, dh)).astype(np.float32)
               for _ in range(3))
    mask = np.ones((b, t), np.float32)
    mask[0, t - t // 3:] = 0.0
    mask[-1, :] = 0.0  # every key masked: the mean of V
    want = jflash(*(jnp.asarray(np.ascontiguousarray(x.transpose(0, 2, 1, 3)))
                    for x in (q, k, v)), jnp.asarray(mask), 128, 128, True)
    seen = []
    plain = tfa.flash_attention_plain

    def spy(q_, k_, v_, mask_, scale=None):
        seen.append((q_.shape[-1], scale))
        return plain(q_, k_, v_, mask_, scale)

    monkeypatch.setattr(tfa, "flash_attention_plain", spy)
    views = [torch.from_numpy(x).transpose(1, 2) for x in (q, k, v)]
    got = tfa.flash_attention(*views, torch.from_numpy(mask))
    width = next(w for w in (16, 32, 64, 128) if w >= dh)
    assert seen == [(width, 1.0 / np.sqrt(dh))]
    assert got.shape == (b, h, t, dh)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
    assert tfa.FLASH_LAUNCHES == tfa.FLASH_F32_LAUNCHES == 0


@pytest.mark.parametrize("dh,width", [(192, 256), (256, 256), (320, 320)])
def test_flash_wide_heads_match_jax(rng, monkeypatch, dh, width):
    """Head widths past 128, as the JAX kernel takes them: the plain version
    sees the kernel's width (192 padded to 256; 320 on the wide path as it
    is) with the real width's scale, and matches JAX's kernel in interpret
    mode to 2e-5, masked tail and all-masked row included."""
    b, h, t = 2, 2, 96
    q, k, v, mask = _inputs(rng, b, h, t, dh)
    mask[1, :] = 0.0
    want = jflash(*(jnp.asarray(x) for x in (q, k, v, mask)), 32, 32, True)
    seen = []
    plain = tfa.flash_attention_plain

    def spy(q_, k_, v_, mask_, scale=None):
        seen.append((q_.shape[-1], scale))
        return plain(q_, k_, v_, mask_, scale)

    monkeypatch.setattr(tfa, "flash_attention_plain", spy)
    got = tfa.flash_attention(*(torch.from_numpy(x) for x in (q, k, v, mask)))
    assert seen == [(width, 1.0 / np.sqrt(dh))]
    assert got.shape == (b, h, t, dh)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
    assert tfa.FLASH_LAUNCHES == tfa.FLASH_F32_LAUNCHES == 0


def test_flash_kernel_head_dims():
    """Every head width has a kernel width, as the JAX kernel takes any:
    the next of 16-256, past 256 the next multiple of 8 (the wide path)."""
    assert [tfa._kernel_head_dim(d) for d in (1, 16, 17, 32, 48, 64, 65, 80,
                                             128)] == [16, 16, 32, 32, 64, 64,
                                                       128, 128, 128]
    assert [tfa._kernel_head_dim(d) for d in (129, 136, 192, 255, 256, 257,
                                             320, 321, 1000)] == [
        256, 256, 256, 256, 256, 264, 320, 328, 1000]


def test_flash_wide_heads_on_the_cpu_take_the_plain_version(rng):
    """Past 128 a CPU tensor computes the plain version on the padded route
    the card takes (136 padded to 256), equal to the JAX kernel."""
    q, k, v = (rng.standard_normal((1, 2, 64, 136)).astype(np.float32)
               for _ in range(3))
    mask = np.ones((1, 64), np.float32)
    want = jflash(*(jnp.asarray(x) for x in (q, k, v)), jnp.asarray(mask),
                  64, 64, True)
    got = tfa.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                              torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("b,h,t,dh,block,rows", [
    # one key block; a row with every key masked
    (2, 2, 64, 32, 64, [[(0, 40)], []]),
    # a tail block (T = 96, two 64-key blocks, keys past T absent)
    (3, 2, 96, 32, 32, [[(0, 70)], [(10, 20)], []]),
    # dead blocks between live ones, leading, trailing; every key masked
    (4, 2, 256, 32, 128, [[(0, 30), (192, 220)], [(200, 250)], [(0, 64)],
                          []]),
    (2, 2, 256, 256, 64, [[(0, 30), (192, 220)], []]),
    # the wide path's widths
    (3, 1, 96, 320, 32, [[(0, 96)], [(5, 6)], []]),
    (2, 1, 256, 320, 64, [[(40, 60), (200, 256)], []]),
])
def test_tf32_flash_model_matches_jax(rng, b, h, t, dh, block, rows):
    """The numerics of the f32 kernels (the f32 path and the wide path on
    3xTF32: raw operands split into trunc(x) and trunc(x - trunc(x)), S's
    small terms summed apart, O's folded in, online softmax over the live
    64-key blocks) against JAX's flash kernel in interpret mode, within the
    JAX f32 test's 2e-5; NaN keys and values in the skipped blocks change
    no bit of the model, as of the kernel."""
    from _tf32_model import flash_model

    q, k, v = (rng.standard_normal((b, h, t, dh)).astype(np.float32)
               for _ in range(3))
    mask = np.stack([_block_mask(t, spans) for spans in rows])
    want = jflash(*(jnp.asarray(x) for x in (q, k, v, mask)), block, block,
                  True)
    tq, tk, tv, tm = (torch.from_numpy(x) for x in (q, k, v, mask))
    got = flash_model(tq, tk, tv, tm)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
    nb = -(-t // 64)
    dead = np.pad(mask, ((0, 0), (0, nb * 64 - t))).reshape(b, nb, 64)
    dead = (dead == 0).all(axis=2) & (mask > 0).any(axis=1, keepdims=True)
    keys = np.repeat(dead, 64, axis=1)[:, None, :t, None]
    nan_k, nan_v = (torch.from_numpy(np.where(keys, np.float32("nan"), x))
                    for x in (k, v))
    assert torch.equal(flash_model(tq, nan_k, nan_v, tm), got)


@pytest.mark.parametrize("lens", [
    [30, 40, 70, 1, 64, 65, 2],    # texts across 64-token tile boundaries
    [5, 0, 3, 0, 0, 60, 8, 1],     # texts with no token between others
    [256, 7, 200, 129, 3],         # texts longer than a tile
    [1],
])
def test_varlen_plain_equals_each_text_alone(rng, lens):
    """Packed texts' attention: each token attends to its own text alone,
    equal to the plain version on that text by itself (2e-6: f32 sums over
    the same keys, padded to another length)."""
    h, dh = 3, 16
    layout = tfa.varlen_layout(lens)
    n = int(sum(lens))
    q, k, v = (torch.from_numpy(rng.standard_normal((n, h, dh))
                                .astype(np.float32)) for _ in range(3))
    got = tfa.flash_attention_varlen(q, k, v, layout)
    assert got.shape == (n, h, dh)
    start = 0
    for ln in lens:
        s = slice(start, start + ln)
        start += ln
        if not ln:
            continue
        want = tfa.flash_attention_plain(
            *(x[s].transpose(0, 1)[None] for x in (q, k, v)),
            torch.ones((1, ln)))[0].transpose(0, 1)
        np.testing.assert_allclose(got[s].numpy(), want.numpy(), rtol=2e-6,
                                   atol=2e-6)
    assert tfa.FLASH_LAUNCHES == tfa.FLASH_F32_LAUNCHES == 0


@pytest.mark.parametrize("lens", [
    [30, 40, 70, 1, 64, 65, 2],
    [5, 0, 3, 0, 0, 60, 8, 1, 0],
    [256, 7, 200, 129, 3, 64],
    list(np.random.default_rng(7).integers(0, 40, 500)),
])
def test_varlen_tiles_cover_the_tokens(lens):
    """The packed kernel's tiles: consecutive, up to 64 tokens, covering
    every token once; a text longer than 64 tokens has tiles of its own;
    a tile's key span is the span of the texts its tokens belong to."""
    lens = np.asarray(lens)
    cu = np.concatenate([[0], np.cumsum(lens)])
    tiles = tfa.varlen_tiles(cu)
    assert tiles.dtype == np.int32 and tiles.shape[1] == 4
    q0, q1, first, last = tiles.T
    assert q0[0] == 0 and q1[-1] == cu[-1]
    assert np.array_equal(q0[1:], q1[:-1])
    assert ((q1 - q0 >= 1) & (q1 - q0 <= tfa.VARLEN_TILE)).all()
    text = np.repeat(np.arange(lens.size), lens)
    for a, b, f, l in tiles:
        texts = np.unique(text[a:b])
        assert (f, l) == (texts[0], texts[-1] + 1)
        if len(texts) > 1:  # only texts of at most a tile share one
            assert (lens[texts] <= tfa.VARLEN_TILE).all()
    assert tfa.varlen_tiles(np.zeros(3, np.int64)).shape == (0, 4)
