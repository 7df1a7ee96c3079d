"""The port's fused top-k against the JAX package's, on the same numpy inputs.

``topk_scores_fused_plain`` (what a CPU tensor runs, and what the card run
holds the ``csrc/topk_fused.cu`` kernel against) and ``topk_scores_pallas``
against JAX ``topk_scores_pallas(interpret=True)``: values exact on
integer-valued inputs (every dot product exact in f32), 1e-5 otherwise;
indices equal, tie order included (both keep the lower row)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semanticsearch_tpu.ops import topk as jtopk
from semanticsearch_tpu_torch.ops import topk as ttopk


def _jax_fused(Q, C, k):
    v, i = jtopk.topk_scores_pallas(jnp.asarray(Q), jnp.asarray(C), k=k,
                                    block_q=8, block_n=128, interpret=True)
    return np.asarray(v), np.asarray(i)


def _assert_same(j, t, exact):
    np.testing.assert_array_equal(t[1], j[1])
    if exact:
        np.testing.assert_array_equal(t[0], j[0])
    else:
        np.testing.assert_allclose(t[0], j[0], rtol=0, atol=1e-5)


@pytest.mark.parametrize("q,n,k,integer", [
    (5, 700, 128, True),    # N not a block multiple
    (3, 640, 129, True),    # exact block multiple, k past a lane width
    (4, 1000, 300, False),  # several 128-wide list lanes
    (3, 90, 128, True),     # k > N: (-1e30, 0) tail
])
def test_fused_matches_jax(rng, q, n, k, integer):
    d = 64
    if integer:
        Q = rng.integers(-4, 5, size=(q, d)).astype(np.float32)
        C = rng.integers(-4, 5, size=(n, d)).astype(np.float32)
    else:
        Q = rng.standard_normal((q, d)).astype(np.float32)
        C = rng.standard_normal((n, d)).astype(np.float32)
    j = _jax_fused(Q, C, k)
    for fn in (ttopk.topk_scores_fused_plain, ttopk.topk_scores_pallas):
        tv, ti = fn(torch.from_numpy(Q), torch.from_numpy(C), k)
        _assert_same(j, (tv.numpy(), ti.numpy()), integer)
    if k > n:
        assert (j[0][:, n:] == ttopk.NEG_INF).all() and (j[1][:, n:] == 0).all()
    assert ttopk.TOPK_FUSED_LAUNCHES == 0


def test_fused_all_negative_scores_match_jax(rng):
    """Every score negative: zero pad rows of the JAX kernel must not
    surface, nor rows past valid_n in the port."""
    d, n = 64, 300
    C = -np.abs(rng.integers(1, 4, size=(n, d))).astype(np.float32)
    Q = np.abs(rng.integers(1, 4, size=(4, d))).astype(np.float32)
    j = _jax_fused(Q, C, 130)
    tv, ti = ttopk.topk_scores_fused_plain(torch.from_numpy(Q),
                                           torch.from_numpy(C), 130)
    _assert_same(j, (tv.numpy(), ti.numpy()), True)
    assert (j[0] < 0).all()
    # a padded corpus with valid_n: the same answer
    padded = np.concatenate([C, np.zeros((84, d), np.float32)])
    pv, pi = ttopk.topk_scores_fused(torch.from_numpy(Q),
                                     torch.from_numpy(padded), 130,
                                     valid_n=n)
    _assert_same(j, (pv.numpy(), pi.numpy()), True)


def test_fused_constructed_ties_match_jax(rng):
    """300 equal rows: the k best are the k lowest rows; duplicate rows in
    different blocks tie exactly and keep ascending row order."""
    d = 32
    C = np.ones((300, d), np.float32)
    Q = np.ones((2, d), np.float32)
    j = _jax_fused(Q, C, 5)
    np.testing.assert_array_equal(j[1], np.tile(np.arange(5), (2, 1)))
    base = rng.integers(-3, 4, size=(40, d)).astype(np.float32)
    C = np.concatenate([base, base[::-1], base[5:25], base, base])  # 180
    Q = rng.integers(-3, 4, size=(5, d)).astype(np.float32)
    j = _jax_fused(Q, C, 150)
    tv, ti = ttopk.topk_scores_pallas(torch.from_numpy(Q),
                                      torch.from_numpy(C), 150)
    _assert_same(j, (tv.numpy(), ti.numpy()), True)


def test_topk_scores_dispatch_matches_jax(rng):
    """topk_scores on the CPU: the reference scan in both packages."""
    Q = rng.standard_normal((3, 64)).astype(np.float32)
    C = rng.standard_normal((500, 64)).astype(np.float32)
    for k in (3, 140):
        jv, ji = jtopk.topk_scores(jnp.asarray(Q), jnp.asarray(C), k=k)
        tv, ti = ttopk.topk_scores(torch.from_numpy(Q), torch.from_numpy(C),
                                   k=k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0,
                                   atol=1e-5)


def test_fused_k_limit():
    x = torch.zeros((2, 8))
    with pytest.raises(ValueError, match="2048"):
        ttopk.topk_scores_fused(x, x, ttopk.FUSED_MAX_K + 1)
    with pytest.raises(ValueError):
        ttopk.topk_scores_fused(x, x, 4, valid_n=3)
    v, i = ttopk.topk_scores_fused(x, x, ttopk.FUSED_MAX_K)
    assert v.shape == i.shape == (2, ttopk.FUSED_MAX_K)


@pytest.mark.parametrize("d", [72, 100])
@pytest.mark.parametrize("integer", [True, False])
def test_fused_f32_at_narrow_widths_matches_jax(rng, d, integer):
    """f32 operands at widths the f32 schedule takes and the bf16 kernel
    would not (100 is no multiple of 8)."""
    if integer:
        Q = rng.integers(-8, 9, size=(5, d)).astype(np.float32)
        C = rng.integers(-8, 9, size=(700, d)).astype(np.float32)
        C[350:] = C[:350]  # every score twice: ties across the corpus
    else:
        Q = rng.standard_normal((5, d)).astype(np.float32)
        C = rng.standard_normal((700, d)).astype(np.float32)
    j = _jax_fused(Q, C, 130)
    tv, ti = ttopk.topk_scores_fused(torch.from_numpy(Q), torch.from_numpy(C),
                                     130)
    _assert_same(j, (tv.numpy(), ti.numpy()), integer)
    assert ttopk.TOPK_FUSED_F32_LAUNCHES == 0


@pytest.mark.parametrize("d", [30, 100])
@pytest.mark.parametrize("k", [1, 130])
@pytest.mark.parametrize("integer", [True, False])
def test_tf32x3_topk_model_matches_jax_kernel(rng, d, k, integer):
    """The fused top-k on 3xTF32 scores (the f32 schedule's numerics,
    modelled in torch) against the JAX ``_topk_kernel`` in interpret mode:
    on integer rows with ties bit for bit, ids and tie order included; on
    unit rows values within D * 2^-24, ids equal outside near-ties."""
    from _tf32_model import topk_model

    if integer:
        Q = rng.integers(-8, 9, size=(5, d)).astype(np.float32)
        C = rng.integers(-8, 9, size=(700, d)).astype(np.float32)
        C[350:] = C[:350]  # every score twice: ties across the corpus
    else:
        Q = rng.standard_normal((5, d)).astype(np.float32)
        C = rng.standard_normal((700, d)).astype(np.float32)
        Q /= np.linalg.norm(Q, axis=1, keepdims=True)
        C /= np.linalg.norm(C, axis=1, keepdims=True)
    jv, ji = _jax_fused(Q, C, k)
    mv, mi = (x.numpy() for x in topk_model(torch.from_numpy(Q),
                                            torch.from_numpy(C), k))
    if integer:
        _assert_same((jv, ji), (mv, mi), True)
        return
    tol = d * 2.0 ** -24
    np.testing.assert_allclose(mv, jv, rtol=0, atol=tol)
    # ids equal wherever the JAX values are more than 2 tol from both
    # neighbours (the k+1-th from the model's own wider list)
    wider = topk_model(torch.from_numpy(Q), torch.from_numpy(C), k + 1)[0]
    ref = np.concatenate([jv, wider.numpy()[:, k:]], axis=1)
    gap = np.abs(np.diff(ref, axis=1)) > 2 * tol
    apart = np.ones_like(ref, dtype=bool)
    apart[:, 1:] &= gap
    apart[:, :-1] &= gap
    np.testing.assert_array_equal(mi[apart[:, :k]], ji[apart[:, :k]])
