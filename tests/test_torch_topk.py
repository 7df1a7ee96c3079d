"""The port's top-k ops against the JAX package's, on the same numpy inputs.

Two-pass search: the port's plain pass A plus pass B against JAX
``topk_scores_twopass(interpret=True)`` on the cases of test_ops_topk.py,
in the default, overlap (``mxu_overlap``) and int8 (``pass_a_int8``) modes.
Indices must be equal, tie order included; values agree to 1e-4, the
tolerance the JAX tests use.
"""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semanticsearch_tpu.ops import topk as jtopk
from semanticsearch_tpu_torch.ops import topk as ttopk


def _both_twopass(Q, C, single_copy=False, **kw):
    if single_copy:
        block_n = kw["block_n"]
        jv, ji = jtopk.topk_scores_twopass(
            jnp.asarray(Q), jtopk.swizzle_corpus(jnp.asarray(C), block_n),
            block_q=8, q_chunk=8, interpret=True, gather_from_swizzled=True,
            valid_n=C.shape[0], **kw)
        tv, ti = ttopk.topk_scores_twopass(
            torch.from_numpy(Q),
            ttopk.swizzle_corpus(torch.from_numpy(C), block_n),
            q_chunk=8, gather_from_swizzled=True, valid_n=C.shape[0], **kw)
    else:
        jv, ji = jtopk.topk_scores_twopass(
            jnp.asarray(Q), jnp.asarray(C), block_q=8, q_chunk=8,
            interpret=True, **kw)
        tv, ti = ttopk.topk_scores_twopass(
            torch.from_numpy(Q), torch.from_numpy(C), q_chunk=8, **kw)
    return (np.asarray(jv), np.asarray(ji)), (tv.numpy(), ti.numpy())


def _assert_same(j, t, ctx=""):
    np.testing.assert_array_equal(t[1], j[1], err_msg=ctx)
    np.testing.assert_allclose(t[0], j[0], rtol=1e-4, atol=1e-4, err_msg=ctx)


@pytest.mark.parametrize("q,n,d,k,block_n,seg_split,single", [
    (4, 300, 128, 10, 128, 1, False),    # multiple blocks, padding
    (3, 1024, 128, 5, 256, 1, False),    # exact block multiple
    (9, 77, 128, 10, 128, 1, False),     # single padded block, q padding
    (6, 1111, 128, 10, 256, 2, False),   # fine segments
    (6, 1111, 128, 10, 512, 4, False),
    (5, 300, 128, 10, 128, 1, True),     # single-copy (swizzled) mode
    (5, 700, 128, 10, 256, 2, True),
    (5, 1024, 128, 31, 512, 2, False),
])
def test_twopass_matches_jax(rng, q, n, d, k, block_n, seg_split, single):
    Q = rng.standard_normal((q, d)).astype(np.float32)
    C = rng.standard_normal((n, d)).astype(np.float32)
    j, t = _both_twopass(Q, C, single_copy=single, k=k, block_n=block_n,
                         seg_split=seg_split)
    _assert_same(j, t)


def test_twopass_negative_scores_padding_matches_jax(rng):
    """Every score negative: zero pad rows in the straddling segment must
    not surface, in either package."""
    n, d, k = 77, 64, 10
    base = np.zeros(d, np.float32)
    base[0] = 1.0
    C = base[None, :] + 0.5 * rng.standard_normal((n, d)).astype(np.float32)
    C[:, 0] = np.abs(C[:, 0]) + 0.2
    C /= np.linalg.norm(C, axis=1, keepdims=True)
    Q = np.zeros((4, d), np.float32)
    Q[:, 0] = -1.0
    j, t = _both_twopass(Q, C, k=k, block_n=128)
    _assert_same(j, t)
    assert (t[1] < n).all()


def test_twopass_constructed_ties_match_jax(rng):
    """Duplicate rows in different segments tie exactly; pass B must order
    them as jax.lax.top_k does over pass A's candidate order."""
    d, k = 64, 12
    base = rng.integers(-3, 4, size=(40, d)).astype(np.float32)
    C = np.concatenate([base, base[::-1], base[5:25], base])  # 140 rows
    Q = rng.integers(-3, 4, size=(5, d)).astype(np.float32)
    for block_n, seg_split in [(128, 1), (256, 2), (512, 4)]:
        j, t = _both_twopass(Q, C, k=k, block_n=block_n, seg_split=seg_split)
        _assert_same(j, t, f"block_n={block_n} seg_split={seg_split}")


def test_twopass_query_chunking_matches_jax(rng, monkeypatch):
    """More queries than _MAX_TWOPASS_Q: both packages split the batch."""
    monkeypatch.setattr(jtopk, "_MAX_TWOPASS_Q", 8)
    monkeypatch.setattr(ttopk, "_MAX_TWOPASS_Q", 8)
    Q = rng.standard_normal((19, 64)).astype(np.float32)
    C = rng.standard_normal((300, 64)).astype(np.float32)
    j, t = _both_twopass(Q, C, k=5, block_n=128)
    _assert_same(j, t)


def test_pass_a_order_and_placeholders():
    """Fewer real segments than k_sel: slot j past them holds -1-j."""
    Q = np.eye(4, 16, dtype=np.float32)
    C = np.eye(6, 16, dtype=np.float32)
    v, ids = ttopk.segtopk_pass_a(torch.from_numpy(Q), torch.from_numpy(C),
                                  n=6, seg_rows=2, k_sel=5)
    # query 0 hits row 0 (segment 0); the other two segments tie at 0
    assert ids[0].tolist() == [0, 1, 2, -4, -5]
    assert (v[0, 3:] == ttopk.NEG_INF).all()
    assert ttopk.SEGTOPK_LAUNCHES == 0  # CPU tensors take the plain version


def test_twopass_guards():
    Q = torch.zeros((2, 8))
    C = torch.zeros((10, 8))
    with pytest.raises(AssertionError):
        ttopk.topk_scores_twopass(Q, C, k=128)
    with pytest.raises(AssertionError):
        ttopk.topk_scores_twopass(Q, C, k=3, block_n=256, seg_split=3)
    with pytest.raises(AssertionError):
        ttopk.topk_scores_twopass(Q, C, k=3, gather_from_swizzled=True)
    with pytest.raises(AssertionError):
        ttopk.topk_scores_twopass(Q, C, k=3, block_n=128,
                                  corpus_swizzled=torch.zeros((64, 8)))
    with pytest.raises(AssertionError, match="mutually exclusive"):
        ttopk.topk_scores_twopass(Q, C, k=3, mxu_overlap=True,
                                  pass_a_int8=True)


@pytest.mark.parametrize("q,n,d,k,block_n", [(4, 100, 128, 5, 256),
                                               (3, 513, 128, 10, 256)])
def test_topk_ref_matches_jax(rng, q, n, d, k, block_n):
    Q = rng.standard_normal((q, d)).astype(np.float32)
    C = rng.standard_normal((n, d)).astype(np.float32)
    jv, ji = jtopk.topk_scores_ref(jnp.asarray(Q), jnp.asarray(C), k=k,
                                   block_n=block_n)
    tv, ti = ttopk.topk_scores_ref(torch.from_numpy(Q), torch.from_numpy(C),
                                   k=k, block_n=block_n)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5,
                               atol=1e-5)


def test_topk_ref_ties_match_jax(rng):
    C = np.repeat(rng.integers(-3, 4, size=(5, 32)).astype(np.float32), 4,
                  axis=0)
    Q = C[:2]
    jv, ji = jtopk.topk_scores_ref(jnp.asarray(Q), jnp.asarray(C), k=8,
                                   block_n=8)
    tv, ti = ttopk.topk_scores_ref(torch.from_numpy(Q), torch.from_numpy(C),
                                   k=8, block_n=8)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_swizzle_and_quantize_match_jax(rng):
    C = rng.standard_normal((300, 16)).astype(np.float32)
    np.testing.assert_array_equal(
        ttopk.swizzle_corpus(torch.from_numpy(C), 256).numpy(),
        np.asarray(jtopk.swizzle_corpus(jnp.asarray(C), 256)))
    tq, ts = ttopk.quantize_int8_global(torch.from_numpy(C))
    jq, js = jtopk.quantize_int8_global(jnp.asarray(C))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_allclose(float(ts), float(js), rtol=1e-7)


@pytest.mark.parametrize("width,kp", [(700, 20), (4096, 40), (65536, 130)])
def test_block_topk_matches_jax(rng, width, kp):
    """Each stage of the staged selection, ties included (integer scores
    from a narrow range tie often)."""
    S = rng.integers(-50, 50, size=(3, width)).astype(np.float32)
    jv, ji = jtopk.block_topk(jnp.asarray(S), kp)
    tv, ti = ttopk.block_topk(torch.from_numpy(S), kp)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("n,k,chunk,valid_n,budget", [
    (3333, 160, 512, -1, 1 << 30),   # chunks + remainder tail
    (700, 130, 262144, -1, 1 << 30),  # single chunk
    (700, 130, 262144, -1, 4 * 4 * 256),  # budget shrinks the chunk
    (64, 50, 256, 40, 1 << 30),     # pad rows past valid_n, k > valid_n
])
def test_topk_chunked_matches_jax(rng, n, k, chunk, valid_n, budget):
    d = 48
    Q = rng.integers(-4, 5, size=(4, d)).astype(np.float32)
    C = rng.integers(-4, 5, size=(n, d)).astype(np.float32)
    C[: n // 3] = C[:1]  # identical rows -> massive ties
    kw = dict(k=k, chunk=chunk, valid_n=valid_n, score_budget_bytes=budget)
    jv, ji = jtopk.topk_scores_chunked(jnp.asarray(Q), jnp.asarray(C), **kw)
    tv, ti = ttopk.topk_scores_chunked(torch.from_numpy(Q),
                                       torch.from_numpy(C), **kw)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("seg_split", [1, 2, 4])
def test_twopass_overlap_matches_jax(rng, seg_split):
    """test_ops_topk.py's overlap case: the overlap schedule equals the
    default one bit for bit, in both packages."""
    Q = rng.standard_normal((16, 128)).astype(np.float32)
    C = rng.standard_normal((2000, 128)).astype(np.float32)
    kw = dict(k=7, block_n=512, seg_split=seg_split)
    j, t = _both_twopass(Q, C, mxu_overlap=True, **kw)
    _assert_same(j, t)
    dv, di = ttopk.topk_scores_twopass(torch.from_numpy(Q),
                                       torch.from_numpy(C), **kw)
    np.testing.assert_array_equal(t[1], di.numpy())
    np.testing.assert_array_equal(t[0], dv.numpy())
    assert ttopk.SEGTOPK_OVERLAP_LAUNCHES == 0


def _unit(rng, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.mark.parametrize("q,n,d,k,block_n,unit_q", [
    (8, 512, 128, 10, 256, True),   # test_ops_topk.py's int8 cases
    (5, 300, 64, 5, 128, True),
    (6, 400, 64, 7, 128, False),    # unnormalized queries
])
def test_twopass_int8_matches_jax(rng, q, n, d, k, block_n, unit_q):
    Q = _unit(rng, (q, d)) if unit_q else rng.standard_normal(
        (q, d)).astype(np.float32)
    C = _unit(rng, (n, d))
    j, t = _both_twopass(Q, C, k=k, block_n=block_n, pass_a_int8=True)
    _assert_same(j, t)
    assert ttopk.SEGTOPK_INT8_LAUNCHES == 0


def _jax_pass_a(Q, C, k, block_n, monkeypatch, **kw):
    """The JAX package's pass-A kernel in interpret mode, recorded as
    topk_scores_twopass launches it: (segment maxima, segment ids) of the Q
    queries, each as wide as the kernel's k_sel scratch (128), segments of
    block_n / 128 rows."""
    outs = []
    real = jtopk.pl.pallas_call

    def recording_pallas_call(*a, **kw):
        call = real(*a, **kw)
        return lambda *args: outs.append(call(*args)) or outs[-1]

    monkeypatch.setattr(jtopk.pl, "pallas_call", recording_pallas_call)
    jtopk.topk_scores_twopass.__wrapped__(
        jnp.asarray(Q), jnp.asarray(C), k=k, block_q=8, block_n=block_n,
        q_chunk=8, interpret=True, **kw)
    monkeypatch.undo()
    jv, ji = (np.asarray(o) for o in outs[0])
    return jv[:Q.shape[0]], ji[:Q.shape[0]]


def test_int8_pass_a_plain_matches_jax_kernel(rng, monkeypatch):
    """Pass A alone in int8: the JAX kernel's segment order (int32 maxima
    converted to f32) equals the plain version's, values exactly."""
    Q = _unit(rng, (8, 64))
    C = _unit(rng, (300, 64))
    jv, ji = _jax_pass_a(Q, C, 5, 128, monkeypatch, pass_a_int8=True)
    q8 = ttopk._quantize_rows_int8(torch.from_numpy(Q))
    c8, _ = ttopk.quantize_int8_global(torch.from_numpy(C))
    k_sel = 5 + 1 + 5
    tv, ti = ttopk.segtopk_pass_a_int8(q8, c8, 300, 1, k_sel)
    np.testing.assert_array_equal(ti.numpy(), ji[:, :k_sel])
    np.testing.assert_array_equal(tv.numpy(), jv[:, :k_sel])


def test_twopass_int8_prequantized_matches_jax(rng):
    """A prequantized swizzled corpus gives the on-the-fly results."""
    Q = rng.standard_normal((6, 64)).astype(np.float32)
    C = _unit(rng, (400, 64))
    jswz = jtopk.swizzle_corpus(jnp.asarray(C), 128)
    jc8, _ = jtopk.quantize_int8_global(jswz)
    jv, ji = jtopk.topk_scores_twopass(
        jnp.asarray(Q), jnp.asarray(C), k=7, block_q=8, block_n=128,
        q_chunk=8, interpret=True, pass_a_int8=True, corpus_swizzled=jswz,
        corpus_swizzled_q8=jc8)
    tswz = ttopk.swizzle_corpus(torch.from_numpy(C), 128)
    tc8, _ = ttopk.quantize_int8_global(tswz)
    kw = dict(k=7, block_n=128, q_chunk=8, pass_a_int8=True)
    tv, ti = ttopk.topk_scores_twopass(
        torch.from_numpy(Q), torch.from_numpy(C), corpus_swizzled=tswz,
        corpus_swizzled_q8=tc8, **kw)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-4,
                               atol=1e-4)
    fv, fi = ttopk.topk_scores_twopass(torch.from_numpy(Q),
                                       torch.from_numpy(C), **kw)
    np.testing.assert_array_equal(fi.numpy(), ti.numpy())
    np.testing.assert_array_equal(fv.numpy(), tv.numpy())


def test_twopass_int8_chunked_single_copy_matches_jax(rng, monkeypatch):
    """More queries than _MAX_TWOPASS_Q, single-copy swizzled corpus, int8
    pass A: the combination test_ops_topk.py guards."""
    monkeypatch.setattr(jtopk, "_MAX_TWOPASS_Q", 8)
    monkeypatch.setattr(ttopk, "_MAX_TWOPASS_Q", 8)
    Q = _unit(rng, (12, 64))
    C = _unit(rng, (300, 64))
    j, t = _both_twopass(Q, C, single_copy=True, k=5, block_n=128,
                         pass_a_int8=True)
    _assert_same(j, t)


@pytest.mark.parametrize("k,k_sel_extra,d,match", [
    (125, 0, 64, "k_sel clamped"),
    (5, 0, 1040, "d=1040"),
])
def test_twopass_int8_warnings_match_jax(rng, k, k_sel_extra, d, match):
    Q = _unit(rng, (4, d))
    C = _unit(rng, (600, d))
    with pytest.warns(UserWarning, match=match):
        jtopk.topk_scores_twopass(
            jnp.asarray(Q), jnp.asarray(C), k=k, block_q=8, block_n=256,
            q_chunk=8, interpret=True, pass_a_int8=True,
            k_sel_extra=k_sel_extra)
    with pytest.warns(UserWarning, match=match):
        ttopk.topk_scores_twopass(
            torch.from_numpy(Q), torch.from_numpy(C), k=k, block_n=256,
            q_chunk=8, pass_a_int8=True, k_sel_extra=k_sel_extra)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        ttopk.topk_scores_twopass(torch.from_numpy(Q), torch.from_numpy(C),
                                  k=5, block_n=256, pass_a_int8=d < 1040)


# ------------------------------------------------------------- tile planning

_PLAN_Q = [1, 33, 64, 70, 1024, 32768]
_PLAN_D = [8, 72, 384, 768, 1024]


def _check_tile(plan, q, smem):
    assert plan["smem"] == smem <= ttopk.SMEM_LIMIT == 232448
    assert plan["bq"] in (64, 128) and 2 <= plan["stages"] <= 4
    assert plan["bq"] == 64 or q > 64
    assert plan["n_splits"] >= 1


@pytest.mark.parametrize("k_sel", [1, 11, 41, 128])
@pytest.mark.parametrize("d", _PLAN_D)
@pytest.mark.parametrize("q", _PLAN_Q)
def test_pass_a_plan_fits(q, d, k_sel):
    for n, seg_rows in [(100, 8), (20000, 32), (1_250_000, 32), (5000, 256)]:
        n_segs = -(-n // seg_rows)
        plan = ttopk.pass_a_plan(q, d, k_sel, n_segs, seg_rows)
        _check_tile(plan, q, ttopk.pass_a_smem_bytes(
            plan["bq"], d, plan["stages"], k_sel))
        # splits are whole units (a segment or a tile), none of them empty
        unit = max(128, seg_rows)
        n_units = -(-(n_segs * seg_rows) // unit)
        per = -(-n_units // plan["n_splits"])
        assert (plan["n_splits"] - 1) * per < n_units
    # 128 query rows a CTA at the dense shape, 64 for a serve batch
    if d == 384 and k_sel <= 41:
        assert plan["bq"] == (128 if q > 64 else 64) and plan["stages"] == 4


@pytest.mark.parametrize("k", [1, 128, 200, 2048])
@pytest.mark.parametrize("d", _PLAN_D)
@pytest.mark.parametrize("q", _PLAN_Q)
def test_fused_plan_fits_and_keeps_splits_at_4k_rows(q, d, k):
    for vn in (0, 100, 20011, 22000, 1_250_000):
        plan = ttopk.fused_plan(q, d, k, vn)
        _check_tile(plan, q, ttopk.fused_smem_bytes(plan["bq"], d,
                                                    plan["stages"]))
        assert plan["cap"] >= k + 128
        assert plan["scratch"] == plan["n_splits"] * q * (plan["cap"] * 8 + 4)
        if plan["n_splits"] > 1:
            n_tiles = -(-vn // 128)
            rows = -(-n_tiles // plan["n_splits"]) * 128
            last = vn - (plan["n_splits"] - 1) * rows
            assert rows >= 4 * k and last >= 4 * k
    if d == 384:
        assert plan["bq"] == (128 if q > 64 else 64) and plan["stages"] == 4


@pytest.mark.parametrize("k_sel", [1, 11, 41, 128])
def test_pass_a_plan_raises_exactly_past_its_widest_d(k_sel):
    widest = ttopk.pass_a_max_d(k_sel)
    assert widest >= 1024 and widest % 64 == 0
    for q in _PLAN_Q:
        ttopk.pass_a_plan(q, widest, k_sel, 1000, 32)
        ttopk.pass_a_plan(q, widest - 56, k_sel, 1000, 32)
        with pytest.raises(ValueError, match=f"widths up to {widest}"):
            ttopk.pass_a_plan(q, widest + 8, k_sel, 1000, 32)
    assert ttopk.pass_a_smem_bytes(64, widest + 64, 2, k_sel) > ttopk.SMEM_LIMIT


@pytest.mark.parametrize("k", [1, 128, 200, 2048])
def test_fused_plan_raises_exactly_past_its_widest_d(k):
    widest = ttopk.fused_max_d()
    assert widest == 1472
    for q in _PLAN_Q:
        ttopk.fused_plan(q, widest, k, 50000)
        with pytest.raises(ValueError, match="widths up to 1472"):
            ttopk.fused_plan(q, widest + 8, k, 50000)
    assert ttopk.fused_smem_bytes(64, widest + 64, 2) > ttopk.SMEM_LIMIT


@pytest.mark.parametrize("n_qtiles,n_units,expect", [
    (1, 157, 79),     # a serve batch over 20,000 rows: one wave of two tiles
    (256, 9766, 1),   # the dense shape: the query tiles fill the card
    (128, 9766, 1),
    (8, 9766, 33),    # 1,024 queries: two full waves
    (1, 1, 1),
])
def test_pick_splits(n_qtiles, n_units, expect):
    assert ttopk._pick_splits(n_qtiles, n_units, 1, n_units, 132) == expect


# the overlap schedule's plan: the default's tiles and splits on the
# deepest ring that fits
_OVERLAP_D = [8, 64, 72, 128, 320, 384, 512, 576, 768, 1024]


@pytest.mark.parametrize("k_sel", [1, 11, 41, 128])
@pytest.mark.parametrize("d", _OVERLAP_D)
@pytest.mark.parametrize("q", _PLAN_Q)
def test_overlap_plan_fits_on_the_deepest_ring(q, d, k_sel):
    for n, seg_rows in [(100, 8), (20000, 32), (1_250_000, 32), (5000, 256)]:
        n_segs = -(-n // seg_rows)
        plan = ttopk.overlap_plan(q, d, k_sel, n_segs, seg_rows)
        default = ttopk.pass_a_plan(q, d, k_sel, n_segs, seg_rows)
        assert plan["smem"] == ttopk.pass_a_smem_bytes(
            plan["bq"], d, plan["stages"], k_sel) <= ttopk.SMEM_LIMIT
        assert plan["bq"] == default["bq"]
        assert plan["n_splits"] == default["n_splits"]
        if plan["bq"] == 64:  # one consumer warpgroup: the default's ring
            assert plan == default
            continue
        assert default["stages"] <= plan["stages"] <= ttopk.OVERLAP_MAX_STAGES
        assert (plan["stages"] == ttopk.OVERLAP_MAX_STAGES
                or ttopk.pass_a_smem_bytes(plan["bq"], d, plan["stages"] + 1,
                                           k_sel) > ttopk.SMEM_LIMIT)
    # the shard shape: 128-row tiles on a ring longer than a tile's six K
    # chunks, so the two warpgroups can drift out of phase
    if d == 384 and k_sel == 11 and q > 64:
        assert plan["bq"] == 128 and plan["stages"] == 7


@pytest.mark.parametrize("k_sel", [1, 2, 11, 41, 64, 127, 128])
def test_overlap_plan_fits_at_every_width(k_sel):
    """Every width that is a multiple of 8 up to the widest: the default's
    tiles and splits; on 128-row tiles a ring at least as deep as the
    default's, within the shared memory, and no deeper ring would fit; on
    64-row tiles (one warpgroup) the default's plan."""
    for d in range(8, ttopk.pass_a_max_d(k_sel) + 1, 8):
        for q in (64, 1000):
            plan = ttopk.overlap_plan(q, d, k_sel, 40000, 32)
            default = ttopk.pass_a_plan(q, d, k_sel, 40000, 32)
            if plan["bq"] == 64:
                assert plan == default
                continue
            assert {k: plan[k] for k in ("bq", "n_splits")} == {
                k: default[k] for k in ("bq", "n_splits")}
            assert default["stages"] <= plan["stages"]
            assert plan["smem"] <= ttopk.SMEM_LIMIT
            assert (plan["stages"] == ttopk.OVERLAP_MAX_STAGES
                    or ttopk.pass_a_smem_bytes(plan["bq"], d,
                                               plan["stages"] + 1, k_sel)
                    > ttopk.SMEM_LIMIT)


@pytest.mark.parametrize("k_sel", [1, 11, 41, 128])
def test_overlap_plan_raises_exactly_past_its_widest_d(k_sel):
    widest = ttopk.pass_a_max_d(k_sel)
    for q in _PLAN_Q:
        assert ttopk.overlap_plan(q, widest, k_sel, 1000, 32)["bq"] == 64
        with pytest.raises(ValueError, match=f"widths up to {widest}"):
            ttopk.overlap_plan(q, widest + 8, k_sel, 1000, 32)


def _probe_clocks(offset: float, epilogue: float, tiles: int = 50,
                  period: float = 1000.0) -> np.ndarray:
    """Epilogue clocks as the phase probe records them: warpgroup 1 starts
    each epilogue ``offset`` tiles after warpgroup 0."""
    from semanticsearch_tpu_torch.tools import pass_a_phase

    clk = np.zeros((2, 3, pass_a_phase.PROBE_TILES), np.int64)
    start = 10_000 + period * np.arange(tiles)
    for wg, shift in ((0, 0.0), (1, offset * period)):
        clk[wg, 0, :tiles] = start + shift
        clk[wg, 1, :tiles] = start + shift + epilogue * period
        clk[wg, 2, :tiles] = (start + shift) / 2  # a 2 GHz clock, in ns
    return clk


@pytest.mark.parametrize("offset,shared", [(0.0, 1.0), (0.1, 0.5),
                                           (0.5, 0.0), (1.0, 49 / 50)])
def test_pass_a_phase_stats(offset, shared):
    """The phase runner's reading of the probe: warpgroups in step share
    all their epilogue time, half a tile apart none of it."""
    from semanticsearch_tpu_torch.tools import pass_a_phase

    st = pass_a_phase.phase_stats(_probe_clocks(offset, 0.2))
    assert st["tiles"] == 50 and st["tile_cycles"] == 1000.0
    assert st["tile_ns"] == 500.0 and st["sm_ghz"] == pytest.approx(2.0)
    assert st["epilogue_share"] == pytest.approx([0.2, 0.2])
    assert st["wg1_behind_tiles"] == pytest.approx([offset] * 3)
    assert st["both_in_epilogue_share"] == pytest.approx(shared)


# -------------------------------------- narrow widths: int8 padding, f32

@pytest.mark.parametrize("d", [72, 100])
def test_twopass_int8_at_unpadded_widths_matches_jax(rng, d):
    """A width that is not a multiple of 16: the port quantizes straight
    into a 16-column multiple (zero columns change no product) and must
    still give the JAX function's results."""
    Q = _unit(rng, (6, d))
    C = _unit(rng, (700, d))
    j, t = _both_twopass(Q, C, k=7, block_n=256, pass_a_int8=True)
    _assert_same(j, t)
    j, t = _both_twopass(Q, C, single_copy=True, k=7, block_n=256,
                         pass_a_int8=True)
    _assert_same(j, t)
    assert ttopk.SEGTOPK_INT8_LAUNCHES == 0


@pytest.mark.parametrize("d", [72, 100])
def test_int8_quantizers_pad_to_width(rng, d):
    """Quantized into a wider tensor: the same values as the JAX
    quantizers' in the first d columns, zeros past them, one copy."""
    X = rng.standard_normal((300, d)).astype(np.float32)
    w = -(-d // 16) * 16
    tq, ts = ttopk.quantize_int8_global(torch.from_numpy(X), w)
    jq, js = jtopk.quantize_int8_global(jnp.asarray(X))
    assert tq.shape == (300, w) and tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy()[:, :d], np.asarray(jq))
    assert not tq.numpy()[:, d:].any()
    np.testing.assert_allclose(float(ts), float(js), rtol=1e-7)
    rows = ttopk._quantize_rows_int8(torch.from_numpy(X), w)
    np.testing.assert_array_equal(
        rows.numpy()[:, :d],
        ttopk._quantize_rows_int8(torch.from_numpy(X)).numpy())
    assert not rows.numpy()[:, d:].any()
    swz = ttopk.swizzle_corpus(torch.from_numpy(X), 256)
    nat = ttopk._unswizzle(swz, 256, w)
    assert nat.shape == (swz.shape[0], w)
    np.testing.assert_array_equal(nat.numpy()[:300, :d], X)
    assert not nat.numpy()[:, d:].any() and not nat.numpy()[300:].any()


@pytest.mark.parametrize("mode", [{}, {"mxu_overlap": True}])
@pytest.mark.parametrize("d", [72, 100])
def test_twopass_f32_at_narrow_widths_matches_jax(rng, d, mode):
    """An f32 index at widths the f32 schedule takes and bf16 would not
    (100 is no multiple of 8), in the default and overlap modes."""
    Q = rng.standard_normal((6, d)).astype(np.float32)
    C = rng.standard_normal((700, d)).astype(np.float32)
    j, t = _both_twopass(Q, C, k=7, block_n=256, **mode)
    _assert_same(j, t)
    assert ttopk.SEGTOPK_F32_LAUNCHES == ttopk.SEGTOPK_OVERLAP_F32_LAUNCHES == 0


# the int8 schedule's plan: pass_a_plan's tiles on one-byte operands
_INT8_PLAN_D = [16, 80, 384, 768, 1024, 2048]


@pytest.mark.parametrize("k_sel", [1, 16, 41, 128])
@pytest.mark.parametrize("d", _INT8_PLAN_D)
@pytest.mark.parametrize("q", _PLAN_Q)
def test_pass_a_int8_plan_fits(q, d, k_sel):
    for n, seg_rows in [(100, 8), (20000, 32), (1_250_000, 32), (5000, 256)]:
        n_segs = -(-n // seg_rows)
        plan = ttopk.pass_a_int8_plan(q, d, k_sel, n_segs, seg_rows)
        _check_tile(plan, q, ttopk.pass_a_smem_bytes(
            plan["bq"], d, plan["stages"], k_sel, elem=1))
        # a query row takes whole 128-byte chunks: d int8 columns, half of
        # the same width in bf16
        assert plan["smem"] <= ttopk.pass_a_smem_bytes(
            plan["bq"], d, plan["stages"], k_sel)
        unit = max(128, seg_rows)
        n_units = -(-(n_segs * seg_rows) // unit)
        per = -(-n_units // plan["n_splits"])
        assert (plan["n_splits"] - 1) * per < n_units
        assert plan["n_splits"] == ttopk._segment_splits(
            -(-q // plan["bq"]), n_segs, seg_rows, 132)
    # the shard shape: 128 query rows a CTA on four stages
    if d == 384 and k_sel <= 41 and q > 64:
        assert plan["bq"] == 128 and plan["stages"] == 4


@pytest.mark.parametrize("k_sel", [1, 16, 41, 128])
def test_pass_a_int8_plan_raises_exactly_past_its_widest_d(k_sel):
    widest = ttopk.pass_a_max_d(k_sel, 1)
    assert widest >= 2 * ttopk.pass_a_max_d(k_sel) - 64 and widest % 64 == 0
    for q in _PLAN_Q:
        ttopk.pass_a_int8_plan(q, widest, k_sel, 1000, 32)
        with pytest.raises(ValueError, match=f"int8.*widths up to {widest}"):
            ttopk.pass_a_int8_plan(q, widest + 16, k_sel, 1000, 32)
    assert ttopk.pass_a_smem_bytes(64, widest + 64, 2, k_sel, 1) > \
        ttopk.SMEM_LIMIT


# the f32 schedules' plans (csrc/tf32_mainloop.cuh): 128 query rows a CTA
# (64 for a batch of at most 64) on the deepest ring of 48 KB stages that
# fits beside the lists, whatever the width
_F32_PLAN_D = [4, 32, 100, 384, 1024, 2048, 4096]


@pytest.mark.parametrize("k_sel", [1, 11, 33, 34, 41, 81, 82, 128])
@pytest.mark.parametrize("seg_rows", [1, 2, 4, 8, 32, 128, 256])
def test_pass_a_f32_plan_fits_at_any_width(k_sel, seg_rows):
    """Pass A's f32 schedule: the same plan at every width (nothing in
    shared memory grows with it), within 232,448 bytes, on the deepest ring
    that fits (4 stages at k_sel <= 33, 3 to 81, 2 past that on 128-row
    tiles), splits of whole segments and tiles as for the bf16 schedule."""
    n_segs = 40000 // seg_rows + 1
    for q in _PLAN_Q:
        plans = [ttopk.pass_a_f32_plan(q, d, k_sel, n_segs, seg_rows)
                 for d in _F32_PLAN_D]
        assert all(p == plans[0] for p in plans)
        plan = plans[0]
        bq, stages = plan["bq"], plan["stages"]
        assert bq == (128 if q > 64 else 64) and 2 <= stages <= 4
        assert plan["smem"] == ttopk.pass_a_f32_smem_bytes(
            bq, stages, k_sel) <= ttopk.SMEM_LIMIT == 232448
        assert (stages == 4 or ttopk.pass_a_f32_smem_bytes(
            bq, stages + 1, k_sel) > ttopk.SMEM_LIMIT)
        if bq == 128:
            assert stages == (4 if k_sel <= 33 else 3 if k_sel <= 81 else 2)
        assert plan["n_splits"] == ttopk._segment_splits(
            -(-q // bq), n_segs, seg_rows, 132)
    # a stage is the query tile's K chunk, the corpus tile's and its lo plane
    assert ttopk.pass_a_f32_smem_bytes(128, 2, 1) - ttopk.pass_a_f32_smem_bytes(
        128, 1, 1) == 128 * 128 + 2 * 128 * 128


@pytest.mark.parametrize("k", [1, 128, 200, 712, 2048])
@pytest.mark.parametrize("q", _PLAN_Q)
def test_fused_f32_plan_keeps_splits_at_4k_rows(q, k):
    """The fused kernel's f32 schedule: the same plan at every width, 4
    stages within 232,448 bytes, the bf16 schedule's buffers, and splits of
    at least 4k rows."""
    for vn in (0, 100, 20011, 22000, 1_250_000):
        plans = [ttopk.fused_f32_plan(q, d, k, vn) for d in _F32_PLAN_D]
        assert all(p == plans[0] for p in plans)
        plan = plans[0]
        assert plan["bq"] == (128 if q > 64 else 64) and plan["stages"] == 4
        assert plan["smem"] == ttopk.fused_f32_smem_bytes(
            plan["bq"], 4) <= ttopk.SMEM_LIMIT
        assert plan["cap"] == 2 * k + 128
        assert plan["scratch"] == plan["n_splits"] * q * (plan["cap"] * 8 + 4)
        if plan["n_splits"] > 1:
            rows = -(-(-(-vn // 128)) // plan["n_splits"]) * 128
            assert rows >= 4 * k and vn - (plan["n_splits"] - 1) * rows >= 4 * k


@pytest.mark.parametrize("d", [30, 100])
def test_f32_width_pad_keeps_the_plain_result(rng, d):
    """The f32 schedules' tensor maps need widths that are multiples of 4:
    the wrappers pad other widths with zero columns, one copy each, and
    leave the rest alone. On the padded operands the plain pass A and the
    plain fused top-k give the unpadded results: bit for bit on integer
    rows, within D * 2^-24 on unit rows with ids equal outside near-ties."""
    w = -(-d // 4) * 4
    Qi = torch.from_numpy(rng.integers(-8, 9, size=(9, d)).astype(np.float32))
    Ci = torch.from_numpy(rng.integers(-8, 9, size=(700, d)).astype(np.float32))
    Ci[350:] = Ci[:350].clone()
    Qu, Cu = (torch.from_numpy(_unit(rng, s)) for s in ((9, d), (700, d)))
    tol = d * 2.0 ** -24
    for Q, C, exact in ((Qi, Ci, True), (Qu, Cu, False)):
        Qp, Cp = ttopk._pad_f32_width(Q, C)
        assert Qp.shape == (9, w) and Cp.shape == (700, w)
        assert torch.equal(Qp[:, :d], Q) and torch.equal(Cp[:, :d], C)
        assert not Qp[:, d:].any() and not Cp[:, d:].any()
        if w == d:  # nothing copied
            assert Qp is Q and Cp is C
        pairs = [(ttopk.segtopk_pass_a_plain(Qp, Cp, 700, 8, 21),
                  ttopk.segtopk_pass_a_plain(Q, C, 700, 8, 21)),
                 (ttopk.topk_scores_fused_plain(Qp, Cp, 150),
                  ttopk.topk_scores_fused_plain(Q, C, 150))]
        for (pv, pi), (v, i) in pairs:
            if exact:
                assert torch.equal(pi, i) and torch.equal(pv, v)
            else:
                assert float((pv - v).abs().max()) <= tol
                gap = (v[:, 1:] - v[:, :-1]).abs() > 2 * tol
                apart = torch.ones_like(v, dtype=torch.bool)
                apart[:, 1:] &= gap
                apart[:, :-1] &= gap
                assert torch.equal(pi[apart], i[apart])
    # bf16 operands and widths that are multiples of 4 pass untouched
    b = Qi.to(torch.bfloat16)
    assert ttopk._pad_f32_width(b, b)[0] is b


@pytest.mark.parametrize("d", [30, 100])
def test_bf16_width_pad_keeps_the_plain_result(rng, d):
    """The bf16 schedules' tensor maps need widths that are multiples of 8:
    the wrappers pad other widths with zero columns, one copy each. On the
    padded operands the plain pass A and the plain fused top-k give the
    unpadded results bit for bit (integer rows: every sum is exact)."""
    w = -(-d // 8) * 8
    Q = torch.from_numpy(rng.integers(-127, 128, size=(9, d))).to(
        torch.bfloat16)
    C = torch.from_numpy(rng.integers(-127, 128, size=(700, d))).to(
        torch.bfloat16)
    C[350:] = C[:350].clone()  # ties in scores and segment maxima
    Qp, Cp = ttopk._pad_bf16_width(Q, C)
    assert Qp.shape == (9, w) and Cp.shape == (700, w)
    assert torch.equal(Qp[:, :d], Q) and torch.equal(Cp[:, :d], C)
    assert not Qp[:, d:].any() and not Cp[:, d:].any()
    for (pv, pi), (v, i) in [
            (ttopk.segtopk_pass_a_plain(Qp, Cp, 700, 8, 21),
             ttopk.segtopk_pass_a_plain(Q, C, 700, 8, 21)),
            (ttopk.topk_scores_fused_plain(Qp, Cp, 150),
             ttopk.topk_scores_fused_plain(Q, C, 150))]:
        assert torch.equal(pi, i) and torch.equal(pv, v)
    # f32 operands and widths that are multiples of 8 pass untouched
    f = Q.float()
    assert ttopk._pad_bf16_width(f, f)[0] is f
    q8 = Qp[:, :8].contiguous()
    assert ttopk._pad_bf16_width(q8, q8)[0] is q8


@pytest.mark.parametrize("d", [30, 100])
@pytest.mark.parametrize("integer", [True, False])
def test_tf32x3_pass_a_model_matches_jax_kernel(rng, monkeypatch, d, integer):
    """Pass A on 3xTF32 scores (the f32 schedule's numerics, modelled in
    torch) against the JAX pass-A kernel in interpret mode: on integer rows
    with ties bit for bit, ids and tie order included; on unit rows values
    within D * 2^-24, ids equal outside near-ties."""
    from _tf32_model import segtopk_model

    if integer:
        Q = rng.integers(-8, 9, size=(6, d)).astype(np.float32)
        C = rng.integers(-8, 9, size=(700, d)).astype(np.float32)
        C[350:] = C[:350]
    else:
        Q, C = _unit(rng, (6, d)), _unit(rng, (700, d))
    jv, ji = (x[:, :10] for x in _jax_pass_a(Q, C, 9, 256, monkeypatch))
    mv, mi = segtopk_model(torch.from_numpy(Q), torch.from_numpy(C), 700, 2,
                           10)
    mv, mi = mv.numpy(), mi.numpy()
    if integer:
        np.testing.assert_array_equal(mi, ji)
        np.testing.assert_array_equal(mv, jv)
    else:
        tol = d * 2.0 ** -24
        np.testing.assert_allclose(mv, jv, rtol=0, atol=tol)
        gap = np.abs(np.diff(jv, axis=1)) > 2 * tol
        apart = np.ones_like(jv, dtype=bool)
        apart[:, 1:] &= gap
        apart[:, :-1] &= gap
        np.testing.assert_array_equal(mi[apart], ji[apart])


# ------------------------------------------------------------------ pass B

def _pass_b_reference(Q, C, seg_ids, n, L2, k):
    """Pass B written out per query in Python: every candidate's (score,
    position, row), invalid ones at NEG_INF and unread, sorted by score
    descending with ties to the earlier position."""
    vals, ids = [], []
    for qi, segs in enumerate(seg_ids):
        cands = []
        for s, seg in enumerate(segs):
            for j in range(L2):
                row = max(int(seg), 0) * L2 + j
                valid = seg >= 0 and row < n
                score = float(Q[qi] @ C[row]) if valid else ttopk.NEG_INF
                cands.append((np.float32(score), s * L2 + j, row))
        cands.sort(key=lambda t: -t[0])  # stable: ties keep position order
        vals.append([v for v, _, _ in cands[:k]])
        ids.append([r for _, _, r in cands[:k]])
    return np.array(vals, np.float32), np.array(ids, np.int32)


# (n, L2, k_sel, k, seg rows): placeholders, a last segment past n, k = 1,
# k = 127 at k_sel 128, L2 = 128, one-row segments
PASS_B_CASES = [
    (50, 4, 6, 5, [[0, 3, 12, -4, -5, -6], [12, 11, 10, 9, 8, 7]]),
    (50, 4, 6, 24, [[12, 0, -3, -4, -5, -6], [1, 2, 3, 4, 5, 6]]),
    (301, 32, 5, 1, [[9, 0, 4, 2, 1], [3, -2, -3, -4, -5]]),
    (400, 1, 128, 127, [list(range(0, 384, 3))[:128],
                        list(range(399, 271, -1))]),
    (300, 128, 3, 127, [[2, 0, 1], [1, -2, -3]]),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,L2,k_sel,k,segs", PASS_B_CASES)
def test_pass_b_rescore_on_the_cpu(rng, dtype, n, L2, k_sel, k, segs):
    """Integer rows with ties inside a segment and across segments: the
    wrapper on CPU tensors equals the plain version at every query chunk,
    and both equal the reference written out per query, values bit for
    bit; no kernel is launched."""
    d = 24
    base = rng.integers(-4, 5, size=(n // 3 + 1, d))
    C = np.concatenate([base, base[::-1], base])[:n + 5].astype(np.float32)
    C[n:] = np.nan  # rows past n must never be read
    Q = rng.integers(-4, 5, size=(len(segs), d)).astype(np.float32)
    seg_ids = torch.tensor(segs, dtype=torch.int32)
    Qt, Ct = torch.from_numpy(Q).to(dtype), torch.from_numpy(C).to(dtype)
    before = ttopk.PASS_B_LAUNCHES
    v, i = ttopk.pass_b_rescore(Qt, Ct[:n], seg_ids, n, L2, k)
    assert ttopk.PASS_B_LAUNCHES == before
    assert v.dtype == torch.float32 and i.dtype == torch.int32
    assert v.shape == i.shape == (len(segs), k)
    for q_chunk in (1, 256):
        pv, pi = ttopk.pass_b_rescore_plain(Qt, Ct[:n], seg_ids, n, L2, k,
                                            q_chunk)
        assert torch.equal(v, pv) and torch.equal(i, pi)
    rv, ri = _pass_b_reference(Q, C, segs, n, L2, k)
    np.testing.assert_array_equal(i.numpy(), ri)
    np.testing.assert_array_equal(v.numpy(), rv)


def test_pass_b_rescore_refuses_k_outside_its_candidates():
    Q, C = torch.zeros((2, 8)), torch.zeros((40, 8))
    segs = torch.zeros((2, 3), dtype=torch.int32)
    for k in (0, 13):
        with pytest.raises(ValueError, match="k_sel"):
            ttopk.pass_b_rescore(Q, C, segs, 40, 4, k)
    with pytest.raises(ValueError, match="corpus"):
        ttopk.pass_b_rescore(Q, C, segs, 41, 4, 3)


@pytest.mark.parametrize("k_sel,L2", [(128, 128), (11, 32), (41, 32),
                                      (12, 4)])
def test_pass_b_smem_fits_every_two_pass_shape(k_sel, L2):
    """Every segment length block_n <= 16384 gives (up to 128 rows) at
    every k_sel up to 128, at the widest bf16 pass A, fits; f32 widths fit
    up to the shared memory's own limit."""
    assert ttopk.pass_b_smem_bytes(ttopk.pass_a_max_d(k_sel), k_sel,
                                   L2) <= ttopk.SMEM_LIMIT
    d = (ttopk.SMEM_LIMIT - ttopk.pass_b_smem_bytes(0, k_sel, L2)) // 16 * 4
    assert ttopk.pass_b_smem_bytes(d, k_sel, L2) <= ttopk.SMEM_LIMIT
    assert ttopk.pass_b_smem_bytes(d + 4, k_sel, L2) > ttopk.SMEM_LIMIT
    assert d > 40000
