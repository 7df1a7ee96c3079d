"""The Hopper kernels against their plain versions, on a CUDA device.

Marked ``cuda``; each test skips without a card. On the card (no JAX
needed there):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

Pass A (all four schedules) and the fused top-k run on integer-valued
bf16, int8 or f32 inputs, whose dot products are exact in f32 whatever the
summation order, so kernel and plain version must agree bit for bit. On
unit-norm f32 rows the f32 schedules agree with the plain f32 product (TF32
off) to D * 2^-24 (a D-long f32 chain's worst case), and in ids wherever
the plain values are more than twice that apart.
Flash attention runs in bf16/fp16 against the f32 plain math, to atol 1e-2
(a few half-precision ulps at the outputs' scale), and in f32 (3xTF32) to
the JAX test's 2e-5.
The similarity kernel accumulates in f32 (3xTF32 on f32 input, bf16
products on bf16 input): bit-equal to its plain version on integer-valued
rows (f32 or bf16 input), within 1e-5 of it on unit-norm f32 rows (the
split drops 2^-22 of each product; the accumulations round at most a few
ulps of a sum of magnitude at most 1) and D * 2^-24 on bf16 ones, and
always bit-symmetric, bit-reproducible and the same for a document alone
as in its padded bucket."""
import ctypes

import numpy as np
import pytest
import torch

from semanticsearch_tpu_torch.ops import flash_attention as fa
from semanticsearch_tpu_torch.ops import similarity as sim
from semanticsearch_tpu_torch.ops import topk

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _grid(shape, seed, dev, dtype=torch.bfloat16):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randint(-127, 128, shape, generator=g, device=dev,
                         dtype=torch.int16).to(dtype)


PASS_A_CASES = [
    (64, 4096, 384, 32, 11),     # whole tiles
    (200, 20011, 384, 32, 41),   # ragged corpus and query tiles
    (5, 300, 384, 32, 41),       # fewer segments than k_sel: placeholders
    (70, 5000, 384, 256, 41),    # segments spanning several tiles
    (33, 1000, 128, 1, 11),      # one-row segments
    (17, 3000, 72, 8, 20),       # width not a multiple of the K chunk
    (1, 5000, 384, 32, 11),      # one query
    (65, 4097, 384, 32, 11),     # one query past a 64-row tile; tiles + 1 row
    (129, 20011, 384, 32, 41),   # one query past a 128-row tile
    (40, 100, 384, 8, 11),       # a corpus smaller than one tile
    (64, 129, 384, 32, 5),       # one tile plus one row
    (200, 30000, 128, 32, 128),  # the largest k_sel
    (70, 3000, 384, 2, 20),      # segments inside a thread's column pair
    (70, 3000, 384, 4, 20),      # ... inside half a quad
    (70, 3000, 384, 16, 20),
    (70, 3000, 384, 64, 20),
    (70, 9000, 384, 128, 20),    # a segment per tile
    (130, 5000, 384, 512, 7),    # segments of four tiles
    (33, 2000, 8, 32, 11),       # the narrowest width
    (150, 6000, 768, 32, 11),    # a width that leaves room for 64-row tiles only
]
# the overlap schedule runs two warpgroups on 128-row query tiles over a
# deeper ring (more than 64 queries): every way a segment lies in the
# registers, ragged query tiles and corpus ends, one K chunk a tile, an odd
# count of them, eight (a ring shorter than a tile), k_sel 128 (64-row
# tiles) and the serve shape (one warpgroup)
OVERLAP_CASES = PASS_A_CASES + [
    (64, 20000, 384, 32, 41),    # the serve shape
    (200, 20011, 384, 1, 41),
    (200, 20011, 384, 2, 41),
    (200, 20011, 384, 4, 41),
    (200, 20011, 384, 8, 41),
    (200, 20011, 384, 32, 41),
    (200, 20011, 384, 128, 41),
    (200, 20011, 384, 256, 41),
    (200, 3000, 72, 8, 20),      # D = 72 on 128-row tiles
    (300, 10000, 64, 32, 11),    # one K chunk a tile
    (300, 10000, 320, 16, 11),   # five K chunks a tile
    (300, 50000, 512, 32, 11),   # eight K chunks, five stages
    (1000, 100000, 384, 32, 11), # several query tiles and splits
    (200, 30000, 384, 32, 128),  # k_sel 128: 64-row tiles
]
# the int8 schedule (s8 wgmma) at the same layouts, at widths rounded up to
# the 16 its TMA rows need and at the widths themselves (the wrapper pads
# them); k_sel 16 and 128; the serve and a many-query shape
PASS_A_INT8_CASES = [(q, n, -(-d // 16) * 16, seg_rows, k_sel)
                     for q, n, d, seg_rows, k_sel in PASS_A_CASES] + [
    (17, 3000, 72, 8, 20), (33, 2000, 8, 32, 11), (64, 20000, 384, 32, 16),
    (64, 20000, 384, 32, 128), (1000, 100000, 384, 32, 16),
    (300, 50000, 72, 32, 128)]


@pytest.mark.parametrize("q,n,d,seg_rows,k_sel", PASS_A_CASES)
def test_segtopk_kernel_matches_plain(dev, q, n, d, seg_rows, k_sel):
    Q, C = _grid((q, d), 1, dev), _grid((n, d), 2, dev)
    launches = topk.SEGTOPK_LAUNCHES
    kv, ki = topk.segtopk_pass_a(Q, C, n, seg_rows, k_sel)
    pv, pi = topk.segtopk_pass_a_plain(Q, C, n, seg_rows, k_sel)
    torch.cuda.synchronize()
    assert topk.SEGTOPK_LAUNCHES == launches + 1
    assert torch.equal(ki, pi)
    assert torch.equal(kv, pv)


@pytest.mark.parametrize("q,n,d,seg_rows,k_sel", OVERLAP_CASES)
def test_segtopk_overlap_is_bit_identical(dev, q, n, d, seg_rows, k_sel):
    Q, C = _grid((q, d), 3, dev), _grid((n, d), 4, dev)
    launches = topk.SEGTOPK_OVERLAP_LAUNCHES
    ov, oi = topk.segtopk_pass_a_overlap(Q, C, n, seg_rows, k_sel)
    kv, ki = topk.segtopk_pass_a(Q, C, n, seg_rows, k_sel)
    pv, pi = topk.segtopk_pass_a_plain(Q, C, n, seg_rows, k_sel)
    torch.cuda.synchronize()
    assert topk.SEGTOPK_OVERLAP_LAUNCHES == launches + 1
    assert torch.equal(oi, ki) and torch.equal(ov, kv)
    assert torch.equal(oi, pi) and torch.equal(ov, pv)


def test_segtopk_overlap_on_unit_rows_equals_default(dev):
    """Real-valued scores (not integers): the two schedules sum the same
    products in the same order, so they agree bit for bit here too."""
    g = torch.Generator(device=dev).manual_seed(30)
    Q = torch.randn((700, 384), generator=g, device=dev).bfloat16()
    C = torch.randn((60000, 384), generator=g, device=dev).bfloat16()
    ov, oi = topk.segtopk_pass_a_overlap(Q, C, 60000, 32, 41)
    kv, ki = topk.segtopk_pass_a(Q, C, 60000, 32, 41)
    assert torch.equal(oi, ki) and torch.equal(ov, kv)


@pytest.mark.parametrize("q,n,d,seg_rows,k_sel", PASS_A_INT8_CASES)
def test_segtopk_int8_kernel_matches_plain(dev, q, n, d, seg_rows, k_sel):
    Q, C = _grid((q, d), 5, dev, torch.int8), _grid((n, d), 6, dev, torch.int8)
    launches = topk.SEGTOPK_INT8_LAUNCHES
    kv, ki = topk.segtopk_pass_a_int8(Q, C, n, seg_rows, k_sel)
    pv, pi = topk.segtopk_pass_a_int8_plain(Q, C, n, seg_rows, k_sel)
    torch.cuda.synchronize()
    assert topk.SEGTOPK_INT8_LAUNCHES == launches + 1
    assert torch.equal(ki, pi)
    assert torch.equal(kv, pv)


def test_segtopk_never_reads_rows_past_n(dev):
    """A corpus tensor longer than ``n``, with large values past it: the
    kernel scores rows at or past n as zeros, like the plain version."""
    Q = _grid((70, 384), 21, dev)
    C = _grid((5000, 384), 22, dev)
    C[4001:] = 127.0
    Q[:, 0] = 127.0
    for n, seg_rows in [(4001, 32), (4001, 256), (3968, 32), (77, 8)]:
        kv, ki = topk.segtopk_pass_a(Q, C, n, seg_rows, 11)
        pv, pi = topk.segtopk_pass_a_plain(Q, C[:n].clone(), n, seg_rows, 11)
        assert torch.equal(ki, pi) and torch.equal(kv, pv), (n, seg_rows)


def test_topk_kernels_on_a_side_stream(dev):
    """Launched on a non-default stream, both kernels see the operands that
    stream made and hand their results to it."""
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        Q, C = _grid((129, 384), 23, dev), _grid((20011, 384), 24, dev)
        av, ai = topk.segtopk_pass_a(Q, C, 20011, 32, 41)
        fv, fi = topk.topk_scores_fused(Q, C, 200)
        av, ai, fv, fi = av.cpu(), ai.cpu(), fv.cpu(), fi.cpu()
    side.synchronize()
    pv, pi = topk.segtopk_pass_a_plain(Q, C, 20011, 32, 41)
    assert torch.equal(ai, pi.cpu()) and torch.equal(av, pv.cpu())
    pv, pi = topk.topk_scores_fused_plain(Q, C, 200)
    assert torch.equal(fi, pi.cpu()) and torch.equal(fv, pv.cpu())


def test_wgmma_kernels_refuse_widths_past_their_plans(dev):
    x = torch.zeros((4, topk.fused_max_d() + 64), device=dev,
                    dtype=torch.bfloat16)
    launches = topk.SEGTOPK_LAUNCHES, topk.TOPK_FUSED_LAUNCHES
    with pytest.raises(ValueError, match="widths up to"):
        topk.topk_scores_fused(x, x, 2)
    wide = torch.zeros((4, topk.pass_a_max_d(2) + 64), device=dev,
                       dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="widths up to"):
        topk.segtopk_pass_a(wide, wide, 4, 1, 2)
    assert launches == (topk.SEGTOPK_LAUNCHES, topk.TOPK_FUSED_LAUNCHES)
    y = _grid((9, 1024), 25, dev)  # the widest the earlier kernels took
    C = _grid((700, 1024), 26, dev)
    kv, ki = topk.segtopk_pass_a(y, C, 700, 8, 20)
    pv, pi = topk.segtopk_pass_a_plain(y, C, 700, 8, 20)
    assert torch.equal(ki, pi) and torch.equal(kv, pv)
    kv, ki = topk.topk_scores_fused(y, C, 300)
    pv, pi = topk.topk_scores_fused_plain(y, C, 300)
    assert torch.equal(ki, pi) and torch.equal(kv, pv)


def test_segtopk_int8_pads_width_not_multiple_of_16(dev):
    """D = 72 int8 operands: the wrapper pads them to 80 columns of zeros
    and the s8 kernel equals the plain version bit for bit."""
    Q, C = _grid((17, 72), 5, dev, torch.int8), _grid((3000, 72), 6, dev,
                                                      torch.int8)
    launches = topk.SEGTOPK_INT8_LAUNCHES
    kv, ki = topk.segtopk_pass_a_int8(Q, C, 3000, 8, 20)
    pv, pi = topk.segtopk_pass_a_int8_plain(Q, C, 3000, 8, 20)
    assert topk.SEGTOPK_INT8_LAUNCHES == launches + 1
    assert torch.equal(ki, pi) and torch.equal(kv, pv)


@pytest.mark.parametrize("q,n,d,k,valid_n", [
    (64, 4096, 384, 128, -1),    # whole tiles
    (200, 20011, 384, 200, -1),  # ragged corpus and query tiles
    (33, 1000, 128, 129, 900),   # rows past valid_n never appear
    (5, 300, 384, 500, -1),      # k > rows: (-1e30, 0) tail
    (70, 50000, 384, 2048, -1),  # the largest k
    (9, 3000, 80, 300, -1),      # width not a multiple of the K chunk
    (9, 3000, 72, 300, -1),      # ... nor of the 16-wide MMA step
    (1, 5000, 384, 200, -1),     # one query
    (65, 4097, 384, 128, -1),    # one query past a 64-row tile; tiles + 1 row
    (129, 20011, 384, 200, -1),  # one query past a 128-row tile
    (40, 100, 384, 50, -1),      # a corpus smaller than one tile
    (64, 129, 384, 129, -1),     # one tile plus one row, k = rows
    (129, 60000, 384, 2048, -1), # the largest k on 128-row tiles
    (300, 40000, 384, 1, -1),    # the smallest k
    (33, 2000, 8, 100, -1),      # the narrowest width
    (150, 6000, 768, 200, -1),   # a width that leaves room for 64-row tiles only
    (70, 5000, 384, 200, 0),     # no valid row at all
])
def test_topk_fused_kernel_matches_plain(dev, q, n, d, k, valid_n):
    Q, C = _grid((q, d), 7, dev), _grid((n, d), 8, dev)
    launches = topk.TOPK_FUSED_LAUNCHES
    kv, ki = topk.topk_scores_fused(Q, C, k, valid_n=valid_n)
    pv, pi = topk.topk_scores_fused_plain(Q, C, k, valid_n=valid_n)
    torch.cuda.synchronize()
    assert topk.TOPK_FUSED_LAUNCHES == launches + 1
    assert torch.equal(ki, pi)
    assert torch.equal(kv, pv)


def test_topk_fused_never_reads_rows_past_valid_n(dev):
    Q = _grid((70, 384), 27, dev)
    C = _grid((5000, 384), 28, dev)
    C[4001:] = 127.0
    Q[:, 0] = 127.0
    for vn in (4001, 3968, 77):
        kv, ki = topk.topk_scores_fused(Q, C, 150, valid_n=vn)
        pv, pi = topk.topk_scores_fused_plain(Q, C, 150, valid_n=vn)
        assert int(ki.max()) < vn
        assert torch.equal(ki, pi) and torch.equal(kv, pv), vn


def test_topk_fused_all_scores_equal(dev):
    """Zero queries tie every row: the k lowest rows, in order."""
    Q = torch.zeros((5, 384), device=dev, dtype=torch.bfloat16)
    C = _grid((30000, 384), 29, dev)
    kv, ki = topk.topk_scores_fused(Q, C, 300)
    assert torch.equal(ki, torch.arange(300, device=dev, dtype=torch.int32)
                       .expand(5, 300))
    assert float(kv.abs().max()) == 0.0


def test_topk_fused_ties_across_splits(dev):
    """Duplicate rows far apart land in different corpus splits; equal
    scores must come out in ascending row order."""
    base = _grid((40, 128), 9, dev)
    C = torch.cat([base] * 250)  # 10,000 rows, each value 250 times
    Q = base[:3]
    kv, ki = topk.topk_scores_fused(Q, C, 700)
    pv, pi = topk.topk_scores_fused_plain(Q, C, 700)
    assert torch.equal(ki, pi) and torch.equal(kv, pv)
    # many splits (a few queries over a long corpus): the round-by-round merge
    C = torch.cat([base] * 2500)
    assert topk.fused_plan(3, 128, 200, C.shape[0])["n_splits"] * 200 > 12288
    kv, ki = topk.topk_scores_fused(Q, C, 200)
    pv, pi = topk.topk_scores_fused_plain(Q, C, 200)
    assert torch.equal(ki, pi) and torch.equal(kv, pv)


def test_twopass_int8_and_overlap_paths_match_cpu(dev):
    Q, C = _grid((300, 384), 10, dev), _grid((50000, 384), 11, dev)
    for kw in ({"pass_a_int8": True}, {"mxu_overlap": True}):
        kv, ki = topk.topk_scores_twopass(Q, C, k=40, block_n=16384,
                                          seg_split=4, **kw)
        pv, pi = topk.topk_scores_twopass(Q.cpu(), C.cpu(), k=40,
                                          block_n=16384, seg_split=4, **kw)
        assert torch.equal(ki.cpu(), pi), kw
        assert torch.equal(kv.cpu(), pv), kw


def test_twopass_kernel_path_matches_plain_path(dev):
    Q, C = _grid((300, 384), 3, dev), _grid((50000, 384), 4, dev)
    kv, ki = topk.topk_scores_twopass(Q, C, k=40, block_n=16384, seg_split=4)
    pv, pi = topk.topk_scores_twopass(Q.cpu(), C.cpu(), k=40, block_n=16384,
                                      seg_split=4)
    assert torch.equal(ki.cpu(), pi)
    assert torch.equal(kv.cpu(), pv)


def _flash_inputs(shape, dtype, layout, g, dev):
    """q, k, v of logical shape (B, H, T, Dh): contiguous, or the
    encoder's transposed views of (B, T, H, Dh) tensors."""
    b, h, t, dh = shape
    if layout == "contiguous":
        return [torch.randn(shape, generator=g, device=dev).to(dtype)
                for _ in range(3)]
    return [torch.randn((b, t, h, dh), generator=g, device=dev).to(dtype)
            .transpose(1, 2) for _ in range(3)]


@pytest.mark.parametrize("layout", ["contiguous", "transposed"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("b,h,t,dh", [(3, 12, 64, 32), (2, 12, 256, 32),
                                      (1, 4, 1024, 32), (2, 2, 128, 16),
                                      (2, 2, 128, 64), (2, 2, 128, 128),
                                      (3, 2, 192, 64), (2, 2, 512, 128),
                                      (2, 3, 1024, 16),
                                      # enough CTAs that each takes several
                                      # heads in turn (2, 3 and 6)
                                      (1024, 4, 64, 128), (512, 12, 128, 64),
                                      (600, 12, 256, 16)])
def test_flash_kernel_matches_plain(dev, layout, dtype, b, h, t, dh):
    g = torch.Generator(device=dev).manual_seed(5)
    q, k, v = _flash_inputs((b, h, t, dh), dtype, layout, g, dev)
    mask = torch.ones((b, t), device=dev)
    mask[:, t - t // 3:] = 0.0
    mask[0, :] = 0.0  # every key masked: the mean of V
    if b > 2:
        mask[2, 64:] = 0.0  # all but the first key block masked: skipped
    got = fa.flash_attention(q, k, v, mask)
    want = fa.flash_attention_plain(q, k, v, mask)
    assert got.shape == q.shape and got.stride() == q.stride()
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=0, atol=1e-2)


@pytest.mark.parametrize("heads_per_cta", ["one", "several"])
@pytest.mark.parametrize("t", [128, 256, 1024])
def test_flash_skips_blocks_without_a_real_key(dev, heads_per_cta, t):
    """A key block with no real key is skipped for a row that has one,
    whether such blocks lead, trail or sit between live ones: NaN keys and
    values there change no bit of the output (a block that ran would give
    0 * NaN = NaN). A batch large enough for 4,096 CTAs of one head lets
    each CTA take several heads in turn."""
    b, h = (4, 2) if heads_per_cta == "one" else (131072 // t, 4)
    g = torch.Generator(device=dev).manual_seed(15)
    q, k, v = (torch.randn((b, h, t, 32), generator=g, device=dev)
               .to(torch.bfloat16) for _ in range(3))
    pattern = torch.zeros((4, t), device=dev)
    pattern[0, :64] = 1.0                    # live block, dead tail
    pattern[1, t - 64: t - 10] = 1.0         # dead lead
    pattern[2, :30] = 1.0                    # live, dead, ..., live
    pattern[2, t - 64: t - 40] = 1.0
    pattern[3, 5] = 1.0                      # a single real key
    mask = pattern.repeat(b // 4, 1)
    got = fa.flash_attention(q, k, v, mask)
    dead = (mask.view(b, t // 64, 64) == 0).all(dim=2)  # (B, blocks)
    keys = dead.repeat_interleave(64, dim=1)[:, None, :, None]
    k2 = torch.where(keys, torch.full_like(k, float("nan")), k)
    v2 = torch.where(keys, torch.full_like(v, float("nan")), v)
    again = fa.flash_attention(q, k2, v2, mask)
    assert bool(torch.isfinite(got).all()) and torch.equal(got, again)
    want = fa.flash_attention_plain(q, k, v, mask)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=0, atol=1e-2)


def test_flash_reads_the_encoders_views_without_copies(dev):
    """The encoder hands the kernel transposed (B, T, H, Dh) views: the
    wrapper allocates the output and nothing else, and the output's own
    transpose back is contiguous, so the reshape after it is free."""
    b, t, h, dh = 64, 256, 12, 32
    g = torch.Generator(device=dev).manual_seed(16)
    x = [torch.randn((b, t, h * dh), generator=g, device=dev)
         .to(torch.bfloat16) for _ in range(3)]
    q, k, v = (y.view(b, t, h, dh).transpose(1, 2) for y in x)
    mask = torch.ones((b, t), device=dev)
    fa.flash_attention(q, k, v, mask)  # builds and loads the kernel
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    launches = fa.FLASH_LAUNCHES
    out = fa.flash_attention(q, k, v, mask)
    torch.cuda.synchronize()
    assert fa.FLASH_LAUNCHES == launches + 1
    assert out.transpose(1, 2).is_contiguous()
    out_bytes = out.numel() * out.element_size()
    assert torch.cuda.memory_allocated() - before == out_bytes
    assert torch.cuda.max_memory_allocated() - before == out_bytes
    want = fa.flash_attention_plain(q, k, v, mask)
    np.testing.assert_allclose(out.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=0, atol=1e-2)


@pytest.mark.parametrize("b", [2048, 813])
def test_flash_kernel_at_the_chunking_batch(dev, b):
    """The chunking pipeline's encoder batches: up to 2,048 short sentences
    in the 64 bucket, each row keeping its own few leading keys."""
    g = torch.Generator(device=dev).manual_seed(8)
    q, k, v = _flash_inputs((b, 12, 64, 32), torch.bfloat16, "transposed", g,
                            dev)
    lens = torch.randint(3, 13, (b,), generator=g, device=dev)
    mask = (torch.arange(64, device=dev)[None, :] < lens[:, None]).float()
    got = fa.flash_attention(q, k, v, mask)
    want = fa.flash_attention_plain(q, k, v, mask)
    # a mean over 3-12 values of V reaches |o| = 3, where one bf16 ulp is
    # 1.6e-2: 5 ulps of each output, the 1e-2 of the other cases at 0.5
    diff = (got.float() - want.float()).abs()
    assert bool(torch.isfinite(got).all())
    assert float((diff / want.float().abs().clamp(min=0.5)).max()) <= 2e-2


def test_flash_backward_on_cuda(dev):
    g = torch.Generator(device=dev).manual_seed(6)
    q, k, v = (torch.randn((1, 2, 128, 32), generator=g, device=dev)
               .to(torch.bfloat16).requires_grad_(True) for _ in range(3))
    mask = torch.ones((1, 128), device=dev)
    fa.flash_attention(q, k, v, mask).float().sum().backward()
    q2, k2, v2 = (x.detach().requires_grad_(True) for x in (q, k, v))
    fa.flash_attention_plain(q2, k2, v2, mask).float().sum().backward()
    for a, b in ((q, q2), (k, k2), (v, v2)):
        assert torch.equal(a.grad, b.grad)


# ------------------------------------------------- f32 schedules (top-k)

def _small_grid(shape, seed, dev):
    """f32 integers in [-8, 8]: every dot product exact in f32, and many
    equal scores."""
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randint(-8, 9, shape, generator=g, device=dev).float()


def _tied(C):
    """Each row of the first half again in the second: equal scores (and
    equal segment maxima) far apart in the corpus."""
    n = C.shape[0]
    C[n - n // 2:] = C[: n // 2].clone()
    return C


def _unit(shape, seed, dev):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(shape, generator=g, device=dev)
    return x / x.norm(dim=1, keepdim=True)


def _near_tie_agree(v, i, pv, pi, tol):
    """A (Q, k) result against a (Q, k+1) plain one: (max |v - pv|, id
    mismatches where the plain value is more than 2 tol from both its
    neighbours, id mismatches skipped inside such near-ties)."""
    k = v.shape[1]
    err = float((v - pv[:, :k]).abs().max())
    close = (pv[:, 1:] - pv[:, :-1]).abs() <= 2 * tol
    near = torch.zeros_like(pv, dtype=torch.bool)
    near[:, 1:] |= close
    near[:, :-1] |= close
    mism = i != pi[:, :k]
    return (err, int((mism & ~near[:, :k]).sum()),
            int((mism & near[:, :k]).sum()))


F32_PASS_A_CASES = [
    (64, 4096, 384, 32, 11),     # whole tiles
    (200, 20011, 384, 32, 41),   # ragged corpus and query tiles
    (5, 300, 384, 32, 41),       # fewer segments than k_sel: placeholders
    (70, 5000, 384, 256, 41),    # segments spanning several tiles
    (33, 1000, 128, 1, 11),      # one-row segments
    (17, 3000, 72, 8, 20),       # D = 72
    (9, 3000, 100, 16, 20),      # a width that is not a multiple of 8
    (33, 2000, 30, 32, 11),      # ... nor of 4: scalar loads
    (1, 5000, 384, 32, 11),      # one query
    (65, 4097, 384, 32, 11),     # one query past a 64-row tile
    (40, 100, 384, 8, 11),       # a corpus smaller than one tile
    (200, 30000, 128, 32, 128),  # the largest k_sel
    (70, 3000, 384, 4, 20),
    (130, 5000, 384, 512, 7),    # segments of four tiles
    (64, 20000, 384, 32, 41),    # the serve shape
]


@pytest.mark.parametrize("wrapper", ["default", "overlap"])
@pytest.mark.parametrize("q,n,d,seg_rows,k_sel", F32_PASS_A_CASES)
def test_segtopk_f32_on_integer_rows(dev, wrapper, q, n, d, seg_rows, k_sel):
    """f32 operands reach the f32 schedule through either wrapper, each on
    its own counter; on integer rows with built-in ties its ids, tie order
    and values equal the plain version's."""
    Q, C = _small_grid((q, d), 50, dev), _tied(_small_grid((n, d), 51, dev))
    fn, counter = {"default": (topk.segtopk_pass_a, "SEGTOPK_F32_LAUNCHES"),
                   "overlap": (topk.segtopk_pass_a_overlap,
                               "SEGTOPK_OVERLAP_F32_LAUNCHES")}[wrapper]
    launches = getattr(topk, counter)
    kv, ki = fn(Q, C, n, seg_rows, k_sel)
    pv, pi = topk.segtopk_pass_a_plain(Q, C, n, seg_rows, k_sel)
    torch.cuda.synchronize()
    assert getattr(topk, counter) == launches + 1
    assert torch.equal(ki, pi) and torch.equal(kv, pv)


@pytest.mark.parametrize("d", [384, 72, 100])
def test_segtopk_f32_on_unit_rows(dev, d):
    Q, C = _unit((300, d), 52, dev), _unit((50000, d), 53, dev)
    tol = d * 2.0 ** -24
    kv, ki = topk.segtopk_pass_a(Q, C, 50000, 32, 41)
    pv, pi = topk.segtopk_pass_a_plain(Q, C, 50000, 32, 42)
    err, bad, skipped = _near_tie_agree(kv, ki, pv, pi, tol)
    assert err <= tol and bad == 0
    assert skipped <= kv.numel() // 100, skipped


F32_FUSED_CASES = [
    (64, 4096, 384, 128, -1),    # whole tiles
    (200, 20011, 384, 200, -1),  # ragged corpus and query tiles
    (33, 1000, 128, 129, 900),   # rows past valid_n never appear
    (5, 300, 384, 500, -1),      # k > rows: (-1e30, 0) tail
    (70, 50000, 384, 2048, -1),  # the largest k
    (9, 3000, 72, 300, -1),      # D = 72
    (9, 3000, 100, 300, -1),     # a width that is not a multiple of 8
    (33, 2000, 30, 100, -1),     # ... nor of 4
    (1, 5000, 384, 200, -1),     # one query
    (65, 4097, 384, 128, -1),    # one query past a 64-row tile
    (40, 100, 384, 50, -1),      # a corpus smaller than one tile
    (300, 40000, 384, 1, -1),    # k = 1
    (300, 40000, 384, 10, -1),   # k = 10
    (129, 60000, 384, 2048, -1), # many splits at the largest k
    (3, 250000, 128, 200, -1),   # many splits: the round-by-round merge
    (70, 5000, 384, 200, 0),     # no valid row at all
]


@pytest.mark.parametrize("q,n,d,k,valid_n", F32_FUSED_CASES)
def test_topk_fused_f32_on_integer_rows(dev, q, n, d, k, valid_n):
    Q, C = _small_grid((q, d), 54, dev), _tied(_small_grid((n, d), 55, dev))
    launches = topk.TOPK_FUSED_F32_LAUNCHES, topk.TOPK_FUSED_LAUNCHES
    kv, ki = topk.topk_scores_fused(Q, C, k, valid_n=valid_n)
    pv, pi = topk.topk_scores_fused_plain(Q, C, k, valid_n=valid_n)
    torch.cuda.synchronize()
    assert (topk.TOPK_FUSED_F32_LAUNCHES, topk.TOPK_FUSED_LAUNCHES) == (
        launches[0] + 1, launches[1])
    assert torch.equal(ki, pi) and torch.equal(kv, pv)


@pytest.mark.parametrize("d", [384, 72, 100])
def test_topk_fused_f32_on_unit_rows(dev, d):
    Q, C = _unit((300, d), 56, dev), _unit((50000, d), 57, dev)
    tol = d * 2.0 ** -24
    kv, ki = topk.topk_scores_fused(Q, C, 200)
    pv, pi = topk.topk_scores_fused_plain(Q, C, 201)
    err, bad, skipped = _near_tie_agree(kv, ki, pv, pi, tol)
    assert err <= tol and bad == 0
    assert skipped <= kv.numel() // 100, skipped


# the 3xTF32 main loop at every width class (30 and 100 padded to a
# multiple of 4 by the wrapper, 1 and 2-4 K chunks, 12, 32 and 64 of them),
# every k_sel the plans give another ring (1 and 11: 4 stages, 41: 3, 128:
# 2), segments inside a column pair, inside a tile, and over two tiles, and
# ragged query tiles (64 rows for 17, 33 and 64 queries, 128 past that)
# over corpora that end inside a tile
F32_WIDTHS = [30, 72, 100, 384, 1024, 2048]
F32_GRID_CASES = [
    (q, 2000 + 37 * i, d, seg_rows, k_sel)
    for i, (d, (seg_rows, k_sel), q) in enumerate(
        (d, sk, (17, 33, 64, 129)[(j + m) % 4])
        for m, d in enumerate(F32_WIDTHS)
        for j, sk in enumerate([(1, 1), (4, 11), (32, 41), (256, 128)]))]


@pytest.mark.parametrize("wrapper", ["default", "overlap"])
@pytest.mark.parametrize("q,n,d,seg_rows,k_sel", F32_GRID_CASES)
def test_segtopk_f32_grid_on_integer_rows(dev, wrapper, q, n, d, seg_rows,
                                          k_sel):
    """The f32 schedule at every width, k_sel and segment length class:
    ids, tie order and values equal to the plain version's on integer
    rows with ties, through both wrappers."""
    Q, C = _small_grid((q, d), 60, dev), _tied(_small_grid((n, d), 61, dev))
    fn = {"default": topk.segtopk_pass_a,
          "overlap": topk.segtopk_pass_a_overlap}[wrapper]
    kv, ki = fn(Q, C, n, seg_rows, k_sel)
    pv, pi = topk.segtopk_pass_a_plain(Q, C, n, seg_rows, k_sel)
    torch.cuda.synchronize()
    assert torch.equal(ki, pi) and torch.equal(kv, pv)


@pytest.mark.parametrize("k_sel", [1, 11, 41, 128])
@pytest.mark.parametrize("d", F32_WIDTHS)
def test_segtopk_f32_grid_on_unit_rows(dev, d, k_sel):
    """Unit rows at every width and ring: values within D * 2^-24 of the
    plain f32 product, ids equal outside near-ties, at most 1 % of ids
    differing inside them; the overlap wrapper equal to the default bit for
    bit."""
    Q, C = _unit((129, d), 62, dev), _unit((20011, d), 63, dev)
    tol = d * 2.0 ** -24
    kv, ki = topk.segtopk_pass_a(Q, C, 20011, 32, k_sel)
    ov, oi = topk.segtopk_pass_a_overlap(Q, C, 20011, 32, k_sel)
    pv, pi = topk.segtopk_pass_a_plain(Q, C, 20011, 32, k_sel + 1)
    err, bad, skipped = _near_tie_agree(kv, ki, pv, pi, tol)
    assert err <= tol and bad == 0
    assert skipped <= kv.numel() // 100, skipped
    assert torch.equal(oi, ki) and torch.equal(ov, kv)


@pytest.mark.parametrize("k", [1, 200, 2048])
@pytest.mark.parametrize("q", [17, 33, 64, 129])
@pytest.mark.parametrize("d", F32_WIDTHS)
def test_topk_fused_f32_grid_on_integer_rows(dev, d, q, k):
    Q, C = _small_grid((q, d), 64, dev), _tied(_small_grid((9001, d), 65,
                                                           dev))
    kv, ki = topk.topk_scores_fused(Q, C, k)
    pv, pi = topk.topk_scores_fused_plain(Q, C, k)
    torch.cuda.synchronize()
    assert torch.equal(ki, pi) and torch.equal(kv, pv)


@pytest.mark.parametrize("k", [1, 200, 2048])
@pytest.mark.parametrize("d", F32_WIDTHS)
def test_topk_fused_f32_grid_on_unit_rows(dev, d, k):
    Q, C = _unit((129, d), 66, dev), _unit((20011, d), 67, dev)
    tol = d * 2.0 ** -24
    kv, ki = topk.topk_scores_fused(Q, C, k)
    pv, pi = topk.topk_scores_fused_plain(Q, C, k + 1)
    err, bad, skipped = _near_tie_agree(kv, ki, pv, pi, tol)
    assert err <= tol and bad == 0
    assert skipped <= kv.numel() // 100, skipped


def test_f32_kernels_refuse_a_plan_that_does_not_fit(dev):
    """The C entry points recompute the f32 main loop's bytes and refuse
    a ring deeper than fits: no launch, an error."""
    from semanticsearch_tpu_torch.ops import _build

    x = torch.zeros((200, 384), device=dev)
    part = torch.empty((1, 200, 128), device=dev)
    ids = torch.empty((1, 200, 128), device=dev, dtype=torch.int32)
    fn = _build.load("segtopk").segtopk_pass_a
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
    stream = torch.cuda.current_stream(dev).cuda_stream
    args = [x.data_ptr(), x.data_ptr(), part.data_ptr(), ids.data_ptr(),
            part.data_ptr(), ids.data_ptr(), 200, 200, 384, 8, 25, 128, 1, 3,
            128]
    assert topk.pass_a_f32_smem_bytes(128, 3, 128) > topk.SMEM_LIMIT
    assert fn(*args, 3, stream) != 0  # three stages do not fit at k_sel 128
    assert fn(*args, 2, stream) == 0
    torch.cuda.synchronize()


def test_twopass_f32_index_matches_cpu(dev):
    """An f32 index's two-pass search on the card: pass A's f32 schedule,
    then pass B, equal to the CPU path on integer rows."""
    Q, C = _small_grid((300, 100), 58, dev), _tied(_small_grid((50000, 100),
                                                               59, dev))
    for kw in ({}, {"mxu_overlap": True}):
        kv, ki = topk.topk_scores_twopass(Q, C, k=40, block_n=16384,
                                          seg_split=4, **kw)
        pv, pi = topk.topk_scores_twopass(Q.cpu(), C.cpu(), k=40,
                                          block_n=16384, seg_split=4, **kw)
        assert torch.equal(ki.cpu(), pi) and torch.equal(kv.cpu(), pv), kw


# ------------------------------------------------------------------ pass B

def _segs(q, k_sel, n_segs, seed, dev, placeholders=0):
    """Pass A's output shape: k_sel distinct segment ids a query in random
    order, the last ``placeholders`` slots -1-j."""
    g = torch.Generator(device=dev).manual_seed(seed)
    real = k_sel - placeholders
    ids = torch.rand((q, n_segs), generator=g, device=dev).argsort(dim=1)
    ids = ids[:, :real].int()
    tail = -1 - torch.arange(real, k_sel, device=dev, dtype=torch.int32)
    return torch.cat([ids, tail.expand(q, placeholders)], dim=1).contiguous()


def _pass_b_rows(shape, seed, dev, dtype):
    """Integer rows (bf16: [-127, 127]; f32: [-8, 8]), every dot product
    exact in f32, with ties across segments (the first half again in the
    second) and inside them (each even row again in the next)."""
    C = (_grid(shape, seed, dev, dtype) if dtype == torch.bfloat16
         else _small_grid(shape, seed, dev))
    C = _tied(C)
    m = shape[0] // 4
    C[1:2 * m:2] = C[0:2 * m:2]
    return C


# (q, n, d, L2, k_sel, k, placeholders)
PASS_B_CASES = [
    (300, 50000, 384, 32, 11, 10, 0),     # the shard's segments
    (64, 20000, 384, 32, 41, 40, 0),      # the serve engine's
    (200, 20011, 384, 32, 41, 10, 0),     # a last segment past n
    (33, 1000, 384, 32, 41, 40, 20),      # placeholders
    (17, 30000, 384, 1, 128, 127, 0),     # k = 127 on one-row segments
    (9, 40000, 384, 128, 128, 127, 0),    # k_sel 128 and L2 128
    (70, 5000, 384, 8, 20, 1, 0),         # k = 1
    (40, 5000, 72, 16, 20, 10, 0),        # D 72: 16-byte loads
    (40, 5000, 100, 16, 20, 10, 0),       # D 100: bf16 a value a lane
    (40, 5000, 30, 16, 20, 10, 0),        # D 30: a value a lane
    (40, 3000, 1024, 32, 128, 40, 40),    # the widest bf16 pass A, k_sel 128
]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("q,n,d,L2,k_sel,k,ph", PASS_B_CASES)
def test_pass_b_kernel_matches_plain(dev, dtype, q, n, d, L2, k_sel, k, ph):
    """Integer rows with ties inside and across segments, every other
    query's list led by the last segment (past n where n % L2) and holding
    it twice: values, ids and tie order bit-equal to the plain version."""
    Q = _pass_b_rows((q, d), 60, dev, dtype)
    C = _pass_b_rows((n, d), 61, dev, dtype)
    n_segs = -(-n // L2)
    seg = _segs(q, k_sel, n_segs, 62, dev, ph)
    seg[::2, 0] = n_segs - 1
    launches = topk.PASS_B_LAUNCHES
    kv, ki = topk.pass_b_rescore(Q, C, seg, n, L2, k)
    pv, pi = topk.pass_b_rescore_plain(Q, C, seg, n, L2, k)
    torch.cuda.synchronize()
    assert topk.PASS_B_LAUNCHES == launches + 1
    assert torch.equal(ki, pi) and torch.equal(kv, pv)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [384, 100])
def test_pass_b_kernel_on_unit_rows(dev, dtype, d):
    """Real-valued scores summed in another order than the plain bmm:
    values within D * 2^-24, ids equal wherever the plain version's
    adjacent scores differ by more than that."""
    Q = _unit((500, d), 63, dev).to(dtype)
    C = _unit((50000, d), 64, dev).to(dtype)
    seg = _segs(500, 12, -(-50000 // 32), 65, dev)
    tol = d * 2.0 ** -24
    kv, ki = topk.pass_b_rescore(Q, C, seg, 50000, 32, 10)
    pv, pi = topk.pass_b_rescore_plain(Q, C, seg, 50000, 32, 11)
    err, bad, skipped = _near_tie_agree(kv, ki, pv, pi, tol / 2)
    assert err <= tol and bad == 0
    assert skipped <= kv.numel() // 100, skipped


def test_pass_b_kernel_on_a_side_stream(dev):
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        Q, C = _grid((129, 384), 66, dev), _grid((20011, 384), 67, dev)
        seg = _segs(129, 41, 626, 68, dev)
        kv, ki = topk.pass_b_rescore(Q, C, seg, 20011, 32, 40)
        kv, ki = kv.cpu(), ki.cpu()
    side.synchronize()
    pv, pi = topk.pass_b_rescore_plain(Q, C, seg, 20011, 32, 40)
    assert torch.equal(ki, pi.cpu()) and torch.equal(kv, pv.cpu())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_pass_b_never_reads_rows_past_n(dev, dtype):
    """NaN rows after n: no candidate past n is read, so no NaN appears,
    and the result equals the plain version on the first n rows."""
    Q = _pass_b_rows((70, 384), 69, dev, dtype)
    C = _pass_b_rows((5000, 384), 70, dev, dtype)
    C[4001:] = float("nan")
    for n, L2 in [(4001, 32), (4001, 128), (3968, 32), (77, 8)]:
        n_segs = -(-n // L2)
        seg = _segs(70, min(11, n_segs), n_segs, 71, dev)
        seg[:, 0] = n_segs - 1
        kv, ki = topk.pass_b_rescore(Q, C, seg, n, L2, 10)
        pv, pi = topk.pass_b_rescore_plain(Q, C[:n].clone(), seg, n, L2, 10)
        assert not bool(kv.isnan().any()), (n, L2)
        assert torch.equal(ki, pi) and torch.equal(kv, pv), (n, L2)


def test_pass_b_takes_an_unaligned_corpus(dev):
    """A corpus view 2 bytes past a 16-byte boundary: one value a lane,
    the same result."""
    buf = _grid((5000 * 384 + 1,), 72, dev)
    C = buf[1:].view(5000, 384)
    assert C.data_ptr() % 16
    Q = _grid((50, 384), 73, dev)
    seg = _segs(50, 11, 157, 74, dev)
    kv, ki = topk.pass_b_rescore(Q, C, seg, 5000, 32, 10)
    pv, pi = topk.pass_b_rescore_plain(Q, C, seg, 5000, 32, 10)
    assert torch.equal(ki, pi) and torch.equal(kv, pv)


def test_twopass_on_the_card_never_runs_the_plain_pass_b(dev, monkeypatch):
    """Every two-pass mode on CUDA tensors rescores through the kernel,
    one launch a call, and equals the CPU path."""
    def plain(*args, **kw):
        raise AssertionError("the plain pass B ran on CUDA tensors")

    Q, C = _grid((300, 384), 75, dev), _grid((50000, 384), 76, dev)
    want = {}
    for kw in ({}, {"mxu_overlap": True}, {"pass_a_int8": True}):
        want[str(kw)] = topk.topk_scores_twopass(Q.cpu(), C.cpu(), k=40,
                                                 block_n=16384, seg_split=4,
                                                 **kw)
    monkeypatch.setattr(topk, "pass_b_rescore_plain", plain)
    for kw in ({}, {"mxu_overlap": True}, {"pass_a_int8": True}):
        launches = topk.PASS_B_LAUNCHES
        kv, ki = topk.topk_scores_twopass(Q, C, k=40, block_n=16384,
                                          seg_split=4, **kw)
        assert topk.PASS_B_LAUNCHES == launches + 1
        pv, pi = want[str(kw)]
        assert torch.equal(ki.cpu(), pi) and torch.equal(kv.cpu(), pv), kw


# ------------------------------------------------------ flash: f32, T, Dh

def _flash_mask(b, t, g, dev, lo=None):
    """Each row its own leading real keys (at least ``lo``), row 1 with
    every key masked (the mean of V over its T keys)."""
    lens = torch.randint(lo or max(1, t // 2), t + 1, (b,), generator=g,
                         device=dev)
    mask = (torch.arange(t, device=dev)[None, :] < lens[:, None]).float()
    mask[1 % b, :] = 0.0
    return mask


def _nan_in_skipped_blocks(x, mask):
    """x with NaN at every key of a 64-key block that holds no real key, in
    batch rows that have one (the blocks the kernel skips)."""
    b, t = mask.shape
    nb = -(-t // 64)
    padded = torch.nn.functional.pad(mask, (0, nb * 64 - t))
    dead = (padded.view(b, nb, 64) == 0).all(dim=2)
    dead &= (mask > 0).any(dim=1, keepdim=True)
    keys = dead.repeat_interleave(64, dim=1)[:, :t][:, None, :, None]
    return torch.where(keys, torch.full_like(x, float("nan")), x)


@pytest.mark.parametrize("b,h,t,dh,lo", [
    (256, 12, 256, 32, 40),    # the serve shape
    (2, 12, 1024, 32, 600),    # T = 1024, where "auto" picks flash
    (2048, 12, 64, 32, 3),     # the chunking batch
    (813, 12, 64, 32, 3),
    (4, 2, 512, 128, 10),
    (3, 4, 512, 256, 10),      # the widest head: one Q tile, two stages
    (3, 2, 192, 64, 1),
    (5, 3, 128, 16, 60),
])
def test_flash_f32_matches_plain(dev, b, h, t, dh, lo):
    """f32 q, k, v on the encoder's transposed views: the f32 path (3xTF32),
    within the JAX f32 test's 2e-5 of the plain version (TF32 off); NaN keys
    and values in skipped blocks change no bit."""
    g = torch.Generator(device=dev).manual_seed(60)
    q, k, v = _flash_inputs((b, h, t, dh), torch.float32, "transposed", g,
                            dev)
    mask = _flash_mask(b, t, g, dev, lo)
    if t >= 192:
        mask[2 % b, 40:t - 64] = 0.0  # dead blocks between live ones
    launches = (fa.FLASH_F32_LAUNCHES, fa.FLASH_LAUNCHES,
                fa.FLASH_WIDE_LAUNCHES)
    got = fa.flash_attention(q, k, v, mask)
    torch.cuda.synchronize()
    assert (fa.FLASH_F32_LAUNCHES, fa.FLASH_LAUNCHES,
            fa.FLASH_WIDE_LAUNCHES) == (launches[0] + 1, *launches[1:])
    assert got.dtype == torch.float32 and got.stride() == q.stride()
    want = fa.flash_attention_plain(q, k, v, mask)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=2e-5, atol=2e-5)
    again = fa.flash_attention(q, _nan_in_skipped_blocks(k, mask),
                               _nan_in_skipped_blocks(v, mask), mask)
    assert torch.equal(got, again)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
@pytest.mark.parametrize("t", [1, 32, 96, 100, 128, 192])
@pytest.mark.parametrize("dh", [24, 48, 80, 32])
def test_flash_any_t_and_padded_head_widths(dev, dtype, t, dh):
    """T up to 128 need not be a multiple of 64 (tail blocks zero-filled,
    keys past T never weigh, rows past T never stored); a head width the
    kernel lacks runs padded to the next of 16/32/64/128 with the real
    width's scale. Against the plain version: 2e-5 in f32, a few
    half-precision ulps of each output otherwise."""
    g = torch.Generator(device=dev).manual_seed(61)
    b, h = 5, 3
    q, k, v = _flash_inputs((b, h, t, dh), dtype, "transposed", g, dev)
    mask = _flash_mask(b, t, g, dev)
    got = fa.flash_attention(q, k, v, mask)
    want = fa.flash_attention_plain(q, k, v, mask)
    assert got.shape == q.shape and got.dtype == dtype
    assert bool(torch.isfinite(got).all())
    if dtype == torch.float32:
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   rtol=2e-5, atol=2e-5)
    else:
        diff = (got.float() - want.float()).abs()
        assert float((diff / want.float().abs().clamp(min=0.5)).max()) <= 2e-2
    if t in (1, 32, 96, 100):  # 64-key blocks with a tail: NaN past T is
        # never read (the views' storage ends at T; a copy padded with NaN
        # past T, sliced back, must give the same bits)
        big = [torch.full((b, 128, h, dh), float("nan"), device=dev,
                          dtype=dtype) for _ in range(3)]
        for x, y in zip(big, (q, k, v)):
            x[:, :t] = y.transpose(1, 2)
        views = [x[:, :t].transpose(1, 2) for x in big]
        assert torch.equal(fa.flash_attention(*views, mask), got)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
@pytest.mark.parametrize("t", [96, 128, 256])
@pytest.mark.parametrize("dh", [136, 192, 256, 320, 520, 584, 1000])
def test_flash_wide_head_widths(dev, dtype, t, dh):
    """Head widths past 128: 256 wide (136 and 192 padded to it; 64-row
    tiles, two ring stages, Q's fragments from shared memory), and the wide
    path past 256 (S once per 64 query rows, Q, K and V in 64-column
    chunks; past 576 columns O in groups of 576, a CTA each; its own launch
    counter). Against the plain version on the encoder's transposed views:
    f32 2e-5 + 2e-5 |o|, otherwise 2e-2 max(|o|, 0.5); dead key blocks
    carry NaN and change no bit."""
    g = torch.Generator(device=dev).manual_seed(68)
    b, h = 3, 2
    q, k, v = _flash_inputs((b, h, t, dh), dtype, "transposed", g, dev)
    mask = _flash_mask(b, t, g, dev)
    if t >= 192:
        mask[0, :] = 0.0
        mask[0, :30] = 1.0
        mask[0, t - 64: t - 40] = 1.0  # live blocks around dead ones
    counters = ("FLASH_LAUNCHES", "FLASH_F32_LAUNCHES", "FLASH_WIDE_LAUNCHES")
    counter = ("FLASH_WIDE_LAUNCHES" if dh > 256 else "FLASH_F32_LAUNCHES"
               if dtype == torch.float32 else "FLASH_LAUNCHES")
    launches = {c: getattr(fa, c) for c in counters}
    got = fa.flash_attention(q, k, v, mask)
    torch.cuda.synchronize()
    assert {c: getattr(fa, c) for c in counters} == {
        c: n + (c == counter) for c, n in launches.items()}
    assert got.shape == q.shape and got.dtype == dtype
    want = fa.flash_attention_plain(q, k, v, mask).float()
    diff = (got.float() - want).abs()
    if dtype == torch.float32:
        assert bool((diff <= 2e-5 + 2e-5 * want.abs()).all())
    else:
        assert float((diff / want.abs().clamp(min=0.5)).max()) <= 2e-2
    again = fa.flash_attention(q, _nan_in_skipped_blocks(k, mask),
                               _nan_in_skipped_blocks(v, mask), mask)
    assert torch.equal(got, again)


# ------------------------------------------------------ bf16 similarity

@pytest.mark.parametrize("b,n,d", [(1, 4096, 384), (1, 3939, 384),
                                   (1, 130, 72), (3, 77, 30), (256, 64, 384),
                                   (200, 128, 384)])
def test_similarity_bf16_matches_plain(dev, b, n, d):
    """bf16 input widened to f32 on load: on integer rows (exact in bf16,
    sums exact in f32) bit-equal to the plain version of the same input."""
    E = _grid((b, n, d), 62, dev)
    E[-1, n - n // 3:] = 0.0
    launches = sim.SIM_BF16_LAUNCHES, sim.SIM_LAUNCHES
    S = sim.similarity_matrix(E)
    torch.cuda.synchronize()
    assert (sim.SIM_BF16_LAUNCHES, sim.SIM_LAUNCHES) == (launches[0] + 1,
                                                         launches[1])
    assert S.shape == (b, n, n) and S.dtype == torch.float32
    assert torch.equal(S, sim.similarity_matrix_plain(E))
    assert torch.equal(S, S.transpose(1, 2))
    assert torch.equal(S[0], sim.similarity_matrix(E[0]))


def test_similarity_bf16_on_unit_rows(dev):
    g = torch.Generator(device=dev).manual_seed(63)
    E = sim.l2_normalize(torch.randn((3, 700, 384), generator=g,
                                     device=dev)).bfloat16()
    S = sim.similarity_matrix(E)
    err = float((S - sim.similarity_matrix_plain(E)).abs().max())
    assert err <= 384 * 2.0 ** -24
    assert torch.equal(S, S.transpose(1, 2))
    assert torch.equal(S, sim.similarity_matrix(E))


@pytest.mark.parametrize("b,n,d", [
    (1, 4096, 384),   # the long-document bucket: wide tiles
    (1, 3939, 384),   # n not a multiple of the tile nor of 4
    (1, 1, 384),      # one sentence
    (1, 130, 72),     # a width that is not a multiple of the K step
    (3, 77, 30),      # ... nor of 4: scalar loads
    (256, 64, 384),   # a batch of short documents: one narrow tile each
    (200, 128, 384),  # a batch on wide tiles
    (5, 600, 384),    # a few documents: narrow tiles
])
def test_similarity_kernel_matches_plain(dev, b, n, d):
    E = _grid((b, n, d), 12, dev, torch.float32)
    E[-1, n - n // 3:] = 0.0  # a padded document: rows of zeros
    launches = sim.SIM_LAUNCHES
    S = sim.similarity_matrix(E)
    torch.cuda.synchronize()
    assert sim.SIM_LAUNCHES == launches + 1
    assert S.shape == (b, n, n) and S.dtype == torch.float32
    assert torch.equal(S, sim.similarity_matrix_plain(E))
    assert torch.equal(S, S.transpose(1, 2))
    assert torch.equal(S, sim.similarity_matrix(E))
    # a document gives the same bits alone, unbatched, as in its batch
    assert torch.equal(S[0], sim.similarity_matrix(E[0]))
    assert torch.equal(S[0], sim.similarity_matrix_pallas(E[0], block=64))


def test_similarity_counts_one_launch_per_65535_documents(dev):
    E = _grid((65535 + 3, 8, 16), 13, dev, torch.float32)
    launches = sim.SIM_LAUNCHES
    S = sim.similarity_matrix(E)
    torch.cuda.synchronize()
    assert sim.SIM_LAUNCHES == launches + 2
    assert torch.equal(S, sim.similarity_matrix_plain(E))


@pytest.mark.parametrize("b,n,d", [(1, 3939, 384), (64, 100, 384),
                                   (2, 50, 33)])
def test_similarity_kernel_on_unit_rows(dev, b, n, d):
    g = torch.Generator(device=dev).manual_seed(13)
    E = sim.l2_normalize(torch.randn((b, n, d), generator=g, device=dev))
    S = sim.similarity_matrix(E)
    np.testing.assert_allclose(S.cpu().numpy(),
                               sim.similarity_matrix_plain(E).cpu().numpy(),
                               rtol=0, atol=1e-5)
    assert torch.equal(S, S.transpose(1, 2))
    assert torch.equal(S, sim.similarity_matrix(E))
    # a view whose storage is not 16-byte aligned
    flat = torch.zeros(b * n * d + 1, device=dev)
    flat[1:] = E.reshape(-1)
    assert torch.equal(sim.similarity_matrix(flat[1:].view(b, n, d)), S)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,n", [(37, 8), (21, 16), (9, 32), (5, 64),
                                 (3, 63), (3, 65), (2, 129), (2, 257)])
def test_similarity_stacked_buckets_and_triangle_edges(dev, dtype, b, n):
    """Buckets 8-64 stack 128 / n documents in one tile (the last tile
    part-full), n = 63, 65 and 129 put the triangle's edge inside a tile:
    equal to the plain version bit for bit on integer rows, each document
    the same alone as in the batch, and one launch."""
    E = _grid((b, n, 384), 64, dev, dtype)
    E[-1, n - n // 3:] = 0.0
    before = sim.SIM_LAUNCHES + sim.SIM_BF16_LAUNCHES
    S = sim.similarity_matrix(E)
    torch.cuda.synchronize()
    assert sim.SIM_LAUNCHES + sim.SIM_BF16_LAUNCHES == before + 1
    assert torch.equal(S, sim.similarity_matrix_plain(E))
    assert torch.equal(S, S.transpose(1, 2))
    for i in (0, b // 2, b - 1):
        assert torch.equal(sim.similarity_matrix(E[i]), S[i])
    # a document on unit rows: alone, in its bucket, and in a batch
    g = torch.Generator(device=dev).manual_seed(65)
    U = sim.l2_normalize(torch.randn((b, n, 384), generator=g, device=dev))
    U = U.to(dtype)
    SU = sim.similarity_matrix(U)
    assert torch.equal(SU[1], sim.similarity_matrix(U[1]))
    bucket = torch.nn.functional.pad(U[1], (0, 0, 0, 128))[None]
    assert torch.equal(sim.similarity_matrix(bucket)[0, :n, :n], SU[1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [30, 77, 100, 8, 1])
def test_similarity_pads_the_width(dev, dtype, d):
    """A width whose rows are not whole 16-byte TMA rows runs on the kernel
    with zero columns added by one padded copy: bit-equal to the plain
    version on integer rows."""
    E = _grid((3, 150, d), 66, dev, dtype)
    plan = sim.similarity_plan(3, 150, d, dtype)
    assert plan["pitch"] >= d
    S = sim.similarity_matrix(E)
    assert torch.equal(S, sim.similarity_matrix_plain(E))
    assert torch.equal(S, S.transpose(1, 2))


def test_similarity_releases_its_scratch(dev):
    """A padded copy of a width that is not whole 16-byte rows lives for the
    call only."""
    g = torch.Generator(device=dev).manual_seed(67)
    E = torch.randn((4, 600, 78), generator=g, device=dev)
    Eb = torch.randn((4, 600, 100), generator=g, device=dev).bfloat16()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    for x in (E, Eb):
        torch.cuda.reset_peak_memory_stats(dev)
        S = sim.similarity_matrix(x)
        torch.cuda.synchronize()
        plan = sim.similarity_plan(*x.shape, x.dtype)
        assert plan["scratch_bytes"] > 0
        assert (torch.cuda.max_memory_allocated(dev)
                >= base + S.numel() * 4 + plan["scratch_bytes"])
        assert torch.cuda.memory_allocated(dev) == base + S.numel() * 4
        del S
    assert torch.cuda.memory_allocated(dev) == base


def test_similarity_plain_ignores_tf32_setting(dev):
    g = torch.Generator(device=dev).manual_seed(14)
    E = sim.l2_normalize(torch.randn((512, 384), generator=g, device=dev))
    want = sim.similarity_matrix_plain(E)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        got = sim.similarity_matrix_plain(E)
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    assert torch.equal(got, want)


def test_batched_signals_on_cuda_match_cpu(dev):
    from semanticsearch_tpu_torch.chunking.grouping import (
        batched_similarity_matrices)
    from semanticsearch_tpu_torch.chunking.splitter import (
        batched_split_signals)

    rng = np.random.default_rng(15)
    docs = [rng.integers(-5, 6, size=(n, 384)).astype(np.float32)
            for n in (5, 64, 33, 2)]
    launches = sim.SIM_LAUNCHES
    got = batched_split_signals(docs, 64, device=dev)
    sims = batched_similarity_matrices(docs, 64, device=dev)
    assert sim.SIM_LAUNCHES == launches + 2
    want = batched_split_signals(docs, 64, device="cpu")
    for (R, adj), (Rw, adjw), S, e in zip(got, want, sims, docs):
        np.testing.assert_array_equal(R, Rw)
        np.testing.assert_array_equal(adj, adjw)
        np.testing.assert_array_equal(S, e @ e.T)


def test_wrappers_raise_instead_of_falling_back(dev):
    """What the kernels still refuse raises, and nothing is launched:
    float64 operands, a bf16 tensor sent to the int8 wrapper, k past 2048,
    a T past 128 that is not a multiple of 64, empty input; pass B's k past
    its candidates and a width past its shared memory."""
    x = torch.zeros((4, 64), device=dev, dtype=torch.float64)
    launches = (topk.SEGTOPK_LAUNCHES, topk.SEGTOPK_F32_LAUNCHES,
                topk.SEGTOPK_OVERLAP_LAUNCHES, topk.SEGTOPK_INT8_LAUNCHES,
                topk.TOPK_FUSED_LAUNCHES, topk.TOPK_FUSED_F32_LAUNCHES,
                fa.FLASH_LAUNCHES, fa.FLASH_F32_LAUNCHES,
                fa.FLASH_WIDE_LAUNCHES, sim.SIM_LAUNCHES,
                sim.SIM_BF16_LAUNCHES, topk.PASS_B_LAUNCHES)
    with pytest.raises(NotImplementedError):
        topk.segtopk_pass_a(x, x, 4, 1, 2)
    with pytest.raises(NotImplementedError):
        topk.segtopk_pass_a_overlap(x, x, 4, 1, 2)
    with pytest.raises(NotImplementedError):
        topk.topk_scores_fused(x, x, 2)
    with pytest.raises(NotImplementedError):
        topk.segtopk_pass_a(x.float(), x.bfloat16(), 4, 1, 2)
    with pytest.raises(NotImplementedError):
        topk.segtopk_pass_a_int8(x.bfloat16(), x.bfloat16(), 4, 1, 2)
    with pytest.raises(ValueError, match="2048"):
        topk.topk_scores_fused(x.bfloat16(), x.bfloat16(), 2049)
    with pytest.raises(ValueError, match="2048"):
        topk.topk_scores_fused(x.float(), x.float(), 2049)
    y = torch.zeros((1, 1, 64, 32), device=dev, dtype=torch.float64)
    with pytest.raises(NotImplementedError):
        fa.flash_attention(y, y, y, torch.ones((1, 64), device=dev))
    for dtype in (torch.bfloat16, torch.float32):
        ragged = torch.zeros((1, 1, 160, 32), device=dev, dtype=dtype)
        with pytest.raises(ValueError, match="multiple of 64"):
            fa.flash_attention(ragged, ragged, ragged,
                               torch.ones((1, 160), device=dev))
    with pytest.raises(NotImplementedError, match="float32 or bfloat16"):
        sim.similarity_matrix(x)
    with pytest.raises(NotImplementedError, match="float32 or bfloat16"):
        sim.similarity_matrix(x.half())
    with pytest.raises(ValueError, match="empty"):
        sim.similarity_matrix(x[:0].float())
    with pytest.raises(ValueError, match="empty"):
        sim.similarity_matrix(x[:0].bfloat16())
    # pass B: f64 and mixed operands, k past its k_sel * L2 candidates, a
    # width whose query and scores pass the shared memory
    seg = torch.zeros((4, 2), device=dev, dtype=torch.int32)
    with pytest.raises(NotImplementedError):
        topk.pass_b_rescore(x, x, seg, 4, 1, 1)
    with pytest.raises(NotImplementedError):
        topk.pass_b_rescore(x.float(), x.bfloat16(), seg, 4, 1, 1)
    with pytest.raises(ValueError, match="k_sel"):
        topk.pass_b_rescore(x.float(), x.float(), seg, 4, 1, 3)
    wide = torch.zeros((4, 60000), device=dev)
    with pytest.raises(ValueError, match="shared memory"):
        topk.pass_b_rescore(wide, wide, seg, 4, 1, 1)
    assert launches == (topk.SEGTOPK_LAUNCHES, topk.SEGTOPK_F32_LAUNCHES,
                        topk.SEGTOPK_OVERLAP_LAUNCHES,
                        topk.SEGTOPK_INT8_LAUNCHES, topk.TOPK_FUSED_LAUNCHES,
                        topk.TOPK_FUSED_F32_LAUNCHES, fa.FLASH_LAUNCHES,
                        fa.FLASH_F32_LAUNCHES, fa.FLASH_WIDE_LAUNCHES,
                        sim.SIM_LAUNCHES, sim.SIM_BF16_LAUNCHES,
                        topk.PASS_B_LAUNCHES)


def test_wrappers_take_what_they_refused(dev):
    """The refusals the kernels no longer make, each a parity case against
    its plain version, counted on its own launch counter: f32 pass A (both
    wrappers) and f32 fused top-k, f32 flash, flash at T = 96, bf16
    similarity, int8 pass A at D = 72."""
    x = _grid((4, 64), 40, dev, torch.float32)
    before = topk.SEGTOPK_F32_LAUNCHES, topk.SEGTOPK_OVERLAP_F32_LAUNCHES
    for wrapper in (topk.segtopk_pass_a, topk.segtopk_pass_a_overlap):
        kv, ki = wrapper(x, x, 4, 1, 2)
        pv, pi = topk.segtopk_pass_a_plain(x, x, 4, 1, 2)
        assert torch.equal(ki, pi) and torch.equal(kv, pv)
    assert (topk.SEGTOPK_F32_LAUNCHES, topk.SEGTOPK_OVERLAP_F32_LAUNCHES) == (
        before[0] + 1, before[1] + 1)
    launches = topk.TOPK_FUSED_F32_LAUNCHES
    kv, ki = topk.topk_scores_fused(x, x, 2)
    pv, pi = topk.topk_scores_fused_plain(x, x, 2)
    assert torch.equal(ki, pi) and torch.equal(kv, pv)
    assert topk.TOPK_FUSED_F32_LAUNCHES == launches + 1
    g = torch.Generator(device=dev).manual_seed(41)
    y = torch.randn((1, 1, 64, 32), generator=g, device=dev)
    launches = fa.FLASH_F32_LAUNCHES
    got = fa.flash_attention(y, y, y, torch.ones((1, 64), device=dev))
    assert fa.FLASH_F32_LAUNCHES == launches + 1
    np.testing.assert_allclose(
        got.cpu().numpy(), fa.flash_attention_plain(
            y, y, y, torch.ones((1, 64), device=dev)).cpu().numpy(),
        rtol=2e-5, atol=2e-5)
    z = torch.randn((1, 1, 96, 32), generator=g, device=dev).bfloat16()
    launches = fa.FLASH_LAUNCHES
    got = fa.flash_attention(z, z, z, torch.ones((1, 96), device=dev))
    assert fa.FLASH_LAUNCHES == launches + 1
    np.testing.assert_allclose(
        got.float().cpu().numpy(), fa.flash_attention_plain(
            z, z, z, torch.ones((1, 96), device=dev)).float().cpu().numpy(),
        rtol=0, atol=1e-2)
    launches = sim.SIM_BF16_LAUNCHES
    E = x.bfloat16()
    assert torch.equal(sim.similarity_matrix(E), sim.similarity_matrix_plain(E))
    assert sim.SIM_BF16_LAUNCHES == launches + 1
    Q8, C8 = _grid((5, 72), 42, dev, torch.int8), _grid((700, 72), 43, dev,
                                                         torch.int8)
    kv, ki = topk.segtopk_pass_a_int8(Q8, C8, 700, 8, 20)
    pv, pi = topk.segtopk_pass_a_int8_plain(Q8, C8, 700, 8, 20)
    assert torch.equal(ki, pi) and torch.equal(kv, pv)


@pytest.mark.parametrize("d", [30, 100])
def test_bf16_pads_width_not_multiple_of_8(dev, d):
    """bf16 operands of width 30 and 100: the wrappers pad them with zero
    columns to 32 and 104 (one copy each), and pass A in both schedules and
    the fused top-k equal their plain versions bit for bit, each on its own
    counter."""
    Q, C = _grid((17, d), 60, dev), _grid((3000, d), 61, dev)
    C[1500:] = C[:1500].clone()  # ties in scores and segment maxima
    launches = (topk.SEGTOPK_LAUNCHES, topk.SEGTOPK_OVERLAP_LAUNCHES,
                topk.TOPK_FUSED_LAUNCHES)
    pv, pi = topk.segtopk_pass_a_plain(Q, C, 3000, 8, 20)
    for fn in (topk.segtopk_pass_a, topk.segtopk_pass_a_overlap):
        kv, ki = fn(Q, C, 3000, 8, 20)
        assert torch.equal(ki, pi) and torch.equal(kv, pv)
    fv, fi = topk.topk_scores_fused(Q, C, 300)
    gv, gi = topk.topk_scores_fused_plain(Q, C, 300)
    torch.cuda.synchronize()
    assert torch.equal(fi, gi) and torch.equal(fv, gv)
    assert (topk.SEGTOPK_LAUNCHES, topk.SEGTOPK_OVERLAP_LAUNCHES,
            topk.TOPK_FUSED_LAUNCHES) == tuple(n + 1 for n in launches)


@pytest.mark.parametrize("residual,weights", [(True, "int8"),
                                              (True, "bf16"),
                                              (False, "bf16")])
def test_device_bm25_on_the_card_matches_host(dev, residual, weights):
    """The device BM25 leg on the card (``torch._int_mm`` on the
    column-major matrix, or bf16 products with f32 results) gives the
    native host top-k's ids and score bits, over several score chunks."""
    from semanticsearch_tpu_torch.index.bm25 import BM25Okapi
    from semanticsearch_tpu_torch.index.bm25_tpu import DeviceBM25

    rng = np.random.default_rng(5)
    vocab = [f"w{i}" for i in range(3000)]
    p = 1.0 / np.arange(1, 3001) ** 1.1
    p /= p.sum()
    docs = [list(rng.choice(vocab, size=int(rng.integers(5, 40)), p=p))
            for _ in range(20000)]
    bm = BM25Okapi(docs)
    queries = [list(rng.choice(vocab, size=int(rng.integers(2, 7)), p=p))
               for _ in range(300)] + [[], ["nothing"], [vocab[2999]]]
    leg = DeviceBM25(bm, n_dense_terms=512, topk_device=64, query_chunk=128,
                     residual=residual, weights=weights,
                     score_chunk_cols=8192, device=dev)
    assert leg._CT.device.type == "cuda"
    got_i, got_s = leg.get_topk_batch(queries, 40)
    want_i, want_s = bm.get_topk_batch(queries, 40)
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_array_equal(got_s, want_s)
    assert leg.stats["fallbacks"] < len(queries) // 2, leg.stats


@pytest.mark.parametrize("name,kw", [("knrm", {}),
                                     ("esim", {"hidden_size": 200})])
def test_rerank_service_on_the_card_matches_cpu(dev, name, kw):
    """RerankService on the card (cuDNN LSTMs for ESIM, TF32 off) scores
    as the same service on the CPU, across the block ladder's rungs, to
    rtol = atol = 1e-4: f32 on both sides, the card's libraries summing in
    another order over up to 128 recurrent steps."""
    from semanticsearch_tpu_torch.core.config import TrainConfig
    from semanticsearch_tpu_torch.index.rerank_service import RerankService
    from semanticsearch_tpu_torch.models.rerankers import make_model
    from semanticsearch_tpu_torch.train.vocab import Preprocessor

    rng = np.random.default_rng(8)
    words = [f"w{i}" for i in range(500)]
    texts = [" ".join(rng.choice(words, size=int(rng.integers(1, 160))))
             for _ in range(400)]
    pp = Preprocessor(fixed_length_left=16, fixed_length_right=128,
                      filter_low_freq=1).fit(texts)
    torch.manual_seed(0)
    sd = make_model(name, vocab_size=pp.vocab_size, **kw).state_dict()
    cfg = TrainConfig(model=name)
    cpu = RerankService(name, sd, pp, cfg=cfg, model_kwargs=kw, device="cpu")
    card = RerankService(name, sd, pp, cfg=cfg, model_kwargs=kw, device=dev)
    n = 2048 + 300  # a mid block and a small one
    qs = [texts[int(i)] for i in rng.integers(0, 400, n)]
    cs = [texts[int(i)] for i in rng.integers(0, 400, n)]
    qs[0], cs[1] = "", ""  # an empty query; an all-padding chunk
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        got = card.score_pairs(qs, cs)
    want = cpu.score_pairs(qs, cs)
    assert np.isfinite(got).all() and got.shape == (n,)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_contrastive_steps_on_the_card_match_cpu(dev):
    """Two contrastive steps of a small f32 encoder under flash (the 3xTF32
    kernel forward, the plain recompute backward) against the same steps
    on the CPU: each epoch's loss to 1e-4 relative, the float32 masters to
    1e-5 absolute but for the attention key biases, whose true gradient is
    zero, so Adam turns each device's rounding noise into a step of up to
    the learning rate (2e-3 here: two learning rates)."""
    from semanticsearch_tpu_torch.core.config import EncoderConfig
    from semanticsearch_tpu_torch.models.encoder import SentenceEncoder
    from semanticsearch_tpu_torch.train.encoder_train import (
        ContrastiveConfig, ContrastiveEncoderTrainer)

    cfg = EncoderConfig(vocab_size=500, hidden_dim=64, num_layers=2,
                        num_heads=4, mlp_dim=128, max_len=64,
                        dtype="float32", attention="flash")
    rng = np.random.default_rng(3)
    words = [f"w{i}" for i in range(300)]
    pairs = [(" ".join(rng.choice(words, 5)), " ".join(rng.choice(words, 40)))
             for _ in range(16)]
    negs = [" ".join(rng.choice(words, 30)) for _ in range(16)]
    tcfg = ContrastiveConfig(epochs=2, batch_size=16, learning_rate=1e-3,
                             max_len_query=16, max_len_chunk=64)
    fa.FLASH_F32_LAUNCHES = 0
    out = {}
    for where in ("cuda", "cpu"):
        enc = SentenceEncoder(cfg, device=where, seed=4)
        out[where] = (ContrastiveEncoderTrainer(enc, tcfg).fit(pairs, negs),
                      {k: v.cpu() for k, v in enc.master.state_dict().items()})
    # 2 layers x 2 forwards x 2 steps, none in the backward
    assert fa.FLASH_F32_LAUNCHES == 8
    (h_card, p_card), (h_cpu, p_cpu) = out["cuda"], out["cpu"]
    for a, b in zip(h_card, h_cpu):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-4)
    for k in p_cpu:
        tol = 2e-3 if k.endswith("attn.key.bias") else 1e-5
        assert float((p_card[k] - p_cpu[k]).abs().max()) <= tol, k
