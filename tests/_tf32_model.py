"""A torch model of the port's 3xTF32 products (``csrc/tf32x3.cuh``), shared
by the tests of the similarity kernel, of the top-k kernels' f32 schedules
and of the f32 flash attention.

Each f32 value splits into hi = tf32(x) and lo = tf32(x - hi) (or, for an
operand the kernel leaves as raw f32 in shared memory, hi = trunc(x), the
value the tensor cores read, and lo = tf32(x - trunc(x))); a product of rows
a and b is big = a_hi . b_hi plus small = a_lo . b_hi + a_hi . b_lo, each
sum taken exactly (float64) and rounded once to f32, then big + small in
f32. The kernels accumulate in f32 as they go, so the model stands for
their numerics, not their bits, except where every sum is exact: on
integer-valued rows (lo = 0, small = 0) it gives the plain f32 product."""
import math

import torch

NEG_INF = -1e30


def tf32(x):
    """x rounded to TF32 as cvt.rna.tf32.f32 rounds: to nearest, ties away
    from zero, 10 explicit mantissa bits (the low 13 bits cleared)."""
    return ((x.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def trunc_tf32(x):
    """x with its low 13 mantissa bits cleared: a raw f32 as a TF32 operand
    of the tensor cores."""
    return (x.view(torch.int32) & ~0x1FFF).view(torch.float32)


def tf32x3_scores(a, b, b_trunc=False):
    """(Q, N) f32 scores a . b^T of a (Q, D) and b (N, D) by the 3xTF32
    split; ``b_trunc``: b's hi part truncated (the top-k kernels' corpus
    box), else rounded (the similarity kernel's)."""
    a_hi, b_hi = tf32(a), trunc_tf32(b) if b_trunc else tf32(b)
    a_lo, b_lo = tf32(a - a_hi), tf32(b - b_hi)
    ah, al, bh, bl = (x.double() for x in (a_hi, a_lo, b_hi, b_lo))
    big = (ah @ bh.T).float()
    small = (al @ bh.T + ah @ bl.T).float()
    return big + small


def tf32x3(emb):
    """The Gram matrix emb emb^T by the 3xTF32 split."""
    return tf32x3_scores(emb, emb)


def segtopk_model(queries, corpus, n, seg_rows, k_sel):
    """Pass A on 3xTF32 scores, ``segtopk_pass_a_plain``'s contract: the
    top-k_sel segments of ``seg_rows`` rows by maximum score (rows at or
    past n score 0), ties to the lower id, slot j past the real segments
    (NEG_INF, -1-j)."""
    q = queries.shape[0]
    n_segs = -(-n // seg_rows)
    s = tf32x3_scores(queries, corpus[:n], b_trunc=True)
    s = torch.nn.functional.pad(s, (0, n_segs * seg_rows - n))
    v, i = torch.sort(s.reshape(q, n_segs, seg_rows).amax(dim=2), dim=1,
                      descending=True, stable=True)
    k_real = min(k_sel, n_segs)
    out_v = torch.full((q, k_sel), NEG_INF)
    out_i = (-1 - torch.arange(k_sel, dtype=torch.int32)).expand(q, k_sel).clone()
    out_v[:, :k_real] = v[:, :k_real]
    out_i[:, :k_real] = i[:, :k_real].to(torch.int32)
    return out_v, out_i


def topk_model(queries, corpus, k):
    """The fused top-k on 3xTF32 scores, ``topk_scores_fused_plain``'s
    contract: ties to the lower row, slots past the rows (NEG_INF, 0)."""
    q, n = queries.shape[0], corpus.shape[0]
    v, i = torch.sort(tf32x3_scores(queries, corpus, b_trunc=True), dim=1,
                      descending=True, stable=True)
    out_v = torch.full((q, k), NEG_INF)
    out_i = torch.zeros((q, k), dtype=torch.int32)
    out_v[:, :min(k, n)] = v[:, :k]
    out_i[:, :min(k, n)] = i[:, :k].to(torch.int32)
    return out_v, out_i


def split_raw(x):
    """(hi, lo) of an operand the kernel passes raw, as the tensor cores read
    it: hi = trunc(x), lo = trunc(x - trunc(x)) (``tf32x3::lo_of_raw``, in
    turn truncated by the tensor cores)."""
    hi = trunc_tf32(x)
    return hi, trunc_tf32(x - hi)


def _split_product(a, b):
    """(big, small) of a @ b on raw-split operands, each sum exact (float64)
    and rounded once to f32."""
    (ah, al), (bh, bl) = (tuple(y.double() for y in split_raw(x))
                          for x in (a, b))
    return (ah @ bh).float(), (al @ bh + ah @ bl).float()


def flash_model(q, k, v, mask):
    """The f32 flash kernels' numerics (``csrc/flash_attention.cu``: the f32
    path and the wide path on f32), for (B, H, T, Dh) q, k, v and a (B, T)
    mask: S = Q K^T on the raw 3xTF32 split with the small terms summed
    apart, scaled by log2(e) / sqrt(Dh); masked keys at -1e30; online
    softmax in base 2 over the live 64-key blocks in order (a block with no
    real key is skipped, every block runs in a row with none); P (f32) and V
    split likewise, O += P_lo V_hi + P_hi V_lo + P_hi V_hi with the small
    terms folded into O; out = O / max(l, 1e-30)."""
    b, h, t, dh = q.shape
    block = 64  # the kernels' key block
    scale_log2 = 1.4426950408889634 / math.sqrt(dh)
    nb = -(-t // block)
    out = torch.empty_like(q)
    for i in range(b):
        big, small = _split_product(q[i], k[i].transpose(-1, -2))
        s = (big + small) * scale_log2
        s = torch.where(mask[i] > 0, s, torch.full_like(s, NEG_INF))
        live = [j for j in range(nb)
                if bool((mask[i, j * block:(j + 1) * block] > 0).any())]
        m = torch.full((h, t, 1), NEG_INF)
        l = torch.zeros((h, t, 1))
        o = torch.zeros((h, t, dh))
        for j in live or range(nb):
            keys = slice(j * block, (j + 1) * block)
            mn = torch.maximum(m, s[:, :, keys].amax(dim=-1, keepdim=True))
            alpha = torch.exp2(m - mn)
            p = torch.exp2(s[:, :, keys] - mn)
            l = l * alpha + p.sum(dim=-1, keepdim=True)
            big, small = _split_product(p, v[i, :, keys])
            o = o * alpha + (big + small)
            m = mn
        out[i] = o / l.clamp(min=1e-30)
    return out
