#!/usr/bin/env python3
"""Smoke run of semanticsearch_tpu_torch on one CUDA card (an H100).

    python3 chip_smoke.py

Builds the Hopper kernels from ``semanticsearch_tpu_torch/csrc``, holds each
against its plain PyTorch version on the card, every schedule (bf16,
overlap, int8 and f32 pass A, bf16 and f32 pass B, bf16 and f32 fused
top-k, bf16/fp16 and f32
flash at any T and every head width, f32 and bf16 similarity, stacked
short documents and padded widths included) (phase 2),
serves hybrid queries end to end through ``HybridQueryEngine`` at the
default encoder's full width (phase 3), times every kernel at the per-chip
shard size of 1,250,000 x 384 bf16, pass A and pass B also at the serve
shape (pass B one call and 50 queued), pass B also with every query
picking the same segments, and the fused top-k at the live-search shape,
flash also at head widths 256 and 320 (320 on the wide path, its own
entry), f32 flash beside both its bounds
(three TF32 products, and f32 FMAs) (phase 4), holds the LLM search
cell's three kernels against their plain versions at that cell's shapes and
times them: the packed flash entry, causal with grouped K/V, over 256
texts of its length law at 32 query and 8 K/V heads x 64, the fused gated
short convolution over the same texts at hidden 2,048, and pass A's
wide schedule at 256 x 10,000,000 x 2,048, and counts the launches of one
forward of the cell's whole encoder over those texts (phase 4b), and
serves deep candidate lists over a live index: adds, removals, a 10,000-query search through the
fused top-k, ``tune_fusion`` and ``compact`` (phase 5), chunks a
600-document corpus with one document of 3,939 sentences through
``ChunkPipeline`` (phase 6), and serves the f32 configuration (an f32
encoder under flash attention over an f32 index) end to end, held against
the same engine on the CPU, with one live round through the f32 fused
top-k, and times the f32 schedules (3xTF32 wgmma) at the shard shape, pass
A at the serve shape and the fused top-k at the live round's, and f32 flash
(3xTF32 mma.sync) at phase 4's shapes (phase 7), and runs the device BM25
leg (``index/bm25_tpu.py``) at 1,000,000 documents against the native host
top-k (phase 8), and serves the neural rerank stage over phase 3's index
with one npz-layout checkpoint per reranker at its preset width and the
encoder's full-width cross-encoder twin, each held against the same
service on the CPU (phase 9), and trains at the default encoder's full
width on labels ``rank_and_filter_groups`` makes over phase 3's corpus:
MLM pretraining, contrastive steps under flash (12 launches a step) and
stock from the same masters, f32 steps held against the CPU, hard-negative
re-mining, ``save_encoder`` -> ``load_encoder`` -> a served index, every
reranker preset, 5-fold KNRM cross-validation with
``evaluate_saved_model`` and a resumed run (phase 10), and drives the
entry points a user calls: ``semsearch-torch index --bm25`` and ``search``
over phase 3's corpus, the coalescing HTTP server under 64 concurrent
clients with a freshness round, a ``python -m
semanticsearch_tpu_torch.cli.main serve --port 0`` subprocess, ``chunk``
under ``semantic_grouping`` over phase 6's documents, and ``oie-train`` ->
``oie --extractor neural`` (phase 11), runs the sharded paths on four
virtual shards of the card (phase 12), and trains data parallel across
two processes on the card over gloo, each forwarding its own rows,
against the same steps in one process (phase 13). Phase 3 also serves
the ``serve_device`` profile (the device BM25 leg; hits equal the host
leg's) and an index with a trained subword ``tokenizer.json``; phases 3,
5 and 6 check that the native host
kernels ran and split their host time by part.
Progress and measurements go to stdout; the line before the last is the card's name and power limit, the
one before it the JSON ``kernels`` record, and the last line
``{"ok": true, "device": {...}}``. Any failed check exits non-zero without
that line, as does a machine without a CUDA device.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np


def log(msg: str) -> None:
    print(msg, flush=True)


class CheckFailed(Exception):
    pass


def check(ok: bool, what: str) -> None:
    log(f"  [{'ok' if ok else 'FAIL'}] {what}")
    if not ok:
        raise CheckFailed(what)


# H100 SXM peaks (NVIDIA data sheet, dense): bf16, TF32 and int8 tensor
# cores, f32 outside the tensor cores, HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 495e12
PEAK_INT8_OPS = 1979e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12


def bound_ms(ops: float, nbytes: float, peak: float = PEAK_BF16_FLOPS):
    t_ops, t_mem = ops / peak, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_mem), ("operations" if t_ops >= t_mem else "bytes")


def flash_bound(mask, h: int, dh: int, itemsize: int = 2,
                peak: float = PEAK_BF16_FLOPS):
    """bound_ms of masked attention on this mask: q and o move once, k and
    v only at real keys (a masked key adds exactly 0), and the two products
    cover only those keys; a row with no real key needs every key (the mean
    of V)."""
    b, t = mask.shape
    real = (mask > 0).sum(dim=1)
    keys = float(real.where(real > 0, t).sum())
    return bound_ms(4.0 * h * t * dh * keys,
                    2.0 * b * h * t * dh * itemsize
                    + 2.0 * h * dh * itemsize * keys + 4.0 * b * t, peak)


def flash_f32_bounds(entry, prefix, mask, h, dh):
    """The f32 flash's two bounds on the same bytes: its schedule's three
    TF32 products a term at 495 TFLOP/s (bound_ms, the least time), and one
    f32 FMA a term at 67 TFLOP/s (fma_bound_ms)."""
    entry[prefix + "bound_ms"], entry[prefix + "bound_by"] = flash_bound(
        mask, h, dh, 4, PEAK_TF32_FLOPS / 3)
    entry[prefix + "tf32x3_bound_ms"] = entry[prefix + "bound_ms"]
    entry[prefix + "fma_bound_ms"] = flash_bound(mask, h, dh, 4,
                                                 PEAK_F32_FLOPS)[0]


def nan_in_skipped_blocks(x, mask):
    """x (B, H, T, Dh) with NaN at every key of a 64-key block that holds no
    real key, in the batch rows that have one: the blocks the flash kernel
    skips, so the NaN must change no bit of its output."""
    import torch

    b, t = mask.shape
    nb = -(-t // 64)
    dead = (torch.nn.functional.pad(mask, (0, nb * 64 - t)).view(b, nb, 64)
            == 0).all(dim=2) & (mask > 0).any(dim=1, keepdim=True)
    keys = dead.repeat_interleave(64, dim=1)[:, :t][:, None, :, None]
    return torch.where(keys, torch.full_like(x, float("nan")), x)


def time_ms(fn, reps: int = 5, warmup: int = 1) -> float:
    """Median device time of fn() over reps, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def queued_ms(fn, calls: int) -> float:
    """Device time a call: ``calls`` calls queued between two CUDA events,
    over ``calls``, after one warm-up call; the host's side of each call
    overlaps the device's work of the calls before it."""
    import torch

    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(calls):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / calls


def zero_counts() -> None:
    """Every kernel wrapper's launch count and every native wrapper's call
    count to 0, just before a path is driven; the path's launches are read
    just after it."""
    from semanticsearch_tpu_torch import native
    from semanticsearch_tpu_torch.ops import flash_attention as fa
    from semanticsearch_tpu_torch.ops import rms_norm as rn
    from semanticsearch_tpu_torch.ops import short_conv as sc
    from semanticsearch_tpu_torch.ops import similarity as sim
    from semanticsearch_tpu_torch.ops import topk

    native.reset_counts()
    topk.SEGTOPK_LAUNCHES = topk.SEGTOPK_OVERLAP_LAUNCHES = 0
    topk.SEGTOPK_INT8_LAUNCHES = topk.TOPK_FUSED_LAUNCHES = 0
    topk.SEGTOPK_F32_LAUNCHES = topk.SEGTOPK_OVERLAP_F32_LAUNCHES = 0
    topk.TOPK_FUSED_F32_LAUNCHES = topk.PASS_B_LAUNCHES = 0
    topk.SEGTOPK_WIDE_LAUNCHES = 0
    fa.FLASH_LAUNCHES = fa.FLASH_F32_LAUNCHES = fa.FLASH_WIDE_LAUNCHES = 0
    fa.FLASH_CAUSAL_LAUNCHES = 0
    sim.SIM_LAUNCHES = sim.SIM_BF16_LAUNCHES = 0
    sc.SHORT_CONV_LAUNCHES = 0
    rn.RMS_NORM_LAUNCHES = 0


def topk_agree(v, i, ref_v, ref_i, tol: float, gap: float = None):
    """Compare a (Q, k) top-k with a (Q, k+1) reference. Scores must agree
    to ``tol``; indices must be equal at every position whose reference
    score is more than ``gap`` (default ``tol``) from its neighbours (the
    k+1-th included), i.e. everywhere but inside a (near-)tie. Returns
    (max_abs_err, mismatches outside ties, mismatches inside ties)."""
    import torch

    k = v.shape[1]
    v, i = v.float().cpu(), i.long().cpu()
    rv, ri = ref_v.float().cpu(), ref_i.long().cpu()
    err = float((v - rv[:, :k]).abs().max())
    close = (rv[:, 1:] - rv[:, :-1]).abs() <= (tol if gap is None else gap)
    tied = torch.zeros_like(rv, dtype=torch.bool)
    tied[:, 1:] |= close
    tied[:, :-1] |= close
    mism = i != ri[:, :k]
    return err, int((mism & ~tied[:, :k]).sum()), int((mism & tied[:, :k]).sum())


def pass_b_bound(seg_ids, n: int, L2: int, d: int, k: int, itemsize: int):
    """Pass B's bounds on these segments: (bound_ms, bound_by,
    gathered_bound_ms). Both read the queries and the segment ids and write
    the outputs once, and multiply-add every valid candidate's row with its
    query (at the bf16 peak for bf16 rows, the f32 FMA peak for f32 ones).
    bound_ms reads each corpus row that some query selected once, as the
    contract's least time does; gathered_bound_ms reads a query's rows for
    each query (the design's floor with no reuse between queries)."""
    import torch

    q, k_sel = seg_ids.shape
    rows = (seg_ids.long().clamp(min=0)[:, :, None] * L2
            + torch.arange(L2, device=seg_ids.device))
    valid = (seg_ids[:, :, None] >= 0) & (rows < n)
    gathered = float(valid.sum())
    unique = float(torch.unique(rows[valid]).numel())
    peak = PEAK_BF16_FLOPS if itemsize == 2 else PEAK_F32_FLOPS
    rest = itemsize * d * q + 4.0 * q * k_sel + 8.0 * q * k
    ms, by = bound_ms(2.0 * gathered * d, itemsize * d * unique + rest, peak)
    return ms, by, bound_ms(2.0 * gathered * d,
                            itemsize * d * gathered + rest, peak)[0]


def check_pass_b(queries, corpus, seg_ids, n: int, L2: int, k: int,
                 what: str) -> float:
    """The pass-B kernel against its plain version on the same segments:
    values within D * 2^-24 (a D-long f32 sum in another order), ids and
    tie order equal wherever the plain scores are more than that apart.
    Returns the largest value difference."""
    from semanticsearch_tpu_torch.ops import topk

    tol = queries.shape[1] * 2.0 ** -24
    kv, ki = topk.pass_b_rescore(queries, corpus, seg_ids, n, L2, k)
    pv, pi = topk.pass_b_rescore_plain(queries, corpus, seg_ids, n, L2, k + 1)
    err, bad, tied = topk_agree(kv, ki, pv, pi, tol)
    check(err <= tol and bad == 0,
          f"pass B kernel == plain {what}: max abs err {err:.2e} <= D * "
          f"2^-24 = {tol:.2e}; ids and tie order equal outside score gaps of "
          f"that ({tied} positions inside)")
    return err


# ----------------------------------------------------------------- phases

def phase_build():
    from semanticsearch_tpu_torch.ops import _build

    log("== phase 1: build the kernels (nvcc, sm_90a, one process per source)")
    t0 = time.perf_counter()
    logs = _build.build_all()
    log(f"  built {sorted(logs)} in {time.perf_counter() - t0:.1f} s "
        f"into {_build.BUILD_DIR}")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")
    for name in _build.sources():
        _build.load(name)


def _int_grid(shape, gen, dtype=None):
    """Integers in [-127, 127] on the card, bf16 unless ``dtype`` says
    otherwise: every dot product of width <= 1040 is an integer below 2^24,
    exact in f32 whatever the summation order, so kernel and plain versions
    must agree bit for bit."""
    import torch

    return torch.randint(-127, 128, shape, generator=gen, device=gen.device,
                         dtype=torch.int16).to(dtype or torch.bfloat16)


def phase_kernels(report):
    import torch

    from semanticsearch_tpu_torch.ops import flash_attention as fa
    from semanticsearch_tpu_torch.ops import similarity as sim
    from semanticsearch_tpu_torch.ops import topk

    log("== phase 2: kernels against their plain versions on the card")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(11)
    seg_err = ov_err = i8_err = pb_err = 0.0
    # (Q, N, k, block_rows, seg_split): serve leg, bench leg, edge layouts
    cases = [(256, 20011, 40, 16384, 4), (1024, 1_250_000, 10, 32768, 8),
             (70, 5000, 40, 32768, 1), (33, 1000, 10, 128, 1)]
    for q, n, k, block_rows, seg_split in cases:
        L2 = block_rows // 128 // seg_split
        Qm = _int_grid((q, 384), gen)
        C = _int_grid((n, 384), gen)
        k_sel = k + 1
        kv, ki = topk.segtopk_pass_a(Qm, C, n, L2, k_sel)
        pv, pi = topk.segtopk_pass_a_plain(Qm, C, n, L2, k_sel)
        ov, oi = topk.segtopk_pass_a_overlap(Qm, C, n, L2, k_sel)
        torch.cuda.synchronize()
        seg_err = max(seg_err, float((kv - pv).abs().max()))
        ov_err = max(ov_err, float((ov - pv).abs().max()))
        check(torch.equal(ki, pi) and torch.equal(kv, pv),
              f"pass A kernel == plain (ids and values exact): Q={q} N={n} "
              f"L2={L2} k_sel={k_sel}")
        check(torch.equal(oi, ki) and torch.equal(ov, kv)
              and torch.equal(oi, pi) and torch.equal(ov, pv),
              "overlap schedule == default schedule == plain, bit for bit")
        # pass B on pass A's segments (the last one past n where n % L2):
        # integer rows, so values, ids and tie order exact
        bv, bi = topk.pass_b_rescore(Qm, C, ki, n, L2, k)
        qv_, qi_ = topk.pass_b_rescore_plain(Qm, C, ki, n, L2, k)
        torch.cuda.synchronize()
        pb_err = max(pb_err, float((bv - qv_).abs().max()))
        check(torch.equal(bi, qi_) and torch.equal(bv, qv_),
              f"pass B kernel == plain (ids, tie order and values exact): "
              f"Q={q} N={n} L2={L2} k_sel={k_sel} k={k}")
        tv, ti = topk.topk_scores_twopass(Qm, C, k=k, block_n=block_rows,
                                          seg_split=seg_split)
        rv, ri = topk.topk_scores_ref(Qm, C, k=k + 1, block_n=65536)
        err, bad, tied = topk_agree(tv, ti, rv, ri, tol=0.0)
        check(err == 0.0 and bad == 0,
              f"two-pass == topk_scores_ref: scores exact, indices equal "
              f"outside exact ties ({tied} tie-permuted positions)")
        del C
        Q8 = _int_grid((q, 384), gen, torch.int8)
        C8 = _int_grid((n, 384), gen, torch.int8)
        k_sel8 = k + 1 + 5  # the int8 mode's default noise margin
        iv, ii = topk.segtopk_pass_a_int8(Q8, C8, n, L2, k_sel8)
        jv, ji = topk.segtopk_pass_a_int8_plain(Q8, C8, n, L2, k_sel8)
        torch.cuda.synchronize()
        i8_err = max(i8_err, float((iv - jv).abs().max()))
        check(torch.equal(ii, ji) and torch.equal(iv, jv),
              f"int8 pass A kernel == plain (ids and values exact): Q={q} "
              f"N={n} L2={L2} k_sel={k_sel8}")
    # a width that is a multiple of 8 but not of the 16-wide MMA step: the
    # bf16 schedules zero-fill the last step's upper half
    Qm, C = _int_grid((17, 72), gen), _int_grid((3000, 72), gen)
    kv, ki = topk.segtopk_pass_a(Qm, C, 3000, 8, 20)
    ov, oi = topk.segtopk_pass_a_overlap(Qm, C, 3000, 8, 20)
    pv, pi = topk.segtopk_pass_a_plain(Qm, C, 3000, 8, 20)
    torch.cuda.synchronize()
    seg_err = max(seg_err, float((kv - pv).abs().max()))
    ov_err = max(ov_err, float((ov - pv).abs().max()))
    check(torch.equal(ki, pi) and torch.equal(kv, pv) and torch.equal(oi, pi)
          and torch.equal(ov, pv),
          "pass A default and overlap schedules == plain at D=72, bit for bit")
    # bf16 widths that are not a multiple of 8: the wrappers pad them with
    # zero columns (one copy each) to 32 and 104; integer rows with every
    # score and segment maximum tied twice
    for d in (30, 100):
        Qm, C = _int_grid((17, d), gen), _int_grid((3000, d), gen)
        C[1500:] = C[:1500].clone()
        kv, ki = topk.segtopk_pass_a(Qm, C, 3000, 8, 20)
        ov, oi = topk.segtopk_pass_a_overlap(Qm, C, 3000, 8, 20)
        pv, pi = topk.segtopk_pass_a_plain(Qm, C, 3000, 8, 20)
        fv, fi = topk.topk_scores_fused(Qm, C, 300)
        gv, gi = topk.topk_scores_fused_plain(Qm, C, 300)
        torch.cuda.synchronize()
        seg_err = max(seg_err, float((kv - pv).abs().max()))
        ov_err = max(ov_err, float((ov - pv).abs().max()))
        check(torch.equal(ki, pi) and torch.equal(kv, pv)
              and torch.equal(oi, pi) and torch.equal(ov, pv)
              and torch.equal(fi, gi) and torch.equal(fv, gv),
              f"bf16 at D={d} (padded to {-(-d // 8) * 8}): pass A default "
              f"and overlap schedules and the fused top-k == plain, bit for "
              f"bit")
    # the 128- and 64-row query tiles' edges, a corpus below and just past
    # one 128-row tile, every way a segment lies in the accumulator registers
    # (inside a column pair, a quad, a tile, across tiles), the narrowest
    # width and one that leaves room for 64-row tiles only, the largest k_sel
    for q, n, d, L2, k_sel in [
            (1, 5000, 384, 32, 11), (65, 4097, 384, 32, 11),
            (129, 20011, 384, 32, 41), (40, 100, 384, 8, 11),
            (64, 129, 384, 32, 5), (200, 30000, 128, 32, 128),
            (70, 3000, 384, 1, 20), (70, 3000, 384, 2, 20),
            (70, 3000, 384, 4, 20), (70, 9000, 384, 128, 20),
            (130, 5000, 384, 256, 7), (33, 2000, 8, 32, 11),
            (150, 6000, 768, 32, 11)]:
        Qm, C = _int_grid((q, d), gen), _int_grid((n, d), gen)
        kv, ki = topk.segtopk_pass_a(Qm, C, n, L2, k_sel)
        pv, pi = topk.segtopk_pass_a_plain(Qm, C, n, L2, k_sel)
        torch.cuda.synchronize()
        seg_err = max(seg_err, float((kv - pv).abs().max()))
        check(torch.equal(ki, pi) and torch.equal(kv, pv),
              f"pass A kernel == plain (ids and values exact): Q={q} N={n} "
              f"D={d} L2={L2} k_sel={k_sel}")
    # a corpus tensor longer than n, large values past it: they never score
    Qm, C = _int_grid((70, 384), gen), _int_grid((5000, 384), gen)
    C[4001:] = 127.0
    Qm[:, 0] = 127.0
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # and on a stream that is not the default
        kv, ki = topk.segtopk_pass_a(Qm, C, 4001, 32, 11)
        fv, fi = topk.topk_scores_fused(Qm, C, 150, valid_n=4001)
    side.synchronize()
    pv, pi = topk.segtopk_pass_a_plain(Qm, C[:4001].clone(), 4001, 32, 11)
    gv, gi = topk.topk_scores_fused_plain(Qm, C, 150, valid_n=4001)
    check(torch.equal(ki, pi) and torch.equal(kv, pv) and torch.equal(fi, gi)
          and torch.equal(fv, gv) and int(fi.max()) < 4001,
          "pass A and the fused kernel on a side stream == plain when the "
          "corpus tensor runs past n with large values there")
    # the overlap schedule against the default bit for bit where its two
    # warpgroups run on a deeper ring and drift apart (more than 64
    # queries): every segment length, a ragged query tile, n not a multiple
    # of 128, D = 72, one and eight K chunks a tile (a ring longer and
    # shorter than a tile); the serve shape (one warpgroup) and k_sel 128
    # (64-row tiles); and real-valued scores
    ov_cases = [(64, 20000, 384, 32, 41)] + [
        (200, 20011, 384, L2, 41) for L2 in (1, 2, 4, 8, 32, 128, 256)] + [
        (200, 3000, 72, 8, 20), (300, 10000, 64, 32, 11),
        (300, 50000, 512, 32, 11), (200, 30000, 384, 32, 128)]
    for q, n, d, L2, k_sel in ov_cases:
        Qm, C = _int_grid((q, d), gen), _int_grid((n, d), gen)
        ov, oi = topk.segtopk_pass_a_overlap(Qm, C, n, L2, k_sel)
        kv, ki = topk.segtopk_pass_a(Qm, C, n, L2, k_sel)
        pv, pi = topk.segtopk_pass_a_plain(Qm, C, n, L2, k_sel)
        torch.cuda.synchronize()
        ov_err = max(ov_err, float((ov - pv).abs().max()))
        plan = topk.overlap_plan(q, d, k_sel, -(-n // L2), L2)
        check(torch.equal(oi, ki) and torch.equal(ov, kv)
              and torch.equal(oi, pi) and torch.equal(ov, pv),
              f"overlap schedule == default == plain, bit for bit: Q={q} "
              f"N={n} D={d} L2={L2} k_sel={k_sel} ({plan['bq']} query rows "
              f"a CTA, {plan['stages']} stages)")
    Qm = torch.randn((700, 384), generator=gen, device=dev).bfloat16()
    C = torch.randn((60000, 384), generator=gen, device=dev).bfloat16()
    ov, oi = topk.segtopk_pass_a_overlap(Qm, C, 60000, 32, 41)
    kv, ki = topk.segtopk_pass_a(Qm, C, 60000, 32, 41)
    check(torch.equal(oi, ki) and torch.equal(ov, kv),
          "overlap schedule == default bit for bit on real-valued scores "
          "(Q=700 N=60000 L2=32 k_sel=41)")
    report["segtopk"]["max_abs_err"] = seg_err
    report["segtopk_overlap"]["max_abs_err"] = ov_err
    report["segtopk_int8"]["max_abs_err"] = i8_err
    report["pass_b"]["max_abs_err"] = pb_err

    fu_err = 0.0
    for q, n, k, what in [(256, 20011, 200, "a serve-sized batch"),
                          (9000, 50000, 128, "past 8192 queries"),
                          (300, 50000, 2048, "the largest k"),
                          (64, 1000, 1500, "k > N: (-1e30, 0) tail"),
                          (1, 5000, 200, "one query"),
                          (65, 4097, 128, "a 64-row tile's edge"),
                          (129, 60000, 2048, "a 128-row tile's edge, the "
                           "round-by-round merge"),
                          (40, 100, 50, "a corpus below one tile"),
                          (64, 129, 129, "one tile plus one row, k = N"),
                          (300, 40000, 1, "k = 1")]:
        Qm = _int_grid((q, 384), gen)
        C = _int_grid((n, 384), gen)
        kv, ki = topk.topk_scores_fused(Qm, C, k)
        pv, pi = topk.topk_scores_fused_plain(Qm, C, k)
        torch.cuda.synchronize()
        fu_err = max(fu_err, float((kv - pv).abs().max()))
        check(torch.equal(ki, pi) and torch.equal(kv, pv),
              f"fused top-k kernel == plain (ids and values exact), {what}: "
              f"Q={q} N={n} k={k}")
    for q, n, d, k in [(9, 3000, 72, 300), (33, 2000, 8, 100),
                       (150, 6000, 768, 200)]:
        Qm, C = _int_grid((q, d), gen), _int_grid((n, d), gen)
        kv, ki = topk.topk_scores_fused(Qm, C, k)
        pv, pi = topk.topk_scores_fused_plain(Qm, C, k)
        torch.cuda.synchronize()
        fu_err = max(fu_err, float((kv - pv).abs().max()))
        check(torch.equal(ki, pi) and torch.equal(kv, pv),
              f"fused top-k kernel == plain at D={d} (ids and values exact)")
    # 50 distinct rows, each repeated 400 times across the corpus: every
    # score ties 400 ways, and the copies fall in different corpus splits
    base = _int_grid((50, 384), gen)
    C = base.repeat(400, 1)
    kv, ki = topk.topk_scores_fused(base[:8], C, 1000)
    pv, pi = topk.topk_scores_fused_plain(base[:8], C, 1000)
    ascending = bool(((kv[:, 1:] < kv[:, :-1])
                      | (ki[:, 1:] > ki[:, :-1])).all())
    check(torch.equal(ki, pi) and torch.equal(kv, pv) and ascending,
          "fused top-k kernel == plain on 400-way ties across splits; equal "
          "scores in ascending row order")
    report["topk_fused"]["max_abs_err"] = fu_err

    # the f32 schedules (an f32 index, 3xTF32 wgmma). Integer-valued rows in
    # [-8, 8], the corpus's first half repeated as its second, so every sum
    # is exact and scores and segment maxima tie: ids, tie order and values
    # must equal the plain f32 version's, in both pass-A wrappers and the
    # fused kernel, at D = 30 (padded to 32), 72, 100, 128, 384 and 1,024.
    # Then unit rows: values within D * 2^-24 (a D-long f32 chain's worst
    # case), ids equal wherever the plain values are more than twice that
    # apart, and few id differences inside such near-ties.
    def small_f32(shape):
        return torch.randint(-8, 9, shape, generator=gen, device=dev).float()

    def tied(C):
        C[C.shape[0] - C.shape[0] // 2:] = C[: C.shape[0] // 2].clone()
        return C

    def unit(shape):
        x = torch.randn(shape, generator=gen, device=dev)
        return x / x.norm(dim=1, keepdim=True)

    pass_a_f32 = (("segtopk_f32", topk.segtopk_pass_a),
                  ("segtopk_overlap_f32", topk.segtopk_pass_a_overlap))
    f32_err = {"segtopk_f32": 0.0, "segtopk_overlap_f32": 0.0,
               "topk_fused_f32": 0.0}
    for q, n, d, L2, k_sel in [(256, 20011, 384, 32, 41),
                               (64, 20000, 384, 32, 41),
                               (1024, 200000, 384, 32, 11),
                               (17, 3000, 72, 8, 20), (9, 3000, 100, 16, 20),
                               (70, 5000, 384, 256, 41),
                               (200, 30000, 128, 1, 128),
                               (33, 2000, 30, 4, 11),
                               (129, 20011, 1024, 32, 41),
                               (64, 20000, 1024, 8, 128)]:
        Qm, C = small_f32((q, d)), tied(small_f32((n, d)))
        pv, pi = topk.segtopk_pass_a_plain(Qm, C, n, L2, k_sel)
        for key, fn in pass_a_f32:
            kv, ki = fn(Qm, C, n, L2, k_sel)
            torch.cuda.synchronize()
            check(torch.equal(ki, pi) and torch.equal(kv, pv),
                  f"f32 pass A ({fn.__name__}) == plain on integer rows with "
                  f"ties (ids, tie order, values exact): Q={q} N={n} D={d} "
                  f"L2={L2} k_sel={k_sel}")
        k = min(k_sel - 1, 40) or 1
        bv, bi = topk.pass_b_rescore(Qm, C, pi, n, L2, k)
        qv_, qi_ = topk.pass_b_rescore_plain(Qm, C, pi, n, L2, k)
        torch.cuda.synchronize()
        check(torch.equal(bi, qi_) and torch.equal(bv, qv_),
              f"f32 pass B == plain on pass A's segments of integer rows with "
              f"ties (ids, tie order, values exact): Q={q} N={n} D={d} "
              f"L2={L2} k_sel={k_sel} k={k}")
    for q, n, d, k in [(300, 40000, 384, 1), (300, 40000, 384, 10),
                       (256, 20011, 384, 200), (129, 60000, 384, 2048),
                       (3, 250000, 128, 200), (9, 3000, 72, 300),
                       (9, 3000, 100, 300), (5, 300, 384, 500),
                       (129, 20011, 1024, 200), (17, 5000, 1024, 2048)]:
        Qm, C = small_f32((q, d)), tied(small_f32((n, d)))
        kv, ki = topk.topk_scores_fused(Qm, C, k)
        pv, pi = topk.topk_scores_fused_plain(Qm, C, k)
        torch.cuda.synchronize()
        check(torch.equal(ki, pi) and torch.equal(kv, pv),
              f"f32 fused top-k == plain on integer rows with ties (ids, tie "
              f"order, values exact): Q={q} N={n} D={d} k={k}")
    for d in (384, 72, 100, 1024):
        tol = d * 2.0 ** -24
        Qm, C = unit((300, d)), unit((50000, d))
        pv, pi = topk.segtopk_pass_a_plain(Qm, C, 50000, 32, 42)
        runs = [(key, fn(Qm, C, 50000, 32, 41)) for key, fn in pass_a_f32]
        runs.append(("topk_fused_f32", topk.topk_scores_fused(Qm, C, 200)))
        fv, fi = topk.topk_scores_fused_plain(Qm, C, 201)
        for key, (kv, ki) in runs:
            ref_v, ref_i = (fv, fi) if key == "topk_fused_f32" else (pv, pi)
            err, bad, near = topk_agree(kv, ki, ref_v, ref_i, tol, gap=2 * tol)
            f32_err[key] = max(f32_err[key], err)
            check(err <= tol and bad == 0 and near <= kv.numel() // 100,
                  f"{key} vs plain on unit rows, Q=300 N=50000 D={d}: max abs "
                  f"err {err:.2e} <= D * 2^-24 = {tol:.2e}; ids equal outside "
                  f"near-ties (gaps <= {2 * tol:.2e}); {near} id differences "
                  f"inside them (<= 1% of {kv.numel()})")
    for key, err in f32_err.items():
        report[key]["max_abs_err"] = err

    # int8 pass A on s8 wgmma: D = 384 and D = 72 (padded to 80 columns by
    # the wrapper), k_sel 16 and 128, the serve shape and the shard shape
    for q, n, d, L2, k_sel in [(64, 20000, 384, 32, 16),
                               (64, 20000, 384, 32, 128),
                               (64, 20000, 72, 32, 16),
                               (64, 20000, 72, 32, 128),
                               (2048, 200000, 72, 8, 128),
                               (32768, 1_250_000, 384, 32, 16)]:
        Q8 = _int_grid((q, d), gen, torch.int8)
        C8 = _int_grid((n, d), gen, torch.int8)
        iv, ii = topk.segtopk_pass_a_int8(Q8, C8, n, L2, k_sel)
        jv, ji = topk.segtopk_pass_a_int8_plain(Q8, C8, n, L2, k_sel)
        torch.cuda.synchronize()
        report["segtopk_int8"]["max_abs_err"] = max(
            report["segtopk_int8"]["max_abs_err"], float((iv - jv).abs().max()))
        check(torch.equal(ii, ji) and torch.equal(iv, jv),
              f"int8 pass A (s8 wgmma) == plain (ids and values exact): Q={q} "
              f"N={n} D={d} L2={L2} k_sel={k_sel}")
        del C8

    fl_err = 0.0
    # (B, T, Dh, dtype, keys kept): the serve and long-input shapes with a
    # third of the keys masked (whole trailing blocks at T = 256 and 1024,
    # which the kernel skips), a row whose keys are all masked and one with
    # live blocks around dead ones, other head widths and fp16; then the
    # serve batch (256 chunks of 40-256 tokens) and the chunking path's: a
    # full batch of 2,048 short sentences in the 64 bucket and a partial
    # last batch, each row keeping its own 3-12 leading keys as the
    # tokenizer pads them. Batches of 256 and more give each CTA several
    # heads in turn. q, k, v are the encoder's transposed views of
    # (B, T, H, Dh) tensors, read through their strides.
    bf16, fp16 = torch.bfloat16, torch.float16
    for b, t, dh, dtype, kept in [
            (8, 128, 32, bf16, None), (8, 256, 32, bf16, None),
            (2, 1024, 32, bf16, None), (4, 256, 64, fp16, None),
            (3, 512, 128, bf16, None), (3, 192, 16, fp16, None),
            (512, 128, 64, fp16, None), (256, 256, 32, bf16, (40, 256)),
            (2048, 64, 32, bf16, (3, 12)), (813, 64, 32, bf16, (3, 12))]:
        qkv = [torch.randn((b, t, 12, dh), generator=gen, device=dev)
               .to(dtype).transpose(1, 2) for _ in range(3)]
        if kept is None:
            mask = torch.ones((b, t), device=dev)
            mask[:, t - t // 3:] = 0.0  # masked tail
            mask[2 % b, 40:t - 64] = 0.0  # dead blocks between live ones
        else:
            lens = torch.randint(kept[0], kept[1] + 1, (b,), generator=gen,
                                 device=dev)
            mask = (torch.arange(t, device=dev)[None, :]
                    < lens[:, None]).float()
        mask[1, :] = 0.0            # a row with every key masked
        got = fa.flash_attention(*qkv, mask)
        want = fa.flash_attention_plain(*qkv, mask)
        diff = (got.float() - want.float()).abs()
        err = float(diff.max())
        fl_err = max(fl_err, err)
        if kept is None:
            check(bool(torch.isfinite(got).all()) and err <= 1e-2
                  and got.stride() == qkv[0].stride(),
                  f"flash kernel vs plain on strided views, {dtype}, B={b} "
                  f"H=12 T={t} Dh={dh}: max abs err {err:.3e} <= 1e-2 "
                  "(about 5 bf16 ulps at |o| = 0.5); output in q's strides")
        else:
            # a mean over 3-12 values of V reaches |o| = 3, where one bf16
            # ulp is 1.6e-2: the same 5 ulps, taken at each output's size
            rel = float((diff / want.float().abs().clamp(min=0.5)).max())
            check(bool(torch.isfinite(got).all()) and rel <= 2e-2,
                  f"flash kernel vs plain, bf16 views, B={b} H=12 T={t} "
                  f"Dh={dh}, "
                  f"{kept[0]}-{kept[1]} keys kept per row: max |err| / "
                  f"max(|o|, 0.5) {rel:.3e} <= 2e-2 (about 5 bf16 ulps of "
                  f"each output; max abs err {err:.3e} at |o| up to "
                  f"{float(want.float().abs().max()):.2f})")
    report["flash"]["max_abs_err"] = fl_err

    # f32 q, k, v (an f32 encoder) run the f32 path: within the JAX f32
    # test's 2e-5 of the plain version (TF32 off) at the serve shape, T =
    # 1024 and the chunking batches, with dead key blocks, a row with every
    # key masked, and NaN keys and values in the blocks the kernel skips,
    # which must change no bit
    f32_fl_err = 0.0
    for b, t, (lo, hi) in [(256, 256, (40, 256)), (2, 1024, (600, 1000)),
                           (2048, 64, (3, 12)), (813, 64, (3, 12))]:
        qkv = [torch.randn((b, t, 12, 32), generator=gen, device=dev)
               .transpose(1, 2) for _ in range(3)]
        lens = torch.randint(lo, hi + 1, (b,), generator=gen, device=dev)
        mask = (torch.arange(t, device=dev)[None, :] < lens[:, None]).float()
        mask[1, :] = 0.0
        if t >= 256:  # live blocks around dead ones
            mask[0, :] = 0.0
            mask[0, :30] = 1.0
            mask[0, t - 64: t - 40] = 1.0
        got = fa.flash_attention(*qkv, mask)
        want = fa.flash_attention_plain(*qkv, mask)
        again = fa.flash_attention(qkv[0], nan_in_skipped_blocks(qkv[1], mask),
                                   nan_in_skipped_blocks(qkv[2], mask), mask)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        f32_fl_err = max(f32_fl_err, err)
        within = bool(((got - want).abs() <= 2e-5 + 2e-5 * want.abs()).all())
        check(within and torch.equal(got, again)
              and got.stride() == qkv[0].stride(),
              f"f32 flash vs plain on strided views, B={b} H=12 T={t} Dh=32, "
              f"{lo}-{hi} real keys: within 2e-5 + 2e-5 |o| (max abs err "
              f"{err:.2e}); NaN in the skipped blocks changes no bit")
    # T up to 128 that is not a multiple of 64 (tail blocks zero-filled), and
    # head widths the kernel lacks (padded to the next of 16/32/64/128)
    for dtype in (bf16, fp16, torch.float32):
        worst = 0.0
        for t in (32, 96, 128, 192):
            for dh in (24, 48, 80):
                qkv = [torch.randn((4, t, 12, dh), generator=gen, device=dev)
                       .to(dtype).transpose(1, 2) for _ in range(3)]
                lens = torch.randint(t // 2, t + 1, (4,), generator=gen,
                                     device=dev)
                mask = (torch.arange(t, device=dev)[None, :]
                        < lens[:, None]).float()
                mask[1, :] = 0.0
                got = fa.flash_attention(*qkv, mask).float()
                want = fa.flash_attention_plain(*qkv, mask).float()
                if dtype == torch.float32:
                    f32_fl_err = max(f32_fl_err,
                                     float((got - want).abs().max()))
                    worst = max(worst, float(((got - want).abs()
                                              / (2e-5 + 2e-5 * want.abs()))
                                             .max()))
                else:
                    fl_err = max(fl_err, float((got - want).abs().max()))
                    worst = max(worst, float(((got - want).abs()
                                              / want.abs().clamp(min=0.5))
                                             .max()) / 2e-2)
        check(worst <= 1.0,
              f"flash in {dtype} at T = 32, 96, 128, 192 and Dh = 24, 48, 80 "
              f"(B=4 H=12) vs plain: worst error {worst:.3f} of its bound "
              "(f32: 2e-5 + 2e-5 |o|; bf16/fp16: 2e-2 max(|o|, 0.5))")
    # head widths past 128, as the JAX kernel takes them: 192 padded to the
    # 256-wide instantiation, 256, and 320 and 520 on the wide path (S once
    # per 64 query rows, its own launch counter); dead key blocks with NaN
    # in them change no bit
    wide_err = {}
    for dtype in (bf16, fp16, torch.float32):
        worst, same, wide_err[dtype] = 0.0, True, 0.0
        calls = wide_calls = 0
        before = (fa.FLASH_LAUNCHES, fa.FLASH_F32_LAUNCHES,
                  fa.FLASH_WIDE_LAUNCHES)
        for t in (96, 256):
            for dh in (192, 256, 320, 520):
                qkv = [torch.randn((4, t, 6, dh), generator=gen, device=dev)
                       .to(dtype).transpose(1, 2) for _ in range(3)]
                lens = torch.randint(t // 2, t + 1, (4,), generator=gen,
                                     device=dev)
                mask = (torch.arange(t, device=dev)[None, :]
                        < lens[:, None]).float()
                mask[1, :] = 0.0
                if t == 256:
                    mask[2, 40:t - 64] = 0.0  # dead blocks between live ones
                out = fa.flash_attention(*qkv, mask)
                got = out.float()
                want = fa.flash_attention_plain(*qkv, mask).float()
                same &= torch.equal(out, fa.flash_attention(
                    qkv[0], nan_in_skipped_blocks(qkv[1], mask),
                    nan_in_skipped_blocks(qkv[2], mask), mask))
                calls += 2
                if dh > 256:
                    wide_calls += 2
                    wide_err[dtype] = max(wide_err[dtype],
                                          float((got - want).abs().max()))
                if dtype == torch.float32:
                    f32_fl_err = max(f32_fl_err,
                                     float((got - want).abs().max()))
                    worst = max(worst, float(((got - want).abs()
                                              / (2e-5 + 2e-5 * want.abs()))
                                             .max()))
                else:
                    fl_err = max(fl_err, float((got - want).abs().max()))
                    worst = max(worst, float(((got - want).abs()
                                              / want.abs().clamp(min=0.5))
                                             .max()) / 2e-2)
        narrow = calls - wide_calls
        launched = (fa.FLASH_LAUNCHES - before[0],
                    fa.FLASH_F32_LAUNCHES - before[1],
                    fa.FLASH_WIDE_LAUNCHES - before[2])
        want_launched = ((0, narrow) if dtype == torch.float32
                         else (narrow, 0)) + (wide_calls,)
        check(worst <= 1.0 and same and launched == want_launched,
              f"flash in {dtype} at Dh = 192, 256, 320, 520 and T = 96, 256 "
              f"(B=4 H=6) vs plain: worst error {worst:.3f} of its bound "
              "(f32: 2e-5 + 2e-5 |o|; bf16, fp16: 2e-2 max(|o|, 0.5)); NaN "
              "in the skipped blocks changes no bit; launches (bf16/fp16, "
              f"f32, wide) {launched}, the wide kernel for Dh past 256")
    report["flash"]["max_abs_err"] = fl_err
    report["flash_f32"]["max_abs_err"] = f32_fl_err
    report["flash_wide"]["max_abs_err"] = max(wide_err[bf16], wide_err[fp16])
    report["flash_wide"]["f32_max_abs_err"] = wide_err[torch.float32]

    # the similarity kernel: integer-valued f32 rows give sums exact in f32
    # (at most 384 * 127^2 < 2^24), so kernel == plain bit for bit
    for b, n, d, what in [(1, 4096, 384, "the long-document bucket"),
                          (1, 3939, 384, "n not a multiple of the tile"),
                          (1, 1, 384, "n = 1"),
                          (1, 130, 72, "d = 72"),
                          (3, 77, 30, "d not a multiple of 4"),
                          (256, 64, 384, "a batch of padded short documents"),
                          (200, 128, 384, "a batch on wide tiles"),
                          (5, 600, 384, "a few documents on narrow tiles")]:
        E = _int_grid((b, n, d), gen, torch.float32)
        if b > 1:  # documents padded with rows of zeros, as the pipeline's
            lens = torch.randint(1, n + 1, (b,), generator=gen, device=dev)
            E = E * (torch.arange(n, device=dev)[None, :]
                     < lens[:, None])[:, :, None]
        S = sim.similarity_matrix(E)
        again = sim.similarity_matrix(E)
        P = sim.similarity_matrix_plain(E)
        torch.cuda.synchronize()
        check(torch.equal(S, P) and torch.equal(S, S.transpose(1, 2))
              and torch.equal(S, again),
              f"similarity kernel == plain bit for bit, S == S^T, two "
              f"launches identical; {what}: B={b} n={n} d={d}")
    # documents of 8-64 rows stacked 128 / n to a tile (the last tile
    # part-full), the triangle's edge inside a tile (n = 63, 65, 129), and
    # widths padded to whole 16-byte rows by one copy, on f32 and bf16
    # input: bit for bit, each document the same alone as in its batch
    for b, n, d in [(37, 8, 384), (21, 16, 384), (9, 32, 384), (5, 64, 384),
                    (3, 63, 384), (3, 65, 384), (2, 129, 384), (3, 150, 77),
                    (3, 150, 100)]:
        for dtype in (torch.float32, torch.bfloat16):
            E = _int_grid((b, n, d), gen, dtype)
            S = sim.similarity_matrix(E)
            alone = all(torch.equal(sim.similarity_matrix(E[i]), S[i])
                        for i in (0, b // 2, b - 1))
            plan = sim.similarity_plan(b, n, d, dtype)
            torch.cuda.synchronize()
            check(torch.equal(S, sim.similarity_matrix_plain(E))
                  and torch.equal(S, S.transpose(1, 2)) and alone,
                  f"similarity kernel == plain bit for bit, S == S^T, alone "
                  f"== in the batch; {dtype}, B={b} n={n} d={d} "
                  f"({plan['docs_per_tile']} documents a tile, "
                  f"{plan['ctas']} CTAs, {plan['col_pad']} columns padded)")
    sim_err = 0.0
    for b, n in [(1, 3939), (256, 64)]:
        E = sim.l2_normalize(torch.randn((b, n, 384), generator=gen,
                                         device=dev))
        S = sim.similarity_matrix(E)
        err = float((S - sim.similarity_matrix_plain(E)).abs().max())
        sim_err = max(sim_err, err)
        alone = torch.equal(sim.similarity_matrix(E[-1]), S[-1])
        check(err <= 1e-5 and torch.equal(S, S.transpose(1, 2))
              and torch.equal(S, sim.similarity_matrix(E)) and alone,
              f"similarity kernel vs plain on unit rows, B={b} n={n} d=384: "
              f"max abs err {err:.3e} <= 1e-5 (the 3xTF32 split drops 2^-22 "
              "of each product; the two accumulators round a few ulps of "
              "sums of size <= 1); bit-symmetric, bit-reproducible, a "
              "document alone == in its batch")
    report["similarity"]["max_abs_err"] = sim_err

    # bf16 input, widened to f32 as it is loaded: bit-equal to the plain
    # version of the same bf16 input on integer rows, within D * 2^-24 of it
    # on unit rows; bit-symmetric and bit-reproducible
    for b, n, d in [(1, 4096, 384), (1, 3939, 384), (3, 77, 30),
                    (256, 64, 384), (200, 128, 384)]:
        E = _int_grid((b, n, d), gen)
        S = sim.similarity_matrix(E)
        torch.cuda.synchronize()
        check(torch.equal(S, sim.similarity_matrix_plain(E))
              and torch.equal(S, S.transpose(1, 2))
              and torch.equal(S, sim.similarity_matrix(E)),
              f"similarity kernel on bf16 input == plain bit for bit, S == "
              f"S^T, two launches identical: B={b} n={n} d={d}")
    bf_err = 0.0
    for b, n in [(1, 3939), (256, 64)]:
        E = sim.l2_normalize(torch.randn((b, n, 384), generator=gen,
                                         device=dev)).bfloat16()
        S = sim.similarity_matrix(E)
        err = float((S - sim.similarity_matrix_plain(E)).abs().max())
        bf_err = max(bf_err, err)
        check(err <= 384 * 2.0 ** -24 and torch.equal(S, S.transpose(1, 2)),
              f"similarity kernel on bf16 unit rows, B={b} n={n} d=384: max "
              f"abs err {err:.3e} <= 384 * 2^-24; bit-symmetric")
    report["similarity_bf16"]["max_abs_err"] = bf_err


def _zipf_text(rng, words, n_words):
    """n_words drawn Zipf(1.2) from the word list: a few frequent words and
    a long tail, so BM25 sees real postings of every length."""
    ranks = np.minimum(rng.zipf(1.2, size=n_words), len(words)) - 1
    return " ".join(words[r] for r in ranks)


def phase_serve(report, tmp):
    import torch

    from semanticsearch_tpu_torch import native
    from semanticsearch_tpu_torch.core.config import (EncoderConfig,
                                                      get_named_config)
    from semanticsearch_tpu_torch.data.tsv import write_tsv
    from semanticsearch_tpu_torch.index.query_engine import HybridQueryEngine
    from semanticsearch_tpu_torch.models.encoder import SentenceEncoder
    from semanticsearch_tpu_torch.models.subword import (SubwordTokenizer,
                                                         train_bpe)
    from semanticsearch_tpu_torch.ops import flash_attention as fa
    from semanticsearch_tpu_torch.ops import topk
    from semanticsearch_tpu_torch.tools.host_profile import HostSplit

    log("== phase 3: hybrid serving through HybridQueryEngine (main path)")
    rng = np.random.default_rng(7)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    words = ["".join(rng.choice(letters, size=int(rng.integers(3, 10))))
             for _ in range(6000)]
    n_chunks = 20000
    lengths = rng.integers(40, 241, size=n_chunks)
    rows = [{"chunk_id": f"c{i}", "query_id": "", "document_id": f"d{i // 4}",
             "chunk_text": _zipf_text(rng, words, int(n))}
            for i, n in enumerate(lengths)]
    tsv = os.path.join(tmp, "chunks.tsv")
    write_tsv(tsv, rows, ["chunk_id", "query_id", "document_id", "chunk_text"])
    buckets = {b: int(((lengths + 1 > lo) & (lengths + 1 <= b)).sum())
               for lo, b in ((0, 64), (64, 128), (128, 256))}
    log(f"  {n_chunks} chunks of 40-240 words; chunks per length bucket "
        f"{buckets}")
    queries = [_zipf_text(rng, words, int(rng.integers(3, 9)))
               for _ in range(256)]
    batches = [queries[s: s + 64] for s in range(0, 256, 64)]

    cfg = EncoderConfig(attention="flash")
    log(f"  encoder: {dataclasses.asdict(cfg)}")
    encoder = SentenceEncoder(cfg, device="cuda", seed=0)

    zero_counts()
    t0 = time.perf_counter()
    built = HybridQueryEngine.build(tsv, encoder, os.path.join(tmp, "idx"))
    torch.cuda.synchronize()
    log(f"  build: {time.perf_counter() - t0:.1f} s (host clock)")
    engine = HybridQueryEngine.load(os.path.join(tmp, "idx"), encoder)
    native.reset_counts()
    t0 = time.perf_counter()
    with HostSplit(engine) as split:
        hybrid = [engine.search(b, k=10) for b in batches]
        dense_only = [engine.search(b, k=10, hybrid=False) for b in batches]
        piped = engine.search_pipelined(batches, k=10)
        torch.cuda.synchronize()
    log(f"  {3 * len(queries)} queries searched in "
        f"{time.perf_counter() - t0:.2f} s (host clock)")
    log(f"  host split (s): {split.line()}")
    report["host_split"] = {"serve": split.seconds}
    log(f"  native calls: hash tokenizer {native.HASH_TOKENIZE_CALLS}, BM25 "
        f"top-k {native.BM25_TOPK_CALLS}")
    check(native.HASH_TOKENIZE_CALLS > 0 and native.BM25_TOPK_CALLS > 0,
          "the served queries tokenized and ran the BM25 top-k natively")
    report["segtopk"]["launches"] = topk.SEGTOPK_LAUNCHES
    report["pass_b"]["launches"] = topk.PASS_B_LAUNCHES
    report["flash"]["launches"] = fa.FLASH_LAUNCHES
    report["flash_wide"]["launches"] = fa.FLASH_WIDE_LAUNCHES
    log(f"  launches on the serve path: segtopk {topk.SEGTOPK_LAUNCHES}, "
        f"pass B {topk.PASS_B_LAUNCHES}, flash {fa.FLASH_LAUNCHES}, flash "
        f"past Dh 256 {fa.FLASH_WIDE_LAUNCHES}")
    check(topk.SEGTOPK_LAUNCHES > 0 and fa.FLASH_LAUNCHES > 0
          and topk.PASS_B_LAUNCHES == topk.SEGTOPK_LAUNCHES,
          "pass A, pass B and flash launched on the serve path (one pass B "
          "a pass A)")

    def key(hits):
        return [[(h.chunk_id, h.score, h.dense_rank, h.lexical_rank)
                 for h in q] for q in hits]

    check(all(key(p) == key(h) for p, h in zip(piped, hybrid)),
          "search_pipelined == search (hits, scores, ranks)")
    check(key(built.search(batches[0], k=10)) == key(hybrid[0]),
          "the built engine and the reloaded one answer alike")
    n_lex = sum(h.lexical_rank > 0 for b in hybrid for q in b for h in q)
    check(all(len(q) == 10 for b in hybrid + dense_only for q in b)
          and n_lex > 0,
          f"10 hits per query; {n_lex} hybrid hits carry a lexical rank")
    check(all(h.lexical_rank == 0 for b in dense_only for q in b for h in q),
          "dense-only hits carry no lexical rank")

    # the serve_device profile over the same index: the device BM25 leg
    # (index/bm25_tpu.py) must answer the host leg's hits, list for list
    dev_cfg = get_named_config("serve_device").ranking
    dev_engine = HybridQueryEngine.load(os.path.join(tmp, "idx"), encoder,
                                        rank_cfg=dev_cfg)
    dev_engine.search(batches[0], k=10)  # builds the leg (B, K' from cfg)
    torch.cuda.synchronize()
    native.reset_counts()
    t0 = time.perf_counter()
    with HostSplit(dev_engine) as dsplit:
        dev_hybrid = [dev_engine.search(b, k=10) for b in batches]
        dev_piped = dev_engine.search_pipelined(batches, k=10)
        torch.cuda.synchronize()
    leg = dev_engine._device_bm25
    log(f"  serve_device: {2 * len(queries)} hybrid queries in "
        f"{time.perf_counter() - t0:.2f} s (host clock); device leg B="
        f"{leg.B}, K'={leg.topk_device}, weights {leg.weights}, "
        f"residual {leg.residual}: {leg.stats['queries']} queries, "
        f"{leg.stats['fallbacks']} host fallbacks; native calls: rare touch "
        f"{native.BM25_RARE_TOUCH_CALLS}, post "
        f"{native.BM25_DEVICE_POST_CALLS}")
    log(f"  serve_device host split (s): {dsplit.line()}")
    report["host_split"]["serve_device"] = dsplit.seconds
    check(all(key(d) == key(h) for d, h in zip(dev_hybrid, hybrid))
          and all(key(d) == key(h) for d, h in zip(dev_piped, hybrid))
          and native.BM25_DEVICE_POST_CALLS > 0,
          "serve_device (the device BM25 leg) == the host leg: every hit "
          "list, scores and ranks, searched and pipelined")
    del dev_engine, leg

    # a trained subword vocabulary (tokenizer.json) in the index: trained
    # on this corpus, persisted by build, swapped in by load
    t0 = time.perf_counter()
    tok = train_bpe((r["chunk_text"] for r in rows), vocab_size=8192,
                    max_len=cfg.max_len)
    sub_rows = rows[:2000]
    sub_tsv = os.path.join(tmp, "chunks_subword.tsv")
    write_tsv(sub_tsv, sub_rows,
              ["chunk_id", "query_id", "document_id", "chunk_text"])
    sub_dir = os.path.join(tmp, "idx_subword")
    check(tok.vocab_size <= cfg.vocab_size,
          f"trained a {tok.vocab_size}-piece vocabulary on the "
          f"{n_chunks} chunks in {time.perf_counter() - t0:.1f} s (the "
          f"encoder's table holds {cfg.vocab_size})")
    sub_built = HybridQueryEngine.build(
        sub_tsv, SentenceEncoder(cfg, device="cuda", seed=0, tokenizer=tok),
        sub_dir)
    fresh = SentenceEncoder(cfg, device="cuda", seed=0)
    native.reset_counts()
    sub_engine = HybridQueryEngine.load(sub_dir, fresh)
    sub_hits = sub_engine.search(batches[0], k=10)
    check(isinstance(fresh.tokenizer, SubwordTokenizer)
          and fresh.tokenizer.vocab == tok.vocab
          and native.SUBWORD_TOKENIZE_CALLS > 0
          and key(sub_hits) == key(sub_built.search(batches[0], k=10))
          and all(len(q) == 10 for q in sub_hits),
          "an index with tokenizer.json: load swapped the trained vocabulary "
          "into a hashing-tokenizer encoder, encoded natively, and answers "
          "as the engine that built it")

    q_emb = encoder.encode_device(queries)
    check(q_emb.shape == (256, 384) and bool(torch.isfinite(q_emb).all())
          and float((q_emb.norm(dim=1) - 1).abs().max()) < 1e-3,
          "query embeddings: (256, 384), finite, unit norm")
    v, i = engine.index.search_device(q_emb, k=40)
    corpus = engine.index._corpus
    rv, ri = topk.topk_scores_ref(q_emb.to(corpus.dtype), corpus, k=41,
                                  block_n=65536)
    err, bad, tied = topk_agree(v, i, rv, ri, tol=1e-5)
    check(err <= 1e-5 and bad == 0,
          f"dense leg == plain exact top-40 on the same embeddings (max abs "
          f"err {err:.2e}; {tied} positions inside near-ties)")

    log("  encoder at max_len 1024 under attention='auto'")
    long_cfg = EncoderConfig(max_len=1024, attention="auto")
    stock_cfg = dataclasses.replace(long_cfg, attention="stock")
    enc_auto = SentenceEncoder(long_cfg, device="cuda", seed=1)
    enc_stock = SentenceEncoder(stock_cfg, device="cuda", seed=1)
    texts = [_zipf_text(rng, words, int(n)) for n in (900, 500, 30, 1000)]
    before = fa.FLASH_LAUNCHES
    e_auto = enc_auto.encode_device(texts)
    check(fa.FLASH_LAUNCHES > before,
          f"'auto' engaged the flash kernel at max_len 1024 "
          f"({fa.FLASH_LAUNCHES - before} launches)")
    cos = float((e_auto * enc_stock.encode_device(texts)).sum(dim=1).min())
    check(cos > 0.99, f"flash vs stock encoder at T up to 1024, bf16: "
          f"least cosine {cos:.5f} > 0.99")
    return {"words": words, "encoder": encoder, "tmp": tmp,
            "idx": os.path.join(tmp, "idx"), "tsv": tsv, "batches": batches}


def phase_dense(report):
    import torch

    from semanticsearch_tpu_torch.core.config import IndexConfig
    from semanticsearch_tpu_torch.data import synth
    from semanticsearch_tpu_torch.index.engine import EmbeddingIndex
    from semanticsearch_tpu_torch.ops import flash_attention as fa
    from semanticsearch_tpu_torch.ops import topk

    log("== phase 4: dense top-10 at the shard size (1,250,000 x 384 bf16)")
    n, d, q, k = 1_250_000, 384, 32768, 10
    cfg = IndexConfig(block_rows=32768, seg_split=8)
    corpus = synth.corpus(n, d, torch.bfloat16, "cuda")
    queries = synth.corpus(q, d, torch.bfloat16, "cuda", start=20_000_000)
    index = EmbeddingIndex(corpus, n, cfg)
    zero_counts()
    index.search_device(queries, k=k)  # warm-up
    torch.cuda.synchronize()
    iters = 3
    t0 = time.perf_counter()
    for _ in range(iters):
        vals, idx = index.search_device(queries, k=k)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / iters
    report["dense_qps"] = q / dt
    log(f"  EmbeddingIndex.search_device: {dt * 1e3:.1f} ms per {q} queries "
        f"= {q / dt:,.0f} QPS ({topk.SEGTOPK_LAUNCHES} pass-A, "
        f"{topk.PASS_B_LAUNCHES} pass-B launches)")
    report["pass_b"]["dense_launches"] = topk.PASS_B_LAUNCHES
    check(topk.PASS_B_LAUNCHES == topk.SEGTOPK_LAUNCHES == iters + 1,
          "the dense search rescored through the pass-B kernel, one launch "
          "a search")
    sample = torch.arange(0, q, q // 128, device="cuda")[:128]
    rv, ri = topk.topk_scores_ref(queries[sample], corpus, k=k, block_n=65536)
    hits = sum(len(set(a) & set(b)) for a, b in
               zip(idx[sample].tolist(), ri.tolist()))
    recall = hits / (128 * k)
    report["recall_at_10"] = recall
    check(recall == 1.0, f"recall@10 = {recall} on 128 sampled queries "
          "against the plain exact top-k")

    # pass A alone at this shape: kernel in both bf16 schedules (timed in
    # turns: default, overlap, overlap, default), plain version, GEMM floor
    L2 = cfg.block_rows // 128 // cfg.seg_split
    k_sel = k + 1
    seg, ov = report["segtopk"], report["segtopk_overlap"]
    zero_counts()
    ov_vals, ov_idx = topk.topk_scores_twopass(
        queries, corpus, k=k, block_n=cfg.block_rows,
        seg_split=cfg.seg_split, mxu_overlap=True)
    torch.cuda.synchronize()
    ov["launches"] = topk.SEGTOPK_OVERLAP_LAUNCHES
    check(ov["launches"] > 0 and torch.equal(ov_idx, idx)
          and torch.equal(ov_vals, vals),
          f"topk_scores_twopass(mxu_overlap=True) launched the overlap "
          f"schedule ({ov['launches']}x) and equals the default search bit "
          "for bit")

    def pass_a():
        topk.segtopk_pass_a(queries, corpus, n, L2, k_sel)

    def pass_a_overlap():
        topk.segtopk_pass_a_overlap(queries, corpus, n, L2, k_sel)

    turns = [time_ms(f, reps=3) for f in (pass_a, pass_a_overlap,
                                          pass_a_overlap, pass_a)]
    seg["ms"] = (turns[0] + turns[3]) / 2
    ov["ms"] = (turns[1] + turns[2]) / 2
    seg["plain_ms"] = time_ms(lambda: topk.segtopk_pass_a_plain(
        queries, corpus, n, L2, k_sel), reps=1, warmup=0)
    ov["plain_ms"] = seg["plain_ms"]  # one plain version for both schedules

    def gemm_floor(qs):
        for s in range(0, n, 16384):
            torch.matmul(qs, corpus[s: s + 16384].T)

    seg["library_ms"] = ov["library_ms"] = time_ms(lambda: gemm_floor(queries),
                                                   reps=3)
    seg["bound_ms"], seg["bound_by"] = bound_ms(
        2.0 * q * n * d, 2.0 * (q * d + n * d) + 8.0 * q * k_sel)
    ov["bound_ms"], ov["bound_by"] = seg["bound_ms"], seg["bound_by"]
    log(f"  pass A: kernel {seg['ms']:.2f} ms, overlap schedule "
        f"{ov['ms']:.2f} ms (turns {', '.join(f'{t:.2f}' for t in turns)}), "
        f"plain {seg['plain_ms']:.2f} ms, bf16 GEMM floor "
        f"{seg['library_ms']:.2f} ms, bound {seg['bound_ms']:.2f} ms "
        f"({seg['bound_by']})")

    # pass B alone on pass A's segments: the kernel in turns with its plain
    # version (the torch gather and bmm it replaced), held against it
    pb = report["pass_b"]
    _, seg_ids = topk.segtopk_pass_a(queries, corpus, n, L2, k_sel)
    pb["max_abs_err"] = max(pb["max_abs_err"], check_pass_b(
        queries, corpus, seg_ids, n, L2, k, f"at the shard (Q={q}, k_sel "
        f"{k_sel}, L2 {L2})"))

    def pass_b():
        topk.pass_b_rescore(queries, corpus, seg_ids, n, L2, k)

    def pass_b_plain():
        topk.pass_b_rescore_plain(queries, corpus, seg_ids, n, L2, k)

    turns = [time_ms(pass_b, reps=5), time_ms(pass_b_plain, reps=2),
             time_ms(pass_b, reps=5)]
    pb["ms"], pb["plain_ms"] = (turns[0] + turns[2]) / 2, turns[1]
    pb["library_ms"] = None
    pb["bound_ms"], pb["bound_by"], pb["gathered_bound_ms"] = pass_b_bound(
        seg_ids, n, L2, d, k, 2)
    pb["bound_note"] = (
        "bound_ms reads each corpus row some query selected once, the "
        "queries, segment ids and outputs once, and multiply-adds every "
        "valid candidate with its query at the bf16 peak (f32_*: the f32 "
        "FMA peak); gathered_bound_ms reads a query's rows for each query "
        "(no reuse between queries: the floor of a one-CTA-a-query "
        "design); the segment-major kernel reads each selected segment "
        "about once; hot_*: every query one of 64 repeated, so all pick "
        "the same segments; serve_queued_ms: 50 calls queued between two "
        "events, over 50 (the device's time a call, apart from the host's)")
    log(f"  pass B alone (Q={q}, k_sel {k_sel}, L2 {L2}): kernel "
        f"{pb['ms']:.3f} ms (turns {turns[0]:.3f}, {turns[2]:.3f}), plain "
        f"{pb['plain_ms']:.2f} ms, bound {pb['bound_ms']:.3f} ms "
        f"({pb['bound_by']}: each selected row once), "
        f"{pb['gathered_bound_ms']:.3f} ms with a query's rows once a query")
    # pass A and pass B at the serve shape: one 64-query batch over 20,000
    # rows, the serve engine's own segments (block_rows 16384 / 128 /
    # seg_split 4 = 32 rows, k_sel 41, k 40)
    qs, cs = queries[:64], corpus[:20000]
    serve = [time_ms(f, reps=50, warmup=3) for f in (
        lambda: topk.segtopk_pass_a(qs, cs, 20000, 32, 41),
        lambda: topk.segtopk_pass_a_overlap(qs, cs, 20000, 32, 41),
        lambda: topk.segtopk_pass_a_overlap(qs, cs, 20000, 32, 41),
        lambda: topk.segtopk_pass_a(qs, cs, 20000, 32, 41))]
    seg["serve_ms"] = (serve[0] + serve[3]) / 2
    ov["serve_ms"] = (serve[1] + serve[2]) / 2
    seg["serve_library_ms"] = time_ms(lambda: torch.matmul(qs, cs.T), reps=50)
    seg["serve_bound_ms"], seg["serve_bound_by"] = bound_ms(
        2.0 * 64 * 20000 * d, 2.0 * (64 + 20000) * d + 8.0 * 64 * 41)
    ov["serve_bound_ms"] = seg["serve_bound_ms"]
    _, s_seg = topk.segtopk_pass_a(qs, cs, 20000, 32, 41)
    pb["serve_ms"] = time_ms(lambda: topk.pass_b_rescore(
        qs, cs, s_seg, 20000, 32, 40), reps=50, warmup=3)
    pb["serve_queued_ms"] = queued_ms(lambda: topk.pass_b_rescore(
        qs, cs, s_seg, 20000, 32, 40), 50)
    (pb["serve_bound_ms"], pb["serve_bound_by"],
     pb["serve_gathered_bound_ms"]) = pass_b_bound(s_seg, 20000, 32, d, 40, 2)
    log(f"  pass B at the serve shape (64 x 20,000, k_sel 41, k 40): kernel "
        f"{pb['serve_ms']:.4f} ms a call by events, "
        f"{pb['serve_queued_ms']:.4f} ms a call with 50 queued, bound "
        f"{pb['serve_bound_ms']:.4f} ms ({pb['serve_bound_by']}; a query's "
        f"rows once a query {pb['serve_gathered_bound_ms']:.4f} ms)")
    # every query the same (hot segments): 64 distinct queries repeated to
    # the shard's 32,768, so every query picks the same k_sel segments
    hot_q = queries[:64].repeat(q // 64, 1)
    _, hot_seg = topk.segtopk_pass_a(hot_q, corpus, n, L2, k_sel)
    pb["max_abs_err"] = max(pb["max_abs_err"], check_pass_b(
        hot_q, corpus, hot_seg, n, L2, k, f"with every query one of 64 "
        f"repeated (hot segments, Q={q})"))
    pb["hot_ms"] = time_ms(lambda: topk.pass_b_rescore(
        hot_q, corpus, hot_seg, n, L2, k), reps=5)
    pb["hot_bound_ms"], pb["hot_bound_by"], _ = pass_b_bound(
        hot_seg, n, L2, d, k, 2)
    log(f"  pass B with hot segments (64 queries repeated to {q}): kernel "
        f"{pb['hot_ms']:.3f} ms against {pb['ms']:.3f} ms for distinct "
        f"queries, bound {pb['hot_bound_ms']:.4f} ms ({pb['hot_bound_by']})")
    check(pb["hot_ms"] <= 1.1 * pb["ms"],
          "pass B with every query picking the same segments is no slower "
          "than with distinct queries (within 10 %)")
    del hot_q, hot_seg
    log(f"  pass A at the serve shape (64 x 20,000, k_sel 41): kernel "
        f"{seg['serve_ms']:.4f} ms, overlap schedule (one warpgroup) "
        f"{ov['serve_ms']:.4f} ms (turns "
        f"{', '.join(f'{t:.4f}' for t in serve)}), bf16 torch.matmul "
        f"{seg['serve_library_ms']:.4f} ms, bound "
        f"{seg['serve_bound_ms']:.4f} ms ({seg['serve_bound_by']})")

    # int8 pass A, driven through topk_scores_twopass(pass_a_int8=True)
    i8 = report["segtopk_int8"]
    zero_counts()
    i8_vals, i8_idx = topk.topk_scores_twopass(
        queries, corpus, k=k, block_n=cfg.block_rows,
        seg_split=cfg.seg_split, pass_a_int8=True)
    torch.cuda.synchronize()
    i8["launches"] = topk.SEGTOPK_INT8_LAUNCHES
    hits8 = sum(len(set(a) & set(b)) for a, b in
                zip(i8_idx[sample].tolist(), ri.tolist()))
    report["recall_at_10_int8"] = hits8 / (128 * k)
    check(i8["launches"] > 0 and report["recall_at_10_int8"] >= 0.99,
          f"topk_scores_twopass(pass_a_int8=True) launched the int8 kernel "
          f"({i8['launches']}x); recall@10 = {report['recall_at_10_int8']} "
          ">= 0.99 on 128 sampled queries (statistically exact mode)")
    q8 = topk._quantize_rows_int8(queries)
    c8, _ = topk.quantize_int8_global(corpus)
    k_sel8 = k + 1 + 5
    i8["ms"] = time_ms(lambda: topk.segtopk_pass_a_int8(q8, c8, n, L2, k_sel8),
                       reps=3)
    i8["plain_ms"] = time_ms(lambda: topk.segtopk_pass_a_int8_plain(
        q8, c8, n, L2, k_sel8), reps=1, warmup=0)

    def int8_gemm_floor():
        for s in range(0, n, 16384):
            torch._int_mm(q8, c8[s: s + 16384].T)

    try:
        i8["library_ms"] = time_ms(int8_gemm_floor, reps=3)
        what = "torch._int_mm int8 GEMM floor"
    except RuntimeError as exc:  # no int8 GEMM for this layout or build
        log(f"  torch._int_mm unavailable ({str(exc).splitlines()[0]}); "
            "library_ms is the bf16 GEMM floor")
        i8["library_ms"] = seg["library_ms"]
        what = "bf16 GEMM floor"
        i8["library_note"] = ("torch._int_mm unavailable: the bf16 "
                              "torch.matmul GEMM floor")
    i8["bound_ms"], i8["bound_by"] = bound_ms(
        2.0 * q * n * d, 1.0 * (q * d + n * d) + 8.0 * q * k_sel8,
        PEAK_INT8_OPS)
    log(f"  int8 pass A: kernel {i8['ms']:.2f} ms, plain "
        f"{i8['plain_ms']:.2f} ms, {what} {i8['library_ms']:.2f} ms, bound "
        f"{i8['bound_ms']:.2f} ms ({i8['bound_by']})")
    del q8, c8

    # fused top-200 over the shard at 16,384 queries
    fu = report["topk_fused"]
    qf, kf = queries[:16384], 200
    fu["ms"] = time_ms(lambda: topk.topk_scores_fused(qf, corpus, kf), reps=3)
    fv, fi = topk.topk_scores_fused(qf, corpus, kf)
    fsample = torch.arange(0, 16384, 128, device="cuda")
    rv, ri = topk.topk_scores_ref(qf[fsample], corpus, k=kf + 1, block_n=65536)
    err, bad, tied = topk_agree(fv[fsample], fi[fsample], rv, ri, tol=1e-5)
    hits = sum(len(set(a) & set(b)) for a, b in
               zip(fi[fsample].tolist(), ri[:, :kf].tolist()))
    report["recall_at_200_fused"] = hits / (128 * kf)
    check(err <= 1e-5 and bad == 0,
          f"fused top-200 == plain exact top-200 on 128 sampled queries: "
          f"recall@200 = {report['recall_at_200_fused']}, max abs err "
          f"{err:.2e}, {tied} positions inside near-ties (1e-5)")
    # the plain version at 2,048 queries, scaled by 8 to the batch
    fu["plain_ms"] = 8 * time_ms(lambda: topk.topk_scores_fused_plain(
        qf[:2048], corpus, kf), reps=1, warmup=0)
    fu["plain_note"] = "timed on 2,048 of the 16,384 queries, times 8"
    fu["library_ms"] = time_ms(lambda: gemm_floor(qf), reps=3)
    fu["bound_ms"], fu["bound_by"] = bound_ms(
        2.0 * 16384 * n * d, 2.0 * (16384 * d + n * d) + 8.0 * 16384 * kf)
    log(f"  fused top-{kf}, {qf.shape[0]} queries: kernel {fu['ms']:.2f} ms, "
        f"plain {fu['plain_ms']:.2f} ms (2,048 queries x 8), bf16 GEMM floor "
        f"{fu['library_ms']:.2f} ms, bound {fu['bound_ms']:.2f} ms "
        f"({fu['bound_by']})")

    # the fused kernel at the live search's shape: 10,000 queries over a
    # 22,000-row index, k = 200
    ql, cl = queries[:10000], corpus[:22000]
    fu["live_ms"] = time_ms(lambda: topk.topk_scores_fused(ql, cl, kf), reps=5)
    fu["live_library_ms"] = time_ms(lambda: torch.matmul(ql, cl.T), reps=5)
    fu["live_bound_ms"], fu["live_bound_by"] = bound_ms(
        2.0 * 10000 * 22000 * d, 2.0 * (10000 + 22000) * d + 8.0 * 10000 * kf)
    log(f"  fused top-{kf} at the live shape (10,000 x 22,000): kernel "
        f"{fu['live_ms']:.3f} ms, bf16 torch.matmul "
        f"{fu['live_library_ms']:.3f} ms, bound {fu['live_bound_ms']:.3f} ms "
        f"({fu['live_bound_by']})")

    # flash on the encoder's transposed views of (B, T, H, Dh) tensors: the
    # serve shape (256 chunks of 40-256 tokens), T = 1024 (the "auto" rule's
    # length) and the chunking batch (2,048 sentences of 3-12 tokens)
    fl = report["flash"]
    gen = torch.Generator().manual_seed(3)
    h, dh = 12, 32
    for which, b, t, (lo, hi) in [("", 256, 256, (40, 256)),
                                  ("t1024_", 2, 1024, (600, 1000)),
                                  ("chunk_", 2048, 64, (3, 12))]:
        qkv = [torch.randn((b, t, h, dh), generator=gen)
               .to("cuda", torch.bfloat16).transpose(1, 2) for _ in range(3)]
        lengths = torch.randint(lo, hi + 1, (b,), generator=gen)
        mask = (torch.arange(t)[None, :] < lengths[:, None]).float().to("cuda")
        bool_mask = mask.bool()[:, None, None, :]
        fl[which + "ms"] = time_ms(lambda: fa.flash_attention(*qkv, mask),
                                   reps=20, warmup=3)
        fl[which + "plain_ms"] = time_ms(
            lambda: fa.flash_attention_plain(*qkv, mask), reps=5)
        fl[which + "library_ms"] = time_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                *qkv, attn_mask=bool_mask), reps=20, warmup=3)
        fl[which + "bound_ms"], fl[which + "bound_by"] = flash_bound(mask, h,
                                                                     dh)
        log(f"  flash B={b} H={h} T={t} Dh={dh}, {lo}-{hi} real keys: kernel "
            f"{fl[which + 'ms']:.4f} ms, plain {fl[which + 'plain_ms']:.3f} "
            f"ms, SDPA {fl[which + 'library_ms']:.4f} ms, bound "
            f"{fl[which + 'bound_ms']:.4f} ms ({fl[which + 'bound_by']}, the "
            "real keys)")
    # head widths past 128 (no configuration of the repo has one): 256 (the
    # 256-wide schedules) and 320 (the wide path) at B=64 H=8 T=256, 40-256
    # real keys, bf16 and f32
    wide = report["flash_wide"]
    for dtype in (torch.bfloat16, torch.float32):
        f32 = dtype == torch.float32
        for width in (256, 320):
            b, t, hw = 64, 256, 8
            entry, key = ((wide, "f32_" if f32 else "") if width > 256 else
                          (report["flash_f32"] if f32 else fl, f"dh{width}_"))
            qkv = [torch.randn((b, t, hw, width), generator=gen)
                   .to("cuda", dtype).transpose(1, 2) for _ in range(3)]
            lengths = torch.randint(40, t + 1, (b,), generator=gen)
            mask = (torch.arange(t)[None, :]
                    < lengths[:, None]).float().to("cuda")
            bool_mask = mask.bool()[:, None, None, :]
            entry[key + "ms"] = time_ms(lambda: fa.flash_attention(*qkv, mask),
                                        reps=10, warmup=2)
            entry[key + "plain_ms"] = time_ms(
                lambda: fa.flash_attention_plain(*qkv, mask), reps=3)
            entry[key + "library_ms"] = time_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    *qkv, attn_mask=bool_mask), reps=10, warmup=2)
            if f32:
                flash_f32_bounds(entry, key, mask, hw, width)
            else:
                entry[key + "bound_ms"], entry[key + "bound_by"] = (
                    flash_bound(mask, hw, width))
            log(f"  flash {dtype} B={b} H={hw} T={t} Dh={width}, 40-256 real "
                f"keys: kernel {entry[key + 'ms']:.4f} ms, plain "
                f"{entry[key + 'plain_ms']:.3f} ms, SDPA "
                f"{entry[key + 'library_ms']:.4f} ms, bound "
                f"{entry[key + 'bound_ms']:.4f} ms ({entry[key + 'bound_by']}"
                + (f"; 3xTF32 at 495 TFLOP/s; f32 FMAs "
                   f"{entry[key + 'fma_bound_ms']:.4f} ms)" if f32 else ")"))
    wide["shape_note"] = (
        "Dh 320 at B=64 H=8 T=256 (40-256 real keys), q, k, v transposed "
        "(B, T, H, Dh) views; ms, plain_ms, library_ms (SDPA), bound_ms in "
        "bf16; f32_* the same in f32 (library: f32 SDPA, TF32 off; "
        "f32_bound_ms = f32_tf32x3_bound_ms, three TF32 products a term at "
        "495 TFLOP/s; f32_fma_bound_ms one f32 FMA at 67 TFLOP/s); bounds "
        "count the real keys")
    fl["shape_note"] = (
        "ms, plain_ms, library_ms, bound_ms at B=256 H=12 T=256 Dh=32 with "
        "40-256 real keys; t1024_* at B=2 T=1024 (600-1000 real); chunk_* at "
        "B=2048 T=64 (3-12 real); dh256_* at B=64 H=8 T=256 (40-256 real) "
        "with Dh 256 (Dh 320: the flash_wide entry); q, k, v transposed "
        "(B, T, H, Dh) views; bounds count the real keys' K and V and "
        "products (a row with none counts every key); varlen_* the packed "
        "entry at the serve shape (4,096 texts, lognormal, median 8 tokens, "
        "2-33), varlen_chunk_* at 256 chunks of 40-256 tokens, H=12 Dh=32, "
        "(N, H, Dh) views of (N, 384) rows, bounds on the real tokens' q, k, "
        "v and o and each text's own products, padded_ms the padded kernel "
        "on the same texts at T = 64 (serve) or 256 (chunks)")
    time_flash_varlen(report, gen)


def varlen_bound(lens, h: int, dh: int, itemsize: int, peak: float):
    """bound_ms of packed texts' attention: q, k, v and o of every real
    token once, the offsets and tiles, and each text's own products."""
    from semanticsearch_tpu_torch.ops import flash_attention as fa

    lens = np.asarray(lens, np.float64)
    n_tiles = len(fa.varlen_tiles(np.concatenate([[0], np.cumsum(lens)])
                                  .astype(np.int64)))
    return bound_ms(4.0 * h * dh * float((lens * lens).sum()),
                    4.0 * lens.sum() * h * dh * itemsize
                    + 4.0 * (lens.size + 1) + 16.0 * n_tiles, peak)


def time_flash_varlen(report, gen):
    """The packed entry (bf16 and f32) against its plain version and timed
    at the serve shape and the chunks' shape, beside the padded kernel on
    the same texts and SDPA on them padded to the longest."""
    import torch
    from semanticsearch_tpu_torch.ops import flash_attention as fa

    h, dh = 12, 32
    shapes = [("varlen_", np.clip(np.rint(np.random.default_rng(4).lognormal(
        np.log(8), 0.5, 4096)), 2, 33), 64),
        ("varlen_chunk_", np.random.default_rng(5).integers(40, 257, 256),
         256)]
    for dtype in (torch.bfloat16, torch.float32):
        f32 = dtype == torch.float32
        entry = report["flash_f32"] if f32 else report["flash"]
        for key, lens, t in shapes:
            layout = fa.varlen_layout(lens, "cuda")
            n = int(lens.sum())
            q, k, v = (torch.randn((n, h * dh), generator=gen).to(
                "cuda", dtype).view(n, h, dh) for _ in range(3))
            got = fa.flash_attention_varlen(q, k, v, layout)
            want = fa.flash_attention_varlen_plain(q, k, v, layout)
            diff = (got.float() - want.float()).abs()
            worst = (float((diff / (2e-5 + 2e-5 * want.float().abs())).max())
                     if f32 else
                     float((diff / want.float().abs().clamp(min=0.5)).max())
                     / 2e-2)
            check(bool(torch.isfinite(got).all()) and worst <= 1.0,
                  f"packed flash in {dtype}, {len(lens)} texts of "
                  f"{int(lens.min())}-{int(lens.max())} tokens vs plain: "
                  f"worst error {worst:.3f} of its bound (f32: 2e-5 + 2e-5 "
                  "|o|; bf16: 2e-2 max(|o|, 0.5))")
            entry[key + "max_abs_err"] = float(diff.max())
            entry[key + "ms"] = time_ms(
                lambda: fa.flash_attention_varlen(q, k, v, layout), reps=20,
                warmup=3)
            entry[key + "plain_ms"] = time_ms(
                lambda: fa.flash_attention_varlen_plain(q, k, v, layout),
                reps=5)
            # the same texts padded: the padded kernel at the bucket, SDPA
            # at the longest text
            padded = [torch.zeros((len(lens), t, h, dh), device="cuda",
                                  dtype=dtype) for _ in range(3)]
            idx = (layout.seg.long(), layout.pos.long())
            for p, x in zip(padded, (q, k, v)):
                p[idx] = x
            mask = torch.zeros((len(lens), t), device="cuda")
            mask[idx] = 1.0
            views = [p.transpose(1, 2) for p in padded]
            entry[key + "padded_ms"] = time_ms(
                lambda: fa.flash_attention(*views, mask), reps=20, warmup=3)
            w = layout.width
            short = [x[:, :, :w] for x in views]
            bool_mask = mask[:, None, None, :w].bool()
            entry[key + "library_ms"] = time_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    *short, attn_mask=bool_mask), reps=20, warmup=3)
            if f32:
                entry[key + "bound_ms"], entry[key + "bound_by"] = (
                    varlen_bound(lens, h, dh, 4, PEAK_TF32_FLOPS / 3))
                entry[key + "fma_bound_ms"] = varlen_bound(
                    lens, h, dh, 4, PEAK_F32_FLOPS)[0]
            else:
                entry[key + "bound_ms"], entry[key + "bound_by"] = (
                    varlen_bound(lens, h, dh, 2, PEAK_BF16_FLOPS))
            log(f"  packed flash {dtype} {len(lens)} texts, {n} tokens, "
                f"H={h} Dh={dh}: kernel {entry[key + 'ms']:.4f} ms, padded "
                f"kernel at T={t} {entry[key + 'padded_ms']:.4f} ms, plain "
                f"{entry[key + 'plain_ms']:.3f} ms, SDPA at T={w} "
                f"{entry[key + 'library_ms']:.4f} ms, bound "
                f"{entry[key + 'bound_ms']:.4f} ms ({entry[key + 'bound_by']}"
                + (f"; 3xTF32; f32 FMAs {entry[key + 'fma_bound_ms']:.4f} ms)"
                   if f32 else ")"))



def varlen_causal_bound(lens, h: int, h_kv: int, dh: int, itemsize: int):
    """bound_ms of packed texts' causal grouped-K/V attention: q and o of
    the ``h`` heads and k and v of the ``h_kv`` heads of every real token
    once, the offsets and tiles, and each text's causal products (a token
    and the keys up to itself)."""
    from semanticsearch_tpu_torch.ops import flash_attention as fa

    lens = np.asarray(lens, np.float64)
    n_tiles = len(fa.varlen_tiles(np.concatenate([[0], np.cumsum(lens)])
                                  .astype(np.int64)))
    return bound_ms(4.0 * h * dh * float((lens * (lens + 1) / 2).sum()),
                    2.0 * lens.sum() * (h + h_kv) * dh * itemsize
                    + 4.0 * (lens.size + 1) + 16.0 * n_tiles)


def phase_llm_kernels(report):
    """The LLM search cell's (``lfm2-8b-a1b-bf16.mine_b256``) three kernels
    at its shapes: the packed flash entry, causal with grouped K/V, over a
    forward of 256 texts whose lengths follow the cell's law (log-normal
    words, median 160, sigma 0.6, 32-511, plus a BOS token) at 32 query and
    8 K/V heads x 64; the fused gated short convolution over the same texts
    (:func:`phase_short_conv`); and pass A's wide bf16 schedule (past
    ``pass_a_max_d``) at 256 queries over 10,000,000 rows of 2,048 (the
    cell's segments: 16,384-row blocks split 4 ways, k_sel 11). Each is
    held against its plain version, launch counters from 0; pass A on
    integer rows in [-63, 63], whose products sum exactly in float32 (63^2
    x 2,048 < 2^24), so ids, tie order and values must be equal bit for
    bit."""
    import torch
    from semanticsearch_tpu_torch.ops import flash_attention as fa
    from semanticsearch_tpu_torch.ops import topk

    log("== phase 4b: the LLM search cell's kernels at its shapes")
    torch.cuda.empty_cache()
    fc, wide = report["flash_causal"], report["segtopk_wide"]
    gen = torch.Generator().manual_seed(23)

    h, h_kv, dh = 32, 8, 64
    lens = np.clip(np.rint(np.random.default_rng(23).lognormal(
        np.log(160), 0.6, 256)), 32, 511).astype(np.int64) + 1
    layout = fa.varlen_layout(lens, "cuda")
    n = int(lens.sum())
    q = torch.randn((n, h, dh), generator=gen).to("cuda", torch.bfloat16)
    k, v = (torch.randn((n, h_kv, dh), generator=gen).to(
        "cuda", torch.bfloat16) for _ in range(2))
    zero_counts()
    got = fa.flash_attention_varlen(q, k, v, layout, causal=True)
    fc["launches"] = fa.FLASH_CAUSAL_LAUNCHES
    launches = (fa.FLASH_LAUNCHES, fa.FLASH_F32_LAUNCHES,
                fa.FLASH_WIDE_LAUNCHES)
    want = fa.flash_attention_varlen_plain(q, k, v, layout, causal=True)
    diff = (got.float() - want.float()).abs()
    worst = float((diff / want.float().abs().clamp(min=0.5)).max()) / 2e-2
    fc["max_abs_err"] = float(diff.max())
    check(fc["launches"] == 1 and launches == (0, 0, 0)
          and bool(torch.isfinite(got).all()) and worst <= 1.0,
          f"causal grouped-K/V packed flash, {len(lens)} texts of "
          f"{int(lens.min())}-{int(lens.max())} tokens ({n}), {h}/{h_kv} "
          f"heads x {dh}, vs plain: one launch of its entry and none of "
          f"another, worst error {worst:.3f} of its bound (2e-2 max(|o|, "
          "0.5))")
    del want, diff
    fc["ms"] = time_ms(lambda: fa.flash_attention_varlen(
        q, k, v, layout, causal=True), reps=20, warmup=3)
    fc["plain_ms"] = time_ms(lambda: fa.flash_attention_varlen_plain(
        q, k, v, layout, causal=True), reps=3)
    # SDPA over the texts padded to the longest, causal: pads sit after a
    # text's tokens, so no real query sees one
    w = layout.width
    idx = (layout.seg.long(), layout.pos.long())
    padded = []
    for x in (q, k, v):
        p = x.new_zeros((len(lens), w) + x.shape[1:])
        p[idx] = x
        padded.append(p.transpose(1, 2))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    try:
        sdpa(*padded, is_causal=True, enable_gqa=True)
        fc["library_ms"] = time_ms(lambda: sdpa(
            *padded, is_causal=True, enable_gqa=True), reps=20, warmup=3)
        fc["library_note"] = ("SDPA padded to the longest text, causal, "
                              "enable_gqa")
    except TypeError:  # a torch without enable_gqa: K/V heads repeated
        rep = [x.repeat_interleave(h // h_kv, dim=1) for x in padded[1:]]
        fc["library_ms"] = time_ms(lambda: sdpa(
            padded[0], *rep, is_causal=True), reps=20, warmup=3)
        fc["library_note"] = ("SDPA padded to the longest text, causal, "
                              "K/V heads repeated before the call")
    fc["bound_ms"], fc["bound_by"] = varlen_causal_bound(lens, h, h_kv, dh, 2)
    fc["shape_note"] = (f"{len(lens)} texts of {int(lens.min())}-"
                        f"{int(lens.max())} tokens ({n}) in one forward, "
                        f"{h} query and {h_kv} K/V heads x {dh}, bf16; "
                        "bound: q, k, v, o once, the causal products")
    log(f"  causal GQA packed flash, {n} tokens: kernel {fc['ms']:.4f} ms, "
        f"plain {fc['plain_ms']:.3f} ms, SDPA {fc['library_ms']:.4f} ms, "
        f"bound {fc['bound_ms']:.4f} ms ({fc['bound_by']})")
    del q, k, v, got, padded
    torch.cuda.empty_cache()
    phase_short_conv(report, lens, layout)
    phase_rms_norm(report, lens)
    phase_llm_forward(report, lens)

    nq, nr, d, k_sel, seg_rows = 256, 10_000_000, 2048, 11, 32
    check(topk.pass_a_schedule(d, k_sel) == "wide",
          f"D {d} is past pass_a_max_d({k_sel}) = {topk.pass_a_max_d(k_sel)}"
          ": pass A takes its wide schedule")
    g = torch.Generator(device="cuda").manual_seed(24)

    def grid(rows):
        out = torch.empty((rows, d), dtype=torch.bfloat16, device="cuda")
        for s in range(0, rows, 1 << 16):
            r = min(1 << 16, rows - s)
            out[s: s + r] = torch.randint(-63, 64, (r, d), generator=g,
                                          device="cuda").to(torch.bfloat16)
        return out

    queries, corpus = grid(nq), grid(nr)
    zero_counts()
    kv, ki = topk.segtopk_pass_a(queries, corpus, nr, seg_rows, k_sel)
    torch.cuda.synchronize()
    wide["launches"] = topk.SEGTOPK_WIDE_LAUNCHES
    other = topk.SEGTOPK_LAUNCHES
    pv, pi = topk.segtopk_pass_a_plain(queries, corpus, nr, seg_rows, k_sel)
    wide["max_abs_err"] = float((kv - pv).abs().max())
    check(wide["launches"] == 1 and other == 0 and torch.equal(ki, pi)
          and torch.equal(kv, pv),
          f"wide pass A at {nq} x {nr:,} x {d} (segments of {seg_rows} "
          f"rows, k_sel {k_sel}) == plain: one launch of the wide schedule, "
          "none of the resident-tile one, ids in the same order and values "
          "bit for bit")
    del kv, ki, pv, pi
    wide["ms"] = time_ms(lambda: topk.segtopk_pass_a(
        queries, corpus, nr, seg_rows, k_sel), reps=5)
    wide["plain_ms"] = time_ms(lambda: topk.segtopk_pass_a_plain(
        queries, corpus, nr, seg_rows, k_sel), reps=1, warmup=0)

    def gemm_floor():
        for s in range(0, nr, 16384):
            torch.matmul(queries, corpus[s: s + 16384].T)

    wide["library_ms"] = time_ms(gemm_floor, reps=3)
    wide["library_note"] = "bf16 torch.matmul over 16,384-row blocks"
    wide["bound_ms"], wide["bound_by"] = bound_ms(
        2.0 * nq * nr * d, 2.0 * (nq * d + nr * d) + 8.0 * nq * k_sel)
    wide["shape_note"] = (f"{nq} queries x {nr:,} rows x {d}, bf16, "
                          f"segments of {seg_rows} rows, k_sel {k_sel}")
    log(f"  wide pass A: kernel {wide['ms']:.2f} ms, plain "
        f"{wide['plain_ms']:.2f} ms, bf16 GEMM floor "
        f"{wide['library_ms']:.2f} ms, bound {wide['bound_ms']:.2f} ms "
        f"({wide['bound_by']})")
    del queries, corpus
    torch.cuda.empty_cache()


def phase_short_conv(report, lens, layout):
    """Phase 4b's fused gated short convolution (``csrc/short_conv.cu``) at
    the LLM cell's conv layer: the texts of ``lens`` (``layout``), hidden
    2,048, three taps, bf16, held bit for bit against its plain version,
    one ``launch.short_conv``; timed beside the plain chain and its bound
    (B, C and X read once, the result written once)."""
    import torch
    from semanticsearch_tpu_torch.core import profiling
    from semanticsearch_tpu_torch.ops import short_conv as sc

    conv = report["short_conv"]
    h, taps, n = 2048, 3, int(lens.sum())
    g = torch.Generator(device="cuda").manual_seed(25)
    bcx = torch.randn((n, 3 * h), generator=g, device="cuda").to(
        torch.bfloat16)
    w = (torch.randn((h, 1, taps), generator=g, device="cuda")
         * taps ** -0.5).to(torch.bfloat16)
    zero_counts()
    got = sc.gated_short_conv(bcx, w, layout.pos)
    conv["launches"] = profiling.counters()["launch.short_conv"]
    want = sc.gated_short_conv_plain(bcx, w, layout.pos)
    conv["max_abs_err"] = float((got.float() - want.float()).abs().max())
    check(conv["launches"] == 1 and torch.equal(got.view(torch.int16),
                                                want.view(torch.int16)),
          f"fused gated short conv, {len(lens)} texts ({n} tokens) x {h}, "
          f"{taps} taps, bf16 == plain bit for bit, one launch.short_conv")
    del got, want
    # the device's time a call, as the cell's forward queues it; one call
    # between two events also holds the wrapper's host path (0.04-0.09 ms)
    conv["ms"] = queued_ms(lambda: sc.gated_short_conv(bcx, w, layout.pos),
                           50)
    conv["call_ms"] = time_ms(lambda: sc.gated_short_conv(
        bcx, w, layout.pos), reps=20, warmup=3)
    conv["plain_ms"] = time_ms(lambda: sc.gated_short_conv_plain(
        bcx, w, layout.pos), reps=5)
    conv["library_ms"] = None
    conv["library_note"] = "none: no one PyTorch call computes it"
    conv["bound_ms"], conv["bound_by"] = bound_ms(
        0.0, 2.0 * n * 4 * h + 4.0 * n + 2.0 * h * taps)
    conv["shape_note"] = (f"{len(lens)} texts ({n} tokens) x hidden {h}, "
                          f"{taps} taps, bf16; bound: B, C, X read once, "
                          "the result written once; ms: 50 calls queued "
                          "between two events, over 50; call_ms: one call "
                          "between two events, the host path included")
    log(f"  fused short conv, {n} tokens x {h}: kernel {conv['ms']:.4f} ms "
        f"a call queued ({conv['call_ms']:.4f} one call alone), plain "
        f"{conv['plain_ms']:.3f} ms, bound {conv['bound_ms']:.4f} ms "
        f"({conv['bound_by']})")
    del bcx
    torch.cuda.empty_cache()


def phase_rms_norm(report, lens):
    """Phase 4b's RMSNorm kernel (``csrc/rms_norm.cu``) at the LLM cell's
    shapes over the tokens of ``lens``, bf16: the add and the norm after it
    at hidden 2,048, the norm alone at 2,048 (the first ``op_norm``) and
    over each token's 32 q heads and 8 k heads of 64 (the q/k norms), each
    with a weight of its own width; each one ``launch.rms_norm``, held
    against its plain chain as ``tests/test_torch_cuda_kernels.py`` holds
    it (``ops/rms_norm.py`` ``rms_norm_agrees``: 1/rms within two float32
    ulps, each normalized value within one ulp, 99 % of the output
    bit-equal; the residual bit for bit). The add and the q norm are timed
    beside the plain chain and their bounds (x and d read once, s and out
    written once)."""
    import torch
    from semanticsearch_tpu_torch.core import profiling
    from semanticsearch_tpu_torch.ops import rms_norm as rn

    norm = report["rms_norm"]
    h, n, eps = 2048, int(lens.sum()), 1e-5
    g = torch.Generator(device="cuda").manual_seed(27)

    def weight(width):
        return (1.0 + 0.2 * torch.randn(width, generator=g, device="cuda")
                ).to(torch.bfloat16)

    x = (torch.randn((n, h), generator=g, device="cuda") * 3.0).to(
        torch.bfloat16)
    d = torch.randn((n, h), generator=g, device="cuda").to(torch.bfloat16)
    w, wq, wk = weight(h), weight(64), weight(64)
    norm["bit_equal_share"] = {}
    for what, args, wv in (("add", (x, d), w), ("norm", (x,), w),
                           ("q", (x.view(n, 32, 64),), wq),
                           ("k", (x[:, :512].contiguous().view(n, 8, 64),),
                            wk)):
        zero_counts()
        if what == "add":
            s, got = rn.add_rms_norm(*args, wv, eps)
            want_s = rn.add_rms_norm_plain(*args, wv, eps)[0]
            same_s = torch.equal(s.view(torch.int16),
                                 want_s.view(torch.int16))
        else:
            got, want_s, same_s = rn.rms_norm(*args, wv, eps), args[0], True
        launches = profiling.counters()["launch.rms_norm"]
        rows, near, same = rn.rms_norm_agrees(got, want_s, wv, eps)
        norm["bit_equal_share"][what] = same
        if what == "add":
            norm["launches"] = launches
            norm["max_abs_err"] = float(
                (got.float() - rn.rms_norm_plain(want_s, wv, eps).float())
                .abs().max())
        check(launches == 1 and same_s and rows and near and same >= 0.99,
              f"RMSNorm {what} over {tuple(got.shape)}, bf16 vs plain: one "
              "launch.rms_norm, "
              + ("the residual bit for bit, " if what == "add" else "")
              + "each row the plain chain's with 1/rms within two float32 "
              f"ulps, each normalized value within one ulp, {100 * same:.4f}"
              " % of the output bit-equal (>= 99)")
        del got, want_s
    norm["ms"] = queued_ms(lambda: rn.add_rms_norm(x, d, w, eps), 50)
    norm["call_ms"] = time_ms(lambda: rn.add_rms_norm(x, d, w, eps), reps=20,
                              warmup=3)
    norm["plain_ms"] = time_ms(lambda: rn.add_rms_norm_plain(x, d, w, eps),
                               reps=5)
    norm["library_ms"] = None
    norm["library_note"] = "none: PyTorch has no fused add and RMSNorm"
    norm["bound_ms"], norm["bound_by"] = bound_ms(0.0, 2.0 * n * h * 4
                                                  + 2.0 * h)
    del d
    q = x.view(n, 32, 64)
    norm["head_ms"] = queued_ms(lambda: rn.rms_norm(q, wq, eps), 50)
    norm["head_plain_ms"] = time_ms(lambda: rn.rms_norm_plain(q, wq, eps),
                                    reps=5)
    norm["head_bound_ms"] = bound_ms(0.0, 2.0 * n * h * 2 + 128.0)[0]
    norm["shape_note"] = (f"{len(lens)} texts ({n} tokens) x hidden {h}, "
                          "bf16; bound: x and d read once, s and out written "
                          "once; ms: 50 calls queued between two events, "
                          "over 50; call_ms: one call between two events; "
                          f"head_*: rms_norm over ({n}, 32, 64), no add; "
                          "bit_equal_share: the add, the norm alone at "
                          "2,048, the q and k norms")
    log(f"  fused add + RMSNorm, {n} tokens x {h}: kernel {norm['ms']:.4f} "
        f"ms a call queued ({norm['call_ms']:.4f} one call alone), plain "
        f"{norm['plain_ms']:.3f} ms, bound {norm['bound_ms']:.4f} ms "
        f"({norm['bound_by']}); q norm ({n} x 32 x 64): kernel "
        f"{norm['head_ms']:.4f} ms, plain {norm['head_plain_ms']:.3f} ms, "
        f"bound {norm['head_bound_ms']:.4f} ms")
    del x, q
    torch.cuda.empty_cache()


def phase_llm_forward(report, lens):
    """Phase 4b's whole LLM encoder: LFM2-8B-A1B at its published sizes in
    bf16 (16.7 GB of seeded weights made on the card leaf by leaf), one
    ``encode_device`` of 256 texts of ``lens`` tokens in one forward,
    launch counters from 0: the fused conv once a conv layer and the
    causal flash once an attention layer, and no other flash entry."""
    import torch
    from semanticsearch_tpu_torch.core import profiling
    from semanticsearch_tpu_torch.core.config import LFM2MoEConfig
    from semanticsearch_tpu_torch.models.encoder import SentenceEncoder
    from semanticsearch_tpu_torch.models.lfm2_moe import LFM2MoEModel
    from semanticsearch_tpu_torch.ops import flash_attention as fa

    cfg = LFM2MoEConfig(dtype="bfloat16")
    with torch.device("meta"):
        shapes = {k: v.shape for k, v in LFM2MoEModel(cfg).state_dict()
                  .items()}
    g = torch.Generator(device="cuda").manual_seed(26)
    weights = {}
    for name, shape in shapes.items():
        w = torch.randn(shape, generator=g, device="cuda",
                        dtype=torch.bfloat16)
        if name.endswith("norm.weight"):
            w.mul_(0.05).add_(1.0)
        elif name.endswith("expert_bias"):
            w.mul_(0.01)
        elif not name.startswith("embed"):  # (..., out, fan_in)
            w.mul_(shape[-1] ** -0.5)
        weights[name] = w
    enc = SentenceEncoder(cfg, device="cuda", state_dict=weights)
    del weights
    rng = np.random.default_rng(26)
    # the tokenizer puts the first id before a text's words
    texts = [" ".join(f"w{j}" for j in rng.integers(0, 50000, m - 1))
             for m in lens]
    conv_layers = cfg.layer_types.count("conv")
    attn_layers = cfg.layer_types.count("full_attention")
    # the first op_norm, an add and the norm after it twice a layer, the q
    # and k norms of each attention layer
    norm_launches = 1 + 2 * cfg.num_layers + 2 * attn_layers
    zero_counts()
    out = enc.encode_device(texts, batch_size=len(texts))
    torch.cuda.synchronize()
    counts = profiling.counters()
    conv, causal = counts["launch.short_conv"], counts["launch.flash_causal"]
    norms = counts["launch.rms_norm"]
    other = (fa.FLASH_LAUNCHES, fa.FLASH_F32_LAUNCHES, fa.FLASH_WIDE_LAUNCHES)
    report["short_conv"]["forward_launches"] = conv
    report["flash_causal"]["forward_launches"] = causal
    report["rms_norm"]["forward_launches"] = norms
    check(conv == conv_layers and causal == attn_layers
          and norms == norm_launches
          and other == (0, 0, 0) and out.shape == (len(texts), cfg.hidden_dim)
          and bool(torch.isfinite(out).all()),
          f"LFM2-8B-A1B forward over {len(texts)} texts ({int(lens.sum())} "
          f"tokens): launch.short_conv {conv} (a conv layer: "
          f"{conv_layers}), launch.flash_causal {causal} (an attention "
          f"layer: {attn_layers}), launch.rms_norm {norms} "
          f"({norm_launches}), no other flash entry, finite embeddings")
    log(f"  LFM2-8B-A1B forward, {len(texts)} texts: launch.short_conv "
        f"{conv}, launch.flash_causal {causal}, launch.rms_norm {norms}")
    del enc, out
    torch.cuda.empty_cache()


# phase 5: chunks added to and removed from the phase-3 index, and queries
LIVE_ADDS, LIVE_REMOVES, LIVE_QUERIES = 2000, 500, 10000


class _RowEncoder:
    """Encoder stand-in for a fresh build over given embedding rows:
    ``encode`` hands out the rows in order (the builder embeds the chunk
    file front to back), queries go to the real encoder."""

    def __init__(self, encoder, rows: np.ndarray) -> None:
        self.cfg, self._encoder, self._rows, self._next = (
            encoder.cfg, encoder, rows, 0)

    def encode(self, texts, batch_size: int = 256) -> np.ndarray:
        out = self._rows[self._next: self._next + len(texts)]
        self._next += len(texts)
        return out

    def encode_device(self, texts, batch_size: int = 256):
        return self._encoder.encode_device(texts, batch_size)


def phase_live(report, ctx):
    import shutil

    import torch

    from semanticsearch_tpu_torch.data.tsv import read_tsv, write_tsv
    from semanticsearch_tpu_torch.index.builder import EMB_FILE, IDS_FILE
    from semanticsearch_tpu_torch.index.query_engine import (
        FUSION_FILE, HybridQueryEngine)
    from semanticsearch_tpu_torch import native
    from semanticsearch_tpu_torch.ops import flash_attention as fa
    from semanticsearch_tpu_torch.ops import topk
    from semanticsearch_tpu_torch.tools.host_profile import HostSplit

    log("== phase 5: deep-candidate retrieval over a live index (main path)")
    rng = np.random.default_rng(17)
    words, encoder = ctx["words"], ctx["encoder"]
    live_dir = os.path.join(ctx["tmp"], "live")
    shutil.copytree(ctx["idx"], live_dir)
    engine = HybridQueryEngine.load(live_dir, encoder)
    n_main = engine.index.size
    n_all = n_main + LIVE_ADDS
    add_ids = [f"a{i}" for i in range(LIVE_ADDS)]
    add_texts = [_zipf_text(rng, words, int(n))
                 for n in rng.integers(40, 241, size=LIVE_ADDS)]
    t0 = time.perf_counter()
    engine.add_documents(add_ids, add_texts)
    dead_rows = np.sort(rng.choice(n_all, size=LIVE_REMOVES, replace=False))
    removed = [engine.chunk_ids[r] for r in dead_rows]
    check(engine.remove_documents(removed) == LIVE_REMOVES,
          f"added {LIVE_ADDS} chunks to the {n_main}-chunk index and removed "
          f"{LIVE_REMOVES} ({time.perf_counter() - t0:.1f} s, host clock)")
    queries = [_zipf_text(rng, words, int(rng.integers(3, 9)))
               for _ in range(LIVE_QUERIES)]

    zero_counts()
    t0 = time.perf_counter()
    with HostSplit(engine) as split:
        hits = engine.search(queries, k=50)
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    report["topk_fused"]["launches"] = topk.TOPK_FUSED_LAUNCHES
    log(f"  {LIVE_QUERIES} hybrid queries at k=50 (dense fetch 200 + "
        f"{(LIVE_REMOVES + 63) // 64 * 64}) in "
        f"{dt:.2f} s (host clock); launches: topk_fused "
        f"{topk.TOPK_FUSED_LAUNCHES}, flash {fa.FLASH_LAUNCHES}, segtopk "
        f"{topk.SEGTOPK_LAUNCHES}")
    log(f"  host split (s): {split.line()}")
    report["host_split"]["live"] = split.seconds
    log(f"  native calls: hash tokenizer {native.HASH_TOKENIZE_CALLS}, BM25 "
        f"top-k {native.BM25_TOPK_CALLS}, delta score "
        f"{native.BM25_SCORE_CALLS}")
    check(native.HASH_TOKENIZE_CALLS > 0 and native.BM25_TOPK_CALLS > 0
          and native.BM25_SCORE_CALLS > 0,
          "the live search tokenized, ran the BM25 top-k and scored the "
          "delta natively")
    check(topk.TOPK_FUSED_LAUNCHES > 0 and fa.FLASH_LAUNCHES > 0,
          "the fused top-k kernel and the flash kernel launched on the "
          "live-index search")
    gone = set(removed)
    live_ids = set(engine.chunk_ids) - gone
    check(all(len(h) == 50 for h in hits)
          and all(x.chunk_id in live_ids for h in hits for x in h)
          and sum(x.chunk_id.startswith("a") for h in hits for x in h) > 0,
          "50 hits per query, every hit a live chunk (no removed one), "
          "added chunks among them")

    # the dense leg against a plain exact top-200 over the same live set:
    # main rows scored in bf16 as the index holds them, delta rows in f32
    q_emb = encoder.encode_device(queries)
    dense_lists, _ = engine._leg_lists(
        engine._dispatch_legs(queries, 50, None, False))
    ns = min(512, LIVE_QUERIES)
    qs = q_emb[:ns]
    corpus = engine.index._corpus
    delta = torch.from_numpy(engine._delta._host[:LIVE_ADDS]).cuda()
    S = torch.cat([qs.to(corpus.dtype).float() @ corpus.float().T,
                   qs.float() @ delta.T], dim=1)
    S[:, torch.from_numpy(dead_rows).cuda()] = -float("inf")
    rv, ri = torch.sort(S, dim=1, descending=True, stable=True)
    ev = torch.tensor([[v for v, _ in lst] for lst in dense_lists[:ns]])
    ei = torch.tensor([[r for _, r in lst] for lst in dense_lists[:ns]])
    err, bad, tied = topk_agree(ev, ei, rv[:, :201], ri[:, :201], tol=1e-5)
    check(ev.shape == (ns, 200) and err <= 1e-5 and bad == 0,
          f"dense leg over the live index (main + delta - tombstones) == "
          f"plain exact top-200 on {ns} queries: max abs err {err:.2e}, "
          f"{tied} positions inside near-ties (1e-5)")

    # tune_fusion over the queries at candidates=200, synthetic
    # labels: each query's top hybrid hit and one more of its hits
    picks = rng.integers(1, 50, size=len(hits))
    relevant = [[h[0].chunk_id, h[j].chunk_id] for h, j in zip(hits, picks)]
    zero_counts()
    t0 = time.perf_counter()
    best, best_map, table = engine.tune_fusion(queries, relevant,
                                               candidates=200)
    log(f"  tune_fusion: alpha {best}, MAP {best_map:.4f} (alpha 0.5: "
        f"{table[0.5]:.4f}) in {time.perf_counter() - t0:.1f} s (host "
        f"clock), {topk.TOPK_FUSED_LAUNCHES} fused launches")
    check(topk.TOPK_FUSED_LAUNCHES > 0 and len(table) == 21
          and best_map == max(table.values()) and 0 < best_map <= 1,
          "tune_fusion ran through the fused kernel over 21 alphas")
    with open(os.path.join(live_dir, FUSION_FILE), "w") as f:
        json.dump({"fusion_alpha": best}, f)
    check(HybridQueryEngine.load(live_dir, encoder).cfg.fusion_alpha == best,
          f"load applies the persisted fusion.json (alpha {best})")
    engine.cfg = dataclasses.replace(engine.cfg, fusion_alpha=best)

    # the live set as the engine holds it, for a fresh build after compact
    live_rows = np.setdiff1d(np.arange(n_all), dead_rows)
    main_rows = live_rows[live_rows < n_main]
    emb = np.concatenate([
        np.load(os.path.join(live_dir, EMB_FILE))[main_rows].astype(np.float32),
        engine._delta._host[live_rows[live_rows >= n_main] - n_main]])
    meta = list(read_tsv(os.path.join(live_dir, IDS_FILE)))
    fresh_rows = [{"chunk_id": engine.chunk_ids[r],
                   "query_id": meta[r]["query_id"] if r < n_main else "",
                   "document_id": meta[r]["document_id"] if r < n_main
                   else "", "chunk_text": engine.texts[r]} for r in live_rows]

    t0 = time.perf_counter()
    engine.compact()
    log(f"  compact: {time.perf_counter() - t0:.1f} s (host clock), "
        f"{engine.index.size} rows")
    check(engine.index.size == n_all - LIVE_REMOVES and engine._delta is None,
          "compact folded the delta and dropped the tombstones")

    def key(h):
        return [[(x.chunk_id, x.score, x.dense_rank, x.lexical_rank)
                 for x in q] for q in h]

    compacted = key(engine.search(queries, k=50))
    reloaded = HybridQueryEngine.load(live_dir, encoder)
    check(key(reloaded.search(queries, k=50)) == compacted,
          f"reloaded from disk, the compacted index answers the "
          f"{LIVE_QUERIES} queries unchanged")
    tsv = os.path.join(ctx["tmp"], "live_chunks.tsv")
    write_tsv(tsv, fresh_rows,
              ["chunk_id", "query_id", "document_id", "chunk_text"])
    fresh = HybridQueryEngine.build(tsv, _RowEncoder(encoder, emb),
                                    os.path.join(ctx["tmp"], "fresh"),
                                    rank_cfg=engine.cfg)
    check(key(fresh.search(queries, k=50)) == compacted,
          "a fresh build over the same live chunks and embeddings answers "
          f"the {LIVE_QUERIES} queries exactly as the compacted index")


# phase 6: documents of the chunking run, the longest one's sentences (the
# reference corpus's maximum), and the grouping subset
CHUNK_DOCS, LONG_DOC_SENTENCES = 600, 3939
GROUP_DOCS, GROUP_MAX_SENTENCES, GROUP_LONG_SENTENCES = 100, 256, 640
LOCAL_RANK_DOCS = 40  # chunked again on the per-document route
# the two shapes the similarity kernel is timed at: the long document in its
# 4096 bucket, and a sub-batch of short documents
SIM_SHAPES = ((1, 4096, 384), (256, 64, 384))


def _topic_document(rng, n_sents, topic_len, words):
    """n_sents sentences of five random words, each led by its topic's own
    word; the topic shifts every topic_len sentences."""
    return " ".join(
        f"Topic{i // topic_len} " + " ".join(rng.choice(words, size=5)) + "."
        for i in range(n_sents))


def _chunk_rows(rng, counts, topic_lens):
    words = [f"w{i}" for i in range(50)]
    return [{"query_id": f"q{i // 10}", "query_text": f"query {i // 10}",
             "document_id": f"doc{i}",
             "document": _topic_document(rng, int(n), int(t), words),
             "label": str(i % 2)}
            for i, (n, t) in enumerate(zip(counts, topic_lens))]


def _predicted_sim_launches(counts, batch_size, budget=1 << 26):
    """Kernel launches the pipeline's bucket ladder needs: per row batch,
    one per (power-of-two bucket >= 8, sub-batch of budget // bucket^2)."""
    total = 0
    for s in range(0, len(counts), batch_size):
        buckets = {}
        for n in counts[s: s + batch_size]:
            if n > 1:
                b = 1 << max(3, (int(n) - 1).bit_length())
                buckets[b] = buckets.get(b, 0) + 1
        total += sum(-(-k // max(1, budget // (b * b)))
                     for b, k in buckets.items())
    return total


def _coverage(map_tsv):
    """{document_id: sorted sentence indices} and the chunk ids, from a
    chunk map."""
    from semanticsearch_tpu_torch.data.tsv import read_tsv

    covered, ids = {}, []
    for row in read_tsv(map_tsv):
        covered.setdefault(row["document_id"], []).extend(
            int(x) for x in row["sent_indices"].split(","))
        ids.append(row["chunk_id"])
    return {doc: sorted(v) for doc, v in covered.items()}, ids


def _boundaries(map_tsv):
    from semanticsearch_tpu_torch.data.tsv import read_tsv

    out = {}
    for row in read_tsv(map_tsv):
        out.setdefault(row["document_id"], []).append(row["sent_indices"])
    return out


def time_similarity(report):
    """The similarity kernel at SIM_SHAPES beside its plain version, the f32
    ``torch.matmul`` and two bounds on the same bytes: the schedule's (the
    upper triangle's products on the tensor cores: three TF32 products a
    term for f32 input, one bf16 product for bf16 input) and the f32 FMA
    bound of the same products outside the tensor cores."""
    import torch

    from semanticsearch_tpu_torch.ops import similarity as sim

    entry = report["similarity"]
    gen = torch.Generator(device="cuda").manual_seed(23)
    for which, (b, n, d) in zip(("", "batched_"), SIM_SHAPES):
        E = sim.l2_normalize(torch.randn((b, n, d), generator=gen,
                                         device="cuda"))
        if b == 1:
            E[:, LONG_DOC_SENTENCES:] = 0.0  # the bucket's zero rows

        def kernel():
            sim.similarity_matrix(E)

        def plain():
            sim.similarity_matrix_plain(E)

        def library():  # f32: main() turns TF32 off
            torch.matmul(E, E.transpose(1, 2))

        turns = [time_ms(f, reps=20, warmup=3)
                 for f in (plain, kernel, kernel, plain)]
        ms, plain_ms = (turns[1] + turns[2]) / 2, (turns[0] + turns[3]) / 2
        lib_ms = time_ms(library, reps=20, warmup=3)
        # S == S^T: n(n+1)/2 dot products of width d are what the function
        # needs; the kernel runs three TF32 products of each
        nbytes = 4.0 * b * (n * d + n * n)
        bnd, by = bound_ms(3.0 * b * n * (n + 1) * d, nbytes, PEAK_TF32_FLOPS)
        fma, _ = bound_ms(1.0 * b * n * (n + 1) * d, nbytes, PEAK_F32_FLOPS)
        entry.update({which + "ms": ms, which + "plain_ms": plain_ms,
                      which + "library_ms": lib_ms, which + "bound_ms": bnd,
                      which + "bound_by": by, which + "fma_bound_ms": fma})
        log(f"  similarity B={b} n={n} d={d}: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, f32 torch.matmul {lib_ms:.4f} ms, bound "
            f"{bnd:.4f} ms ({by}; 3xTF32 on the upper triangle), f32 FMA "
            f"bound {fma:.4f} ms (turns "
            f"{', '.join(f'{t:.4f}' for t in turns)})")
    entry["shape_note"] = (
        "ms, plain_ms, bound_ms, library_ms at B=1, n=4096 (3,939 real "
        "rows), d=384; batched_* at B=256, n=64, d=384; library = f32 "
        "torch.matmul with TF32 off")
    entry["bound_note"] = (
        "bound_ms: 3*B*n*(n+1)*d operations (three TF32 products of the "
        "upper triangle's terms) at 495 TFLOP/s; fma_bound_ms: B*n*(n+1)*d "
        "at the f32 FMA peak, 67 TFLOP/s; both against 4*B*(n*d + n^2) "
        "bytes")

    # bf16 input at the same shapes; no path passes bf16, so its launches
    # are those of one direct call of the entry point
    bf = report["similarity_bf16"]
    for which, (b, n, d) in zip(("", "batched_"), SIM_SHAPES):
        E = sim.l2_normalize(torch.randn((b, n, d), generator=gen,
                                         device="cuda")).bfloat16()
        if which == "":
            zero_counts()
            sim.similarity_matrix(E)
            torch.cuda.synchronize()
            bf["launches"] = sim.SIM_BF16_LAUNCHES
        bf[which + "ms"] = time_ms(lambda: sim.similarity_matrix(E), reps=20,
                                   warmup=3)
        bf[which + "plain_ms"] = time_ms(
            lambda: sim.similarity_matrix_plain(E), reps=20, warmup=3)
        bf[which + "library_ms"] = time_ms(
            lambda: torch.matmul(E.float(), E.float().transpose(1, 2)),
            reps=20, warmup=3)
        nbytes = 2.0 * b * n * d + 4.0 * b * n * n
        bf[which + "bound_ms"], bf[which + "bound_by"] = bound_ms(
            1.0 * b * n * (n + 1) * d, nbytes, PEAK_BF16_FLOPS)
        bf[which + "fma_bound_ms"], _ = bound_ms(
            1.0 * b * n * (n + 1) * d, nbytes, PEAK_F32_FLOPS)
        log(f"  similarity on bf16 input B={b} n={n} d={d}: kernel "
            f"{bf[which + 'ms']:.4f} ms, plain {bf[which + 'plain_ms']:.4f} "
            f"ms, f32 torch.matmul of the widened input "
            f"{bf[which + 'library_ms']:.4f} ms, bound "
            f"{bf[which + 'bound_ms']:.4f} ms ({bf[which + 'bound_by']}; bf16 "
            f"wgmma on the upper triangle), f32 FMA bound "
            f"{bf[which + 'fma_bound_ms']:.4f} ms")
    bf["shape_note"] = (
        "bf16 input (unit rows) at the f32 entry's shapes; library = f32 "
        "torch.matmul of the input widened to f32 (the widening included); "
        "launches = one direct call at (1, 4096, 384): no path passes bf16")
    bf["bound_note"] = (
        "bound_ms: B*n*(n+1)*d operations (one bf16 product of the upper "
        "triangle's terms) at 989 TFLOP/s; fma_bound_ms: the same at 67 "
        "TFLOP/s; both against 2*B*n*d + 4*B*n^2 bytes")


def phase_chunk(report, ctx):
    import torch

    from semanticsearch_tpu_torch import native
    from semanticsearch_tpu_torch.chunking import grouping, splitter
    from semanticsearch_tpu_torch.chunking import pipeline as chunk_pipeline
    from semanticsearch_tpu_torch.chunking.cleaning import (
        clean_with_guardrail, preclean_text)
    from semanticsearch_tpu_torch.chunking.segmenter import extract_sentences
    from semanticsearch_tpu_torch.core.config import get_named_config
    from semanticsearch_tpu_torch.data.tsv import write_tsv
    from semanticsearch_tpu_torch.models.encoder import SentenceEncoder
    from semanticsearch_tpu_torch.ops import flash_attention as fa
    from semanticsearch_tpu_torch.ops import similarity as sim

    log("== phase 6: semantic chunking through ChunkPipeline (main path)")
    rng = np.random.default_rng(29)
    encoder, tmp = ctx["encoder"], ctx["tmp"]
    columns = ["query_id", "query_text", "document_id", "document", "label"]

    # sentence counts with a long tail: most 5-200, a few 500-1,500, one of
    # 3,939; topic shifts every 8-40 sentences (every 400 in the longest)
    counts = np.clip(rng.lognormal(3.7, 0.8, size=CHUNK_DOCS), 5, 200)
    counts = counts.astype(int)
    few = rng.choice(CHUNK_DOCS, size=8, replace=False)
    counts[few[1:]] = rng.integers(500, 1501, size=7)
    counts[few[0]] = LONG_DOC_SENTENCES
    topic_lens = rng.integers(8, 41, size=CHUNK_DOCS)
    topic_lens[few[0]] = 400
    rows = _chunk_rows(rng, counts, topic_lens)
    long_id = rows[few[0]]["document_id"]
    seen = [len(extract_sentences(preclean_text(clean_with_guardrail(
        r["document"])))) for r in rows]
    check(seen == counts.tolist() and max(seen) == LONG_DOC_SENTENCES,
          f"{CHUNK_DOCS} documents, {sum(seen)} sentences after cleaning and "
          f"segmentation (median {int(np.median(seen))}, "
          f"{sum(n >= 500 for n in seen)} of 500 or more, the longest "
          f"{max(seen)})")
    tsv = os.path.join(tmp, "chunk_corpus.tsv")
    write_tsv(tsv, rows, columns)
    want_launches = _predicted_sim_launches(seen, chunk_pipeline.BATCH_SIZE)

    cfg = get_named_config("semantic_splitter").override(
        chunking={"collect_metadata": True})

    timers = {"encode": 0.0, "signals": 0.0}

    def timed(fn, key):
        """fn with its host-clock seconds, device work included, added to
        timers[key]."""
        def wrapper(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            timers[key] += time.perf_counter() - t0
            return out
        return wrapper

    def run(out, split_times=False):
        pipe = chunk_pipeline.ChunkPipeline(cfg, encoder=encoder)
        if split_times:
            pipe._precompute_signals = timed(pipe._precompute_signals,
                                             "signals")
        return pipe.run(tsv, os.path.join(tmp, out), write_chunk_map=True)

    encoder.encode_device = timed(encoder.encode_device, "encode")
    tokenizer = encoder.tokenizer
    encode_batch = tokenizer.encode_batch

    def timed_tokenize(*args, **kwargs):  # host only: no synchronize
        t0 = time.perf_counter()
        out = encode_batch(*args, **kwargs)
        timers["tokenize"] = (timers.get("tokenize", 0.0)
                              + time.perf_counter() - t0)
        return out

    tokenizer.encode_batch = timed_tokenize
    zero_counts()
    try:
        first = run("chunk_a", split_times=True)
    finally:
        del encoder.encode_device  # back to the class's method
        del tokenizer.encode_batch
    torch.cuda.synchronize()
    report["similarity"]["launches"] = sim.SIM_LAUNCHES
    host = first["elapsed_s"] - timers["encode"] - timers["signals"]
    log(f"  semantic_splitter over {first['docs_chunked']} documents: "
        f"{first['chunks_out']} chunks in {first['elapsed_s']:.2f} s (host "
        f"clock) = {first['chunks_per_sec']} chunks/s; encode "
        f"{timers['encode']:.2f} s (its tokenization "
        f"{timers.get('tokenize', 0.0):.3f} s, "
        f"{native.HASH_TOKENIZE_CALLS} native calls), signals "
        f"{timers['signals']:.2f} s, host logic and I/O {host:.2f} s; "
        f"launches: similarity {sim.SIM_LAUNCHES}, flash "
        f"{fa.FLASH_LAUNCHES}")
    report["host_split"]["chunk"] = {
        "tokenize": timers.get("tokenize", 0.0),
        "encode_rest": timers["encode"] - timers.get("tokenize", 0.0),
        "signals": timers["signals"], "rest": host,
        "total": first["elapsed_s"]}
    check(native.HASH_TOKENIZE_CALLS > 0,
          "the chunking run tokenized its sentences natively")
    check(sim.SIM_LAUNCHES == want_launches and fa.FLASH_LAUNCHES > 0,
          f"the similarity kernel launched once per (bucket, sub-batch): "
          f"{sim.SIM_LAUNCHES} == {want_launches} predicted by the bucket "
          "ladder; the flash kernel launched")
    map_a = os.path.join(tmp, "chunk_a", f"{cfg.name}_chunk_map.tsv")
    covered, ids = _coverage(map_a)
    check(first["docs_chunked"] == CHUNK_DOCS and first["fallbacks"] == 0
          and not any(i.endswith("_fallback") for i in ids)
          and all(covered.get(r["document_id"]) == list(range(n))
                  for r, n in zip(rows, seen)),
          f"every sentence of every document in exactly one chunk (the "
          f"{LONG_DOC_SENTENCES}-sentence document in "
          f"{sum(i.startswith(long_id + '_') for i in ids)} chunks, not "
          "truncated); no fallback chunk")
    second = run("chunk_b")
    with open(first["output_path"], "rb") as fa_, \
            open(second["output_path"], "rb") as fb_:
        same = fa_.read() == fb_.read()
    check(same, "a second run writes a byte-identical chunks TSV")

    # the embeddings themselves: a full encoder batch of 2,048 sentences and
    # a partial one, through the flash kernel and through the stock attention
    # of an encoder with the same weights
    stock = SentenceEncoder(dataclasses.replace(encoder.cfg,
                                                attention="stock"),
                            device=encoder.device, seed=0)
    sample = [s for r in rows[:150] for s in extract_sentences(preclean_text(
        clean_with_guardrail(r["document"])))][:2048 + 813]
    before = fa.FLASH_LAUNCHES
    e_flash = encoder.encode_device(sample, batch_size=2048)
    e_stock = stock.encode_device(sample, batch_size=2048)
    cos = float((e_flash * e_stock).sum(dim=1).min())
    check(len(sample) == 2048 + 813 and fa.FLASH_LAUNCHES > before
          and bool(torch.isfinite(e_flash).all()) and cos > 0.99,
          f"flash vs stock encoder on {len(sample)} of the run's sentences in "
          f"batches of 2,048 and {len(sample) - 2048}, bf16: least cosine "
          f"{cos:.5f} > 0.99 (max abs difference "
          f"{float((e_flash - e_stock).abs().max()):.3e})")
    del stock

    # the longest document's S: kernel against plain, alone and in its bucket
    sents = extract_sentences(preclean_text(clean_with_guardrail(
        rows[few[0]]["document"])))
    E = encoder.encode_device(sents, batch_size=2048)
    S = sim.similarity_matrix(E)
    ctx["long_sents"] = sents  # phase 12's ring runs on this document
    err = float((S - sim.similarity_matrix_plain(E)).abs().max())
    padded = torch.nn.functional.pad(E, (0, 0, 0, 4096 - E.shape[0]))[None]
    in_bucket = sim.similarity_matrix(padded)[0, :E.shape[0], :E.shape[0]]
    check(err <= 1e-5 and torch.equal(S, S.T) and torch.equal(S, in_bucket),
          f"the {LONG_DOC_SENTENCES}-sentence document's S: kernel vs plain "
          f"max abs err {err:.3e} <= 1e-5; S == S^T; alone == inside its "
          "4096 bucket, bit for bit")
    report["similarity"]["max_abs_err"] = max(
        report["similarity"]["max_abs_err"], err)

    # the same run on the plain S: rank flips between near-tied
    # similarities may move a boundary; counted, not a failure
    kernel_fn = splitter.similarity_matrix
    splitter.similarity_matrix = sim.similarity_matrix_plain
    try:
        run("chunk_plain")
    finally:
        splitter.similarity_matrix = kernel_fn
    b_kernel = _boundaries(map_a)
    b_plain = _boundaries(os.path.join(tmp, "chunk_plain",
                                       f"{cfg.name}_chunk_map.tsv"))
    differ = sum(b_kernel[d] != b_plain.get(d) for d in b_kernel)
    report["chunk_docs_differing_from_plain_s"] = differ
    log(f"  documents whose boundaries differ between the kernel's S and "
        f"the plain S: {differ} of {len(b_kernel)}")

    keep = [i for i, n in enumerate(seen) if n <= GROUP_MAX_SENTENCES]
    keep = keep[:GROUP_DOCS]

    # the per-document route (the local rank takes no batched signals): each
    # document launches the kernel itself, inside the pipeline's
    # per-document try
    l_rows = [rows[i] for i in keep[:LOCAL_RANK_DOCS]]
    l_tsv = os.path.join(tmp, "local_corpus.tsv")
    write_tsv(l_tsv, l_rows, columns)
    l_cfg = cfg.override(chunking={"c99_use_local_rank": True})
    zero_counts()
    loc = chunk_pipeline.ChunkPipeline(l_cfg, encoder=encoder).run(
        l_tsv, os.path.join(tmp, "local"), write_chunk_map=True)
    l_cov, l_ids = _coverage(os.path.join(tmp, "local",
                                          f"{l_cfg.name}_chunk_map.tsv"))
    check(sim.SIM_LAUNCHES == len(l_rows) and fa.FLASH_LAUNCHES > 0
          and loc["docs_chunked"] == len(l_rows) and loc["fallbacks"] == 0
          and not any(i.endswith("_fallback") for i in l_ids)
          and all(l_cov.get(rows[i]["document_id"]) == list(range(seen[i]))
                  for i in keep[:LOCAL_RANK_DOCS]),
          f"c99_use_local_rank over {len(l_rows)} documents: "
          f"{sim.SIM_LAUNCHES} similarity launches, one per document; every "
          "sentence in exactly one chunk; no fallback chunk")

    # semantic_grouping over a subset: short documents plus one long enough
    # for the device eigendecomposition
    g_rows = [rows[i] for i in keep] + _chunk_rows(
        rng, [GROUP_LONG_SENTENCES], [80])
    g_rows[-1]["document_id"] = "doc_group_long"
    g_seen = [seen[i] for i in keep] + [GROUP_LONG_SENTENCES]
    g_tsv = os.path.join(tmp, "group_corpus.tsv")
    write_tsv(g_tsv, g_rows, columns)
    g_cfg = get_named_config("semantic_grouping").override(
        chunking={"collect_metadata": True})
    large_eigh = []
    eigh = grouping._eigh

    def counting_eigh(S_sym, device="cuda"):
        if S_sym.shape[0] >= grouping._EIGH_DEVICE_MIN_N:
            large_eigh.append((S_sym.shape[0], str(torch.device(device))))
        return eigh(S_sym, device)

    grouping._eigh = counting_eigh
    zero_counts()
    try:
        g = chunk_pipeline.ChunkPipeline(g_cfg, encoder=encoder).run(
            g_tsv, os.path.join(tmp, "group"), write_chunk_map=True)
    finally:
        grouping._eigh = eigh
    g_launches = _predicted_sim_launches(g_seen, chunk_pipeline.BATCH_SIZE)
    log(f"  semantic_grouping over {g['docs_chunked']} documents: "
        f"{g['chunks_out']} chunks in {g['elapsed_s']:.2f} s (host clock); "
        f"launches: similarity {sim.SIM_LAUNCHES}, flash "
        f"{fa.FLASH_LAUNCHES}; eigendecompositions on the device: "
        f"{large_eigh}")
    g_cov, g_ids = _coverage(os.path.join(tmp, "group",
                                          f"{g_cfg.name}_chunk_map.tsv"))
    ctx["group"] = (g_tsv, g_cfg, os.path.join(
        tmp, "group", f"{g_cfg.name}_chunk_map.tsv"))  # phase 12 reruns it
    check(sim.SIM_LAUNCHES == g_launches and fa.FLASH_LAUNCHES > 0
          and g["docs_chunked"] == len(g_rows) and g["fallbacks"] == 0
          and not any(i.endswith("_fallback") for i in g_ids)
          and all(g_cov.get(r["document_id"]) == list(range(n))
                  for r, n in zip(g_rows, g_seen))
          and any(dev.startswith("cuda") for _, dev in large_eigh),
          f"grouping: {sim.SIM_LAUNCHES} similarity launches == "
          f"{g_launches} predicted; every sentence in exactly one chunk; no "
          f"fallback chunk; the {GROUP_LONG_SENTENCES}-sentence document's "
          "Laplacian decomposed on the card")

    time_similarity(report)


# phase 7: the f32 configuration's live round, and the CPU comparison's batch
F32_LIVE_ADDS, F32_LIVE_REMOVES, F32_LIVE_QUERIES = 2000, 500, 10000


def phase_f32(report, ctx):
    import torch

    from semanticsearch_tpu_torch.core.config import EncoderConfig, IndexConfig
    from semanticsearch_tpu_torch.index.query_engine import HybridQueryEngine
    from semanticsearch_tpu_torch.models.encoder import SentenceEncoder
    from semanticsearch_tpu_torch.ops import flash_attention as fa
    from semanticsearch_tpu_torch.ops import topk

    log("== phase 7: the f32 configuration end to end (f32 encoder under "
        "flash attention, f32 index; main path)")
    rng = np.random.default_rng(31)
    words, tmp = ctx["words"], ctx["tmp"]
    enc_cfg = EncoderConfig(dtype="float32", attention="flash")
    idx_cfg = IndexConfig(dtype="float32")
    idx_dir = os.path.join(tmp, "idx_f32")
    log(f"  encoder: {dataclasses.asdict(enc_cfg)}; index: "
        f"{dataclasses.asdict(idx_cfg)}")
    encoder = SentenceEncoder(enc_cfg, device="cuda", seed=0)

    zero_counts()
    t0 = time.perf_counter()
    engine = HybridQueryEngine.build(ctx["tsv"], encoder, idx_dir,
                                     index_cfg=idx_cfg)
    torch.cuda.synchronize()
    log(f"  build over the phase-3 corpus (20,000 chunks): "
        f"{time.perf_counter() - t0:.1f} s (host clock)")
    t0 = time.perf_counter()
    hybrid = [engine.search(b, k=10) for b in ctx["batches"]]
    torch.cuda.synchronize()
    log(f"  {sum(map(len, ctx['batches']))} hybrid queries in batches of 64: "
        f"{time.perf_counter() - t0:.2f} s (host clock); launches: segtopk "
        f"f32 {topk.SEGTOPK_F32_LAUNCHES}, pass B {topk.PASS_B_LAUNCHES}, "
        f"flash f32 {fa.FLASH_F32_LAUNCHES}")
    report["segtopk_f32"]["launches"] = topk.SEGTOPK_F32_LAUNCHES
    report["pass_b"]["f32_launches"] = topk.PASS_B_LAUNCHES
    report["flash_f32"]["launches"] = fa.FLASH_F32_LAUNCHES
    report["flash_wide"]["launches"] += fa.FLASH_WIDE_LAUNCHES
    check(engine.index._corpus.dtype == torch.float32
          and topk.SEGTOPK_F32_LAUNCHES > 0 and fa.FLASH_F32_LAUNCHES > 0
          and topk.PASS_B_LAUNCHES == topk.SEGTOPK_F32_LAUNCHES
          and topk.SEGTOPK_LAUNCHES == 0 and fa.FLASH_LAUNCHES == 0,
          "an f32 index and an f32 encoder: the f32 pass-A and f32 flash "
          "schedules and pass B (on f32 rows, one a pass A) launched on the "
          "serve path, and no bf16 one")
    check(all(len(q) == 10 for b in hybrid for q in b),
          "10 hits per query")

    # the same engine on the CPU (the index files, the encoder's seeded
    # weights) on one batch: the dense leg within the f32 bound plus what
    # the two encoders' query embeddings differ by, ids equal outside
    # near-ties; the fused hybrid lists equal wherever the dense legs are
    # equal in ids, which every query without a near-tie is
    sample = ctx["batches"][0]
    cpu_encoder = SentenceEncoder(enc_cfg, device="cpu", seed=0)
    cpu_engine = HybridQueryEngine.load(idx_dir, cpu_encoder,
                                        index_cfg=idx_cfg, device="cpu")
    dq = float((encoder.encode_device(sample).cpu()
                - cpu_encoder.encode_device(sample)).norm(dim=1).max())
    tol = 384 * 2.0 ** -24 + dq

    def dense(eng):
        lists, _ = eng._leg_lists(eng._dispatch_legs(sample, 10, 41, True))
        return (torch.tensor([[v for v, _ in lst] for lst in lists]),
                torch.tensor([[r for _, r in lst] for lst in lists]))

    cv, ci = dense(engine)
    pv, pi = dense(cpu_engine)
    err, bad, near = topk_agree(cv[:, :40], ci[:, :40], pv, pi, tol,
                                gap=2 * tol)
    check(err <= tol and bad == 0,
          f"dense leg on the card == the CPU engine's on {len(sample)} "
          f"queries (top-40): max abs err {err:.2e} <= 384 * 2^-24 + "
          f"{dq:.2e} (the query embeddings' largest difference); ids equal "
          f"outside near-ties ({near} differ inside them)")

    def key(hits):
        return [(h.chunk_id, h.score, h.dense_rank, h.lexical_rank)
                for h in hits]

    no_tie = [qi for qi in range(len(sample))
              if bool(((pv[qi, 1:] - pv[qi, :-1]).abs() > 2 * tol).all())]
    same = [qi for qi in range(len(sample)) if torch.equal(ci[qi], pi[qi])]
    card_hits = engine.search(sample, k=10, candidates=40)
    cpu_hits = cpu_engine.search(sample, k=10, candidates=40)
    check(set(no_tie) <= set(same) and len(same) > len(sample) // 2
          and all(key(card_hits[qi]) == key(cpu_hits[qi]) for qi in same),
          f"fused hybrid top-10 on the card == the CPU engine's for all "
          f"{len(same)} of {len(sample)} queries whose dense legs (top-41) "
          f"are equal in ids, among them the {len(no_tie)} without a "
          f"near-tie (gap <= {2 * tol:.2e})")
    del cpu_engine, cpu_encoder

    # one live round: adds, removals, a 10,000-query search at k = 50 (a
    # dense fetch of 200 plus the tombstones') through the f32 fused top-k
    n_main = engine.index.size
    n_all = n_main + F32_LIVE_ADDS
    engine.add_documents([f"f{i}" for i in range(F32_LIVE_ADDS)],
                         [_zipf_text(rng, words, int(n)) for n in
                          rng.integers(40, 241, size=F32_LIVE_ADDS)])
    dead_rows = np.sort(rng.choice(n_all, size=F32_LIVE_REMOVES,
                                   replace=False))
    check(engine.remove_documents([engine.chunk_ids[r] for r in dead_rows])
          == F32_LIVE_REMOVES,
          f"added {F32_LIVE_ADDS} chunks to the f32 index and removed "
          f"{F32_LIVE_REMOVES}")
    queries = [_zipf_text(rng, words, int(rng.integers(3, 9)))
               for _ in range(F32_LIVE_QUERIES)]
    # the fused launch of this search: every query over the main index, k =
    # the dense depth (4 * 50) plus the tombstones' over-fetch in 64s
    live_k = 200 + -(-F32_LIVE_REMOVES // 64) * 64
    zero_counts()
    t0 = time.perf_counter()
    hits = engine.search(queries, k=50, hybrid=False)
    torch.cuda.synchronize()
    report["topk_fused_f32"]["launches"] = topk.TOPK_FUSED_F32_LAUNCHES
    log(f"  {F32_LIVE_QUERIES} dense queries at k=50 over the live f32 index "
        f"in {time.perf_counter() - t0:.2f} s (host clock); launches: "
        f"topk_fused f32 {topk.TOPK_FUSED_F32_LAUNCHES}, flash f32 "
        f"{fa.FLASH_F32_LAUNCHES}")
    live_ids = set(engine.chunk_ids) - {engine.chunk_ids[r] for r in dead_rows}
    check(topk.TOPK_FUSED_F32_LAUNCHES > 0 and topk.TOPK_FUSED_LAUNCHES == 0
          and all(len(h) == 50 for h in hits)
          and all(x.chunk_id in live_ids for h in hits for x in h),
          "the f32 fused top-k launched on the live search (and no bf16 "
          "one); 50 live hits per query")
    ns = min(512, F32_LIVE_QUERIES)
    q_emb = encoder.encode_device(queries[:ns])
    dense_lists, _ = engine._leg_lists(
        engine._dispatch_legs(queries, 50, None, False))
    corpus = engine.index._corpus
    delta = torch.from_numpy(engine._delta._host[:F32_LIVE_ADDS]).cuda()
    S = torch.cat([q_emb @ corpus.T, q_emb @ delta.T], dim=1)
    S[:, torch.from_numpy(dead_rows).cuda()] = -float("inf")
    rv, ri = torch.sort(S, dim=1, descending=True, stable=True)
    ev = torch.tensor([[v for v, _ in lst] for lst in dense_lists[:ns]])
    ei = torch.tensor([[r for _, r in lst] for lst in dense_lists[:ns]])
    ftol = 384 * 2.0 ** -24
    err, bad, near = topk_agree(ev, ei, rv[:, :201], ri[:, :201], ftol,
                                gap=2 * ftol)
    check(ev.shape == (ns, 200) and err <= ftol and bad == 0,
          f"dense leg over the live f32 index (main + delta - tombstones) == "
          f"plain exact f32 top-200 on {ns} queries: max abs err {err:.2e} <= "
          f"384 * 2^-24; ids equal outside near-ties ({near} differ inside)")
    del engine, corpus, delta, S
    time_f32_topk(report, n_main, live_k)
    time_f32_flash(report)


# the f32 shard: 1,250,000 x 384 f32 (1.92 GB), 32,768 queries (16,384 for
# the fused top-k)
F32_SHARD = (1_250_000, 384, 32768, 16384)


def time_f32_topk(report, n_main, live_k):
    """The f32 schedules of pass A and the fused top-k at the shard shape,
    pass A at the serve shape and the fused top-k at the shape of the live
    round's launch (F32_LIVE_QUERIES over the n_main-row main index at
    live_k), each beside its plain version (at the shard), f32
    torch.matmul and two bounds; and f32 recall@10 at the shard."""
    import torch

    from semanticsearch_tpu_torch.data import synth
    from semanticsearch_tpu_torch.ops import topk

    n, d, q, qf_n = F32_SHARD
    k = 10
    ftol = d * 2.0 ** -24
    corpus = synth.corpus(n, d, torch.float32, "cuda")
    queries = synth.corpus(q, d, torch.float32, "cuda", start=20_000_000)
    L2, k_sel = 32768 // 128 // 8, k + 1
    pa, po = report["segtopk_f32"], report["segtopk_overlap_f32"]
    zero_counts()
    ov_v, ov_i = topk.topk_scores_twopass(queries, corpus, k=k,
                                          block_n=32768, seg_split=8,
                                          mxu_overlap=True)
    torch.cuda.synchronize()
    po["launches"] = topk.SEGTOPK_OVERLAP_F32_LAUNCHES
    dv, di = topk.topk_scores_twopass(queries, corpus, k=k, block_n=32768,
                                      seg_split=8)
    check(po["launches"] > 0 and torch.equal(ov_i, di)
          and torch.equal(ov_v, dv),
          f"topk_scores_twopass(mxu_overlap=True) over the f32 shard "
          f"launched the f32 schedule ({po['launches']}x) and equals the "
          "default search bit for bit")
    sample_q = torch.arange(0, q, q // 128, device="cuda")[:128]
    rv, ri = topk.topk_scores_ref(queries[sample_q], corpus, k=k,
                                  block_n=65536)
    hits = sum(len(set(a) & set(b)) for a, b in
               zip(di[sample_q].tolist(), ri.tolist()))
    report["recall_at_10_f32"] = hits / (128 * k)
    check(report["recall_at_10_f32"] == 1.0,
          f"f32 two-pass recall@10 = {report['recall_at_10_f32']} on 128 "
          "sampled queries against the plain exact top-k")
    turns = [time_ms(f, reps=2) for f in (
        lambda: topk.segtopk_pass_a(queries, corpus, n, L2, k_sel),
        lambda: topk.segtopk_pass_a_overlap(queries, corpus, n, L2, k_sel))]
    pa["ms"], po["ms"] = turns
    pa["plain_ms"] = po["plain_ms"] = time_ms(
        lambda: topk.segtopk_pass_a_plain(queries, corpus, n, L2, k_sel),
        reps=1, warmup=0)

    def f32_gemm_floor(qs):  # TF32 is off (main)
        for s in range(0, n, 16384):
            torch.matmul(qs, corpus[s: s + 16384].T)

    pa["library_ms"] = po["library_ms"] = time_ms(
        lambda: f32_gemm_floor(queries), reps=2)

    def f32_bounds(entry, prefix, q_rows, n_rows, out_bytes):
        """Two bounds on the same bytes: the schedule's three TF32 products
        a score at 495 TFLOP/s (bound_ms, the least time), and one f32 FMA
        a score at 67 TFLOP/s (fma_bound_ms)."""
        nbytes = 4.0 * (q_rows + n_rows) * d + out_bytes
        entry[prefix + "bound_ms"], entry[prefix + "bound_by"] = bound_ms(
            3 * 2.0 * q_rows * n_rows * d, nbytes, PEAK_TF32_FLOPS)
        entry[prefix + "tf32x3_bound_ms"] = entry[prefix + "bound_ms"]
        entry[prefix + "fma_bound_ms"] = bound_ms(
            2.0 * q_rows * n_rows * d, nbytes, PEAK_F32_FLOPS)[0]

    for entry in (pa, po):
        f32_bounds(entry, "", q, n, 8.0 * q * k_sel)
    # pass B on f32 rows at the shard, on pass A's segments
    pb = report["pass_b"]
    _, seg_ids = topk.segtopk_pass_a(queries, corpus, n, L2, k_sel)
    pb["f32_max_abs_err"] = check_pass_b(
        queries, corpus, seg_ids, n, L2, k, f"on f32 rows at the shard "
        f"(Q={q}, k_sel {k_sel}, L2 {L2})")
    pb["f32_ms"] = time_ms(lambda: topk.pass_b_rescore(
        queries, corpus, seg_ids, n, L2, k), reps=5)
    pb["f32_plain_ms"] = time_ms(lambda: topk.pass_b_rescore_plain(
        queries, corpus, seg_ids, n, L2, k), reps=2)
    pb["f32_library_ms"] = None
    (pb["f32_bound_ms"], pb["f32_bound_by"],
     pb["f32_gathered_bound_ms"]) = pass_b_bound(seg_ids, n, L2, d, k, 4)
    log(f"  f32 pass B (Q={q}, k_sel {k_sel}, L2 {L2}): kernel "
        f"{pb['f32_ms']:.3f} ms, plain {pb['f32_plain_ms']:.2f} ms, bound "
        f"{pb['f32_bound_ms']:.3f} ms ({pb['f32_bound_by']}; a query's rows "
        f"once a query {pb['f32_gathered_bound_ms']:.3f} ms)")
    del seg_ids
    log(f"  f32 pass A (Q={q}, k_sel {k_sel}): kernel {pa['ms']:.2f} ms, "
        f"through the overlap wrapper {po['ms']:.2f} ms, plain "
        f"{pa['plain_ms']:.2f} ms, f32 GEMM floor {pa['library_ms']:.2f} ms, "
        f"bound {pa['bound_ms']:.2f} ms ({pa['bound_by']}, 3xTF32 at 495 "
        f"TFLOP/s; f32 FMAs {pa['fma_bound_ms']:.2f} ms)")
    # the serve shape: one 64-query batch over 20,000 rows, k_sel 41
    qs, cs = queries[:64], corpus[:20000].contiguous()
    pa["serve_ms"] = time_ms(
        lambda: topk.segtopk_pass_a(qs, cs, 20000, 32, 41), reps=50)
    pa["serve_library_ms"] = time_ms(lambda: torch.matmul(qs, cs.T), reps=50)
    f32_bounds(pa, "serve_", 64, 20000, 8.0 * 64 * 41)
    log(f"  f32 pass A at the serve shape (64 x 20,000, k_sel 41): kernel "
        f"{pa['serve_ms']:.4f} ms, f32 torch.matmul "
        f"{pa['serve_library_ms']:.4f} ms, bound {pa['serve_bound_ms']:.4f} "
        f"ms ({pa['serve_bound_by']}; f32 FMAs "
        f"{pa['serve_fma_bound_ms']:.4f} ms)")
    fu, qf, kf = report["topk_fused_f32"], queries[:qf_n], 200
    fu["ms"] = time_ms(lambda: topk.topk_scores_fused(qf, corpus, kf), reps=2)
    fv, fi = topk.topk_scores_fused(qf, corpus, kf)
    fs = torch.arange(0, qf_n, qf_n // 128, device="cuda")
    rv, ri = topk.topk_scores_ref(qf[fs], corpus, k=kf + 1, block_n=65536)
    err, bad, near = topk_agree(fv[fs], fi[fs], rv, ri, ftol, gap=2 * ftol)
    check(err <= ftol and bad == 0,
          f"f32 fused top-{kf} at the shard shape == plain exact top-{kf} on "
          f"128 sampled queries: max abs err {err:.2e}; ids equal outside "
          f"near-ties ({near} differ inside)")
    fu["plain_ms"] = 8 * time_ms(lambda: topk.topk_scores_fused_plain(
        qf[:qf_n // 8], corpus, kf), reps=1, warmup=0)
    fu["plain_note"] = "timed on 2,048 of the 16,384 queries, times 8"
    fu["library_ms"] = time_ms(lambda: f32_gemm_floor(qf), reps=2)
    f32_bounds(fu, "", qf_n, n, 8.0 * qf_n * kf)
    log(f"  f32 fused top-{kf}, {qf_n} queries: kernel {fu['ms']:.2f} ms, "
        f"plain {fu['plain_ms']:.2f} ms (2,048 queries x 8), f32 GEMM floor "
        f"{fu['library_ms']:.2f} ms, bound {fu['bound_ms']:.2f} ms "
        f"({fu['bound_by']}, 3xTF32; f32 FMAs {fu['fma_bound_ms']:.2f} ms)")
    # the live round's launch: 10,000 queries over the 20,000-row main
    # index at k = 712, on the shard's first rows
    ql, cl = queries[:F32_LIVE_QUERIES], corpus[:n_main].contiguous()
    fu["live_ms"] = time_ms(
        lambda: topk.topk_scores_fused(ql, cl, live_k), reps=5)
    fu["live_library_ms"] = time_ms(lambda: torch.matmul(ql, cl.T), reps=5)
    f32_bounds(fu, "live_", F32_LIVE_QUERIES, n_main,
               8.0 * F32_LIVE_QUERIES * live_k)
    log(f"  f32 fused top-{live_k} at the live round's shape "
        f"({F32_LIVE_QUERIES:,} x {n_main:,}): kernel {fu['live_ms']:.3f} ms, "
        f"f32 torch.matmul {fu['live_library_ms']:.3f} ms, bound "
        f"{fu['live_bound_ms']:.3f} ms ({fu['live_bound_by']}; f32 FMAs "
        f"{fu['live_fma_bound_ms']:.3f} ms)")
    for entry in (pa, po, fu):
        entry["shape_note"] = (
            "f32 shard 1,250,000 x 384; pass A at 32,768 queries, 32-row "
            "segments, k_sel 11 (serve_*: 64 x 20,000, k_sel 41); fused at "
            f"16,384 queries, k = 200 (live_*: {F32_LIVE_QUERIES:,} x "
            f"{n_main:,}, k = {live_k}); library = f32 torch.matmul (in "
            "16,384-row column chunks at the shard), TF32 off; bound_ms = "
            "tf32x3_bound_ms (three TF32 products a score), fma_bound_ms "
            "(one f32 FMA)")
    del corpus, queries, ov_v, ov_i, dv, di


def time_f32_flash(report):
    """f32 flash at phase 4's shapes, against SDPA in f32; and the bf16
    flash at a padded head width (Dh 48)."""
    import torch

    from semanticsearch_tpu_torch.ops import flash_attention as fa

    fl = report["flash_f32"]
    gen = torch.Generator().manual_seed(3)
    h, dh = 12, 32
    for which, b, t, (lo, hi) in [("", 256, 256, (40, 256)),
                                  ("t1024_", 2, 1024, (600, 1000)),
                                  ("chunk_", 2048, 64, (3, 12))]:
        qkv = [torch.randn((b, t, h, dh), generator=gen)
               .to("cuda").transpose(1, 2) for _ in range(3)]
        lengths = torch.randint(lo, hi + 1, (b,), generator=gen)
        mask = (torch.arange(t)[None, :] < lengths[:, None]).float().to("cuda")
        bool_mask = mask.bool()[:, None, None, :]
        fl[which + "ms"] = time_ms(lambda: fa.flash_attention(*qkv, mask),
                                   reps=20, warmup=3)
        fl[which + "plain_ms"] = time_ms(
            lambda: fa.flash_attention_plain(*qkv, mask), reps=5)
        fl[which + "library_ms"] = time_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                *qkv, attn_mask=bool_mask), reps=20, warmup=3)
        flash_f32_bounds(fl, which, mask, h, dh)
        log(f"  f32 flash B={b} H={h} T={t} Dh={dh}, {lo}-{hi} real keys: "
            f"kernel {fl[which + 'ms']:.4f} ms, plain "
            f"{fl[which + 'plain_ms']:.3f} ms, f32 SDPA "
            f"{fl[which + 'library_ms']:.4f} ms, bound "
            f"{fl[which + 'bound_ms']:.4f} ms ({fl[which + 'bound_by']}, "
            f"3xTF32 at 495 TFLOP/s; f32 FMAs "
            f"{fl[which + 'fma_bound_ms']:.4f} ms)")
    fl["shape_note"] = (
        "f32 q, k, v; ms, plain_ms, library_ms, bound_ms at B=256 H=12 T=256 "
        "Dh=32 with 40-256 real keys; t1024_* at B=2 T=1024; chunk_* at "
        "B=2048 T=64 (3-12 real); dh256_* (timed in phase 4) at B=64 H=8 "
        "T=256 (40-256 real) with Dh 256 (Dh 320: the flash_wide entry); "
        "library = f32 SDPA (TF32 off); bound_ms = tf32x3_bound_ms (three "
        "TF32 products a term at 495 TFLOP/s), fma_bound_ms (one f32 FMA at "
        "67 TFLOP/s)")

    # a head width the kernel lacks: hidden 384 over 8 heads (Dh 48), bf16,
    # padded to 64 columns on each call; the three pads timed alone
    qkv = [torch.randn((256, 256, 8, 48), generator=gen)
           .to("cuda", torch.bfloat16).transpose(1, 2) for _ in range(3)]
    lengths = torch.randint(40, 257, (256,), generator=gen)
    mask = (torch.arange(256)[None, :] < lengths[:, None]).float().to("cuda")
    report["flash"]["dh48_ms"] = time_ms(lambda: fa.flash_attention(*qkv, mask),
                                         reps=20, warmup=3)
    report["flash"]["dh48_pad_ms"] = time_ms(lambda: [
        torch.nn.functional.pad(x, (0, 16)) for x in qkv], reps=20, warmup=3)
    log(f"  flash at Dh 48 (B=256 H=8 T=256, bf16, padded to 64): "
        f"{report['flash']['dh48_ms']:.4f} ms, of which the pad of q, k, v "
        f"alone {report['flash']['dh48_pad_ms']:.4f} ms")


# phase 9: the rerank stage over phase 3's index, one npz-layout checkpoint
# per reranker at its preset width plus the encoder's full-width twin
RERANK_QUERIES = 768      # 768 x rerank_top 20 = 15,360 pairs: two 8,192 blocks
RERANK_TOP = 20
RERANK_DEPTH = 40         # the per-leg depth of a k = 10 search
RERANK_TOL = 1e-4         # rtol = atol, card vs CPU, f32 with TF32 off
TUNE_QUERIES = 256        # the labeled sample of tune_rerank_blend
TUNE_TOP = 4              # 1,024 pairs, also scored on the CPU
# the full-width twin's CPU scoring takes ~28 ms a pair: half the sample
FULL_WIDTH_TUNE_QUERIES = 128
BLOCK_CHECK_PAIRS = 2048  # rows held against 256-row blocks
FULL_WIDTH_CE = {"num_layers": 6, "num_heads": 12, "mlp_dim": 1536,
                 "dropout_rate": 0.1}


def _treedef(tree) -> str:
    """``str(jax.tree.structure(tree))`` of a nested dict: keys sorted,
    ``*`` at the leaves."""
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_treedef(tree[k])}"
                               for k in sorted(tree)) + "}"
    return "*"


def _leaves(tree):
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    return [tree]


def write_npz_checkpoint(path, params, metadata, pp) -> None:
    """The layout the JAX package's ``save_checkpoint`` writes without
    orbax (``semanticsearch_tpu/core/checkpoint.py:68-84``): the leaves of
    ``{"params": params}`` in ``jax.tree.flatten`` order in ``state.npz``,
    the tree's structure string in ``treedef.txt``, ``format.json``, and
    the trainer's ``metadata.json`` and ``preprocessor.json`` beside them."""
    os.makedirs(path, exist_ok=True)
    state = {"params": params}
    np.savez(os.path.join(path, "state.npz"), *_leaves(state))
    with open(os.path.join(path, "treedef.txt"), "w") as f:
        f.write(f"PyTreeDef({_treedef(state)})")
    with open(os.path.join(path, "format.json"), "w") as f:
        json.dump({"format": "npz"}, f)
    with open(os.path.join(path, "metadata.json"), "w") as f:
        json.dump(metadata, f)
    pp.save(os.path.join(path, "preprocessor.json"))


class _StageTimer:
    """The rerank stage's parts in one engine: host seconds in the stage
    (``_rerank_heads``), in ``transform_pair`` and in ``score_pairs``
    (which ends in its one copy back), and the device span from the first
    block's launch to the last block's end (CUDA events around the
    model's calls)."""

    def __init__(self, engine) -> None:
        import torch

        self.torch, svc = torch, engine.reranker
        self.seconds = {"stage": 0.0, "transform": 0.0, "score": 0.0}
        self.first = self.last = None
        self._wrapped = [(engine, "_rerank_heads", "stage"),
                         (svc.pp, "transform_pair", "transform"),
                         (svc, "score_pairs", "score")]
        self._model = svc.model

    def _timed(self, fn, part):
        def timed(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                self.seconds[part] += time.perf_counter() - t0
        return timed

    def __enter__(self):
        for obj, name, part in self._wrapped:
            setattr(obj, name, self._timed(getattr(obj, name), part))
        forward = self._model.forward

        def timed_forward(*a, **kw):
            if self.first is None:
                self.first = self.torch.cuda.Event(enable_timing=True)
                self.first.record()
            out = forward(*a, **kw)
            self.last = self.torch.cuda.Event(enable_timing=True)
            self.last.record()
            return out

        self._model.forward = timed_forward
        return self

    def __exit__(self, *exc):
        for obj, name, _ in self._wrapped:
            delattr(obj, name)
        del self._model.forward

    def device_ms(self) -> float:
        self.last.synchronize()
        return self.first.elapsed_time(self.last)


def _pooling_bound_ms(name, cfg, kw, rows):
    """bound_ms of one block of KNRM or Conv-KNRM (None for the others):
    the ids, the table and the scores moved once; the operations the
    convolutions (Conv-KNRM), the cosine products and the kernel pooling
    (7 per (left, right, kernel) cell: subtract, square, scale, divide,
    exp, mask, sum) need, at the f32 rate (TF32 is off)."""
    if name not in ("knrm", "conv_knrm"):
        return None
    lq, rq, d = cfg.fixed_length_left, cfg.fixed_length_right, \
        cfg.embedding_dim
    if name == "knrm":
        maps, width, conv = 1, d, 0.0
        kernels = kw["kernel_num"]
    else:
        n = kw["max_ngram"]
        maps, width, kernels = n * n, kw["filters"], kw["kernel_num"]
        conv = 2.0 * (lq + rq) * kw["filters"] * d * n * (n + 1) / 2
    ops = rows * (conv + maps * (2.0 * lq * rq * width
                                 + 7.0 * lq * rq * kernels))
    nbytes = rows * ((lq + rq) * 8 + 4) + cfg.vocab_size * d * 4
    return bound_ms(ops, nbytes, PEAK_F32_FLOPS)


def _rerank_configs():
    """(label, model name, TrainConfig, model_kwargs): the eight presets
    and the encoder's full-width twin (embed 384, 6 layers, 12 heads,
    MLP 1,536; packed length 1 + 16 + 128 = 145)."""
    from semanticsearch_tpu_torch.train.presets import (MODEL_TRAIN_PRESETS,
                                                        get_preset)

    out = [(name, name, *get_preset(name)) for name in MODEL_TRAIN_PRESETS]
    cfg, _ = get_preset("cross_encoder")
    out.append(("cross_encoder_full", "cross_encoder",
                dataclasses.replace(cfg, embedding_dim=384),
                dict(FULL_WIDTH_CE)))
    return out


def phase_rerank(report, ctx):
    import torch

    from semanticsearch_tpu_torch.index.query_engine import HybridQueryEngine
    from semanticsearch_tpu_torch.index.rerank_service import (
        SCORE_BATCH, SCORE_BATCH_LARGE, RerankService)
    from semanticsearch_tpu_torch.models.convert import reranker_flax_tree
    from semanticsearch_tpu_torch.models.rerankers import make_model
    from semanticsearch_tpu_torch.ops import flash_attention as fa
    from semanticsearch_tpu_torch.ops import topk
    from semanticsearch_tpu_torch.train.vocab import Preprocessor

    log("== phase 9: the neural rerank stage over phase 3's index (main "
        f"path): {RERANK_QUERIES} queries at k = 10, rerank_top = "
        f"{RERANK_TOP}, every reranker at its preset width")
    t_phase = time.perf_counter()
    rng = np.random.default_rng(41)
    words, tmp, encoder = ctx["words"], ctx["tmp"], ctx["encoder"]
    queries = [_zipf_text(rng, words, int(rng.integers(3, 9)))
               for _ in range(RERANK_QUERIES)]
    base = HybridQueryEngine.load(ctx["idx"], encoder)
    texts, id_to_row = base.texts, {c: i for i, c in
                                    enumerate(base.chunk_ids)}
    vocab = Preprocessor(filter_low_freq=5).fit(texts).vocab
    # labels of the tuning sample: two of each query's fused top 10 and
    # one chunk drawn from the corpus
    fused = base.search(queries[:TUNE_QUERIES], k=10)
    labels = [[hits[int(i)].chunk_id for i in rng.choice(10, 2, False)]
              + [f"c{int(rng.integers(len(texts)))}"] for hits in fused]
    del base
    log(f"  word vocabulary of the corpus (filter_low_freq 5): {len(vocab)}")

    results = {}
    for seed, (label, name, cfg, kw) in enumerate(_rerank_configs()):
        pp = Preprocessor(fixed_length_left=cfg.fixed_length_left,
                          fixed_length_right=cfg.fixed_length_right,
                          filter_low_freq=cfg.filter_low_freq, vocab=vocab)
        torch.manual_seed(100 + seed)
        model = make_model(name, vocab_size=pp.vocab_size,
                           embed_dim=cfg.embedding_dim, **kw)
        with torch.no_grad():  # materializes ArcII's width-dependent head
            model(torch.ones((1, cfg.fixed_length_left), dtype=torch.long),
                  torch.ones((1, cfg.fixed_length_right), dtype=torch.long))
        ckpt = os.path.join(tmp, f"rerank_{label}")
        write_npz_checkpoint(
            ckpt, reranker_flax_tree(model),
            {"model": type(model).__name__,
             "config": {**dataclasses.asdict(cfg),
                        "eval_metrics": list(cfg.eval_metrics)},
             "model_kwargs": kw}, pp)
        del model
        t0 = time.perf_counter()
        engine = HybridQueryEngine.load(ctx["idx"], encoder,
                                        reranker_dir=ckpt)
        svc = engine.reranker
        load_s = time.perf_counter() - t0
        check(svc.model_name == name and next(
            svc.model.parameters()).device.type == "cuda",
            f"{label}: load(reranker_dir=...) read the npz checkpoint onto "
            f"the card in {load_s:.2f} s")
        engine.search(queries[:64], k=10, rerank_top=RERANK_TOP)  # warm-up

        # the timed pair: the same 768 queries with the stage and without
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        plain10 = engine.search(queries, k=10)
        torch.cuda.synchronize()
        t_plain = time.perf_counter() - t0
        plain_launches = (topk.SEGTOPK_LAUNCHES, fa.FLASH_LAUNCHES)
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        with _StageTimer(engine) as st:
            t0 = time.perf_counter()
            rr10 = engine.search(queries, k=10, rerank_top=RERANK_TOP)
            torch.cuda.synchronize()
            t_rr = time.perf_counter() - t0
        rr_launches = (topk.SEGTOPK_LAUNCHES, fa.FLASH_LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        check(rr_launches == plain_launches and min(rr_launches) > 0,
              f"{label}: pass A and flash launched on the reranked path as "
              f"without the stage (segtopk, flash) {rr_launches}")

        # the head's candidate set, the tail's order, the order by score
        plain30 = engine.search(queries, k=30, candidates=RERANK_DEPTH)
        rr30 = engine.search(queries, k=30, candidates=RERANK_DEPTH,
                             rerank_top=RERANK_TOP)
        ok_head = ok_tail = ok_order = True
        for p, r in zip(plain30, rr30):
            ok_head &= ({h.chunk_id for h in r[:RERANK_TOP]}
                        == {h.chunk_id for h in p[:RERANK_TOP]})
            ok_tail &= ([h.chunk_id for h in r[RERANK_TOP:]]
                        == [h.chunk_id for h in p[RERANK_TOP:]]
                        and all(h.rerank_score is None
                                for h in r[RERANK_TOP:]))
            scores = [h.rerank_score for h in r[:RERANK_TOP]]
            ok_order &= (None not in scores
                         and scores == sorted(scores, reverse=True))
        check(ok_head and ok_order and all(len(r) == 30 for r in rr30),
              f"{label}: each reranked head is its fused head's "
              f"{RERANK_TOP} candidates, ordered by rerank score")
        check(ok_tail, f"{label}: the tail past rerank_top keeps the fused "
              "order and has no rerank_score")
        check(all([(h.chunk_id, h.rerank_score) for h in a]
                  == [(h.chunk_id, h.rerank_score) for h in b[:10]]
                  for a, b in zip(rr10, rr30))
              and plain10[0][0].rerank_score is None,
              f"{label}: k = 10 is the first 10 of k = 30 at the same depth")

        # one 8,192-row block against 256-row blocks, row for row
        pairs = [(q, texts[id_to_row[h.chunk_id]], h.rerank_score)
                 for q, hits in zip(queries, rr30)
                 for h in hits[:RERANK_TOP]][:BLOCK_CHECK_PAIRS]
        small = np.concatenate([
            svc.score_pairs([p[0] for p in pairs[s: s + SCORE_BATCH]],
                            [p[1] for p in pairs[s: s + SCORE_BATCH]])
            for s in range(0, len(pairs), SCORE_BATCH)])
        whole = np.array([p[2] for p in pairs], np.float32)
        err_blocks = float(np.abs(small - whole).max())
        check(bool(np.allclose(small, whole, rtol=RERANK_TOL,
                               atol=RERANK_TOL)),
              f"{label}: {len(pairs)} rows scored in the 8,192-row blocks "
              f"equal them in 256-row blocks (max abs diff "
              f"{err_blocks:.2e})")

        # the device time of one full block at the served ids
        enc = svc.pp.transform_pair([p[0] for p in pairs] * 4,
                                    [p[1] for p in pairs] * 4)
        lb = torch.from_numpy(enc["left"][:SCORE_BATCH_LARGE]).cuda().long()
        rb = torch.from_numpy(enc["right"][:SCORE_BATCH_LARGE]).cuda().long()
        with torch.inference_mode():
            block_ms = time_ms(lambda: svc.model(lb, rb), reps=3)
        bound = _pooling_bound_ms(name, dataclasses.replace(
            cfg, vocab_size=svc.pp.vocab_size), kw, SCORE_BATCH_LARGE)

        # the card against the CPU: tune_rerank_blend on the labeled
        # sample with each service, the same legs, every scored pair held
        cpu_svc = RerankService.load(ckpt, device="cpu")
        n_tune = (FULL_WIDTH_TUNE_QUERIES if label == "cross_encoder_full"
                  else TUNE_QUERIES)
        seen = {}
        tuned = {}
        for where, service in (("card", svc), ("cpu", cpu_svc)):
            score = service.score_pairs

            def recording(q, c, score=score, where=where):
                seen[where] = score(q, c)
                return seen[where]

            service.score_pairs = recording
            engine.reranker = service
            t0 = time.perf_counter()
            tuned[where] = engine.tune_rerank_blend(
                queries[:n_tune], labels[:n_tune], rerank_top=TUNE_TOP)
            tuned[where + "_s"] = time.perf_counter() - t0
            del service.score_pairs
        engine.reranker = svc
        err_cpu = float(np.abs(seen["card"] - seen["cpu"]).max())
        check(seen["card"].shape == (n_tune * TUNE_TOP,)
              and bool(np.isfinite(seen["card"]).all())
              and bool(np.allclose(seen["card"], seen["cpu"],
                                   rtol=RERANK_TOL, atol=RERANK_TOL)),
              f"{label}: score_pairs on the card == on the CPU over "
              f"{seen['card'].size} pairs (max abs diff {err_cpu:.2e}, "
              f"scores up to {float(np.abs(seen['cpu']).max()):.3g})")
        (b_card, m_card, t_card), (b_cpu, m_cpu, t_cpu) = (tuned["card"],
                                                           tuned["cpu"])
        check(b_card == b_cpu and list(t_card) == list(t_cpu)
              and max(abs(t_card[b] - t_cpu[b]) for b in t_card) <= 1e-12,
              f"{label}: tune_rerank_blend on {n_tune} labeled "
              f"queries: best beta {b_card} (MAP {m_card:.4f}) and the MAP "
              "table equal on the card and the CPU")

        n_pairs = RERANK_QUERIES * RERANK_TOP
        part = st.seconds
        res = {
            "model": name, "model_kwargs": kw,
            "embed_dim": cfg.embedding_dim,
            "lengths": [cfg.fixed_length_left, cfg.fixed_length_right],
            "params": int(sum(v.numel() for v in svc.model.state_dict(
            ).values())),
            "load_s": load_s, "search_s": t_plain, "search_rerank_s": t_rr,
            "stage_s": part["stage"], "transform_s": part["transform"],
            "score_pairs_s": part["score"],
            "device_span_ms": st.device_ms(),
            "reorder_s": part["stage"] - part["score"],
            "host_share": 1.0 - st.device_ms() / 1e3 / part["stage"],
            "pairs": n_pairs, "pairs_per_s": n_pairs / part["score"],
            "block_8192_ms": block_ms, "peak_gib": peak / 2**30,
            "block_bound_ms": bound and bound[0],
            "block_bound_by": bound and bound[1],
            "card_vs_cpu_max_abs": err_cpu, "blocks_max_abs": err_blocks,
            "tune_best": b_card, "tune_map": m_card,
            "tune_card_s": tuned["card_s"], "tune_cpu_s": tuned["cpu_s"],
        }
        results[label] = res
        log(f"  {label}: {RERANK_QUERIES} queries {t_plain:.3f} s without "
            f"the stage, {t_rr:.3f} s with (the stage {part['stage']:.3f} s: "
            f"transform_pair {part['transform']:.3f} s, score_pairs "
            f"{part['score']:.3f} s with a device span of "
            f"{res['device_span_ms']:.1f} ms, pair lists and reorder "
            f"{res['reorder_s']:.3f} s; host share "
            f"{res['host_share']:.3f}); "
            f"{res['pairs_per_s']:.0f} pairs/s; one 8,192-pair block "
            f"{block_ms:.2f} ms"
            + (f" (bound {bound[0]:.3f} ms, {bound[1]})" if bound else "")
            + f"; peak {res['peak_gib']:.2f} GiB")
        del engine, svc, cpu_svc, lb, rb
        torch.cuda.empty_cache()
    report["segtopk"]["rerank_launches"] = rr_launches[0]
    report["flash"]["rerank_launches"] = rr_launches[1]
    report["rerank"] = results
    print(json.dumps({"rerank": results}), flush=True)
    log(f"  phase 9: {time.perf_counter() - t_phase:.1f} s")


# phase 10: the training path at the default encoder's full width, on
# labels that rank_and_filter_groups makes over phase 3's corpus and encoder
TRAIN_QUERIES = 160        # x 20 candidates: ~4 positives and ~4 negatives
TRAIN_CANDIDATES = 20
MLM_STEPS = 16             # MLMConfig's batch 64 at max_len 128
CONTRASTIVE_STEPS = 8      # ContrastiveConfig's batch 64, 64 + 256 tokens
FLASH_STOCK_RTOL = 2e-2    # bf16: see the check
F32_PAIRS = 16             # the f32 card-against-CPU steps' batch
MINING_CORPUS = 2048
RERANK_STEPS = 20
PROFILED_STEPS = 3         # steps under torch.profiler, for the host share
RESUME_ATOL = 1e-5         # the CUDA embedding backward sums by atomics
ADAMW_BYTES = 28           # read p, g, mu, nu; write p, mu, nu (f32)


# A training step's bound: its matrix products at the peak rate, plus the
# optimizer's pass over the f32 parameters at the memory rate (the update
# reads every gradient, so it follows the backward)


def _encoder_fwd_flops(cfg, b, t):
    """Products of one encoder forward over b padded sequences of t
    tokens: q, k, v, o and the two MLP matrices per token and layer, and
    the two attention products over t keys."""
    h, m = cfg.hidden_dim, cfg.mlp_dim
    return b * t * cfg.num_layers * (2.0 * (4 * h * h + 2 * h * m)
                                     + 4.0 * t * h)


class _StepTimer:
    """CUDA events and host clock after each ``Optimizer.step`` (the last
    launch of a training step), while the context is open: ms per step
    from the first recorded step to the last (the first is the warm-up)."""

    def __init__(self) -> None:
        from semanticsearch_tpu_torch.train import optim

        self.optim, self.events, self.host = optim, [], []

    def __enter__(self):
        import torch

        step = self.optim.Optimizer.step

        def timed(opt):
            step(opt)
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.events.append(ev)
            self.host.append(time.perf_counter())

        self._step = step
        self.optim.Optimizer.step = timed
        return self

    def __exit__(self, *exc):
        self.optim.Optimizer.step = self._step

    def ms(self) -> float:
        self.events[-1].synchronize()
        return (self.events[0].elapsed_time(self.events[-1])
                / (len(self.events) - 1))

    def host_ms(self) -> float:
        return 1e3 * (self.host[-1] - self.host[0]) / (len(self.host) - 1)


def _device_busy_ms(fn, top: int = 8):
    """fn()'s device busy time (the union of its kernels' intervals under
    torch.profiler), its host wall time, and its ``top`` kernels by device
    time; None for the first where the profiler shows no kernel."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    spans, by_name = [], {}
    for evt in prof.events():
        # kernels and copies; not the user ranges the optimizer annotates
        if (evt.device_type == DeviceType.CUDA
                and not getattr(evt, "is_user_annotation", False)
                and "#" not in evt.name):
            a, b = evt.time_range.start, evt.time_range.end
            spans.append((a, b))
            by_name[evt.name] = by_name.get(evt.name, 0.0) + (b - a) / 1e3
    busy, end = 0.0, None
    for a, b in sorted(spans):
        if end is None or a > end:
            busy, end = busy + (b - a), b
        elif b > end:
            busy, end = busy + (b - end), b
    kernels = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return (busy / 1e3 if spans else None), wall, kernels


def _host_share(busy, step_ms, kernels):
    """The device's busy ms a step over PROFILED_STEPS profiled steps, the
    share of a step (ms by events) the device is idle, i.e. waits on the
    host, and the top kernels a step."""
    if busy is None:
        return {"busy_ms": None, "host_share": None, "top_kernels_ms": []}
    per = busy / PROFILED_STEPS
    return {"busy_ms": per, "host_share": max(0.0, 1.0 - per / step_ms),
            "top_kernels_ms": [(n, ms / PROFILED_STEPS) for n, ms in kernels]}


def _share_line(r) -> str:
    if r["busy_ms"] is None:
        return "device busy not measured"
    return (f"device busy {r['busy_ms']:.2f} ms a step, host share "
            f"{r['host_share']:.3f}; kernels, device ms a step: "
            + "; ".join(f"{ms:.2f} {name[:60]}"
                        for name, ms in r["top_kernels_ms"]))


def _step_flops(model, fn):
    """Products of one training step fn(): torch's FlopCounterMode (matrix
    products and convolutions, forward and backward) plus the LSTMs' gate
    products, which the cuDNN call hides from it (x3 for the backward)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    lstm = [0.0]

    def hook(mod, args, out):
        b, t, d_in = args[0].shape
        h, dirs = mod.hidden_size, 2 if mod.bidirectional else 1
        lstm[0] += 3 * 2.0 * b * t * dirs * 4 * h * (d_in + h)

    hooks = [m.register_forward_hook(hook) for m in model.modules()
             if isinstance(m, torch.nn.LSTM)]
    try:
        with FlopCounterMode(display=False) as fc:
            fn()
    finally:
        for hk in hooks:
            hk.remove()
    return float(fc.get_total_flops()) + lstm[0]


def _training_rows(ctx):
    """Labeled rows (query_id, query_text, chunk_text, label) for phase 3's
    corpus: each query's hybrid top-20 candidates, labeled by
    rank_and_filter_groups over the phase 3 encoder; and the corpus texts."""
    from semanticsearch_tpu_torch.index.query_engine import HybridQueryEngine
    from semanticsearch_tpu_torch.index.ranker import (QueryGroup,
                                                       rank_and_filter_groups)

    rng = np.random.default_rng(53)
    engine = HybridQueryEngine.load(ctx["idx"], ctx["encoder"])
    texts, row = engine.texts, {c: i for i, c in enumerate(engine.chunk_ids)}
    queries = [_zipf_text(rng, ctx["words"], int(rng.integers(3, 9)))
               for _ in range(TRAIN_QUERIES)]
    hits = engine.search(queries, k=TRAIN_CANDIDATES)
    groups = [QueryGroup(f"q{i}", q, [h.chunk_id for h in hs],
                         [texts[row[h.chunk_id]] for h in hs])
              for i, (q, hs) in enumerate(zip(queries, hits))]
    t0 = time.perf_counter()
    ranked = rank_and_filter_groups(groups, ctx["encoder"].encode)
    label_s = time.perf_counter() - t0
    qtext = {g.query_id: g.query_text for g in groups}
    rows = [{"query_id": r.query_id, "query_text": qtext[r.query_id],
             "chunk_text": r.chunk_text, "label": str(r.label)}
            for r in ranked]
    return rows, list(texts), label_s


def phase_train(report, ctx):
    import torch

    from semanticsearch_tpu_torch.core.config import EncoderConfig
    from semanticsearch_tpu_torch.data.folds import create_cv_folds
    from semanticsearch_tpu_torch.data.tsv import write_tsv
    from semanticsearch_tpu_torch.index.query_engine import HybridQueryEngine
    from semanticsearch_tpu_torch.models.encoder import SentenceEncoder
    from semanticsearch_tpu_torch.ops import flash_attention as fa
    from semanticsearch_tpu_torch.train.encoder_train import (
        ContrastiveConfig, ContrastiveEncoderTrainer, fit_with_mining,
        load_encoder, mining_inputs_from_labeled_rows,
        pairs_from_labeled_rows, save_encoder)
    from semanticsearch_tpu_torch.train.evaluate import (
        CVEvaluator, dataset_from_fold, evaluate_saved_model)
    from semanticsearch_tpu_torch.train.mlm_pretrain import (MLMConfig,
                                                             MLMPretrainer)
    from semanticsearch_tpu_torch.train.pairs import PairDataset
    from semanticsearch_tpu_torch.train.presets import (MODEL_TRAIN_PRESETS,
                                                        get_preset)
    from semanticsearch_tpu_torch.train.trainer import RerankTrainer
    from semanticsearch_tpu_torch.train.vocab import Preprocessor

    log("== phase 10: the training path at the default encoder's full width "
        "(MLM, contrastive under flash and stock, f32 against the CPU, "
        "re-mining, save and load, the eight rerankers, 5-fold CV, resume)")
    t_phase = time.perf_counter()
    tmp = ctx["tmp"]
    rows, corpus, label_s = _training_rows(ctx)
    pairs, negs = pairs_from_labeled_rows(rows)
    n_pos = sum(r["label"] == "1" for r in rows)
    check(len(pairs) >= CONTRASTIVE_STEPS * 64
          and len(rows) - n_pos >= TRAIN_QUERIES,
          f"rank_and_filter_groups labeled {len(rows)} of "
          f"{TRAIN_QUERIES * TRAIN_CANDIDATES} candidates ({n_pos} "
          f"positive) in {label_s:.2f} s: {len(pairs)} training pairs")
    cfg = EncoderConfig(attention="flash")
    res = {"label_s": label_s, "pairs": len(pairs)}

    # 1. MLM pretraining: one warm-up step, then MLM_STEPS timed ones
    enc = SentenceEncoder(cfg, device="cuda", seed=0)
    n_params = sum(p.numel() for p in enc.master.parameters())
    mcfg = MLMConfig(epochs=1)
    texts = corpus[:mcfg.batch_size * (MLM_STEPS + 1)]
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    with _StepTimer() as st:
        hist = MLMPretrainer(enc, mcfg).fit(texts)
    mlm_ms, mlm_host_ms = st.ms(), st.host_ms()
    mlm_peak = torch.cuda.max_memory_allocated() / 2**30
    check(len(st.events) == MLM_STEPS + 1
          and fa.FLASH_LAUNCHES == cfg.num_layers * (MLM_STEPS + 1)
          and np.isfinite(hist[0]["loss"]),
          f"MLM: {MLM_STEPS + 1} steps, flash launched "
          f"{fa.FLASH_LAUNCHES} times ({cfg.num_layers} a step), loss "
          f"{hist[0]['loss']:.4f}")
    n_mask = max(1, int(round(mcfg.mask_prob * mcfg.max_len)))
    mlm_ops = 3 * (_encoder_fwd_flops(cfg, mcfg.batch_size, mcfg.max_len)
                   + 2.0 * mcfg.batch_size * n_mask * cfg.vocab_size
                   * cfg.hidden_dim)
    mlm_bound = (bound_ms(mlm_ops, 0)[0]
                 + bound_ms(0, ADAMW_BYTES * n_params)[0])
    mlm_tokens = mcfg.batch_size * mcfg.max_len
    res["mlm"] = {"ms": mlm_ms, "host_issue_ms": mlm_host_ms,
                  "tokens_per_s": mlm_tokens / mlm_ms * 1e3,
                  "bound_ms": mlm_bound, "tflop": mlm_ops / 1e12,
                  "peak_gib": mlm_peak, "loss": hist[0]["loss"]}
    log(f"  MLM step: {mlm_ms:.2f} ms by events ({mlm_host_ms:.2f} ms of "
        f"host issue), {mlm_tokens / mlm_ms * 1e3:,.0f} tokens/s, bound "
        f"{mlm_bound:.3f} ms ({mlm_ops / 1e12:.3f} TFLOP bf16 + AdamW over "
        f"{n_params:,} f32 parameters), peak {mlm_peak:.2f} GiB")
    busy, wall, kernels = _device_busy_ms(lambda: MLMPretrainer(
        enc, dataclasses.replace(mcfg, seed=1)).fit(
            texts[:mcfg.batch_size * PROFILED_STEPS]))
    res["mlm"].update(_host_share(busy, mlm_ms, kernels))
    log(f"    profiled {PROFILED_STEPS} steps: {_share_line(res['mlm'])}")
    masters = {k: v.clone() for k, v in enc.master.state_dict().items()}

    # 2. contrastive: the same masters and batches under flash and stock
    ccfg = ContrastiveConfig(epochs=1)
    c_pairs = pairs[:ccfg.batch_size * CONTRASTIVE_STEPS]
    c_negs = negs[:len(c_pairs)]
    runs = {}
    for attention in ("flash", "stock"):
        e = SentenceEncoder(dataclasses.replace(cfg, attention=attention),
                            device="cuda", state_dict=masters)
        trainer = ContrastiveEncoderTrainer(e, ccfg)
        losses = []
        loss_fn = trainer._loss

        def recording(*a, _f=loss_fn, _l=losses):
            _l.append(_f(*a))
            return _l[-1]

        trainer._loss = recording
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        with _StepTimer() as st:
            trainer.fit(c_pairs, c_negs)
        runs[attention] = {
            "losses": [float(x.detach()) for x in losses], "ms": st.ms(),
            "host_issue_ms": st.host_ms(), "launches": fa.FLASH_LAUNCHES,
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
        n = ccfg.batch_size * PROFILED_STEPS
        busy, _, kernels = _device_busy_ms(
            lambda: ContrastiveEncoderTrainer(
                e, dataclasses.replace(ccfg, seed=1)).fit(c_pairs[:n],
                                                          c_negs[:n]))
        runs[attention].update(_host_share(busy, runs[attention]["ms"],
                                           kernels))
        del e, trainer
        torch.cuda.empty_cache()
    fl, sk = runs["flash"], runs["stock"]
    check(fl["launches"] == 2 * cfg.num_layers * CONTRASTIVE_STEPS
          and sk["launches"] == 0,
          f"contrastive: flash launched {fl['launches']} times in "
          f"{CONTRASTIVE_STEPS} steps under attention='flash' (12 a step: 6 "
          f"layers x 2 forwards; none in the backward), {sk['launches']} "
          "under 'stock'")
    rel = max(abs(a - b) / abs(b) for a, b in zip(fl["losses"],
                                                   sk["losses"]))
    # bf16 rounds at 2^-8: flash keeps scores and P in f32, stock rounds
    # q / sqrt(Dh), the scores and P to bf16; through 6 layers and the 1 /
    # 0.05 temperature a few such ulps of the cosines move the loss by ~1e-2
    check(rel <= FLASH_STOCK_RTOL,
          f"contrastive per-step losses, flash against stock: max relative "
          f"difference {rel:.2e} <= {FLASH_STOCK_RTOL} (flash "
          f"{[round(x, 4) for x in fl['losses']]})")
    c_tokens = ccfg.batch_size * (ccfg.max_len_query + 2 * ccfg.max_len_chunk)
    c_ops = 3 * (_encoder_fwd_flops(cfg, ccfg.batch_size, ccfg.max_len_query)
                 + _encoder_fwd_flops(cfg, 2 * ccfg.batch_size,
                                      ccfg.max_len_chunk))
    c_bound = (bound_ms(c_ops, 0)[0]
               + bound_ms(0, ADAMW_BYTES * n_params)[0])
    for name, r in runs.items():
        r["tokens_per_s"] = c_tokens / r["ms"] * 1e3
        log(f"  contrastive step ({name}): {r['ms']:.2f} ms by events "
            f"({r['host_issue_ms']:.2f} ms of host issue), "
            f"{r['tokens_per_s']:,.0f} tokens/s, bound {c_bound:.3f} ms "
            f"({c_ops / 1e12:.3f} TFLOP bf16 + AdamW), peak "
            f"{r['peak_gib']:.2f} GiB")
        log(f"    profiled {PROFILED_STEPS} steps: {_share_line(r)}")
    res["contrastive"] = {**runs, "bound_ms": c_bound,
                          "tflop": c_ops / 1e12, "tokens": c_tokens,
                          "flash_vs_stock_rel": rel}
    report["flash"]["train_launches"] = fl["launches"] // CONTRASTIVE_STEPS

    # 3. the f32 encoder: 2 steps on the card against the same on the CPU
    f32 = dataclasses.replace(cfg, dtype="float32")
    fcfg = ContrastiveConfig(epochs=2, batch_size=F32_PAIRS)
    out = {}
    zero_counts()
    for where in ("cuda", "cpu"):
        e = SentenceEncoder(f32, device=where, state_dict=masters)
        t0 = time.perf_counter()
        h = ContrastiveEncoderTrainer(e, fcfg).fit(pairs[:F32_PAIRS],
                                                   negs[:F32_PAIRS])
        out[where] = (h, {k: v.cpu() for k, v in
                          e.master.state_dict().items()},
                      time.perf_counter() - t0)
    f32_launches = fa.FLASH_F32_LAUNCHES
    loss_rel = max(abs(a["loss"] - b["loss"]) / abs(b["loss"])
                   for a, b in zip(out["cuda"][0], out["cpu"][0]))
    p_card, p_cpu = out["cuda"][1], out["cpu"][1]
    worst = max(float((p_card[k] - p_cpu[k]).abs().max()) for k in p_cpu)
    step_diff = sum(float(((p_card[k] - p_cpu[k]) ** 2).sum())
                    for k in p_cpu) ** 0.5
    step_norm = sum(float(((p_cpu[k] - masters[k].cpu()) ** 2).sum())
                    for k in p_cpu) ** 0.5
    report["flash_f32"]["train_launches"] = f32_launches // 2
    check(f32_launches == 2 * 2 * cfg.num_layers and loss_rel <= 1e-4,
          f"f32 encoder (flash on flash_tf32_kernel, {f32_launches} "
          f"launches): 2 contrastive steps of {F32_PAIRS} pairs on the card "
          f"and on the CPU, losses within {loss_rel:.2e} relative <= 1e-4 "
          f"({out['cuda'][2]:.1f} s and {out['cpu'][2]:.1f} s)")
    # the first update has learning rate 0, the second the peak. Adam
    # moves each coordinate by about lr whatever its gradient's size, so a
    # coordinate whose gradient is rounding noise (the key biases' true
    # gradient is 0) can differ by up to 2 lr; the update as a whole must
    # agree to 1e-3 of its norm
    lr = fcfg.learning_rate
    check(worst <= 2 * lr and step_diff <= 1e-3 * step_norm,
          f"f32 masters after the 2 steps, card against CPU: the update "
          f"differs by {step_diff:.2e}, {step_diff / step_norm:.1e} of its "
          f"norm {step_norm:.3f} (<= 1e-3); max abs difference "
          f"{worst:.2e} <= 2 lr = {2 * lr:g}")
    res["f32"] = {"loss_rel": loss_rel, "param_max_abs": worst,
                  "update_rel_diff": step_diff / step_norm,
                  "launches": f32_launches,
                  "card_s": out["cuda"][2], "cpu_s": out["cpu"][2]}
    del out

    # 4. re-mining over a 2,048-chunk corpus, save, load, serve
    m_corpus, relevant = mining_inputs_from_labeled_rows(rows, c_pairs)
    seen = set(m_corpus)
    m_corpus += [t for t in corpus if t not in seen][
        :MINING_CORPUS - len(m_corpus)]
    e = SentenceEncoder(cfg, device="cuda", state_dict=masters)
    t0 = time.perf_counter()
    hist = fit_with_mining(e, ccfg, c_pairs, m_corpus, relevant, c_negs,
                           rounds=2)
    torch.cuda.synchronize()
    mine_s = time.perf_counter() - t0
    check(len(m_corpus) == MINING_CORPUS and [r["round"] for r in hist]
          == [0, 1] and all(np.isfinite(r["loss"]) for r in hist),
          f"fit_with_mining, 2 rounds over {len(m_corpus)} chunks: losses "
          f"{[round(r['loss'], 4) for r in hist]} in {mine_s:.1f} s")
    enc_dir = os.path.join(tmp, "trained_encoder")
    save_encoder(e, enc_dir)
    loaded = load_encoder(enc_dir)
    probe = m_corpus[:512]
    check(loaded.model.token_embed.weight.device.type == "cuda"
          and all(torch.equal(a, b) for a, b in zip(
              loaded.master.parameters(), e.master.parameters()))
          and np.array_equal(loaded.encode(probe), e.encode(probe)),
          "save_encoder -> load_encoder on the card: f32 masters and the "
          "encodings of 512 chunks bit for bit")
    tsv = os.path.join(tmp, "trained_chunks.tsv")
    write_tsv(tsv, [{"chunk_id": f"m{i}", "query_id": "",
                     "document_id": f"m{i}", "chunk_text": t}
                    for i, t in enumerate(m_corpus)],
              ["chunk_id", "query_id", "document_id", "chunk_text"])
    served = HybridQueryEngine.build(tsv, loaded,
                                     os.path.join(tmp, "trained_idx"))
    zero_counts()
    hits = served.search([r["query_text"] for r in rows[:64]], k=10)
    check(all(len(q) == 10 for q in hits) and fa.FLASH_LAUNCHES > 0,
          f"the trained encoder serves 64 queries through HybridQueryEngine "
          f"(10 hits each; flash {fa.FLASH_LAUNCHES} launches)")
    res["mining_s"] = mine_s
    del e, loaded, served
    torch.cuda.empty_cache()

    # 5. the rerankers: each preset 20 steps at its batch and widths
    qtexts = [r["query_text"] for r in rows]
    ctexts = [r["chunk_text"] for r in rows]
    labels = np.array([float(r["label"]) for r in rows], np.float32)
    qids = np.array([r["query_id"] for r in rows])
    presets = {}
    for name in MODEL_TRAIN_PRESETS:
        pcfg, kw = get_preset(name)
        pp = Preprocessor(fixed_length_left=pcfg.fixed_length_left,
                          fixed_length_right=pcfg.fixed_length_right,
                          filter_low_freq=pcfg.filter_low_freq
                          ).fit(qtexts + ctexts)
        tp = pp.transform_pair(qtexts, ctexts)
        ds = PairDataset(left=tp["left"], right=tp["right"], labels=labels,
                         query_ids=qids)
        per_epoch = sum(1 for _ in ds.iter_pair_batches(
            pcfg.batch_size, pcfg.num_dup, pcfg.num_neg, seed=pcfg.seed))
        pcfg = dataclasses.replace(pcfg, epochs=-(-RERANK_STEPS // per_epoch))
        trainer = RerankTrainer(name, pp.vocab_size, pcfg, model_kwargs=kw)
        torch.cuda.reset_peak_memory_stats()
        with _StepTimer() as st:
            result = trainer.fit(ds)
        ms = st.ms()
        batch = next(ds.iter_pair_batches(pcfg.batch_size, pcfg.num_dup,
                                          pcfg.num_neg, seed=1))
        opt_bytes = ADAMW_BYTES * sum(p.numel() for p in
                                      trainer.model.parameters())

        def one_step(trainer=trainer, batch=batch):
            from semanticsearch_tpu_torch.train.trainer import make_optimizer

            opt = make_optimizer(trainer.cfg, {
                k: p for k, p in trainer.model.named_parameters()
                if p.requires_grad})
            trainer._step(opt, batch, torch.Generator(device="cuda"))

        flops = _step_flops(trainer.model, one_step)

        def profiled(trainer=trainer, batch=batch):
            from semanticsearch_tpu_torch.train.trainer import make_optimizer

            opt = make_optimizer(trainer.cfg, {
                k: p for k, p in trainer.model.named_parameters()
                if p.requires_grad})
            for _ in range(PROFILED_STEPS):
                trainer._step(opt, batch, torch.Generator(device="cuda"))

        busy, _, kernels = _device_busy_ms(profiled, top=3)
        # as for the encoder steps: the products at the f32 rate (TF32 is
        # off), then the optimizer's pass over the parameters
        t_ops = bound_ms(flops, 0, PEAK_F32_FLOPS)[0]
        t_opt = bound_ms(0, opt_bytes)[0]
        bound = t_ops + t_opt
        by = "operations" if t_ops >= t_opt else "bytes"
        rows_per_step = pcfg.batch_size * (1 + pcfg.num_neg)
        tokens = rows_per_step * (pcfg.fixed_length_left
                                  + pcfg.fixed_length_right)
        presets[name] = {
            "steps": len(st.events), "ms": ms, "host_issue_ms": st.host_ms(),
            "tokens_per_s": tokens / ms * 1e3, "rows_per_step": rows_per_step,
            "bound_ms": bound, "bound_by": by, "gflop": flops / 1e9,
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "loss": [h["loss"] for h in result.history],
            **_host_share(busy, ms, kernels)}
        check(len(st.events) >= RERANK_STEPS
              and all(np.isfinite(h["loss"]) for h in result.history),
              f"{name}: {len(st.events)} steps of {rows_per_step} rows, "
              f"{ms:.2f} ms a step by events, {tokens / ms * 1e3:,.0f} "
              f"tokens/s, bound {bound:.4f} ms ({by}; {flops / 1e9:.2f} "
              f"GFLOP f32 with TF32 off), peak "
              f"{presets[name]['peak_gib']:.2f} GiB; losses "
              f"{[round(h['loss'], 4) for h in result.history]}; "
              f"{_share_line(presets[name])}")
        del trainer, result
        torch.cuda.empty_cache()
    res["rerankers"] = presets

    # KNRM over 5 folds with checkpoints; evaluate_saved_model per fold
    lab_tsv = os.path.join(tmp, "labeled.tsv")
    write_tsv(lab_tsv, rows, ["query_id", "query_text", "chunk_text",
                              "label"])
    folds = create_cv_folds(lab_tsv, os.path.join(tmp, "folds"), 5)
    kcfg, kkw = get_preset("knrm")
    kcfg = dataclasses.replace(kcfg, epochs=2)
    cv_dir = os.path.join(tmp, "cv")
    t0 = time.perf_counter()
    cv = CVEvaluator(folds).run_model("knrm", kcfg, kkw, output_dir=cv_dir)
    cv_s = time.perf_counter() - t0
    saved = [evaluate_saved_model(os.path.join(cv_dir, "knrm", f"fold_{k}"),
                                  f.test) for k, f in enumerate(folds, 1)]
    worst = max(abs(s[m] - f[m]) for s, f in zip(saved, cv.per_fold)
                for m in f)
    check(len(cv.per_fold) == 5 and worst <= 1e-6,
          f"KNRM 5-fold CV, 2 epochs each, in {cv_s:.1f} s: MAP "
          f"{cv.mean_std()['map']['mean']:.4f} +- "
          f"{cv.mean_std()['map']['std']:.4f}; evaluate_saved_model on "
          f"each fold's checkpoint equals the run's metrics (max abs "
          f"difference {worst:.1e})")

    # a run resumed from a mid-epoch step checkpoint
    pp = Preprocessor.load(os.path.join(cv_dir, "knrm", "fold_1",
                                        "preprocessor.json"))
    train_ds = dataset_from_fold(folds[0].train, pp)
    test_ds = dataset_from_fold(folds[0].test, pp)
    rdir = os.path.join(tmp, "resume")
    full = RerankTrainer("knrm", pp.vocab_size, kcfg, model_kwargs=kkw)
    full_res = full.fit(train_ds, checkpoint_dir=rdir,
                        checkpoint_every_steps=3)
    again = RerankTrainer("knrm", pp.vocab_size, kcfg, model_kwargs=kkw)
    again_res = again.fit(train_ds, resume_from=os.path.join(rdir, "step_3"))
    diff = float(np.abs(again.predict(again_res.params, test_ds)
                        - full.predict(full_res.params, test_ds)).max())
    check(diff <= RESUME_ATOL,
          f"KNRM resumed from step 3 (mid-epoch 0) equals the "
          f"uninterrupted run: test scores within {diff:.2e} <= "
          f"{RESUME_ATOL} (the embedding backward sums by atomics)")
    res.update({"cv_s": cv_s, "cv_map": cv.mean_std()["map"],
                "cv_saved_max_abs": worst, "resume_max_abs": diff,
                "phase_s": time.perf_counter() - t_phase})
    report["train"] = res
    print(json.dumps({"train": res}), flush=True)
    log(f"  phase 10: {res['phase_s']:.1f} s")


# phase 11: the entry points a user calls (the CLI, in process and as a
# subprocess, and the coalescing HTTP server), over phase 3's corpus and
# phase 6's documents
HTTP_CLIENTS = 64          # concurrent clients of the coalescing server
HTTP_REQUESTS = 8          # requests a client sends, one after another
OIE_TAG_SAMPLE = 512       # sentences tagged on the card and on the CPU
OIE_MARGIN = 1e-3          # tags compared where the top-two logits differ more


def _cli(argv):
    """Run ``semsearch-torch argv`` in this process; (exit code, stdout)."""
    import contextlib
    import io

    from semanticsearch_tpu_torch.cli.main import main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(list(argv))
    return rc, buf.getvalue()


def _http(base, path, body=None, timeout=120):
    import urllib.request

    req = urllib.request.Request(
        base + path, method="GET" if body is None else "POST",
        data=None if body is None else json.dumps(body).encode())
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def _hit_rows(hits):
    return [[(h["chunk_id"], h["score"], h["dense_rank"], h["lexical_rank"])
             for h in q] for q in hits]


def _engine_rows(hits):
    return [[(h.chunk_id, h.score, h.dense_rank, h.lexical_rank) for h in q]
            for q in hits]


def phase_entry(report, ctx):
    import torch

    from semanticsearch_tpu_torch.chunking.pipeline import ChunkPipeline
    from semanticsearch_tpu_torch.core.config import get_named_config
    from semanticsearch_tpu_torch.data.tsv import read_tsv
    from semanticsearch_tpu_torch.oie.heuristic import _tokens
    from semanticsearch_tpu_torch.oie.neural import NeuralOIE
    from semanticsearch_tpu_torch.ops import flash_attention as fa
    from semanticsearch_tpu_torch.ops import similarity as sim

    log("== phase 11: the entry points (semsearch-torch index/search/serve/"
        "chunk/oie-train/oie, the coalescing HTTP server)")
    t_phase = time.perf_counter()
    tmp = ctx["tmp"]
    idx = os.path.join(tmp, "idx_cli")
    flash = ["--set", "encoder.attention=flash"]
    res, launches = {}, {}

    # 1. index --bm25 over phase 3's 20,000 chunks, then search
    zero_counts()
    t0 = time.perf_counter()
    rc, out = _cli(["index", "-i", ctx["tsv"], "-o", idx, "--bm25"] + flash)
    torch.cuda.synchronize()
    res["index_s"] = time.perf_counter() - t0
    check(rc == 0 and json.loads(out.splitlines()[-1]) == {
        "rows": 20000, "bm25": True},
          f"index --bm25: 20,000 chunks in {res['index_s']:.2f} s (host "
          f"clock), {fa.FLASH_LAUNCHES} flash launches")
    check(fa.FLASH_LAUNCHES > 0, "the index build launched flash")
    launches["index_flash"] = fa.FLASH_LAUNCHES

    # the subprocess server loads while this process works on
    err_path = os.path.join(tmp, "serve_stderr.txt")
    err_f = open(err_path, "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "semanticsearch_tpu_torch.cli.main", "serve",
         "--index-dir", idx, "--port", "0", "--coalesce"] + flash,
        stdout=subprocess.PIPE, stderr=err_f, text=True)
    t_spawn = time.perf_counter()
    try:
        res.update(_entry_serve(report, ctx, idx, flash, proc, t_spawn,
                                launches))
    finally:
        if proc.poll() is None:
            proc.terminate()
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=30)
        proc.stdout.close()
        err_f.close()

    # 4. chunk under semantic_grouping over phase 6's 600 documents
    corpus = os.path.join(tmp, "chunk_corpus.tsv")
    zero_counts()
    t0 = time.perf_counter()
    rc, out = _cli(["chunk", "-i", corpus, "-o", os.path.join(tmp, "cc"),
                    "--config", "semantic_grouping"])
    torch.cuda.synchronize()
    res["chunk_cli_s"] = time.perf_counter() - t0
    launches["chunk_similarity"] = sim.SIM_LAUNCHES
    summary = json.loads(out.splitlines()[-1])
    t0 = time.perf_counter()
    ref = ChunkPipeline(get_named_config("semantic_grouping"),
                        device="cuda").run(corpus, os.path.join(tmp, "cr"))
    res["chunk_pipeline_s"] = time.perf_counter() - t0
    with open(summary["output_path"], "rb") as a, \
            open(ref["output_path"], "rb") as b:
        same = a.read() == b.read()
    check(sim.SIM_LAUNCHES > 0, "chunk launched the similarity kernel")
    check(rc == 0 and same
          and summary["docs_chunked"] == 600 and summary["fallbacks"] == 0,
          f"chunk --config semantic_grouping: {summary['chunks_out']} chunks "
          f"of 600 documents in {res['chunk_cli_s']:.2f} s (host clock), "
          f"{sim.SIM_LAUNCHES} similarity launches; the TSV is byte-equal "
          f"to ChunkPipeline.run's ({res['chunk_pipeline_s']:.2f} s)")

    # 5. oie-train at NeuralOIEConfig's defaults, then oie --extractor neural
    model_dir = os.path.join(tmp, "oie_model")
    zero_counts()
    t0 = time.perf_counter()
    rc, out = _cli(["oie-train", "-i", ctx["tsv"], "-o", model_dir])
    torch.cuda.synchronize()
    res["oie_train_s"] = time.perf_counter() - t0
    trained = json.loads(out.splitlines()[-1])
    check(rc == 0 and trained["texts"] == 20000,
          f"oie-train (NeuralOIEConfig's defaults: 8 epochs, hidden 128, 2 "
          f"layers) over the 20,000 chunk texts, BPE vocabulary "
          f"{trained['vocab']}, in {res['oie_train_s']:.2f} s (host clock)")
    t0 = time.perf_counter()
    rc, out = _cli(["oie", "-i", ctx["tsv"], "-o",
                    os.path.join(tmp, "oie.tsv"), "--extractor", "neural",
                    "--model-dir", model_dir])
    torch.cuda.synchronize()
    res["oie_s"] = time.perf_counter() - t0
    res["oie_rows_per_s"] = 20000 / res["oie_s"]
    enriched = json.loads(out.splitlines()[-1])
    check(rc == 0 and enriched["enriched_rows"] == 20000
          and fa.FLASH_LAUNCHES == 0,
          f"oie --extractor neural: 20,000 rows in {res['oie_s']:.2f} s = "
          f"{res['oie_rows_per_s']:.1f} rows/s (host clock, self-check "
          f"included); the tagger (max_len 96, attention auto) launched no "
          f"flash kernel")
    card = NeuralOIE.load(model_dir, device="cuda")
    texts = [r["chunk_text"] for r in read_tsv(ctx["tsv"])]
    agreement = card.teacher_agreement(texts[:256])
    res["teacher_agreement"] = agreement
    cpu = NeuralOIE.load(model_dir, device="cpu")
    sents = [w for w in (_tokens(t)[:card.cfg.max_words]
                         for t in texts[:OIE_TAG_SAMPLE]) if len(w) >= 3]
    ids, mask, starts, nwords = card._batch_arrays(sents)
    with torch.no_grad():
        lc = card._logits(dict(card.model.named_parameters()),
                          card._upload(ids), card._upload(mask)).cpu().numpy()
        lh = cpu._logits(dict(cpu.model.named_parameters()),
                         cpu._upload(ids), cpu._upload(mask)).numpy()
    word = np.concatenate([lc[i, starts[i, :nwords[i]]]
                           for i in range(len(sents))])
    word_cpu = np.concatenate([lh[i, starts[i, :nwords[i]]]
                               for i in range(len(sents))])
    top2 = np.sort(word, axis=-1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > OIE_MARGIN
    tags_card = np.concatenate(card.tag_sentences(sents))
    tags_cpu = np.concatenate(cpu.tag_sentences(sents))
    same_tags = (np.array_equal(tags_card[clear], tags_cpu[clear])
                 and np.array_equal(tags_card[clear],
                                    word.argmax(-1)[clear])
                 and np.array_equal(tags_cpu[clear],
                                    word_cpu.argmax(-1)[clear]))
    res["oie_logit_max_abs"] = float(np.abs(lc - lh).max())
    check(same_tags and clear.sum() > 0.5 * clear.size,
          f"the card's tags equal a CPU copy's at {int(clear.sum())} of "
          f"{clear.size} words of {len(sents)} sentences (margin > "
          f"{OIE_MARGIN}; logits within {res['oie_logit_max_abs']:.2e}); "
          f"teacher agreement {agreement['agreement']:.3f} on "
          f"{agreement['n_teacher_sentences']} sentences")

    for key, k2 in (("segtopk", "search_segtopk"), ("flash", "search_flash"),
                    ("similarity", "chunk_similarity")):
        report[key]["entry_launches"] = launches.get(k2, 0)
    res["launches"] = launches
    res["phase_s"] = time.perf_counter() - t_phase
    report["entry"] = res
    print(json.dumps({"entry_points": res}), flush=True)
    log(f"  phase 11: {res['phase_s']:.1f} s")


def _entry_serve(report, ctx, idx, flash, proc, t_spawn, launches):
    """Phase 11's serving part: CLI search, the coalescing server under
    concurrent clients, the subprocess server, and a mutation round."""
    import threading

    import torch

    from semanticsearch_tpu_torch.core.config import EncoderConfig
    from semanticsearch_tpu_torch.index import server as srv_mod
    from semanticsearch_tpu_torch.index.query_engine import HybridQueryEngine
    from semanticsearch_tpu_torch.models.encoder import SentenceEncoder
    from semanticsearch_tpu_torch.ops import flash_attention as fa
    from semanticsearch_tpu_torch.ops import topk
    from semanticsearch_tpu_torch.tools.host_profile import HostSplit

    res = {}
    rng = np.random.default_rng(111)
    # the CLI's encoder: the default config under flash, seed 0
    engine = HybridQueryEngine.load(
        idx, SentenceEncoder(EncoderConfig(attention="flash"), device="cuda",
                             seed=0))
    queries = ctx["batches"][0]
    zero_counts()
    t0 = time.perf_counter()
    search_argv = ["search", "--index-dir", idx, "-k", "10"] + queries + flash
    rc, out = _cli(search_argv)
    torch.cuda.synchronize()
    res["search_cli_s"] = time.perf_counter() - t0
    # phase 12 searches a copy again (the server below compacts this one)
    import shutil
    shutil.copytree(idx, idx + "_copy")
    ctx["cli_search"] = ([idx + "_copy" if a == idx else a
                          for a in search_argv], out)
    launches["search_segtopk"] = topk.SEGTOPK_LAUNCHES
    launches["search_flash"] = fa.FLASH_LAUNCHES
    check(topk.SEGTOPK_LAUNCHES > 0 and fa.FLASH_LAUNCHES > 0,
          f"search launched segtopk {topk.SEGTOPK_LAUNCHES}, flash "
          f"{fa.FLASH_LAUNCHES} times")
    got = json.loads(out.splitlines()[-1])
    cli_rows = [[(h["chunk_id"], h["rrf_score"], h["dense_rank"],
                  h["lexical_rank"]) for h in q["hits"]] for q in got]
    want = engine.search(queries, k=10)
    check(rc == 0 and cli_rows == _engine_rows(want)
          and [q["query"] for q in got] == queries,
          f"search: {len(queries)} queries in {res['search_cli_s']:.2f} s "
          f"(host clock, index load included); hits equal "
          f"HybridQueryEngine.load(...).search's")

    # 2. the coalescing server in a thread, under concurrent clients
    pool = sorted({_zipf_text(rng, ctx["words"], int(rng.integers(3, 9)))
                   for _ in range(HTTP_CLIENTS * HTTP_REQUESTS * 4)})
    rng.shuffle(pool)
    plan, used = [], 0
    for c in range(HTTP_CLIENTS):
        reqs = []
        for _ in range(HTTP_REQUESTS):
            n = int(rng.integers(1, 5))
            reqs.append(pool[used: used + n])
            used += n
        plan.append(reqs)
    check(used <= len(pool), f"{used} distinct queries for "
          f"{HTTP_CLIENTS * HTTP_REQUESTS} requests")
    batches = []
    dispatch = engine._dispatch_legs

    def recorded(qs, k, candidates, hybrid):
        batches.append((list(qs), k))
        return dispatch(qs, k, candidates, hybrid)

    engine._dispatch_legs = recorded
    srv = srv_mod.make_server(engine, port=0, coalesce=True)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    base = f"http://{srv.server_address[0]}:{srv.server_address[1]}"
    answers, lat, errors = {}, [], []
    barrier = threading.Barrier(HTTP_CLIENTS)

    def client(c):
        barrier.wait()
        try:
            for r, qs in enumerate(plan[c]):
                t = time.perf_counter()
                answers[(c, r)] = _http(base, "/search",
                                        {"queries": qs, "k": 10})["results"]
                lat.append(time.perf_counter() - t)
        except Exception as exc:  # collected, checked below
            errors.append(repr(exc))

    try:
        _http(base, "/search", {"queries": pool[-1:], "k": 10})  # warm-up
        clients = [threading.Thread(target=client, args=(c,))
                   for c in range(HTTP_CLIENTS)]
        zero_counts()
        with HostSplit(engine) as split:
            t0 = time.perf_counter()
            for c in clients:
                c.start()
            for c in clients:
                c.join(timeout=300)
            wall = time.perf_counter() - t0
        launches["http_segtopk"] = topk.SEGTOPK_LAUNCHES
        launches["http_flash"] = fa.FLASH_LAUNCHES
        stats = _http(base, "/statz")
        alive = any(c.is_alive() for c in clients)
        check(not errors and not alive, f"{HTTP_CLIENTS} clients x "
              f"{HTTP_REQUESTS} requests answered ({errors[:2]})")
        n_req = HTTP_CLIENTS * HTTP_REQUESTS
        res["http"] = {
            "clients": HTTP_CLIENTS, "requests": n_req,
            "queries": used, "wall_s": wall, "requests_per_s": n_req / wall,
            "queries_per_s": used / wall,
            "p50_ms": 1e3 * float(np.percentile(lat, 50)),
            "p99_ms": 1e3 * float(np.percentile(lat, 99)),
            "batches": stats["coalesce"]["batches"],
            "merged_requests": stats["coalesce"]["merged_requests"],
            "segtopk_launches": topk.SEGTOPK_LAUNCHES,
            "flash_launches": fa.FLASH_LAUNCHES,
            "host_split": split.seconds}
        h = res["http"]
        log(f"  HTTP, coalescing: {n_req} requests ({used} queries) from "
            f"{HTTP_CLIENTS} clients in {wall:.2f} s = "
            f"{h['requests_per_s']:.1f} requests/s, {h['queries_per_s']:.1f} "
            f"queries/s; latency p50 {h['p50_ms']:.1f} ms, p99 "
            f"{h['p99_ms']:.1f} ms (host clock); {h['batches']} merged "
            f"batches, {h['merged_requests']} requests rode a shared one; "
            f"launches segtopk {topk.SEGTOPK_LAUNCHES}, flash "
            f"{fa.FLASH_LAUNCHES}")
        log(f"  the dispatcher's engine parts (s; rest = the wall less "
            f"them: HTTP, JSON, waiting): {split.line()}")
        check(topk.SEGTOPK_LAUNCHES > 0 and fa.FLASH_LAUNCHES > 0,
              "the dispatcher thread launched segtopk and flash")
        engine._dispatch_legs = dispatch
        # the engine's answer for every batch the dispatcher ran, each query
        # from the row that carried it: the coalescer's padding copies of a
        # batch's last query sit at other offsets of the packed encoder
        # forward, where attention sums in another order, so they may
        # differ from it in the last bits
        by_query = {}
        for qs, k in batches[1:]:
            for q, hits in zip(qs, _engine_rows(engine.search(qs, k=k))):
                by_query.setdefault(q, hits)
        served = all(_hit_rows(answers[(c, r)])
                     == [by_query[q] for q in plan[c][r]]
                     for c in range(HTTP_CLIENTS)
                     for r in range(HTTP_REQUESTS))
        lone = sum(_hit_rows(answers[(c, 0)])
                   == _engine_rows(engine.search(plan[c][0], k=10))
                   for c in range(HTTP_CLIENTS))
        res["http"]["lone_equal"] = lone
        check(served and h["batches"] < n_req,
              f"every HTTP answer equals HybridQueryEngine.search over the "
              f"merged batch that carried it ({len(batches) - 1} batches of "
              f"{min(len(b[0]) for b in batches[1:])}-"
              f"{max(len(b[0]) for b in batches[1:])} queries, padded to "
              f"powers of two); {lone} of {HTTP_CLIENTS} first requests "
              f"also equal a lone search of their queries")

        # 3. the subprocess server: its bound port, /healthz, one /search
        line = proc.stdout.readline()
        res["serve_start_s"] = time.perf_counter() - t_spawn
        check(line.startswith("serving http://127.0.0.1:"),
              f"python -m semanticsearch_tpu_torch.cli.main serve --port 0 "
              f"printed {line.strip()!r}")
        sub = line.split()[1]
        health = _http(sub, "/healthz")
        sub_hits = _http(sub, "/search", {"queries": queries, "k": 10})
        check(health == {"ok": True, "docs": 20000}
              and _hit_rows(sub_hits["results"]) == _engine_rows(want),
              f"the subprocess server (up {res['serve_start_s']:.1f} s after "
              f"its start, host clock) answers /healthz and a "
              f"{len(queries)}-query /search as the in-process engine")
        proc.terminate()
        proc.wait(timeout=30)

        # the freshness round through the same server
        new = [f"zq{i}xv wplk{i} " + _zipf_text(rng, ctx["words"], 6)
               for i in range(2)]
        t0 = time.perf_counter()
        added = _http(base, "/add", {"chunk_ids": ["n0", "n1"],
                                     "texts": new})
        found = _http(base, "/search", {"queries": new, "k": 10})["results"]
        removed = _http(base, "/remove", {"chunk_ids": ["n0"]})
        after = _http(base, "/search", {"queries": new, "k": 10})["results"]
        compact = _http(base, "/compact", {}, timeout=600)
        final = _http(base, "/search", {"queries": new[1:], "k": 10})
        res["mutation_round_s"] = time.perf_counter() - t0
        check(added == {"added": 2, "docs": 20002}
              and [q[0]["chunk_id"] for q in found] == ["n0", "n1"]
              and removed == {"removed": 1, "docs": 20001}
              and all(h["chunk_id"] != "n0" for h in after[0])
              and compact == {"ok": True, "docs": 20001}
              and final["results"][0][0]["chunk_id"] == "n1"
              and engine.index.size == 20001,
              f"/add -> /search -> /remove -> /compact -> /search in "
              f"{res['mutation_round_s']:.2f} s (host clock): the added "
              f"chunks rank first for their own text, the removed one is "
              f"gone, and the compacted index holds 20,001 rows")
    finally:
        engine._dispatch_legs = dispatch
        srv.shutdown()
        srv.server_close()
        th.join(timeout=30)
    return res


# phase 8: the device lexical leg at the size its design serves: documents
# of 16-96 tokens drawn Zipf(1.1) from a 50,000-term vocabulary, queries of
# 2-6 terms from the same law, in 1,024-query chunks at k = 40 (K' = 64)
LEX_DOCS, LEX_VOCAB, LEX_QUERIES, LEX_CHUNK, LEX_K = 1_000_000, 50_000, 4096, 1024, 40
LEX_DENSE_TERMS, LEX_KP = 4096, 64


def _zipf_bm25(rng, n_docs, vocab, s=1.1, lengths=(16, 97)):
    """BM25Okapi statistics of a synthetic corpus made in bulk: per-document
    term counts from one numpy draw, the CSR by one sort (ascending term id
    within each document), then ``BM25Okapi.from_csr``. Terms are named
    ``t<rank>``; ids are ranks, compacted to the terms that occur."""
    from semanticsearch_tpu_torch.index.bm25 import BM25Okapi

    p = 1.0 / np.arange(1, vocab + 1) ** s
    p /= p.sum()
    n_tok = rng.integers(*lengths, size=n_docs)
    terms = np.searchsorted(np.cumsum(p), rng.random(int(n_tok.sum())),
                            side="right").clip(max=vocab - 1)
    docs = np.repeat(np.arange(n_docs, dtype=np.int64), n_tok)
    keys, tf = np.unique(docs * vocab + terms, return_counts=True)
    doc_of, term_of = np.divmod(keys, vocab)
    seen = np.zeros(vocab, bool)
    seen[term_of] = True
    new_id = np.cumsum(seen) - 1
    vocab_map = {f"t{r}": int(new_id[r]) for r in np.flatnonzero(seen)}
    indptr = np.zeros(n_docs + 1, np.int64)
    np.cumsum(np.bincount(doc_of, minlength=n_docs), out=indptr[1:])
    return BM25Okapi.from_csr(vocab_map, indptr,
                              new_id[term_of].astype(np.int32),
                              tf.astype(np.float32)), p


def phase_lexical(report):
    import torch

    from semanticsearch_tpu_torch import native
    from semanticsearch_tpu_torch.core.config import RankingConfig
    from semanticsearch_tpu_torch.index.bm25 import BM25Okapi
    from semanticsearch_tpu_torch.index.bm25_tpu import DeviceBM25

    log(f"== phase 8: the device BM25 leg at {LEX_DOCS:,} documents "
        f"(B={LEX_DENSE_TERMS} dense terms, residual, int8 weights)")
    rng = np.random.default_rng(41)
    # the bulk build against the constructor, on a small corpus: the same
    # statistics give the same top-k lists and score bits
    small, _ = _zipf_bm25(np.random.default_rng(5), 3000, 2000)
    inv = {i: t for t, i in small.vocab.items()}
    docs = [[inv[int(t)] for t, c in zip(
        small._indices[small._indptr[d]:small._indptr[d + 1]],
        small._data[small._indptr[d]:small._indptr[d + 1]])
        for _ in range(int(c))] for d in range(small.n_docs)]
    ref = BM25Okapi(docs)
    qs = [docs[i][:4] for i in range(0, 3000, 100)]
    a, b = small.get_topk_batch(qs, 20), ref.get_topk_batch(qs, 20)
    check(np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
          and np.array_equal(np.sort(small.idf), np.sort(ref.idf)),
          "BM25Okapi.from_csr (the bulk build) == the token-list "
          "constructor: idf multiset, top-20 ids and score bits")

    t0 = time.perf_counter()
    bm, p = _zipf_bm25(rng, LEX_DOCS, LEX_VOCAB)
    t_stats = time.perf_counter() - t0
    t0 = time.perf_counter()
    bm._ensure_inverted()
    t_inv = time.perf_counter() - t0
    n_post = int(bm._inv_indptr[-1])
    log(f"  corpus: {bm.n_docs:,} documents, {len(bm.vocab):,} terms, "
        f"{n_post:,} postings (mean length {bm.avgdl:.1f}); statistics "
        f"{t_stats:.1f} s, inverted {t_inv:.1f} s (host clock)")
    q_terms = np.searchsorted(np.cumsum(p), rng.random(LEX_QUERIES * 6),
                              side="right").clip(max=LEX_VOCAB - 1)
    n_q = rng.integers(2, 7, size=LEX_QUERIES)
    queries = [[f"t{r}" for r in q_terms[6 * i: 6 * i + n]]
               for i, n in enumerate(n_q)]

    threads = RankingConfig().resolved_bm25_threads()
    bm.get_topk_batch(queries[:64], LEX_K, n_threads=threads)  # warm
    t0 = time.perf_counter()
    host_i, host_s = bm.get_topk_batch(queries, LEX_K, n_threads=threads)
    t_host = time.perf_counter() - t0
    log(f"  native host top-k ({threads} threads): {LEX_QUERIES} queries in "
        f"{t_host:.3f} s = {LEX_QUERIES / t_host:.1f} QPS")

    t0 = time.perf_counter()
    leg = DeviceBM25(bm, n_dense_terms=LEX_DENSE_TERMS, topk_device=LEX_KP,
                     query_chunk=LEX_CHUNK, residual=True, weights="int8")
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    CT = leg._CT
    log(f"  device matrix: {tuple(CT.shape)} int8 ({CT.numel() / 1e9:.2f} "
        f"GB) built and uploaded in {t_build:.1f} s (host clock)")
    leg.get_topk_batch(queries[:LEX_CHUNK], LEX_K)  # warm: allocator, sort
    native.reset_counts()
    leg.stats.update(dict.fromkeys(leg.stats, 0))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dev_i, dev_s = leg.get_topk_batch(queries, LEX_K)
    t_leg = time.perf_counter() - t0
    st = leg.stats
    cert = 1.0 - st["fallbacks"] / st["queries"]
    log(f"  device leg: {LEX_QUERIES} queries in {t_leg:.3f} s (host "
        f"clock) = {LEX_QUERIES / t_leg:.1f} QPS; certified "
        f"{100 * cert:.2f} % ({st['fallbacks']} host fallbacks); split (s) "
        + ", ".join(f"{k[2:-2]} {v:.3f}" for k, v in st.items()
                    if k.startswith("t_")))
    check(np.array_equal(dev_i, host_i) and np.array_equal(dev_s, host_s)
          and native.BM25_RARE_TOUCH_CALLS > 0
          and native.BM25_DEVICE_POST_CALLS > 0,
          f"all {LEX_QUERIES} device-leg id lists and score bits == the "
          "native host top-k")

    # the device phase of one chunk alone (densify, three int8 products a
    # score chunk, the f32 combine, the selection and merge), by CUDA
    # events; its bound: the three products at the int8 peak, or one read
    # of the matrix
    wq = torch.from_numpy(leg._split(queries[:LEX_CHUNK])[0]).cuda()
    ms = time_ms(lambda: leg._select(wq, LEX_KP))
    W8 = leg._densify(wq)[0]
    Bp, d_pad = leg._Bp, CT.shape[0]
    ops = 3 * 2.0 * leg._rows * Bp * d_pad
    b_ms, b_by = bound_ms(ops, float(CT.numel()), PEAK_INT8_OPS)
    sc = leg.score_chunk_cols
    mm_one = time_ms(lambda: torch._int_mm(W8[0], CT[:sc, :Bp].t()))
    # the same product on a row-major right operand (the JAX package's
    # terms x documents layout): why the matrix lives transposed
    row_major = CT[:sc, :Bp].t().contiguous()
    mm_row = time_ms(lambda: torch._int_mm(W8[0], row_major))
    del row_major
    mm_all = time_ms(lambda: [torch._int_mm(W8[j], CT[c: c + sc, o: o + Bp]
                                            .t())
                              for c in range(0, d_pad, sc)
                              for j, o in ((0, 0), (1, 0), (2, Bp))])
    log(f"  device phase of one {LEX_CHUNK}-query chunk: {ms:.3f} ms "
        f"(bound {b_ms:.3f} ms by {b_by}: {ops:.3e} int8 operations, "
        f"{CT.numel() / 1e9:.2f} GB read); torch._int_mm alone: "
        f"{mm_one:.3f} ms a product of one {sc}-column score chunk "
        f"({mm_row:.3f} ms on a row-major right operand), {mm_all:.3f} ms "
        f"for the chunk's {3 * -(-d_pad // sc)} products")
    del W8, wq

    # the bf16 weights on one chunk (products bf16 x bf16 -> f32)
    del leg, CT
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    leg16 = DeviceBM25(bm, n_dense_terms=LEX_DENSE_TERMS, topk_device=LEX_KP,
                       query_chunk=LEX_CHUNK, residual=True, weights="bf16")
    b16_i, b16_s = leg16.get_topk_batch(queries[:LEX_CHUNK], LEX_K)
    wq = torch.from_numpy(leg16._split(queries[:LEX_CHUNK])[0]).cuda()
    ms16 = time_ms(lambda: leg16._select(wq, LEX_KP))
    cert16 = 1.0 - leg16.stats["fallbacks"] / leg16.stats["queries"]
    log(f"  bf16 weights, one chunk: built and served in "
        f"{time.perf_counter() - t0:.1f} s; device phase {ms16:.3f} ms; "
        f"certified {100 * cert16:.2f} % ({leg16.stats['fallbacks']} host "
        f"fallbacks)")
    check(np.array_equal(b16_i, host_i[:LEX_CHUNK])
          and np.array_equal(b16_s, host_s[:LEX_CHUNK]),
          f"bf16 weights: the {LEX_CHUNK} id lists and score bits == the "
          "native host top-k")
    del leg16, wq
    torch.cuda.empty_cache()
    lex = {"docs": bm.n_docs, "postings": n_post, "dense_terms": LEX_DENSE_TERMS,
           "topk_device": LEX_KP, "k": LEX_K, "queries": LEX_QUERIES,
           "chunk_ms": ms, "bound_ms": b_ms, "bound_by": b_by,
           "int_mm_one_ms": mm_one, "int_mm_rowmajor_ms": mm_row,
           "int_mm_chunk_ms": mm_all,
           "leg_s": t_leg, "leg_qps": LEX_QUERIES / t_leg,
           "certified": cert, "fallbacks": int(st["fallbacks"]),
           "host_topk_s": t_host, "host_qps": LEX_QUERIES / t_host,
           "host_threads": threads, "bf16_chunk_ms": ms16,
           "bf16_certified": cert16, "stats_s": t_stats,
           "build_s": t_build}
    report["device_bm25"] = lex
    log(json.dumps({"device_bm25": lex}))
    return bm, queries, dev_i, dev_s


# phase 12: the sharded paths on SHARDS virtual shards of the one card (a
# mesh may repeat a device): the dense shard of 1,250,003 rows (n_pad = 1),
# the fused top-k's shape, the ring, the data- and tensor-parallel encoder,
# the pipeline's SP route and the CLI; phase 12b (after phase 8) shards the
# device BM25 leg's columns
SHARDS = 4
SHARD_ROWS, SHARD_QUERIES, SHARD_K = 1_250_003, 32768, 10
SHARD_FUSED = (10000, 22000, 200)  # queries, rows, k
SHARD_ENCODE_TEXTS = 1024
SHARD_TRAIN_PAIRS = 64
SHARD_TRAIN_EPOCHS = 4  # one step each
# TP against the unsharded step, bf16: the loss after an update, and the
# cosine of the two master updates of every parameter. A correct step on
# an H100 gives a least cosine of 0.983 (a LayerNorm bias: Adam turns bf16
# rounding into whole steps where a gradient is near zero); a shard's
# dropped gradient slice takes its parameter's to about sqrt(3/4)
TP_LOSS_RTOL = 1e-3
TP_UPDATE_COS = 0.97


def _virtual_mesh(**spec):
    import torch

    from semanticsearch_tpu_torch.core.mesh import MeshSpec, make_mesh

    n = spec.get("data", 1) * spec.get("model", 1)
    return make_mesh(MeshSpec(**spec), [torch.device("cuda", 0)] * n)


def phase_shard(report, ctx):
    import torch

    log(f"== phase 12: sharding on {SHARDS} virtual shards of the one card "
        "(mesh devices [cuda:0] x 4; main path)")
    t_phase = time.perf_counter()
    res = {"launches": {}}
    _shard_dense(report, res)
    _shard_fused(report, res)
    _shard_chunk(report, ctx, res)
    _shard_encoder(report, ctx, res)
    _shard_cli(report, ctx, res)
    torch.cuda.synchronize()
    res["phase_s"] = time.perf_counter() - t_phase
    for key, names in (("segtopk", ("dense_segtopk", "cli_segtopk")),
                       ("pass_b", ("dense_pass_b", "cli_pass_b")),
                       ("topk_fused", ("fused",)),
                       ("flash", ("encode_flash", "pipeline_flash",
                                  "train_flash", "cli_flash")),
                       ("similarity", ("pipeline_similarity",))):
        report[key]["shard_launches"] = sum(res["launches"][n] for n in names)
    report["shard"] = res
    log(json.dumps({"shard": res}))


def _shard_dense(report, res):
    import torch

    from semanticsearch_tpu_torch.core.config import IndexConfig
    from semanticsearch_tpu_torch.data import synth
    from semanticsearch_tpu_torch.index.engine import EmbeddingIndex
    from semanticsearch_tpu_torch.ops import topk
    from semanticsearch_tpu_torch.parallel.sharding import merge_candidates

    n, d, q, k = SHARD_ROWS, 384, SHARD_QUERIES, SHARD_K
    mesh = _virtual_mesh(data=SHARDS)
    cfg = IndexConfig(block_rows=32768, seg_split=8)
    corpus = synth.corpus(n, d, torch.bfloat16, "cuda")
    queries = synth.corpus(q, d, torch.bfloat16, "cuda", start=20_000_000)
    index = EmbeddingIndex.build(corpus, mesh=mesh, cfg=cfg, normalize=False)
    shards = index._shards
    rows = shards[0].shape[0]
    n_pad = rows * SHARDS - n
    check(len(shards) == SHARDS and n_pad == 1 and index.size == n,
          f"EmbeddingIndex.build on the mesh: {SHARDS} shards of {rows:,} "
          f"rows, {n_pad} pad row")
    index.search_device(queries, k=k)  # warm-up
    zero_counts()
    vals, idx = index.search_device(queries, k=k)
    torch.cuda.synchronize()
    res["launches"]["dense_segtopk"] = topk.SEGTOPK_LAUNCHES
    res["launches"]["dense_pass_b"] = topk.PASS_B_LAUNCHES
    check(topk.SEGTOPK_LAUNCHES == SHARDS and topk.PASS_B_LAUNCHES == SHARDS,
          f"one pass-A and one pass-B launch a shard: "
          f"{topk.SEGTOPK_LAUNCHES}, {topk.PASS_B_LAUNCHES}")
    sample = torch.arange(0, q, q // 128, device="cuda")[:128]
    rv, ri = topk.topk_scores_ref(queries[sample], corpus, k=k, block_n=65536)
    hits = sum(len(set(a) & set(b)) for a, b in
               zip(idx[sample].tolist(), ri.tolist()))
    recall = hits / (128 * k)
    check(recall == 1.0, f"recall@10 = {recall} on 128 sampled queries "
          "against the plain exact top-k")
    single = EmbeddingIndex(corpus, n, cfg)  # the unsharded engine
    uv, ui = single.search_device(queries, k=k + 1)
    err, bad, tied = topk_agree(vals, idx, uv, ui, tol=1e-5, gap=1e-6)
    check(err <= 1e-5 and bad == 0,
          f"ids and order == the unsharded engine's wherever adjacent scores "
          f"differ by more than 1e-6 ({tied} positions inside such ties); "
          f"scores max abs err {err:.2e}")
    res["dense_ms"] = time_ms(lambda: index.search_device(queries, k=k),
                              reps=3)
    res["dense_unsharded_ms"] = time_ms(
        lambda: single.search_device(queries, k=k), reps=3)
    # the split: each shard's pass A (k_local = k + n_pad, k_sel one more),
    # each shard's pass B, the merge of the four lists
    L2 = cfg.block_rows // 128 // cfg.seg_split
    k_local = k + n_pad
    k_sel = k_local + 1
    res["pass_a_ms"] = time_ms(lambda: [topk.segtopk_pass_a(
        queries, c, rows, L2, k_sel) for c in shards], reps=3)
    segs = [topk.segtopk_pass_a(queries, c, rows, L2, k_sel)[1]
            for c in shards]
    res["pass_b_max_abs_err"] = max(
        check_pass_b(queries, c, s_, rows, L2, k_local,
                     f"on shard {j} (Q={q}, k_sel {k_sel}, L2 {L2})")
        for j, (c, s_) in enumerate(zip(shards, segs)))
    res["pass_b_ms"] = time_ms(lambda: [topk.pass_b_rescore(
        queries, c, s_, rows, L2, k_local)
        for c, s_ in zip(shards, segs)], reps=5)
    res["pass_b_plain_ms"] = time_ms(lambda: [topk.pass_b_rescore_plain(
        queries, c, s_, rows, L2, k_local)
        for c, s_ in zip(shards, segs)], reps=2)
    lists = [topk.pass_b_rescore(queries, c, s_, rows, L2, k_local)
             for c, s_ in zip(shards, segs)]
    sv = torch.stack([v for v, _ in lists])
    si = torch.stack([i.long() + j * rows for j, (_, i) in enumerate(lists)])
    sv = torch.where(si < n, sv, torch.full_like(sv, -float("inf")))
    res["merge_ms"] = time_ms(lambda: merge_candidates(mesh, sv, si, k),
                              reps=5)
    mv, mi = merge_candidates(mesh, sv, si, k)
    check(torch.equal(mv, vals) and torch.equal(mi.int(), idx),
          "the split's parts give the engine's lists bit for bit")
    # the two passes' bounds: pass A by its products (the corpus and every
    # shard's copy of the queries read once), pass B by its gathered bytes
    res["pass_a_bound_ms"], res["pass_a_bound_by"] = bound_ms(
        2.0 * q * n * d, 2.0 * (n * d + SHARDS * q * d)
        + 8.0 * SHARDS * q * k_sel)
    pb_bounds = [pass_b_bound(s_, rows, L2, d, k_local, 2) for s_ in segs]
    res["pass_b_bound_ms"] = sum(b[0] for b in pb_bounds)
    res["pass_b_bound_by"] = pb_bounds[0][1]
    res["pass_b_gathered_bound_ms"] = sum(b[2] for b in pb_bounds)
    res["dense_bound_ms"] = res["pass_a_bound_ms"] + res["pass_b_bound_ms"]
    res["dense_bound_by"] = (f"pass A {res['pass_a_bound_by']} + pass B "
                             f"{res['pass_b_bound_by']}")
    log(f"  dense shard {n:,} x {d} bf16 over {SHARDS} shards, {q} queries "
        f"at k = {k}: {res['dense_ms']:.2f} ms (unsharded engine "
        f"{res['dense_unsharded_ms']:.2f} ms); split: pass A "
        f"{res['pass_a_ms']:.2f} ms ({SHARDS} launches, k_sel {k_sel}; bound "
        f"{res['pass_a_bound_ms']:.2f} ms, {res['pass_a_bound_by']}), pass B "
        f"{res['pass_b_ms']:.2f} ms (plain {res['pass_b_plain_ms']:.2f} ms; "
        f"bound {res['pass_b_bound_ms']:.2f} ms, {res['pass_b_bound_by']}; "
        f"{res['pass_b_gathered_bound_ms']:.2f} ms with a query's rows once "
        f"a query), "
        f"merge {res['merge_ms']:.3f} ms; bound {res['dense_bound_ms']:.2f} "
        f"ms ({res['dense_bound_by']}); recall@10 {recall}")
    del index, single, shards, corpus, queries, lists, segs, sv, si
    torch.cuda.empty_cache()


def _shard_fused(report, res):
    import torch

    from semanticsearch_tpu_torch.core.mesh import hybrid_mesh
    from semanticsearch_tpu_torch.data import synth
    from semanticsearch_tpu_torch.ops import topk
    from semanticsearch_tpu_torch.parallel.sharding import (
        shard_corpus, sharded_topk, sharded_topk_2level)

    q, n, k = SHARD_FUSED
    mesh = _virtual_mesh(data=SHARDS)
    queries = synth.corpus(q, 384, torch.bfloat16, "cuda", start=30_000_000)
    corpus = synth.corpus(n, 384, torch.bfloat16, "cuda")
    shards = shard_corpus(corpus, mesh)
    kw = dict(k=k)
    sharded_topk(queries, shards, mesh, **kw)  # warm-up
    zero_counts()
    vals, idx = sharded_topk(queries, shards, mesh, **kw)
    torch.cuda.synchronize()
    res["launches"]["fused"] = topk.TOPK_FUSED_LAUNCHES
    check(topk.TOPK_FUSED_LAUNCHES == SHARDS,
          f"k = {k} at {q:,} queries: one fused top-k launch a shard "
          f"({topk.TOPK_FUSED_LAUNCHES})")
    uv, ui = topk.topk_scores_fused(queries, corpus, k + 1)
    err, bad, tied = topk_agree(vals, idx, uv, ui, tol=1e-5, gap=1e-6)
    check(err <= 1e-5 and bad == 0,
          f"== the unsharded fused top-{k} outside near-ties ({tied} inside); "
          f"max abs err {err:.2e}")
    two = _virtual_mesh(data=SHARDS)  # the same shards on (dcn 2, data 2)
    two = hybrid_mesh(2, list(two.devices.flat))
    v2, i2 = sharded_topk_2level(queries, shards, two, **kw)
    check(torch.equal(v2, vals) and torch.equal(i2, idx),
          "sharded_topk_2level on (dcn 2, data 2) == the flat merge, bit for "
          "bit")
    res["fused_ms"] = time_ms(lambda: sharded_topk(queries, shards, mesh,
                                                   **kw), reps=5)
    res["fused_unsharded_ms"] = time_ms(
        lambda: topk.topk_scores_fused(queries, corpus, k), reps=5)
    log(f"  fused top-{k}, {q:,} x {n:,} over {SHARDS} shards: "
        f"{res['fused_ms']:.3f} ms (unsharded {res['fused_unsharded_ms']:.3f} "
        "ms)")
    del shards, corpus, queries


def _shard_chunk(report, ctx, res):
    import torch

    from semanticsearch_tpu_torch.chunking import pipeline as chunk_pipeline
    from semanticsearch_tpu_torch.core.mesh import hybrid_mesh
    from semanticsearch_tpu_torch.models.encoder import SentenceEncoder
    from semanticsearch_tpu_torch.ops import flash_attention as fa
    from semanticsearch_tpu_torch.ops import similarity as sim
    from semanticsearch_tpu_torch.parallel import ring_similarity
    from semanticsearch_tpu_torch.parallel.sharding import shard_corpus

    mesh = _virtual_mesh(data=SHARDS)
    encoder = ctx["encoder"]
    E = encoder.encode_device(ctx["long_sents"], batch_size=2048)
    zero_counts()
    ring = ring_similarity.sharded_doc_similarity(E, mesh)
    check(sim.SIM_LAUNCHES == 0 and ring.shape == (E.shape[0],) * 2,
          "the ring's tiles are plain f32 products (no Gram kernel launch)")
    S = sim.similarity_matrix(E)
    err = float((torch.from_numpy(ring).cuda() - S).abs().max())
    check(err <= 1e-5, f"sharded_doc_similarity of the {E.shape[0]:,}-"
          f"sentence document == similarity_matrix (the kernel): max abs "
          f"err {err:.2e} <= 1e-5")
    res["ring_max_abs_err"] = err
    res["ring_ms"] = time_ms(
        lambda: ring_similarity.sharded_doc_similarity(E, mesh), reps=3)
    # the ring's device part alone (no pad, no copy of S to the host)
    blocks = shard_corpus(torch.nn.functional.pad(
        E, (0, 0, 0, (-E.shape[0]) % SHARDS)), mesh)
    res["ring_device_ms"] = time_ms(
        lambda: ring_similarity.ring_similarity_matrix(blocks, mesh), reps=3)
    res["ring_kernel_ms"] = time_ms(lambda: sim.similarity_matrix(E), reps=3)

    # the grouping run of phase 6 on the mesh: the encoder data parallel,
    # the 640-sentence document through the ring. Held to phase 6's run on
    # the same data-parallel encoder without the mesh: the mesh's encoder
    # pads each shard's rows to their bucket where phase 6's one device
    # packs them, so the two embed within bf16 rounding of each other, and
    # a sentence group at a boundary may differ (counted, not checked)
    g_tsv, g_cfg, g_map6 = ctx["group"]
    cfg = g_cfg.override(chunking={"sp_min_sentences": GROUP_LONG_SENTENCES})
    dp = SentenceEncoder(encoder.cfg, mesh=mesh,
                         state_dict=encoder.master.state_dict(),
                         tokenizer=encoder.tokenizer)
    chunk_pipeline.ChunkPipeline(cfg, encoder=dp).run(
        g_tsv, os.path.join(ctx["tmp"], "group_dp"), write_chunk_map=True)
    g_map = os.path.join(ctx["tmp"], "group_dp", f"{cfg.name}_chunk_map.tsv")
    calls = []
    doc_sim = ring_similarity.sharded_doc_similarity

    def counting(emb, m):
        calls.append(int(emb.shape[0]))
        return doc_sim(emb, m)

    ring_similarity.sharded_doc_similarity = counting
    zero_counts()
    t0 = time.perf_counter()
    try:
        out = chunk_pipeline.ChunkPipeline(cfg, encoder=dp, mesh=mesh).run(
            g_tsv, os.path.join(ctx["tmp"], "group_mesh"),
            write_chunk_map=True)
    finally:
        ring_similarity.sharded_doc_similarity = doc_sim
    torch.cuda.synchronize()
    res["pipeline_s"] = time.perf_counter() - t0
    res["launches"]["pipeline_flash"] = fa.FLASH_LAUNCHES
    res["launches"]["pipeline_similarity"] = sim.SIM_LAUNCHES
    mine = _boundaries(os.path.join(ctx["tmp"], "group_mesh",
                                    f"{cfg.name}_chunk_map.tsv"))
    theirs = _boundaries(g_map)
    _, ids = _coverage(os.path.join(ctx["tmp"], "group_mesh",
                                    f"{cfg.name}_chunk_map.tsv"))
    _, ref_ids = _coverage(g_map)
    res["pipeline_docs_differing"] = sum(mine[d_] != theirs.get(d_)
                                         for d_ in mine)
    packed = _boundaries(g_map6)
    res["pipeline_docs_differing_packed"] = sum(mine[d_] != packed.get(d_)
                                                for d_ in mine)
    check(calls == [GROUP_LONG_SENTENCES] and out["fallbacks"] == 0
          and sim.SIM_LAUNCHES > 0 and fa.FLASH_LAUNCHES > 0
          and ids == ref_ids,
          f"ChunkPipeline(mesh=...) under semantic_grouping: the "
          f"{GROUP_LONG_SENTENCES}-sentence document through the ring "
          f"({calls}), {sim.SIM_LAUNCHES} Gram launches for the rest, "
          f"{fa.FLASH_LAUNCHES} flash launches; chunk ids == the unsharded "
          f"run on the same encoder ({res['pipeline_docs_differing']} "
          f"documents' sentence groups differ; from phase 6's packed "
          f"encoder, {res['pipeline_docs_differing_packed']})")

    # the same four shards as a hybrid (dcn 2, data 2) mesh: the ring runs
    # over data inside slice 0, dcn replicated; the matrix and the grouping
    # run against the single-slice (data 4) results above
    hmesh = hybrid_mesh(2, list(mesh.devices.flat))
    hring = ring_similarity.sharded_doc_similarity(E, hmesh)
    res["ring_hybrid_max_abs_err"] = float(np.abs(hring - ring).max())
    check(hring.shape == ring.shape and res["ring_hybrid_max_abs_err"] <= 1e-5,
          f"sharded_doc_similarity on (dcn 2, data 2) == on (data 4): max abs "
          f"err {res['ring_hybrid_max_abs_err']:.2e} <= 1e-5")
    calls.clear()
    ring_similarity.sharded_doc_similarity = counting
    try:
        hout = chunk_pipeline.ChunkPipeline(cfg, encoder=dp, mesh=hmesh).run(
            g_tsv, os.path.join(ctx["tmp"], "group_hybrid"),
            write_chunk_map=True)
    finally:
        ring_similarity.sharded_doc_similarity = doc_sim
    h_map = os.path.join(ctx["tmp"], "group_hybrid",
                         f"{cfg.name}_chunk_map.tsv")
    check(calls == [GROUP_LONG_SENTENCES] and hout["fallbacks"] == 0
          and _coverage(h_map)[1] == ids and _boundaries(h_map) == mine,
          f"ChunkPipeline on (dcn 2, data 2): the {GROUP_LONG_SENTENCES}-"
          f"sentence document through the ring ({calls}); chunk map == the "
          "(data 4) mesh's")
    log(f"  ring over {SHARDS} shards of the {E.shape[0]:,}-sentence "
        f"document: {res['ring_ms']:.2f} ms with S on the host, its device "
        f"part {res['ring_device_ms']:.2f} ms (the Gram kernel alone "
        f"{res['ring_kernel_ms']:.2f} ms); the grouping pipeline on the mesh "
        f"{res['pipeline_s']:.2f} s (host clock)")
    del dp, E, S, blocks


def _shard_encoder(report, ctx, res):
    import torch

    from semanticsearch_tpu_torch.data.tsv import read_tsv
    from semanticsearch_tpu_torch.models.encoder import SentenceEncoder
    from semanticsearch_tpu_torch.ops import flash_attention as fa
    from semanticsearch_tpu_torch.train.encoder_train import (
        ContrastiveConfig, ContrastiveEncoderTrainer)

    encoder = ctx["encoder"]
    texts = [r["chunk_text"] for _, r in zip(range(SHARD_ENCODE_TEXTS),
                                             read_tsv(ctx["tsv"]))]
    state = encoder.master.state_dict()
    dp = SentenceEncoder(encoder.cfg, mesh=_virtual_mesh(data=SHARDS),
                         state_dict=state, tokenizer=encoder.tokenizer)
    one = encoder.encode(texts)
    dp.encode(texts[:8])  # warm-up
    zero_counts()
    got = dp.encode(texts)
    torch.cuda.synchronize()
    batches = sum(-(-len(idxs) // 256) for _, idxs in dp._groups(texts))
    want = batches * SHARDS * encoder.cfg.num_layers
    res["launches"]["encode_flash"] = fa.FLASH_LAUNCHES
    cos = float((torch.from_numpy(got) * torch.from_numpy(one)).sum(1).min())
    err = float(np.abs(got - one).max())
    check(fa.FLASH_LAUNCHES == want and cos >= 0.999,
          f"data-parallel encode over {SHARDS} shards, {len(texts)} texts: "
          f"{fa.FLASH_LAUNCHES} flash launches == {batches} batches x "
          f"{SHARDS} shards x {encoder.cfg.num_layers} layers; least cosine "
          f"to the single-device encode {cos:.5f} >= 0.999 (max abs "
          f"{err:.2e}, bf16)")
    res["dp_encode_ms"] = time_ms(lambda: dp.encode_device(texts), reps=3)
    res["encode_ms"] = time_ms(lambda: encoder.encode_device(texts), reps=3)
    del dp

    # TP on (data 1, model 4): stock attention, as in the JAX package
    stock_cfg = dataclasses.replace(encoder.cfg, attention="stock")
    tp = SentenceEncoder(stock_cfg, mesh=_virtual_mesh(data=1, model=SHARDS),
                         state_dict=state, tokenizer=encoder.tokenizer)
    ref = SentenceEncoder(stock_cfg, device="cuda", state_dict=state,
                          tokenizer=encoder.tokenizer)
    check(tp._tp == SHARDS, f"tensor parallel over {SHARDS} model shards")
    e_tp, e_ref = tp.encode(texts[:256]), ref.encode(texts[:256])
    cos_tp = float((torch.from_numpy(e_tp) * torch.from_numpy(e_ref))
                   .sum(1).min())
    check(cos_tp >= 0.999, f"TP encode == the unsharded stock encode: least "
          f"cosine {cos_tp:.5f} >= 0.999 (max abs "
          f"{float(np.abs(e_tp - e_ref).max()):.2e}, bf16)")
    res["tp_encode_ms"] = time_ms(lambda: tp.encode_device(texts[:256]),
                                  reps=3)
    pairs = [(f"query {t[:40]}", t) for t in texts[:SHARD_TRAIN_PAIRS]]
    # one step an epoch; the schedule's first step warms up from 0.0, so
    # the losses of epochs 2 and 3 are the ones after an update
    ccfg = ContrastiveConfig(epochs=SHARD_TRAIN_EPOCHS,
                             batch_size=SHARD_TRAIN_PAIRS,
                             use_hard_negatives=False, seed=0)
    before = {n_: p.detach().clone() for n_, p in tp.master.named_parameters()}
    zero_counts()
    t0 = time.perf_counter()
    h_tp = ContrastiveEncoderTrainer(tp, ccfg).fit(pairs)
    torch.cuda.synchronize()
    res["tp_train_s"] = time.perf_counter() - t0
    res["launches"]["train_flash"] = fa.FLASH_LAUNCHES
    h_ref = ContrastiveEncoderTrainer(ref, ccfg).fit(pairs)
    ref_p = dict(ref.master.named_parameters())
    leaf_cos = {}
    for n_, p in tp.master.named_parameters():
        if n_.endswith("attn.key.bias"):
            continue  # its true gradient is zero: Adam scales up noise
        d_tp = (p.detach() - before[n_]).flatten()
        d_ref = (ref_p[n_].detach() - before[n_]).flatten()
        norms = float(d_tp.norm() * d_ref.norm())
        leaf_cos[n_] = (float(d_tp @ d_ref) / norms if norms
                        else float(torch.equal(d_tp, d_ref)))
    worst = min(leaf_cos, key=leaf_cos.get)
    rel = [abs(a["loss"] - b["loss"]) / b["loss"]
           for a, b in zip(h_tp[2:], h_ref[2:])]
    check(max(rel) <= TP_LOSS_RTOL and leaf_cos[worst] >= TP_UPDATE_COS
          and fa.FLASH_LAUNCHES == 0,
          f"TP contrastive steps (batch {SHARD_TRAIN_PAIRS}): losses after "
          f"an update {[round(h['loss'], 5) for h in h_tp[2:]]} vs unsharded "
          f"{[round(h['loss'], 5) for h in h_ref[2:]]} (rel {max(rel):.1e} <= "
          f"{TP_LOSS_RTOL}); cosine of the two master updates, parameter by "
          f"parameter, least {leaf_cos[worst]:.4f} ({worst}) >= "
          f"{TP_UPDATE_COS}; no flash launch under TP")
    res["tp_loss_rel"] = max(rel)
    res["tp_update_cosine_min"] = leaf_cos[worst]
    log(f"  encode of {len(texts)} texts: data parallel "
        f"{res['dp_encode_ms']:.2f} ms, one device {res['encode_ms']:.2f} "
        f"ms; TP encode of 256 texts {res['tp_encode_ms']:.2f} ms; TP "
        f"training {res['tp_train_s']:.2f} s for {SHARD_TRAIN_EPOCHS} steps "
        "(host clock)")
    del tp, ref


def _shard_cli(report, ctx, res):
    import torch

    from semanticsearch_tpu_torch.cli import main as cli_main
    from semanticsearch_tpu_torch.core.mesh import local_mesh
    from semanticsearch_tpu_torch.index.query_engine import HybridQueryEngine
    from semanticsearch_tpu_torch.ops import flash_attention as fa
    from semanticsearch_tpu_torch.ops import topk

    argv, want = ctx["cli_search"]
    meshes = []
    load = vars(HybridQueryEngine)["load"]  # the classmethod itself

    def recording(*args, **kw):
        meshes.append(kw.get("mesh"))
        return load.__get__(None, HybridQueryEngine)(*args, **kw)

    HybridQueryEngine.load = recording
    local = cli_main._local_mesh
    try:
        rc, out = _cli(argv)
        cli_main._local_mesh = lambda args: _virtual_mesh(data=SHARDS)
        zero_counts()
        rc4, out4 = _cli(argv)
        torch.cuda.synchronize()
    finally:
        HybridQueryEngine.load = load
        cli_main._local_mesh = local
    res["launches"]["cli_segtopk"] = topk.SEGTOPK_LAUNCHES
    res["launches"]["cli_pass_b"] = topk.PASS_B_LAUNCHES
    res["launches"]["cli_flash"] = fa.FLASH_LAUNCHES
    check(rc == 0 and out == want and meshes[0] == local_mesh("cuda")
          and meshes[0].shape == {"data": 1, "model": 1},
          "semsearch-torch search --device cuda through local_mesh() (one "
          "card, the unsharded path): stdout == phase 11's")
    check(rc4 == 0 and out4 == want and meshes[1].shape["data"] == SHARDS
          and topk.SEGTOPK_LAUNCHES == topk.PASS_B_LAUNCHES == SHARDS,
          f"the same search with the CLI's mesh swapped for {SHARDS} virtual "
          f"shards: stdout == phase 11's, {topk.SEGTOPK_LAUNCHES} pass-A and "
          f"{topk.PASS_B_LAUNCHES} pass-B launches (one each a shard)")


def phase_shard_lexical(report, lex):
    """Phase 12b: the phase-8 leg's matrix column-sharded over SHARDS
    virtual shards; every list and score against the unsharded leg's."""
    import torch

    from semanticsearch_tpu_torch.index.bm25_tpu import DeviceBM25

    log(f"== phase 12b: the device BM25 leg column-sharded over {SHARDS} "
        f"virtual shards ({LEX_DOCS:,} documents)")
    bm, queries, dev_i, dev_s = lex
    t0 = time.perf_counter()
    leg = DeviceBM25(bm, n_dense_terms=LEX_DENSE_TERMS, topk_device=LEX_KP,
                     query_chunk=LEX_CHUNK, residual=True, weights="int8",
                     mesh=_virtual_mesh(data=SHARDS))
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    leg.get_topk_batch(queries[:LEX_CHUNK], LEX_K)  # warm
    leg.stats.update(dict.fromkeys(leg.stats, 0))
    t0 = time.perf_counter()
    got_i, got_s = leg.get_topk_batch(queries, LEX_K)
    t_leg = time.perf_counter() - t0
    check(len(leg._CTs) == SHARDS and np.array_equal(got_i, dev_i)
          and np.array_equal(got_s, dev_s),
          f"all {len(queries)} id lists and score bits of the {SHARDS}-way "
          f"column-sharded leg == the unsharded leg's (certified "
          f"{100 * (1 - leg.stats['fallbacks'] / leg.stats['queries']):.2f} "
          "%)")
    wq = torch.from_numpy(leg._split(queries[:LEX_CHUNK])[0]).cuda()
    ms = time_ms(lambda: leg._select(wq, LEX_KP))
    out = {"build_s": t_build, "leg_s": t_leg, "chunk_ms": ms,
           "fallbacks": int(leg.stats["fallbacks"]),
           "unsharded_chunk_ms": report["device_bm25"]["chunk_ms"]}
    report["shard"]["device_bm25"] = out
    log(f"  built in {t_build:.1f} s (host clock); {len(queries)} queries in "
        f"{t_leg:.3f} s; device phase of one chunk {ms:.3f} ms (unsharded "
        f"{out['unsharded_chunk_ms']:.3f} ms)")
    log(json.dumps({"shard_device_bm25": out}))
    del leg, wq
    torch.cuda.empty_cache()


MP_PROCESSES = 2
MP_DEVICE = "cuda:0"       # both processes' rows and kernels
MP_STEPS = 4               # contrastive steps, then MLM steps, batch 64
MP_GRAD_RTOL = 1e-5        # step 1's flat gradient, against its norm
MP_TIMEOUT_S = 300


def _mp_train(mesh, data):
    """Phase 13's training on ``mesh``, each trainer from the seed-0
    default encoder under flash (Adam turns rounding-level differences in
    the gradients of parameters whose true gradient is zero into whole
    steps, so a trainer started from the other's result would start from
    masters that differ between runs): MP_STEPS contrastive steps
    (ContrastiveConfig's batch 64 at 64 + 256 tokens, no hard negatives)
    and MP_STEPS MLM steps (MLMConfig's batch 64 at 128 tokens), each
    trainer one epoch. Returns (a JSON-able record, each trainer's step-1
    flat gradient on the host): per-step losses (MLM's summed over the
    processes), the rows of every ``train_forward`` call, ms a step by
    CUDA events after a warm-up step, the gradient all-reduce's ms in each
    of those steps (CUDA events on either side of it, so the span holds
    the wait for the other process too), flash launches and the masters'
    digest after each trainer."""
    import hashlib

    import torch

    from semanticsearch_tpu_torch.core import distributed
    from semanticsearch_tpu_torch.core.config import EncoderConfig
    from semanticsearch_tpu_torch.models.encoder import SentenceEncoder
    from semanticsearch_tpu_torch.ops import flash_attention as fa
    from semanticsearch_tpu_torch.train import encoder_train as et
    from semanticsearch_tpu_torch.train import optim
    from semanticsearch_tpu_torch.train.mlm_pretrain import (MLMConfig,
                                                             MLMPretrainer)

    res = {"rows": [], "reduce_ms": {}, "losses": {}, "ms": {},
           "digest": {}, "launches": {}}
    grads, spans = {}, {}
    reduce, name = et.all_reduce_flat, None

    def timed_reduce(*args, **kw):  # CUDA events: no synchronize added
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        reduce(*args, **kw)
        ev[1].record()
        spans.setdefault(name, []).append(ev)

    et.all_reduce_flat = timed_reduce
    trainers = (
        ("contrastive", lambda enc: et.ContrastiveEncoderTrainer(
            enc, et.ContrastiveConfig(epochs=1, use_hard_negatives=False,
                                      seed=0)),
         [tuple(p) for p in data["pairs"]]),
        ("mlm", lambda enc: MLMPretrainer(enc, MLMConfig(epochs=1)),
         data["texts"]))
    try:
        for name, make, inputs in trainers:
            enc = SentenceEncoder(EncoderConfig(attention="flash"),
                                  mesh=mesh, seed=0)
            res["params"] = sum(p.numel() for p in enc.master.parameters())
            forward = enc._mesh_apply

            def counted(ids, masks, *args, _fwd=forward, **kw):
                res["rows"].append(sum(int(x.shape[0]) for x in ids))
                return _fwd(ids, masks, *args, **kw)

            enc._mesh_apply = counted  # rows this process forwards
            trainer = make(enc)
            losses, loss_fn = [], trainer._loss

            def recorded(*args, _fn=loss_fn, _out=losses):
                loss = _fn(*args)
                _out.append(loss.detach())
                return loss

            trainer._loss = recorded
            zero_counts()
            with _StepTimer() as st:
                timed = optim.Optimizer.step

                def first_grad(opt, _name=name, _timed=timed):
                    if _name not in grads:
                        grads[_name] = torch.cat([
                            (p.grad if p.grad is not None
                             else torch.zeros_like(p)).reshape(-1)
                            for p in opt.params.values()]).cpu()
                    _timed(opt)

                optim.Optimizer.step = first_grad
                trainer.fit(inputs)
            res["ms"][name] = st.ms()
            res["reduce_ms"][name] = [a.elapsed_time(b)  # the timed steps
                                      for a, b in spans.get(name, [])[1:]]
            res["launches"][name] = fa.FLASH_LAUNCHES
            shares = torch.stack(losses)
            if name == "mlm":  # each process's share of the global loss
                distributed.all_reduce_flat(mesh, [shares])
            res["losses"][name] = shares.cpu().tolist()
            flat = torch.cat([p.detach().reshape(-1)
                              for p in enc.master.parameters()])
            res["digest"][name] = hashlib.sha256(
                flat.cpu().numpy().tobytes()).hexdigest()
    finally:
        et.all_reduce_flat = reduce
    return res, grads


def _mp_worker(rank: str, port: str, out_dir: str) -> int:
    """One of phase 13's processes: join the gloo group, take a global mesh
    of its one shard on MP_DEVICE, train, write its record and gradients
    into ``out_dir``."""
    import torch

    from semanticsearch_tpu_torch.core import distributed

    rank = int(rank)
    distributed.initialize(f"127.0.0.1:{port}", MP_PROCESSES, rank,
                           backend="gloo")
    mesh = distributed.global_mesh(local_devices=[torch.device(MP_DEVICE)])
    with open(os.path.join(out_dir, "data.json")) as f:
        data = json.load(f)
    res, grads = _mp_train(mesh, data)
    for name, g in grads.items():
        torch.save(g, os.path.join(out_dir, f"grad_{name}_{rank}.pt"))
    with open(os.path.join(out_dir, f"mp_{rank}.json"), "w") as f:
        json.dump(res, f)
    torch.distributed.destroy_process_group()
    return 0


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def phase_multiprocess(report, ctx):
    """Phase 13: data-parallel training across MP_PROCESSES processes on
    the one card, over gloo (NCCL refuses two ranks on one device), each
    forwarding its own half of every batch; held against the one-process
    run on a (data 2) mesh of the card twice."""
    import torch

    from semanticsearch_tpu_torch.core.config import EncoderConfig
    from semanticsearch_tpu_torch.data.tsv import read_tsv

    log(f"== phase 13: data-parallel training across {MP_PROCESSES} "
        f"processes on {MP_DEVICE} over gloo (collectives staged through "
        "the host; main path)")
    t_phase = time.perf_counter()
    out_dir = os.path.join(ctx["tmp"], "multiprocess")
    os.makedirs(out_dir)
    texts = [r["chunk_text"] for _, r in zip(range(MP_STEPS * 64),
                                             read_tsv(ctx["tsv"]))]
    data = {"pairs": [(f"query {t[:40]}", t) for t in texts],
            "texts": texts}
    with open(os.path.join(out_dir, "data.json"), "w") as f:
        json.dump(data, f)
    one, one_grads = _mp_train(_virtual_mesh(data=MP_PROCESSES), data)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")}
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    port = str(_free_port())
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--mp-worker", str(r),
         port, out_dir], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=env) for r in range(MP_PROCESSES)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=MP_TIMEOUT_S)[0])
    except subprocess.TimeoutExpired:
        check(False, f"phase 13's processes ended within {MP_TIMEOUT_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall_s = time.perf_counter() - t0
    for r, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode:
            log("\n".join(f"  proc {r}: {line}"
                          for line in out.splitlines()[-30:]))
        check(p.returncode == 0, f"process {r} of {MP_PROCESSES} exited 0")
    mp = []
    for r in range(MP_PROCESSES):
        with open(os.path.join(out_dir, f"mp_{r}.json")) as f:
            mp.append(json.load(f))
    res = {"processes": MP_PROCESSES, "wall_s": wall_s,
           "allreduce_bytes": 4 * one["params"]}
    for name in ("contrastive", "mlm"):
        want = one["losses"][name]
        got = [m["losses"][name] for m in mp]
        ref = one_grads[name].double()
        g_err = max(float((torch.load(os.path.join(
            out_dir, f"grad_{name}_{r}.pt")).double() - ref).norm()
            / ref.norm()) for r in range(MP_PROCESSES))
        rel = max(abs(a - b) / abs(b) for g in got
                  for a, b in zip(g[1:], want[1:]))
        first = max(abs(g[0] - want[0]) / abs(want[0]) for g in got)
        step1 = (all(g[0] == want[0] for g in got) if name == "contrastive"
                 else first <= MP_GRAD_RTOL)
        check(step1 and g_err <= MP_GRAD_RTOL and rel <= TP_LOSS_RTOL
              and got[0] == got[1],
              f"{name}: step-1 loss {got[0][0]!r} vs one process "
              f"{want[0]!r} ("
              + ("bit-equal" if name == "contrastive"
                 else f"rel {first:.1e} <= {MP_GRAD_RTOL}")
              + f"); step-1 flat gradient within {g_err:.1e} <= "
              f"{MP_GRAD_RTOL} of its norm; later losses "
              f"{[round(x, 5) for x in got[0][1:]]} vs "
              f"{[round(x, 5) for x in want[1:]]} (rel {rel:.1e} <= "
              f"{TP_LOSS_RTOL}); both processes report the same losses")
        check(mp[0]["digest"][name] == mp[1]["digest"][name],
              f"{name}: the masters are bit-identical across the processes "
              f"(sha256 {mp[0]['digest'][name][:16]})")
        reduce_ms = [float(np.mean(m["reduce_ms"][name])) for m in mp]
        res[name] = {"ms": [m["ms"][name] for m in mp],
                     "one_process_ms": one["ms"][name],
                     "reduce_ms": reduce_ms,
                     "reduce_share": [a / m["ms"][name]
                                      for a, m in zip(reduce_ms, mp)],
                     "losses": got[0], "one_process_losses": want,
                     "loss_rel": rel, "grad_rel": g_err}
    per = 64 // MP_PROCESSES
    rows = sorted({x for m in mp for x in m["rows"]})
    calls = 2 * MP_STEPS + MP_STEPS
    check(rows == [per] and all(len(m["rows"]) == calls for m in mp)
          and one["rows"] == [64] * calls,
          f"each process's {calls} train_forward calls forwarded {rows} rows "
          f"of 64 ({MP_STEPS} contrastive steps x 2 sides, {MP_STEPS} MLM "
          "steps); the one-process run forwarded all 64 on its two shards")
    layers = EncoderConfig().num_layers
    want_launches = {"contrastive": 2 * MP_STEPS * layers,
                     "mlm": MP_STEPS * layers}
    for name, n in want_launches.items():
        got_l = [m["launches"][name] for m in mp]
        check(got_l == [n] * MP_PROCESSES
              and one["launches"][name] == MP_PROCESSES * n,
              f"{name}: flash launched {got_l} times a process == {n} "
              f"({layers} layers a forward on its one shard); the one-process "
              f"run {one['launches'][name]} on two shards")
    res.update({"launches": [sum(m["launches"].values()) for m in mp],
                "phase_s": time.perf_counter() - t_phase})
    report["flash"]["mp_train_launches"] = sum(res["launches"])
    report["multiprocess"] = res
    for name in want_launches:
        r = res[name]
        log(f"  {name} step: {r['ms'][0]:.2f} / {r['ms'][1]:.2f} ms a "
            f"process by events ({MP_PROCESSES} processes, {per} rows each) "
            f"vs {r['one_process_ms']:.2f} ms in one process on two shards; "
            f"gradient all-reduce {r['reduce_ms'][0]:.2f} / "
            f"{r['reduce_ms'][1]:.2f} ms (CUDA events, including the wait "
            f"for the other process), {r['reduce_share'][0]:.3f} / "
            f"{r['reduce_share'][1]:.3f} of a step")
    log(f"  all-reduced a step: {res['allreduce_bytes'] / 1e6:.1f} MB "
        f"({one['params']:,} f32 parameters); processes' wall "
        f"{wall_s:.1f} s, phase {res['phase_s']:.1f} s")
    log(json.dumps({"multiprocess": res}))


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        import semanticsearch_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: run from the repository root ({exc})",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if sys.argv[1:2] == ["--mp-worker"]:  # one of phase 13's processes
        return _mp_worker(*sys.argv[2:5])
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    seg_src = "semanticsearch_tpu_torch/csrc/segtopk.cu"
    report = {
        "segtopk": {"name": "segtopk_pass_a", "route": "cuda",
                    "source": seg_src,
                    "replaces": "semanticsearch_tpu/ops/topk.py:318"},
        "segtopk_int8": {"name": "segtopk_pass_a_int8", "route": "cuda",
                         "source": seg_src,
                         "replaces": "semanticsearch_tpu/ops/topk.py:355"},
        "segtopk_overlap": {"name": "segtopk_pass_a_overlap", "route": "cuda",
                            "source": seg_src,
                            "replaces": "semanticsearch_tpu/ops/topk.py:403"},
        "topk_fused": {"name": "topk_scores_fused", "route": "cuda",
                       "source": "semanticsearch_tpu_torch/csrc/topk_fused.cu",
                       "replaces": "semanticsearch_tpu/ops/topk.py:119"},
        "flash": {"name": "flash_attention", "route": "cuda",
                  "source": "semanticsearch_tpu_torch/csrc/flash_attention.cu",
                  "replaces": "semanticsearch_tpu/ops/flash_attention.py:28"},
        "similarity": {"name": "similarity_matrix", "route": "cuda",
                       "source": "semanticsearch_tpu_torch/csrc/similarity.cu",
                       "replaces": "semanticsearch_tpu/ops/similarity.py:49"},
        # no Pallas kernel: the XLA gather, einsum and top_k after pass A
        "pass_b": {"name": "pass_b_rescore", "route": "cuda",
                   "source": "semanticsearch_tpu_torch/csrc/pass_b.cu",
                   "replaces": "semanticsearch_tpu/ops/topk.py:707"},
    }
    report["flash_wide"] = {
        **{k: report["flash"][k] for k in ("route", "source", "replaces")},
        "name": "flash_attention (head widths past 256)",
        "launches_note": "the serve paths' launches (phases 3 and 7): no "
                         "configuration has a head wider than 256, so none "
                         "launches it; phases 2 and 4 call it directly"}
    for key, name, base in [
            ("segtopk_f32", "segtopk_pass_a (f32)", "segtopk"),
            ("segtopk_overlap_f32", "segtopk_pass_a_overlap (f32)",
             "segtopk_overlap"),
            ("topk_fused_f32", "topk_scores_fused (f32)", "topk_fused"),
            ("flash_f32", "flash_attention (f32)", "flash"),
            ("similarity_bf16", "similarity_matrix (bf16 input)",
             "similarity")]:
        report[key] = {**{k: report[base][k] for k in ("route", "source",
                                                       "replaces")},
                       "name": name}
    report["flash_causal"] = {
        **{k: report["flash"][k] for k in ("route", "source", "replaces")},
        "name": "flash_attention_varlen (causal, grouped K/V)",
        "launches_note": "launches: one direct call (phase 4b); "
                         "forward_launches: one forward of the LLM cell's "
                         "encoder over 256 texts (phase 4b), once an "
                         "attention layer"}
    report["segtopk_wide"] = {
        **{k: report["segtopk"][k] for k in ("route", "source", "replaces")},
        "name": "segtopk_pass_a (wide bf16)",
        "launches_note": "one direct call (phase 4b); the LLM search cell "
                         "launches it once a search"}
    report["short_conv"] = {
        "name": "gated_short_conv", "route": "cuda",
        "source": "semanticsearch_tpu_torch/csrc/short_conv.cu",
        "replaces": "none: the plain-torch chain of models/lfm2_moe.py "
                    "ShortConv (ops/short_conv.py gated_short_conv_plain)",
        "launches_note": "launches: one direct call (phase 4b); "
                         "forward_launches: one forward of the LLM cell's "
                         "encoder over 256 texts (phase 4b), once a conv "
                         "layer"}
    report["rms_norm"] = {
        "name": "add_rms_norm / rms_norm", "route": "cuda",
        "source": "semanticsearch_tpu_torch/csrc/rms_norm.cu",
        "replaces": "none: the plain-torch RMSNorm and residual adds of "
                    "models/lfm2_moe.py (ops/rms_norm.py "
                    "add_rms_norm_plain)",
        "launches_note": "launches: one direct call (phase 4b); "
                         "forward_launches: one forward of the LLM cell's "
                         "encoder over 256 texts (phase 4b): the first "
                         "op_norm, an add and norm twice a layer, the q and "
                         "k norms of each attention layer"}
    t_start = time.perf_counter()
    try:
        phase_build()
        phase_kernels(report)
        with tempfile.TemporaryDirectory() as tmp:
            ctx = phase_serve(report, tmp)
            phase_dense(report)
            phase_llm_kernels(report)
            phase_live(report, ctx)
            phase_chunk(report, ctx)
            phase_f32(report, ctx)
            phase_rerank(report, ctx)
            phase_train(report, ctx)
            phase_entry(report, ctx)
            phase_shard(report, ctx)
            phase_multiprocess(report, ctx)
        phase_shard_lexical(report, phase_lexical(report))
    except CheckFailed as exc:
        print(f"chip_smoke: check failed: {exc}", file=sys.stderr)
        return 1
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    notes = ("plain_note", "library_note", "shape_note", "bound_note",
             "serve_ms", "serve_library_ms", "serve_bound_ms",
             "serve_bound_by", "call_ms", "forward_launches", "live_ms",
             "live_library_ms", "live_bound_ms",
             "live_bound_by", "dh48_ms", "dh48_pad_ms", "fma_bound_ms",
             "tf32x3_bound_ms", "serve_tf32x3_bound_ms", "serve_fma_bound_ms",
             "rerank_launches", "train_launches", "mp_train_launches",
             "entry_launches",
             "shard_launches", "dense_launches", "f32_launches",
             "gathered_bound_ms", "serve_gathered_bound_ms",
             "f32_gathered_bound_ms", "serve_queued_ms", "hot_ms",
             "hot_bound_ms", "hot_bound_by", "bit_equal_share",
             "head_ms", "head_plain_ms", "head_bound_ms",
             "live_tf32x3_bound_ms", "live_fma_bound_ms", "launches_note",
             *(f"{shape}_{key}" for shape in ("batched", "t1024", "chunk",
                                              "dh256", "f32", "varlen",
                                              "varlen_chunk")
               for key in ("ms", "plain_ms", "bound_ms", "bound_by",
                           "library_ms", "fma_bound_ms", "tf32x3_bound_ms",
                           "max_abs_err", "padded_ms")))
    kernels = [{**{key: report[k][key] for key in keys},
                **{key: report[k][key] for key in notes if key in report[k]}}
               for k in ("segtopk", "segtopk_int8", "segtopk_overlap",
                         "segtopk_f32", "segtopk_overlap_f32", "pass_b",
                         "topk_fused",
                         "topk_fused_f32", "flash", "flash_f32", "flash_wide",
                         "flash_causal", "segtopk_wide", "short_conv",
                         "rms_norm", "similarity", "similarity_bf16")]
    log(f"dense QPS {report['dense_qps']:.1f} at recall@10 "
        f"{report['recall_at_10']}; int8 two-pass recall@10 "
        f"{report['recall_at_10_int8']}; f32 two-pass recall@10 "
        f"{report['recall_at_10_f32']}; fused recall@200 "
        f"{report['recall_at_200_fused']}; chunking: "
        f"{report['chunk_docs_differing_from_plain_s']} documents differ "
        f"from the plain S; total "
        f"{time.perf_counter() - t_start:.0f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
