#!/usr/bin/env python3
"""Smoke run of semanticsearch_tpu_torch on one CUDA card (an H100).

    python3 chip_smoke.py

Builds the Hopper kernels from ``semanticsearch_tpu_torch/csrc``, holds each
against its plain PyTorch version on the card, serves hybrid queries end to
end through ``HybridQueryEngine`` at the default encoder's full width, and
runs the dense search at the per-chip shard size (1,250,000 x 384 bf16).
Progress and measurements go to stdout; the line before the last is the
card's name and power limit, the one before it the JSON ``kernels`` record,
and the last line ``{"ok": true, "device": {...}}``. Any failed check exits
non-zero without that line, as does a machine without a CUDA device.
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


# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12


def bound_ms(flops: float, nbytes: float):
    t_ops, t_mem = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_mem), ("operations" if t_ops >= t_mem else "bytes")


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


def topk_agree(v, i, ref_v, ref_i, tol: float):
    """Compare a (Q, k) top-k with a (Q, k+1) reference. Scores must agree
    to ``tol``; indices must be equal at every position whose reference
    score is more than ``tol`` from its neighbours (the k+1-th included),
    i.e. everywhere but inside a tie. Returns (max_abs_err, mismatches
    outside ties, mismatches inside ties)."""
    import torch

    k = v.shape[1]
    v, i = v.float().cpu(), i.long().cpu()
    rv, ri = ref_v.float().cpu(), ref_i.long().cpu()
    err = float((v - rv[:, :k]).abs().max())
    close = (rv[:, 1:] - rv[:, :-1]).abs() <= tol
    tied = torch.zeros_like(rv, dtype=torch.bool)
    tied[:, 1:] |= close
    tied[:, :-1] |= close
    mism = i != ri[:, :k]
    return err, int((mism & ~tied[:, :k]).sum()), int((mism & tied[:, :k]).sum())


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


def _int_grid(shape, gen):
    """bf16 integers in [-127, 127] on the card: every dot product of width
    <= 1040 is an integer below 2^24, exact in f32 whatever the summation
    order, so kernel and plain versions must agree bit for bit."""
    import torch

    return torch.randint(-127, 128, shape, generator=gen, device=gen.device,
                         dtype=torch.int16).to(torch.bfloat16)


def phase_kernels(report):
    import torch

    from semanticsearch_tpu_torch.ops import flash_attention as fa
    from semanticsearch_tpu_torch.ops import topk

    log("== phase 2: kernels against their plain versions on the card")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(11)
    seg_err = 0.0
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
        torch.cuda.synchronize()
        seg_err = max(seg_err, float((kv - pv).abs().max()))
        check(torch.equal(ki, pi) and torch.equal(kv, pv),
              f"pass A kernel == plain (ids and values exact): Q={q} N={n} "
              f"L2={L2} k_sel={k_sel}")
        tv, ti = topk.topk_scores_twopass(Qm, C, k=k, block_n=block_rows,
                                          seg_split=seg_split)
        rv, ri = topk.topk_scores_ref(Qm, C, k=k + 1, block_n=65536)
        err, bad, tied = topk_agree(tv, ti, rv, ri, tol=0.0)
        check(err == 0.0 and bad == 0,
              f"two-pass == topk_scores_ref: scores exact, indices equal "
              f"outside exact ties ({tied} tie-permuted positions)")
    report["segtopk"]["max_abs_err"] = seg_err

    fl_err = 0.0
    for b, t in [(8, 128), (8, 256), (2, 1024)]:
        shape = (b, 12, t, 32)
        qkv = [torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
               for _ in range(3)]
        mask = torch.ones((b, t), device=dev)
        mask[:, t - t // 3:] = 0.0  # masked tail
        mask[1, :] = 0.0            # a row with every key masked
        got = fa.flash_attention(*qkv, mask)
        want = fa.flash_attention_plain(*qkv, mask)
        err = float((got.float() - want.float()).abs().max())
        fl_err = max(fl_err, err)
        check(bool(torch.isfinite(got).all()) and err <= 1e-2,
              f"flash kernel vs plain, bf16, B={b} H=12 T={t} Dh=32: max abs "
              f"err {err:.3e} <= 1e-2 (about 5 bf16 ulps at |o| = 0.5)")
    report["flash"]["max_abs_err"] = fl_err


def _zipf_text(rng, words, n_words):
    """n_words drawn Zipf(1.2) from the word list: a few frequent words and
    a long tail, so BM25 sees real postings of every length."""
    ranks = np.minimum(rng.zipf(1.2, size=n_words), len(words)) - 1
    return " ".join(words[r] for r in ranks)


def phase_serve(report, tmp):
    import torch

    from semanticsearch_tpu_torch.core.config import EncoderConfig
    from semanticsearch_tpu_torch.data.tsv import write_tsv
    from semanticsearch_tpu_torch.index.query_engine import HybridQueryEngine
    from semanticsearch_tpu_torch.models.encoder import SentenceEncoder
    from semanticsearch_tpu_torch.ops import flash_attention as fa
    from semanticsearch_tpu_torch.ops import topk

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

    topk.SEGTOPK_LAUNCHES = 0
    fa.FLASH_LAUNCHES = 0
    t0 = time.perf_counter()
    built = HybridQueryEngine.build(tsv, encoder, os.path.join(tmp, "idx"))
    torch.cuda.synchronize()
    log(f"  build: {time.perf_counter() - t0:.1f} s (host clock)")
    engine = HybridQueryEngine.load(os.path.join(tmp, "idx"), encoder)
    t0 = time.perf_counter()
    hybrid = [engine.search(b, k=10) for b in batches]
    dense_only = [engine.search(b, k=10, hybrid=False) for b in batches]
    piped = engine.search_pipelined(batches, k=10)
    torch.cuda.synchronize()
    log(f"  {3 * len(queries)} queries searched in "
        f"{time.perf_counter() - t0:.2f} s (host clock)")
    report["segtopk"]["launches"] = topk.SEGTOPK_LAUNCHES
    report["flash"]["launches"] = fa.FLASH_LAUNCHES
    log(f"  launches on the serve path: segtopk {topk.SEGTOPK_LAUNCHES}, "
        f"flash {fa.FLASH_LAUNCHES}")
    check(topk.SEGTOPK_LAUNCHES > 0 and fa.FLASH_LAUNCHES > 0,
          "both kernels launched on the serve path")

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
    launches = topk.SEGTOPK_LAUNCHES
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
        f"= {q / dt:,.0f} QPS ({topk.SEGTOPK_LAUNCHES - launches} pass-A "
        "launches)")
    sample = torch.arange(0, q, q // 128, device="cuda")[:128]
    rv, ri = topk.topk_scores_ref(queries[sample], corpus, k=k, block_n=65536)
    hits = sum(len(set(a) & set(b)) for a, b in
               zip(idx[sample].tolist(), ri.tolist()))
    recall = hits / (128 * k)
    report["recall_at_10"] = recall
    check(recall == 1.0, f"recall@10 = {recall} on 128 sampled queries "
          "against the plain exact top-k")

    # pass A alone at this shape: kernel, plain version, GEMM floor
    L2 = cfg.block_rows // 128 // cfg.seg_split
    k_sel = k + 1
    seg = report["segtopk"]
    seg["ms"] = time_ms(lambda: topk.segtopk_pass_a(queries, corpus, n, L2,
                                                    k_sel), reps=3)
    seg["plain_ms"] = time_ms(lambda: topk.segtopk_pass_a_plain(
        queries, corpus, n, L2, k_sel), reps=1, warmup=0)

    def gemm_floor():
        for s in range(0, n, 16384):
            torch.matmul(queries, corpus[s: s + 16384].T)

    seg["library_ms"] = time_ms(gemm_floor, reps=3)
    seg["bound_ms"], seg["bound_by"] = bound_ms(
        2.0 * q * n * d, 2.0 * (q * d + n * d) + 8.0 * q * k_sel)
    log(f"  pass A: kernel {seg['ms']:.2f} ms, plain {seg['plain_ms']:.2f} ms,"
        f" bf16 GEMM floor {seg['library_ms']:.2f} ms, bound "
        f"{seg['bound_ms']:.2f} ms ({seg['bound_by']})")

    # flash at the encoder's serve shape
    b, h, t, dh = 256, 12, 256, 32
    gen = torch.Generator().manual_seed(3)
    qkv = [torch.randn((b, h, t, dh), generator=gen).to("cuda", torch.bfloat16)
           for _ in range(3)]
    lengths = torch.randint(40, t + 1, (b,), generator=gen)
    mask = (torch.arange(t)[None, :] < lengths[:, None]).float().to("cuda")
    fl = report["flash"]
    fl["ms"] = time_ms(lambda: fa.flash_attention(*qkv, mask))
    fl["plain_ms"] = time_ms(lambda: fa.flash_attention_plain(*qkv, mask))
    bool_mask = mask.bool()[:, None, None, :]
    fl["library_ms"] = time_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(
            *qkv, attn_mask=bool_mask))
    fl["bound_ms"], fl["bound_by"] = bound_ms(
        4.0 * b * h * t * t * dh, 4 * 2.0 * b * h * t * dh + 4.0 * b * t)
    log(f"  flash B={b} H={h} T={t} Dh={dh}: kernel {fl['ms']:.3f} ms, plain "
        f"{fl['plain_ms']:.3f} ms, SDPA {fl['library_ms']:.3f} ms, bound "
        f"{fl['bound_ms']:.3f} ms ({fl['bound_by']})")


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
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    report = {
        "segtopk": {"name": "segtopk_pass_a", "route": "cuda",
                    "source": "semanticsearch_tpu_torch/csrc/segtopk.cu",
                    "replaces": "semanticsearch_tpu/ops/topk.py:318"},
        "flash": {"name": "flash_attention", "route": "cuda",
                  "source": "semanticsearch_tpu_torch/csrc/flash_attention.cu",
                  "replaces": "semanticsearch_tpu/ops/flash_attention.py:28"},
    }
    t_start = time.perf_counter()
    try:
        phase_build()
        phase_kernels(report)
        with tempfile.TemporaryDirectory() as tmp:
            phase_serve(report, tmp)
        phase_dense(report)
    except CheckFailed as exc:
        print(f"chip_smoke: check failed: {exc}", file=sys.stderr)
        return 1
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = [{key: report[k][key] for key in keys}
               for k in ("segtopk", "flash")]
    log(f"dense QPS {report['dense_qps']:.1f} at recall@10 "
        f"{report['recall_at_10']}; total {time.perf_counter() - t_start:.0f} s")
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
