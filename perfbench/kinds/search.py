"""Batch search: an offline job's exact top-k over the index.

A batch of query texts goes through the program's
``SentenceEncoder.encode_device`` (the mix's rows a forward) and
``EmbeddingIndex.search_device``, and its (scores, ids) are copied to the
host. Batches are pipelined as such a job runs them: a batch's results are
copied to pinned host memory as soon as its work is launched, batch i+1 is
dispatched before batch i is fetched, and the fetch waits for batch i's
copy alone. The window dispatches batches for
``--seconds`` and ends when the last one dispatched is on the host.

End-to-end: ``search_qps``, the queries of every batch completed in the
window over the window; ``search_p95_ms``, the 95th percentile over every
batch of the time from its dispatch to its lists on the host.

Correctness, on a sample of the answered queries drawn from the seed (a
few rows of every batch): ``emb_gap``, the widest L2 distance between the
program's query embedding and the reference's (float64, from the text);
``topk_gap``, the widest gap, at any rank, between the program's score
and the reference's at the id it answered, or between the reference's
score at that id and the reference's score at that rank (so an id that
ties within rounding passes, a wrong id does not). The reference scores
the program's own query embeddings (the encoder stage is judged by
``emb_gap`` on its own).
"""
from __future__ import annotations

import time
from typing import List

import numpy as np
import torch

from perfbench import flops, traffic, weights
from perfbench.kinds import common
from perfbench.reference import encoder as ref_encoder
from perfbench.reference import search as ref_search
from perfbench.reference import tokenizer as ref_tokenizer


def sample_rows(seed: int, mix: dict) -> np.ndarray:
    """The rows of each batch that are kept for the check: (max_batches,
    sample_per_batch), drawn from the seed."""
    rng = traffic.rng_for(seed, "sample")
    return rng.integers(0, mix["batch"],
                        (mix["max_batches"], mix["sample_per_batch"]))


def run(ctx) -> dict:
    cfg, mix, dev, tracer = ctx.config, ctx.mix, ctx.device, ctx.tracer
    bs, k = mix["batch"], cfg["index"]["top_k"]
    marks = [("start", time.perf_counter())]
    w = weights.make(cfg, ctx.seed, dev)
    enc = common.port_encoder(cfg, w, dev)
    del w
    marks.append(("encoder", time.perf_counter()))
    raw = common.corpus_rows(cfg, ctx.seed, dev)
    from semanticsearch_tpu_torch.index.engine import EmbeddingIndex

    index = EmbeddingIndex.build(raw, cfg=common.index_config(cfg),
                                 device=dev)
    del raw
    common.free(dev)
    marks.append(("index", time.perf_counter()))
    pool = traffic.query_batches(ctx.seed, mix, mix["pool_batches"], bs)
    sample_np = sample_rows(ctx.seed, mix)
    # on the device, so the window copies nothing host-to-device for them
    sample = torch.from_numpy(sample_np).to(dev)

    fetcher = common.Fetcher(dev)
    marks.append(("traffic", time.perf_counter()))

    def dispatch(i):
        with tracer.span("encode"):
            q = enc.encode_device(pool[i % len(pool)],
                                  batch_size=mix["rows_per_forward"])
        with tracer.span("search"):
            v, ids = index.search_device(q, k=k)
        with tracer.span("sample"):
            sel = sample[i]
            kept = (q[sel], v[sel], ids[sel])
        with tracer.span("copy"):
            return i, fetcher.start((v, ids) + kept)

    def fetch(p):
        i, handle = p
        with tracer.span("fetch"):
            v, ids, *kept = fetcher.wait(handle)
        return i, v, ids, kept

    # warm-up: the window's shapes, once (kernels are built on a first run)
    fetch(dispatch(0))
    common.sync(dev)
    marks.append(("warm-up", time.perf_counter()))
    tracer.warm()
    common.report_setup(ctx.t_start, marks)

    lat: List[float] = []
    kept: List[tuple] = []
    traced: List[int] = []
    t_from, n_traced = mix["trace_from_batch"], mix["trace_batches"]
    pending = None
    done = 0
    t0 = time.perf_counter()

    def finish(p):
        nonlocal done
        i, _, _, rows = fetch(p[0])
        t = time.perf_counter()
        lat.append(t - p[1])
        done += bs
        kept.append((i, rows))
        return t

    t_end = t0
    i = 0
    paused = 0.0  # a traced run's profiler start and stop, not measured
    while (i < mix["max_batches"]
           and time.perf_counter() - t0 - paused < ctx.seconds):
        if ctx.trace and i in (t_from, t_from + n_traced):
            if pending is not None:
                t_end = finish(pending)
                pending = None
            t_p = time.perf_counter()
            (tracer.start if i == t_from else tracer.stop)()
            paused += time.perf_counter() - t_p
        if tracer.active:
            traced.append(i)
        t_disp = time.perf_counter()
        p = (dispatch(i), t_disp)
        if pending is not None:
            t_end = finish(pending)
        pending = p
        i += 1
    if pending is not None:
        t_end = finish(pending)
    tracer.stop()
    window = t_end - t0
    peak = common.memory_peak(dev)
    del index, enc, pending
    common.free(dev)

    layer = {}
    if traced:
        texts = [t for j in traced for t in pool[j % len(pool)]]
        layer.update(_work(cfg, texts, len(traced)))
    texts = [pool[j % len(pool)][r] for j, _ in kept for r in sample_np[j]]
    compared = compare(ctx, texts, *(torch.cat([rows[c] for _, rows in kept])
                                     for c in range(3)))
    return {"e2e": {"search_qps": done / window,
                    "search_p95_ms": 1e3 * common.percentile(lat, 95)},
            "setup_s": t0 - ctx.t_start, "compared": compared,
            "attempted": i * bs, "failed": i * bs - done,
            "memory_peak_bytes": peak, "layer": layer}


def _work(cfg: dict, texts, n_batches: int) -> dict:
    """The operations and bytes of the traced batches, from their real
    token counts (what the per-layer readers divide)."""
    ix = cfg["index"]
    item = 2 if ix["dtype"] == "bfloat16" else 4
    lens = ref_tokenizer.lengths(texts, cfg["vocab_size"],
                                 cfg["max_position_embeddings"])
    enc_ops = flops.encoder_forward_ops(cfg, lens)
    enc_bytes = (n_batches * flops.encoder_weight_bytes(cfg, item)
                 + float(lens.sum()) * cfg["hidden_size"] * item
                 + 4.0 * len(texts) * cfg["hidden_size"])
    q_per = len(texts) // n_batches
    t_ops, t_bytes = flops.topk_ops_bytes(q_per, ix["rows"],
                                          cfg["hidden_size"], ix["top_k"],
                                          item)
    return {"encoder_ops": enc_ops, "encoder_bytes": enc_bytes,
            "topk_ops": n_batches * t_ops, "topk_bytes": n_batches * t_bytes,
            "peak": cfg["peak"], "real_tokens": int(lens.sum()),
            "queries": len(texts)}


def compare(ctx, texts, q, v, ids) -> list:
    """emb_gap and topk_gap of answers (q, v, ids) to ``texts``, each
    beside its limit."""
    cfg, dev, lim = ctx.config, ctx.device, ctx.limits
    k = cfg["index"]["top_k"]
    w = weights.make(cfg, ctx.seed, dev)
    e_ref = ref_encoder.encode(cfg, w, texts, "f64", device=dev)
    del w
    q = q.to(dev)
    emb_gap = float((q.double() - e_ref).norm(dim=1).max())
    rows = ref_search.stored_rows(common.corpus_rows(cfg, ctx.seed, dev),
                                  cfg["index"]["dtype"])
    ids = ids.to(dev, torch.int64)
    n = rows.shape[0]
    valid = bool(((ids >= 0) & (ids < n)).all()) and all(
        len(set(r)) == k for r in ids.tolist()) and ids.shape[1] == k
    best, at = ref_search.judge(q, rows, cfg["index"]["dtype"],
                                ids.clamp(0, n - 1), k)
    gap = torch.maximum((v.to(dev).double() - at).abs(), (best - at).abs())
    topk_gap = float(gap.max()) if valid else float("inf")
    return [("emb_gap", common.finite(emb_gap), lim["emb_gap"]),
            ("topk_gap", common.finite(topk_gap), lim["topk_gap"])]


def control(ctx, prec: str) -> list:
    """The reference in ``prec`` put in the program's place, on the rows a
    run keeps of its first ``control_batches`` batches, judged as a run
    is."""
    cfg, mix, dev = ctx.config, ctx.mix, ctx.device
    n_batches = mix["control_batches"]
    pool = traffic.query_batches(ctx.seed, mix, mix["pool_batches"],
                                 mix["batch"])
    sample_np = sample_rows(ctx.seed, mix)
    texts = [pool[i % len(pool)][r] for i in range(n_batches)
             for r in sample_np[i]]
    w = weights.make(cfg, ctx.seed, dev)
    q = ref_encoder.encode(cfg, w, texts, prec, device=dev).float()
    del w
    rows = ref_search.stored_rows(common.corpus_rows(cfg, ctx.seed, dev),
                                  cfg["index"]["dtype"])
    v, ids = ref_search.topk(q, rows, cfg["index"]["dtype"],
                             cfg["index"]["top_k"], prec)
    del rows
    common.free(dev)
    return compare(ctx, texts, q, v.float(), ids)
