"""Batch search with an LLM embedder: the LFM2-MoE encoder over a corpus
of its own width.

The loop is ``search.py``'s: a batch of query texts goes through the
program's ``SentenceEncoder.encode_device`` (the mix's rows a forward) and
``EmbeddingIndex.search_device``, its (scores, ids) are copied to pinned
host memory as soon as its work is launched, and batch i+1 is dispatched
before batch i is fetched. Every batch holds the same multiset of text
lengths (the seed deals which text gets which length, and the words), so
every batch is the same work. The encoder is built from the seed's weights
(``weights_lfm2.py``) in the configuration's dtype, and the index from the
seed's corpus in row blocks (``corpus.py``), so neither the weights nor
the corpus ever exist in float32 whole.

End-to-end: ``search_qps`` and ``search_p95_ms``, as ``search.py`` reads
them.

Correctness, on a sample of the answered queries drawn from the seed (a
few rows of every batch): ``emb_gap`` and ``topk_gap`` as ``search.py``
defines them, the reference handed the experts the program chose for the
sampled texts' tokens (it weighs them by its own scores), and
``route_gap`` and ``route_flips``, the reference's reading of how far
those choices lie from its own (``reference/lfm2_moe.py``): the largest
score by which a chosen expert falls short of the reference's k-th, and
the share of (token, layer) pairs whose chosen set is not the reference's
own. A router that ignores the expert bias moves only choices near ties,
by less than bf16's drift moves ``route_gap``, but many more of them than
that drift does. The program's choices are read after the window: each
pool batch the sample drew from is encoded once more with the program's
routing capture on, and its embeddings must equal the timed ones bit for
bit, else both route checks read the cap, which no limit passes.
"""
from __future__ import annotations

import time
from typing import List

import numpy as np
import torch

from perfbench import corpus, flops_lfm2, traffic, weights_lfm2
from perfbench.flops import topk_ops_bytes
from perfbench.kinds import common
from perfbench.kinds.search import sample_rows
from perfbench.reference import lfm2_moe as ref_lfm2
from perfbench.reference import precision as P
from perfbench.reference import search as ref_search
from perfbench.reference import tokenizer as ref_tokenizer


def encoder_config(cfg: dict):
    """The program's ``LFM2MoEConfig`` for a configuration file."""
    from semanticsearch_tpu_torch.core.config import LFM2MoEConfig

    return LFM2MoEConfig(
        vocab_size=cfg["vocab_size"], hidden_dim=cfg["hidden_size"],
        num_layers=cfg["num_hidden_layers"],
        num_heads=cfg["num_attention_heads"],
        mlp_dim=cfg["intermediate_size"],
        max_len=cfg["max_position_embeddings"], dtype=cfg["dtype"],
        attention=cfg["attention"],
        num_kv_heads=cfg["num_key_value_heads"],
        layer_types=tuple(weights_lfm2.layer_types(cfg)),
        num_dense_layers=weights_lfm2.dense_layers(cfg),
        num_experts=cfg["num_experts"],
        experts_per_token=cfg["num_experts_per_tok"],
        expert_dim=cfg["moe_intermediate_size"],
        norm_topk_prob=cfg["norm_topk_prob"],
        routed_scaling=float(cfg["routed_scaling_factor"]),
        conv_kernel=cfg["conv_L_cache"], rope_theta=float(cfg["rope_theta"]),
        norm_eps=cfg["norm_eps"])


def query_batches(seed: int, mix: dict, n_batches: int, batch: int
                  ) -> List[List[str]]:
    """``n_batches`` batches of ``batch`` texts, each holding the same
    multiset of lengths (drawn once from the stream every seed shares); the
    seed deals the lengths within each batch and draws the words."""
    lens = traffic.query_lengths(traffic.shape_stream("queries"), batch, mix)
    rng = traffic.rng_for(seed, "queries")
    words = traffic.word_list(mix["vocab"])
    cdf = np.cumsum(traffic.zipf_weights(mix["vocab"], mix["zipf_s"]))
    return [traffic.texts_of(rng, words, cdf, rng.permutation(lens))
            for _ in range(n_batches)]


def run(ctx) -> dict:
    cfg, mix, dev, tracer = ctx.config, ctx.mix, ctx.device, ctx.tracer
    bs, k = mix["batch"], cfg["index"]["top_k"]
    rpf = mix["rows_per_forward"]
    marks = [("start", time.perf_counter())]
    from semanticsearch_tpu_torch.index.engine import EmbeddingIndex
    from semanticsearch_tpu_torch.models.encoder import SentenceEncoder

    enc = SentenceEncoder(encoder_config(cfg), device=dev,
                          state_dict=weights_lfm2.make(cfg, ctx.seed, dev))
    marks.append(("encoder", time.perf_counter()))
    index = EmbeddingIndex.build(corpus.Blocks(cfg, ctx.seed, dev),
                                 cfg=common.index_config(cfg), device=dev,
                                 rows=cfg["index"]["rows"])
    common.free(dev)
    marks.append(("index", time.perf_counter()))
    pool = query_batches(ctx.seed, mix, mix["pool_batches"], bs)
    sample_np = sample_rows(ctx.seed, mix)
    sample = torch.from_numpy(sample_np).to(dev)
    fetcher = common.Fetcher(dev)
    marks.append(("traffic", time.perf_counter()))

    def dispatch(i):
        with tracer.span("encode"):
            q = enc.encode_device(pool[i % len(pool)], batch_size=rpf)
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
    paused = 0.0
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

    texts = [pool[j % len(pool)][r] for j, _ in kept for r in sample_np[j]]
    q = torch.cat([rows[0] for _, rows in kept])
    sets, same = routing(enc, pool, kept, sample_np, cfg, rpf)
    del index, enc, pending
    common.free(dev)

    layer = {}
    if traced:
        layer.update(_work(cfg, [t for j in traced
                                 for t in pool[j % len(pool)]], len(traced)))
    compared = compare(ctx, texts, q, *(torch.cat([rows[c] for _, rows
                                                   in kept])
                                        for c in (1, 2)), sets, same)
    return {"e2e": {"search_qps": done / window,
                    "search_p95_ms": 1e3 * common.percentile(lat, 95)},
            "setup_s": t0 - ctx.t_start, "compared": compared,
            "attempted": i * bs, "failed": i * bs - done,
            "memory_peak_bytes": peak, "layer": layer}


def routing(enc, pool, kept, sample_np, cfg: dict, rpf: int):
    """The experts the program chose for each kept text's tokens ((MoE
    layers, tokens, k) a text, in kept order), read by encoding each pool
    batch the sample drew from once more with the routing capture on; and
    whether those encodings equal the timed ones bit for bit. None for the
    experts where the capture is not one (tokens, k) tensor a MoE layer a
    forward of ``rpf`` texts."""
    n_moe = cfg["num_hidden_layers"] - weights_lfm2.dense_layers(cfg)
    lens_of, by_pool, per_pool = {}, {}, {}
    for j, _ in kept:
        p = j % len(pool)
        if p in per_pool:
            continue
        capture: list = []
        enc.model.set_capture(capture)
        try:
            by_pool[p] = enc.encode_device(pool[p], batch_size=rpf)
        finally:
            enc.model.set_capture(None)
        lens = ref_tokenizer.lengths(pool[p], cfg["vocab_size"],
                                     cfg["max_position_embeddings"])
        tokens = [int(lens[f: f + rpf].sum())
                  for f in range(0, len(lens), rpf)]
        if [c.shape[0] for c in capture] != [
                n for n in tokens for _ in range(n_moe)]:
            return None, False
        lens_of[p] = lens
        per_pool[p] = [c.cpu() for c in capture]
    sets, same = [], True
    for j, rows in kept:
        p = j % len(pool)
        lens = lens_of[p]
        for pos, r in enumerate(sample_np[j]):
            same &= bool(torch.equal(by_pool[p][r].cpu(), rows[0][pos]))
            f, local = divmod(int(r), rpf)
            start = int(lens[f * rpf: f * rpf + local].sum())
            layers = per_pool[p][f * n_moe: (f + 1) * n_moe]
            sets.append(torch.stack([c[start: start + lens[r]]
                                     for c in layers]) if layers else
                        torch.zeros(0, int(lens[r]), 0, dtype=torch.int64))
    return sets, same


def _work(cfg: dict, texts, n_batches: int) -> dict:
    """The operations and bytes of the traced batches (what the per-layer
    readers divide): the encoder's over the real tokens, the routed
    experts only; every weight read once a forward."""
    ix = cfg["index"]
    item = 2 if ix["dtype"] == "bfloat16" else 4
    lens = ref_tokenizer.lengths(texts, cfg["vocab_size"],
                                 cfg["max_position_embeddings"])
    h = cfg["hidden_size"]
    enc_bytes = (n_batches * flops_lfm2.encoder_weight_bytes(cfg, item)
                 + float(lens.sum()) * h * item + 4.0 * len(texts) * h)
    q_per = len(texts) // n_batches
    t_ops, t_bytes = topk_ops_bytes(q_per, ix["rows"], h, ix["top_k"], item)
    return {"encoder_ops": flops_lfm2.encoder_forward_ops(cfg, lens),
            "encoder_bytes": enc_bytes, "topk_ops": n_batches * t_ops,
            "topk_bytes": n_batches * t_bytes, "peak": cfg["peak"],
            "real_tokens": int(lens.sum()), "queries": len(texts)}


def judge(cfg: dict, seed: int, q: torch.Tensor, ids: torch.Tensor, dev):
    """The reference's k best scores of every query and its scores at the
    answered ids (each (S, k), float64), over the corpus rebuilt a block at
    a time."""
    k, dtype = cfg["index"]["top_k"], cfg["index"]["dtype"]
    ids = ids.to(dev, torch.int64)
    at = torch.zeros(ids.shape, dtype=torch.float64, device=dev)
    best = None
    qd = q.to(dev).to(ref_search.DTYPES[dtype])
    for r0, raw in corpus.Blocks(cfg, seed, dev).starts():
        rows = ref_search.stored_rows(raw, dtype)
        del raw
        blk = P.matmul(qd, rows.t(), "f64")
        inside = (ids >= r0) & (ids < r0 + blk.shape[1])
        local = (ids - r0).clamp(0, blk.shape[1] - 1)
        at = torch.where(inside, torch.gather(blk, 1, local), at)
        v = torch.topk(blk, min(k, blk.shape[1]), dim=1).values
        best = v if best is None else torch.topk(
            torch.cat([best, v], 1), k, dim=1).values
    return best, at


def compare(ctx, texts, q, v, ids, sets, same: bool = True) -> list:
    """emb_gap, topk_gap, route_gap and route_flips of answers (q, v,
    ids) to ``texts`` whose experts were ``sets``, each beside its limit;
    with no sets (or ``same`` False: they were not read from the timed
    path) both route checks read the cap and the reference chooses its
    own."""
    cfg, dev, lim = ctx.config, ctx.device, ctx.limits
    k = cfg["index"]["top_k"]
    w = weights_lfm2.make(cfg, ctx.seed, dev)
    e_ref, _, route = ref_lfm2.encode(cfg, w, texts, "f64", sets,
                                      device=dev)
    route_gap, route_flips = route.gap, route.share
    del w
    common.free(dev)
    q = q.to(dev)
    emb_gap = float((q.double() - e_ref).norm(dim=1).max())
    n = cfg["index"]["rows"]
    ids = ids.to(dev, torch.int64)
    valid = bool(((ids >= 0) & (ids < n)).all()) and all(
        len(set(r)) == k for r in ids.tolist()) and ids.shape[1] == k
    best, at = judge(cfg, ctx.seed, q, ids.clamp(0, n - 1), dev)
    gap = torch.maximum((v.to(dev).double() - at).abs(), (best - at).abs())
    topk_gap = float(gap.max()) if valid else float("inf")
    if sets is None or not same:
        route_gap = route_flips = float("inf")
    return [("emb_gap", common.finite(emb_gap), lim["emb_gap"]),
            ("topk_gap", common.finite(topk_gap), lim["topk_gap"]),
            ("route_gap", common.finite(route_gap), lim["route_gap"]),
            ("route_flips", common.finite(route_flips),
             lim["route_flips"])]


def control(ctx, prec: str) -> list:
    """The reference in ``prec`` put in the program's place (its own
    choice of experts, its own top-k), on the rows a run keeps of its
    first ``control_batches`` batches, judged as a run is."""
    cfg, mix, dev = ctx.config, ctx.mix, ctx.device
    n_batches = mix["control_batches"]
    pool = query_batches(ctx.seed, mix, mix["pool_batches"], mix["batch"])
    sample_np = sample_rows(ctx.seed, mix)
    texts = [pool[i % len(pool)][r] for i in range(n_batches)
             for r in sample_np[i]]
    w = weights_lfm2.make(cfg, ctx.seed, dev)
    q, sets, _ = ref_lfm2.encode(cfg, w, texts, prec, device=dev)
    q = q.float()
    del w
    common.free(dev)
    v, ids = topk(cfg, ctx.seed, q, prec, dev)
    return compare(ctx, texts, q, v.float(), ids, sets)


def topk(cfg: dict, seed: int, q: torch.Tensor, prec: str, dev):
    """(values, ids) of the exact top-k in ``prec``, over the corpus
    rebuilt a block at a time."""
    k, dtype = cfg["index"]["top_k"], cfg["index"]["dtype"]
    qd = q.to(dev).to(ref_search.DTYPES[dtype])
    best_v = best_i = None
    for r0, raw in corpus.Blocks(cfg, seed, dev).starts():
        rows = ref_search.stored_rows(raw, dtype)
        del raw
        blk = P.matmul(qd, rows.t(), prec).to(P.compute_dtype(prec))
        vv, ii = torch.topk(blk, min(k, blk.shape[1]), dim=1)
        ii = ii + r0
        if best_v is not None:
            vv, ii = torch.cat([best_v, vv], 1), torch.cat([best_i, ii], 1)
            vv, j = torch.topk(vv, k, dim=1)
            ii = torch.gather(ii, 1, j)
        best_v, best_i = vv, ii
    return best_v, best_i
