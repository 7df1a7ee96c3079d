"""Contrastive fine-tuning of the encoder: ``ContrastiveEncoderTrainer.fit``
on (query, positive chunk, hard negative) triples, as a user fine-tunes on
their corpus.

Set-up builds one trainer on the benchmark's weights and drives it through
its first steps with the window's own call, ``fit``, on rows that all
differ: a first call of ``check_steps`` steps (whose losses, first
gradient and parameter change the reference follows), then a short call
that times a step and sizes the window's call. The window is one ``fit``
call over as many steps as fill ``--seconds``, on the same trainer and
encoder.

End-to-end: ``train_tokens_per_s``, the real (unpadded) tokens of every
side of every step of the window's call, over the call. Per-layer (traced
runs, a short ``fit`` call after the window under the profiler): the
step's share of the bf16 peak and the card's idle share.

Correctness, against the reference's float64 steps from the same weights
on the same rows: ``loss_gap``, the widest relative gap of a step's loss;
``grad_gap``, over the leaves, the gap between the norms of the program's
first gradient (as the optimizer gets it, read by a hook on each master)
and the reference's, over the larger of the reference's norm of that leaf
and of the median leaf; ``update_gap``, the same for each leaf's change
over the checked steps. Leaves whose reference gradient is under a
thousandth of the median leaf's (a key's bias under softmax) move by
round-off alone and are left out of both, by that rule and not by name.
"""
from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from perfbench import flops, traffic, weights
from perfbench.kinds import common
from perfbench.reference import train as ref_train


def trainer_config(mix: dict, seed: int):
    from semanticsearch_tpu_torch.train.encoder_train import ContrastiveConfig

    tc = mix["trainer"]
    return ContrastiveConfig(
        epochs=1, batch_size=mix["batch"],
        learning_rate=tc["learning_rate"], warmup_frac=tc["warmup_frac"],
        weight_decay=tc["weight_decay"], temperature=tc["temperature"],
        symmetric=tc["symmetric"], max_len_query=tc["max_len_query"],
        max_len_chunk=tc["max_len_chunk"], use_hard_negatives=True,
        seed=traffic.sub_seed(seed, "order") % (1 << 31))


def triples(seed: int, mix: dict, n: int, purpose: str):
    """``n`` (query, positive, negative) texts and their word counts."""
    lo, hi = mix["chunk_words"]
    texts = tuple(traffic.dealt_texts(seed, f"{purpose}:{side}", mix, draw)
                  for side, draw in (
                      ("q", lambda sh: traffic.query_lengths(sh, n, mix)),
                      ("p", lambda sh: traffic.uniform_lengths(sh, n, lo, hi)),
                      ("n", lambda sh: traffic.uniform_lengths(sh, n, lo,
                                                               hi))))
    return texts, tuple(np.array([len(t.split()) for t in side])
                        for side in texts)


def real_tokens(mix: dict, counts) -> np.ndarray:
    """Every row's real token count ([CLS] and the words, cut at the
    side's length): queries, positives, negatives."""
    tc = mix["trainer"]
    qn, pn, nn = counts
    return (np.minimum(qn + 1, tc["max_len_query"]),
            np.minimum(pn + 1, tc["max_len_chunk"]),
            np.minimum(nn + 1, tc["max_len_chunk"]))


def _fit(trainer, texts, n_steps: int, bs: int):
    q, p, neg = texts
    n = n_steps * bs
    reps = -(-n // len(q))
    pairs = list(zip(q * reps, p * reps))[:n]
    negs = (neg * reps)[:n]
    trainer.fit(pairs, negs)


def run(ctx) -> dict:
    cfg, mix, dev, tracer = ctx.config, ctx.mix, ctx.device, ctx.tracer
    from semanticsearch_tpu_torch.train.encoder_train import (
        ContrastiveEncoderTrainer)

    bs, n_check = mix["batch"], mix["check_steps"]
    w = weights.make(cfg, ctx.seed, dev)
    enc = common.port_encoder(cfg, w, dev)
    del w
    tcfg = trainer_config(mix, ctx.seed)
    trainer = ContrastiveEncoderTrainer(enc, tcfg)

    # the checked steps: losses at the step's return, the first gradient
    # as it reaches each master
    check, check_counts = triples(ctx.seed, mix, n_check * bs, "check")
    losses: List[torch.Tensor] = []
    first_grad: Dict[str, torch.Tensor] = {}
    step_loss = trainer._loss

    def recording_loss(*a, **kw):
        out = step_loss(*a, **kw)
        losses.append(out.detach())
        return out

    hooks = []
    for name, p in enc.master.named_parameters():
        def keep(param, name=name):
            if name not in first_grad:
                first_grad[name] = param.grad.detach().double().norm()
        hooks.append(p.register_post_accumulate_grad_hook(keep))
    trainer._loss = recording_loss
    trainer.fit(list(zip(check[0], check[1])), check[2])
    common.sync(dev)
    for h in hooks:
        h.remove()
    del trainer._loss
    port = {"losses": [float(x) for x in losses],
            "grad": {n: float(v) for n, v in first_grad.items()},
            "after": {n: p.detach().clone()
                      for n, p in enc.master.named_parameters()}}

    # a short call times a step, which sizes the window's call
    pool, pool_counts = triples(ctx.seed, mix, mix["pool_steps"] * bs,
                                "pool")
    t = time.perf_counter()
    _fit(trainer, pool, mix["timing_steps"], bs)
    common.sync(dev)
    step_s = (time.perf_counter() - t) / mix["timing_steps"]
    n_steps = max(mix["min_steps"], int(round(ctx.seconds / step_s)))
    tracer.warm()

    t0 = time.perf_counter()
    with tracer.span("fit"):
        _fit(trainer, pool, n_steps, bs)
    common.sync(dev)
    t_end = time.perf_counter()
    n_rows = n_steps * bs
    reps = -(-n_rows // (mix["pool_steps"] * bs))
    lens = [np.concatenate([x] * reps)[:n_rows]
            for x in real_tokens(mix, pool_counts)]
    tokens = float(sum(x.sum() for x in lens))
    layer = {}
    if ctx.trace:
        n_tr = mix["trace_steps"]
        tracer.start()
        with tracer.span("fit"):
            _fit(trainer, pool, n_tr, bs)
        tracer.stop()
        tr = [x[:n_tr * bs] for x in lens]
        layer = {"train_ops": flops.train_step_ops(
            cfg, np.concatenate(tr)), "peak": cfg["peak"]}
    peak = common.memory_peak(dev)
    del trainer, enc
    common.free(dev)
    compared = compare(ctx, check, port)
    return {"e2e": {"train_tokens_per_s": tokens / (t_end - t0)},
            "setup_s": t0 - ctx.t_start, "compared": compared,
            "attempted": n_steps, "failed": 0,
            "memory_peak_bytes": peak, "layer": layer}


def _steps(ctx, texts):
    """The checked steps' rows as the trainer orders them: one epoch's
    permutation of the pairs (seeded by the trainer's seed), cut into
    batches."""
    mix = ctx.mix
    bs = mix["batch"]
    q, p, neg = texts
    order = np.random.default_rng(
        trainer_config(mix, ctx.seed).seed).permutation(len(q))
    out = []
    for s in range(0, len(q), bs):
        sel = order[s: s + bs]
        out.append(([q[i] for i in sel],
                    [p[i] for i in sel] + [neg[i] for i in sel]))
    return out


def _leaf_gap(port: Dict[str, float], ref: Dict[str, float],
              keep: List[str]) -> float:
    med = float(np.median([ref[n] for n in keep]))
    return max(abs(port[n] - ref[n]) / max(ref[n], med) for n in keep)


def reference(ctx, texts, prec: str, fault: str = ""):
    """The reference's checked steps in ``prec`` from the seed's weights:
    (losses, first gradient's norm by leaf, parameters after, start)."""
    cfg, mix = ctx.config, ctx.mix
    w0 = weights.make(cfg, ctx.seed, ctx.device)
    losses, g1, after = ref_train.train(cfg, w0, _steps(ctx, texts),
                                        mix["trainer"], mix["check_steps"],
                                        prec, fault)
    return (losses, {n: float(g.double().norm()) for n, g in g1.items()},
            after, w0)


def compare(ctx, texts, port) -> list:
    lim = ctx.limits
    r_losses, r_grad, r_after, w0 = reference(ctx, texts, "f64")
    med = float(np.median(list(r_grad.values())))
    keep = [n for n in r_grad if r_grad[n] >= 1e-3 * med]

    def change(after):
        return {n: float((after[n].double() - w0[n].double()).norm())
                for n in keep}

    loss_gap = max(abs(a - b) / abs(b)
                   for a, b in zip(port["losses"], r_losses)) \
        if len(port["losses"]) == len(r_losses) else float("inf")
    grad_gap = _leaf_gap(port["grad"], r_grad, keep) \
        if set(keep) <= set(port["grad"]) else float("inf")
    update_gap = _leaf_gap(change(port["after"]), change(r_after), keep)
    return [("loss_gap", common.finite(loss_gap), lim["loss_gap"]),
            ("grad_gap", common.finite(grad_gap), lim["grad_gap"]),
            ("update_gap", common.finite(update_gap), lim["update_gap"])]


def control(ctx, prec: str, fault: str = "") -> list:
    """The reference's steps in ``prec`` in the program's place (with
    ``fault`` planted, see ``reference.train.train``), judged as a run
    judges the program's."""
    mix = ctx.mix
    check, _ = triples(ctx.seed, mix, mix["check_steps"] * mix["batch"],
                       "check")
    losses, grad, after, _ = reference(ctx, check, prec, fault)
    return compare(ctx, check, {"losses": losses, "grad": grad,
                                "after": after})
