"""Contrastive (InfoNCE) training of the sentence encoder, as it is
stated: a batch of (query, positive, hard negative) texts, the query
embeddings against the positives and negatives stacked, logits over a
temperature, the symmetric cross entropy over the in-batch columns, and
AdamW (decoupled weight decay, PyTorch's order) on the warmup-cosine
schedule of optax (``init 0``, a linear warmup over ``max(1, int(steps *
warmup_frac))`` steps, a cosine to a tenth of the peak at ``max(2,
steps)``), counted from 0 at the first update.

The gradient is exact and taken in blocks of rows (the embeddings first,
without gradients; the loss's gradient with respect to them; then each
block's forward again with gradients, back-propagated from its share), so
a batch of long chunks fits beside nothing else.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch
from torch.nn import functional as F

from . import encoder as ref_encoder
from . import precision as P
from .tokenizer import encode as tokenize


def schedule(count: int, peak: float, total: int, warmup_frac: float
             ) -> float:
    warm = max(1, int(total * warmup_frac))
    decay = max(2, total)
    if count < warm:
        return peak * count / warm
    c = min(count - warm, decay - warm)
    cosine = 0.5 * (1.0 + math.cos(math.pi * c / (decay - warm)))
    return peak * (0.9 * cosine + 0.1)


def _tokens(cfg, texts, max_len, device):
    ids, mask = tokenize(texts, cfg["vocab_size"], max_len)
    return (torch.from_numpy(ids).to(device),
            torch.from_numpy(mask).to(device))


def loss_of(q: torch.Tensor, c: torch.Tensor, temperature: float,
            symmetric: bool) -> torch.Tensor:
    b = q.shape[0]
    logits = (q @ c.T) / temperature
    labels = torch.arange(b, device=q.device)
    loss = F.cross_entropy(logits, labels)
    if symmetric:
        loss = 0.5 * (loss + F.cross_entropy(logits[:, :b].T, labels))
    return loss


def step_grads(cfg: dict, params: Dict[str, torch.Tensor],
               queries: Sequence[str], chunks: Sequence[str], tc: dict,
               prec: str, block: int = 64):
    """(loss, gradients by name) of one step; ``chunks`` are the positives
    then the negatives."""
    dev = next(iter(params.values())).device
    sides = [(_tokens(cfg, queries, tc["max_len_query"], dev)),
             (_tokens(cfg, chunks, tc["max_len_chunk"], dev))]
    embs = []
    with torch.no_grad():
        for ids, mask in sides:
            embs.append(torch.cat([
                ref_encoder.forward(cfg, params, ids[s: s + block],
                                    mask[s: s + block], prec)
                for s in range(0, ids.shape[0], block)]))
    e = [x.detach().requires_grad_(True) for x in embs]
    loss = loss_of(e[0], e[1], tc["temperature"], tc["symmetric"])
    loss.backward()
    grads = {n: torch.zeros_like(p) for n, p in params.items()}
    leaves = {n: p.detach().requires_grad_(True) for n, p in params.items()}
    for (ids, mask), ge in zip(sides, (e[0].grad, e[1].grad)):
        for s in range(0, ids.shape[0], block):
            out = ref_encoder.forward(cfg, leaves, ids[s: s + block],
                                      mask[s: s + block], prec)
            gs = torch.autograd.grad(out, list(leaves.values()),
                                     grad_outputs=ge[s: s + block],
                                     allow_unused=True)
            for n, g in zip(leaves, gs):
                if g is not None:
                    grads[n] += g
    return float(loss.detach()), grads


def train(cfg: dict, params: Dict[str, torch.Tensor],
          steps: List[tuple], tc: dict, total_steps: int, prec: str = "f64",
          fault: str = ""):
    """Runs ``steps`` (each (queries, chunks)) from ``params``; returns the
    losses, the first step's gradients and the parameters after.

    ``fault`` plants one, for reading the check against it: "unchanged",
    a step that leaves the parameters as they were; "half_batch", each
    step's loss over the first half of its rows alone."""
    dt = P.compute_dtype(prec)
    p = {n: v.to(dt).clone() for n, v in params.items()}
    m = {n: torch.zeros_like(v) for n, v in p.items()}
    v2 = {n: torch.zeros_like(v) for n, v in p.items()}
    b1, b2, eps = 0.9, 0.999, 1e-8
    losses, first = [], None
    for t, (queries, chunks) in enumerate(steps, start=1):
        if fault == "half_batch":
            b, h = len(queries), len(queries) // 2
            queries, chunks = queries[:h], chunks[:h] + chunks[b: b + h]
        loss, g = step_grads(cfg, p, queries, chunks, tc, prec)
        losses.append(loss)
        if first is None:
            first = g
        lr = schedule(t - 1, tc["learning_rate"], total_steps,
                      tc["warmup_frac"])
        if fault == "unchanged":
            continue
        for n in p:
            m[n].mul_(b1).add_(g[n], alpha=1 - b1)
            v2[n].mul_(b2).addcmul_(g[n], g[n], value=1 - b2)
            p[n].mul_(1 - lr * tc["weight_decay"])
            denom = (v2[n].sqrt() / math.sqrt(1 - b2 ** t)).add_(eps)
            p[n].addcdiv_(m[n], denom, value=-lr / (1 - b1 ** t))
    return losses, first, p
