"""The LFM2-MoE encoder's forward in plain PyTorch, as LiquidAI's published
config defines the block (``semanticsearch_tpu_torch/models/lfm2_moe.py``
states the equations): RMSNorm before each operator (eps 1e-5, weight as
is); gated short convolutions (B, C, X from one projection, a causal
depthwise convolution of B * X over three taps, the C gate); grouped-query
causal attention with RMSNorm on q and k and rotate-half RoPE (theta from
the config) at each token's place; a SwiGLU in the dense layers and, in the
rest, a sigmoid router whose top-k of scores plus the expert bias chooses
the experts and whose normalized scores weigh them; a final RMSNorm; each
text's last token, L2-normalized.

Departures from the published model, each an assumption of the benchmark's
configuration: no LM head; the last token's state is the embedding; the
hashing tokenizer's first id stands as BOS.

Texts run in blocks, padded at the end to the block's longest: attention
and the convolution are causal and each text starts at position 0, so a
real token never sees a pad. Products go through ``precision.matmul``, so
the weights are cast to float64 (or rounded for a control) one product at
a time, each expert's while its tokens run; norms, softmax, the router and
the mixture run in the precision's compute dtype.

``forced``: the experts each MoE layer chose for each text's tokens, taken
from the program. The reference then weighs those experts by its own
scores, and reads how far the forced choice lies from its own over every
token and MoE layer: ``route_gap``, the largest (k-th best selection
score) - (the least selection score among the forced experts), the
selection score being the router's sigmoid plus the expert bias; and
``route_flips``, the share of (token, layer) pairs whose forced set is not
the reference's own top k. Both are 0 where every forced set is the
reference's own.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch.nn import functional as F

from . import precision as P

# padded tokens a block of texts may hold
BLOCK_TOKENS = 16384


class Route:
    """How far the experts used lie from the reference's own choice, over
    the (token, MoE layer) pairs seen: ``gap`` (``route_gap``), ``flips``
    of ``pairs`` (``route_flips`` = flips / pairs)."""

    def __init__(self) -> None:
        self.gap, self.flips, self.pairs = 0.0, 0, 0

    def add(self, own, sel: torch.Tensor, chosen: torch.Tensor) -> None:
        """One layer's tokens: ``own``, the reference's top k of the
        selection scores ``sel``; ``chosen``, the experts used."""
        if not chosen.shape[0]:
            return
        self.gap = max(self.gap, float((
            own.values[:, -1] - sel.gather(1, chosen).min(dim=1).values)
            .max()))
        differ = (own.indices.sort(dim=1).values
                  != chosen.sort(dim=1).values).any(dim=1)
        self.flips += int(differ.sum())
        self.pairs += int(chosen.shape[0])

    def merge(self, other: "Route") -> None:
        self.gap = max(self.gap, other.gap)
        self.flips += other.flips
        self.pairs += other.pairs

    @property
    def share(self) -> float:
        """``route_flips``: 0 over no pair."""
        return self.flips / self.pairs if self.pairs else 0.0


def _rms(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w.to(
        x.dtype)


def _mm(x, w, prec):
    """x @ w.T in ``prec``, back in x's dtype."""
    return P.matmul(x, w.t(), prec).to(x.dtype)


def _rope(x, cos, sin):
    x1, x2 = x.chunk(2, dim=-1)
    return x * cos + torch.cat([-x2, x1], dim=-1) * sin


def _layer_types(cfg: dict) -> List[str]:
    return list(cfg["layer_types"][: cfg["num_hidden_layers"]])


def forward(cfg: dict, w: Dict[str, torch.Tensor], ids: torch.Tensor,
            lens: torch.Tensor, prec: str = "f64",
            forced: Optional[List[torch.Tensor]] = None
            ) -> Tuple[torch.Tensor, List[torch.Tensor], Route]:
    """Unit embeddings (B, hidden) in the compute dtype of ``prec`` of
    (B, T) ids, each text's ``lens`` tokens at its first places; the
    experts each MoE layer used, (B, T, k) a layer; and how far they lie
    from the reference's own choice. ``forced``: (B, T, k) chosen experts
    a MoE layer, or None to choose."""
    dt = P.compute_dtype(prec)
    eps = cfg["norm_eps"]
    b, t = ids.shape
    dev = ids.device
    h = cfg["hidden_size"]
    heads, kv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    dh = h // heads
    k_top, n_dense = cfg["num_experts_per_tok"], cfg["num_dense_layers"]
    pos = torch.arange(t, device=dev)
    valid = pos[None] < lens[:, None]
    inv = 1.0 / (float(cfg["rope_theta"]) ** (
        torch.arange(0, dh, 2, device=dev, dtype=torch.float64) / dh))
    ang = pos.double()[:, None] * inv[None]
    ang = torch.cat([ang, ang], dim=-1).to(dt)
    cos, sin = ang.cos()[None, :, None], ang.sin()[None, :, None]
    causal = torch.ones(t, t, dtype=torch.bool, device=dev).tril()
    x = w["embed.weight"][ids].to(dt)
    used, route, j = [], Route(), 0
    for i, kind in enumerate(_layer_types(cfg)):
        p = f"layers.{i}."
        hn = _rms(x, w[p + "op_norm.weight"], eps)
        if kind == "conv":
            bb, c, xx = _mm(hn, w[p + "conv.in_proj.weight"], prec).chunk(
                3, dim=-1)
            u = bb * xx
            taps = w[p + "conv.conv.weight"][:, 0, :].to(dt)  # (h, L)
            n_taps = taps.shape[1]
            v = torch.zeros_like(u)
            for tap in range(n_taps):
                back = n_taps - 1 - tap  # u_{t - back}
                v = v + F.pad(u[:, : t - back], (0, 0, back, 0)) * taps[:, tap]
            out = _mm(c * v, w[p + "conv.out_proj.weight"], prec)
        else:
            q = _mm(hn, w[p + "attn.q_proj.weight"], prec).view(b, t, heads, dh)
            kk = _mm(hn, w[p + "attn.k_proj.weight"], prec).view(b, t, kv, dh)
            vv = _mm(hn, w[p + "attn.v_proj.weight"], prec).view(b, t, kv, dh)
            q = _rope(_rms(q, w[p + "attn.q_norm.weight"], eps), cos, sin)
            kk = _rope(_rms(kk, w[p + "attn.k_norm.weight"], eps), cos, sin)
            kk, vv = (z.repeat_interleave(heads // kv, dim=2).transpose(1, 2)
                      for z in (kk, vv))
            s = P.matmul(q.transpose(1, 2), kk.transpose(-1, -2), prec).to(
                dt) / math.sqrt(dh)
            s = s.masked_fill(~causal, float("-inf"))
            o = P.matmul(torch.softmax(s, dim=-1), vv, prec).to(dt)
            out = _mm(o.transpose(1, 2).reshape(b, t, heads * dh),
                      w[p + "attn.out_proj.weight"], prec)
        x = x + out
        h2 = _rms(x, w[p + "ffn_norm.weight"], eps)
        if i < n_dense:
            a = F.silu(_mm(h2, w[p + "ffn.w1.weight"], prec)) * _mm(
                h2, w[p + "ffn.w3.weight"], prec)
            x = x + _mm(a, w[p + "ffn.w2.weight"], prec)
            continue
        tok = h2[valid]  # the real tokens, (n, h)
        s = torch.sigmoid(_mm(tok, w[p + "ffn.gate.weight"], prec))
        sel = s + w[p + "ffn.expert_bias"].to(dt)
        own = torch.topk(sel, k_top, dim=-1)
        chosen = own.indices if forced is None else forced[j][valid].to(dev)
        route.add(own, sel, chosen)
        g = s.gather(1, chosen)
        if cfg["norm_topk_prob"]:
            g = g / (g.sum(-1, keepdim=True) + 1e-6)
        g = g * cfg["routed_scaling_factor"]
        y = torch.zeros_like(tok)
        for e in range(cfg["num_experts"]):
            rows, slot = (chosen == e).nonzero(as_tuple=True)
            if rows.numel() == 0:
                continue
            xe = tok[rows]
            a = F.silu(_mm(xe, w[p + "ffn.w1"][e], prec)) * _mm(
                xe, w[p + "ffn.w3"][e], prec)
            y.index_add_(0, rows, _mm(a, w[p + "ffn.w2"][e], prec)
                         * g[rows, slot][:, None])
        full = torch.zeros(b, t, k_top, dtype=torch.int64, device=dev)
        full[valid] = chosen
        used.append(full)
        x = x.clone()
        x[valid] = x[valid] + y
        j += 1
    x = _rms(x, w["norm.weight"], eps)
    last = x[torch.arange(b, device=dev), lens - 1]
    return (last / last.norm(dim=-1, keepdim=True).clamp(min=1e-12), used,
            route)


def blocks(lens: Sequence[int], block_tokens: int = BLOCK_TOKENS):
    """Texts in blocks of at most ``block_tokens`` padded tokens (a longer
    text alone), longest first: lists of text indices."""
    order = sorted(range(len(lens)), key=lambda i: -lens[i])
    out, cur = [], []
    for i in order:
        if cur and (len(cur) + 1) * lens[cur[0]] > block_tokens:
            out.append(cur)
            cur = []
        cur.append(i)
    if cur:
        out.append(cur)
    return out


def encode(cfg: dict, w: Dict[str, torch.Tensor], texts, prec: str = "f64",
           forced: Optional[List[torch.Tensor]] = None, device="cpu"):
    """Embeddings of ``texts`` (len, hidden), each text's chosen experts
    ((MoE layers, tokens, k) int64 on the host), and their :class:`Route`
    over all of them. ``forced``: a (MoE layers, tokens, k) tensor a text,
    or None."""
    from .tokenizer import token_ids

    rows = [token_ids(x, cfg["vocab_size"], cfg["max_position_embeddings"])
            for x in texts]
    lens = [len(r) for r in rows]
    out = torch.zeros(len(texts), cfg["hidden_size"],
                      dtype=P.compute_dtype(prec), device=device)
    sets: List[Optional[torch.Tensor]] = [None] * len(texts)
    route = Route()
    for blk in blocks(lens):
        t = lens[blk[0]]
        ids = torch.zeros(len(blk), t, dtype=torch.int64)
        for r, i in enumerate(blk):
            ids[r, : lens[i]] = torch.tensor(rows[i])
        lens_b = torch.tensor([lens[i] for i in blk], device=device)
        fb = None
        if forced is not None:
            fb = []
            for layer in range(forced[blk[0]].shape[0]):
                f = torch.zeros(len(blk), t, forced[blk[0]].shape[2],
                                dtype=torch.int64)
                for r, i in enumerate(blk):
                    f[r, : lens[i]] = forced[i][layer]
                fb.append(f.to(device))
        e, used, r = forward(cfg, w, ids.to(device), lens_b, prec, fb)
        route.merge(r)
        for r, i in enumerate(blk):
            out[i] = e[r]
            sets[i] = (torch.stack([u[r, : lens[i]] for u in used]).cpu()
                       if used else torch.zeros(0, lens[i], 0,
                                                dtype=torch.int64))
    return out, sets, route
