"""A plain float64 LFM2-MoE forward for the tests, written from LiquidAI's
published block (the equations are in
``semanticsearch_tpu_torch/models/lfm2_moe.py``'s docstring); it imports
nothing of the port. One text at a time, no padding, no packing, no
kernels: RMSNorm (weight as is), the gated short convolution over the
text's own tokens, grouped-query causal attention with RMSNorm on q and k
and rotate-half RoPE, a SwiGLU in the dense layers, the sigmoid router
(the expert bias chooses, the normalized scores weigh) and the experts one
token at a time in the rest, a final RMSNorm.

Departures from the published model: no LM head (the final states are
returned; the encoder pools the last one); weights are the port's state
dict by name, experts stacked.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def _rms(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def text_states(cfg: dict, w: Dict[str, torch.Tensor], ids: List[int],
                forced: Optional[List[torch.Tensor]] = None):
    """One text's final states (T, hidden) in float64, the experts each
    MoE layer chose ((T, k) a layer), and route_gap: the largest (k-th best
    selection score) - (least selection score among the chosen), over its
    tokens and MoE layers (0 where ``forced`` is None or agrees)."""
    w = {k: v.double() for k, v in w.items()}
    eps, h = cfg["norm_eps"], cfg["hidden"]
    heads, kv = cfg["heads"], cfg["kv_heads"]
    dh, t = h // heads, len(ids)
    x = w["embed.weight"][torch.tensor(ids)]
    pos = torch.arange(t, dtype=torch.float64)
    inv = 1.0 / cfg["rope_theta"] ** (torch.arange(0, dh, 2).double() / dh)
    ang = torch.cat([pos[:, None] * inv, pos[:, None] * inv], dim=-1)
    cos, sin = ang.cos()[:, None], ang.sin()[:, None]

    def rope(z):
        z1, z2 = z.chunk(2, dim=-1)
        return z * cos + torch.cat([-z2, z1], dim=-1) * sin

    chosen_all, gap, j = [], 0.0, 0
    for i, kind in enumerate(cfg["layer_types"]):
        p = f"layers.{i}."
        hn = _rms(x, w[p + "op_norm.weight"], eps)
        if kind == "conv":
            bb, c, xx = (hn @ w[p + "conv.in_proj.weight"].T).chunk(3, -1)
            u = bb * xx
            taps = w[p + "conv.conv.weight"][:, 0, :]
            n_taps = taps.shape[1]
            v = torch.zeros_like(u)
            for s in range(t):
                for tap in range(n_taps):
                    back = n_taps - 1 - tap
                    if s - back >= 0:
                        v[s] += taps[:, tap] * u[s - back]
            out = (c * v) @ w[p + "conv.out_proj.weight"].T
        else:
            q = (hn @ w[p + "attn.q_proj.weight"].T).view(t, heads, dh)
            k = (hn @ w[p + "attn.k_proj.weight"].T).view(t, kv, dh)
            v = (hn @ w[p + "attn.v_proj.weight"].T).view(t, kv, dh)
            q = rope(_rms(q, w[p + "attn.q_norm.weight"], eps))
            k = rope(_rms(k, w[p + "attn.k_norm.weight"], eps))
            o = torch.zeros(t, heads, dh, dtype=torch.float64)
            for hd in range(heads):
                g = hd // (heads // kv)
                for s in range(t):
                    sc = (k[: s + 1, g] @ q[s, hd]) / math.sqrt(dh)
                    o[s, hd] = torch.softmax(sc, 0) @ v[: s + 1, g]
            out = o.reshape(t, heads * dh) @ w[p + "attn.out_proj.weight"].T
        x = x + out
        h2 = _rms(x, w[p + "ffn_norm.weight"], eps)
        if i < cfg["num_dense_layers"]:
            a = torch.nn.functional.silu(h2 @ w[p + "ffn.w1.weight"].T) * (
                h2 @ w[p + "ffn.w3.weight"].T)
            x = x + a @ w[p + "ffn.w2.weight"].T
            continue
        s = torch.sigmoid(h2 @ w[p + "ffn.gate.weight"].T)
        sel = s + w[p + "ffn.expert_bias"]
        own = torch.topk(sel, cfg["top_k"], dim=-1)
        chosen = own.indices if forced is None else forced[j]
        gap = max(gap, float((own.values[:, -1] - sel.gather(
            1, chosen).min(1).values).max()))
        y = torch.zeros_like(h2)
        for s_ in range(t):
            gw = s[s_, chosen[s_]]
            gw = gw / (gw.sum() + 1e-6)
            for e, ge in zip(chosen[s_].tolist(), gw):
                a = torch.nn.functional.silu(w[p + "ffn.w1"][e] @ h2[s_]) * (
                    w[p + "ffn.w3"][e] @ h2[s_])
                y[s_] += ge * (w[p + "ffn.w2"][e] @ a)
        x = x + y
        chosen_all.append(chosen)
        j += 1
    return _rms(x, w["norm.weight"], eps), chosen_all, gap


def embed(cfg, w, ids, forced=None):
    """A text's embedding: its last token's final state, L2-normalized."""
    states, chosen, gap = text_states(cfg, w, ids, forced)
    last = states[-1]
    return last / last.norm(), chosen, gap
