"""LFM2-MoE as a retrieval encoder: the port's second encoder family.

The block is LiquidAI's LFM2-MoE (``LFM2MoEConfig``; LFM2-8B-A1B at its
defaults), a causal language model served as an encoder the way decoder
embedders are (e5-mistral, arXiv:2401.00368): each text's last token's
final state, L2-normalized, is its embedding. The JAX package has no
counterpart; ``tests/_lfm2_reference.py`` and the benchmark's
``perfbench/reference/lfm2_moe.py`` hold it to plain float64 math.

The forward runs on packed texts, as ``models/encoder.py``'s does: (N,)
token ids, the real tokens of a batch's texts end to end, with their
``ops.flash_attention.Varlen`` layout. Every product has no bias. With
``x`` the (N, hidden) token states, a layer is::

    h  = RMSNorm(x) w_op                      (eps 1e-5, weight as is)
    conv layer:  [B | C | X] = h W_in, u = B * X,
                 v_t = w_0 u_{t-2} + w_1 u_{t-1} + w_2 u_t  (depthwise, a u
                 before its text's first token is 0), out = (C * v) W_out
    attention:   q = h W_q, k = h W_k, v = h W_v; RMSNorm over each head's
                 width on q and k, RoPE (rotate-half, the whole head) at
                 each token's place in its text; causal softmax attention
                 within the text, query head g on K/V head g // (H / H_kv);
                 out = o W_o
    x  = x + out;  h2 = RMSNorm(x) w_ffn
    dense layer: x += W_2(silu(W_1 h2) * W_3 h2)
    MoE layer:   s = sigmoid(h2 W_g) (logits in float32); E = top-k of
                 s + b (the expert bias chooses, it does not weigh);
                 g_e = s_e / (sum_E s + 1e-6) * scaling;
                 x += sum_E g_e W_2^e(silu(W_1^e h2) * W_3^e h2)

then a final RMSNorm and each text's last token. Norms and RoPE tables are
computed in float32 and rounded to the weights' dtype (``ops.rms_norm``: on
the card each residual add and the norm after it, the next layer's
``op_norm`` or the final norm, in one kernel; the q/k norms in the same
kernel), the conv's taps summed in float32 (``ops.short_conv``: on the
card one kernel from B, C, X to the gated result), and the experts'
outputs mixed by one batched product (float32 accumulation) with the gate
weights rounded to that dtype.

The MoE layer makes no device-to-host sync: the route, the sort of the
(token, expert) pairs by expert, the group offsets (a scatter-add of
ones, cumulated), the expert products (``torch._grouped_mm`` over the
offsets, on the device) and the combine (the pairs gathered back into
token order, weighted by one batched product) are all device work of
host-known sizes. So the pipelined search keeps launching while the card
runs, and ``torch.cuda.set_sync_debug_mode("error")`` passes the forward
(``tests/test_torch_cuda_kernels.py``).

Spans (``core/profiling.py``): ``encoder.conv layer=``,
``encoder.attention layer=`` around each token mixer, ``encoder.moe
layer= tokens=`` around each MoE layer's routing, sort, products and
combine; the residual adds and the norms lie outside them. Counters:
``encoder.moe_pairs`` (token-expert pairs run) and ``encoder.moe_layers``
(MoE layer forwards).
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from ..core import profiling
from ..core.config import LFM2MoEConfig
from ..ops.flash_attention import (Varlen, flash_attention_varlen,
                                   flash_attention_varlen_plain)
from ..ops.rms_norm import add_rms_norm, rms_norm
from ..ops.short_conv import gated_short_conv
from .encoder import l2_head, on_meta

# token-expert pairs the MoE layers ran, and MoE layer forwards, in this
# process
MOE_PAIRS = 0
MOE_LAYERS = 0
ON_MESH = False  # the family runs on one device


class RMSNorm(nn.Module):
    """x / rms(x) in float32, rounded to x's dtype, times the weight
    (``ops.rms_norm``: one kernel on the card). ``add(x, d)`` is (x + d,
    the norm of it), in one launch."""

    def __init__(self, dim: int, eps: float) -> None:
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rms_norm(x, self.weight, self.eps)

    def add(self, x: torch.Tensor, d: torch.Tensor):
        return add_rms_norm(x, d, self.weight, self.eps)


class _Packed(NamedTuple):
    """What every layer of one forward shares: the texts' layout and the
    RoPE tables at each token's place."""

    layout: Varlen
    cos: Optional[torch.Tensor]
    sin: Optional[torch.Tensor]


class ShortConv(nn.Module):
    """The gated short convolution: in-projection to B, C, X, the
    depthwise causal convolution of B * X over the text's own tokens and
    the C gate (``ops.short_conv``: one kernel on the card), out-projection.
    """

    def __init__(self, cfg: LFM2MoEConfig) -> None:
        super().__init__()
        h = cfg.hidden_dim
        self.in_proj = nn.Linear(h, 3 * h, bias=False)
        self.conv = nn.Conv1d(h, h, cfg.conv_kernel, groups=h, bias=False)
        self.out_proj = nn.Linear(h, h, bias=False)

    def forward(self, x: torch.Tensor, packed: _Packed) -> torch.Tensor:
        return self.out_proj(gated_short_conv(
            self.in_proj(x), self.conv.weight, packed.layout.pos))


class GQAttention(nn.Module):
    """Grouped-query causal attention with RMSNorm on q and k and RoPE."""

    def __init__(self, cfg: LFM2MoEConfig) -> None:
        super().__init__()
        h, heads, kv = cfg.hidden_dim, cfg.num_heads, cfg.num_kv_heads
        self.heads, self.kv_heads = heads, kv
        self.head_dim = h // heads
        self.q_proj = nn.Linear(h, heads * self.head_dim, bias=False)
        self.k_proj = nn.Linear(h, kv * self.head_dim, bias=False)
        self.v_proj = nn.Linear(h, kv * self.head_dim, bias=False)
        self.out_proj = nn.Linear(heads * self.head_dim, h, bias=False)
        self.q_norm = RMSNorm(self.head_dim, cfg.norm_eps)
        self.k_norm = RMSNorm(self.head_dim, cfg.norm_eps)

    def forward(self, x: torch.Tensor, packed: _Packed,
                flash: bool) -> torch.Tensor:
        dh = self.head_dim
        q = self.q_norm(self.q_proj(x).unflatten(-1, (self.heads, dh)))
        k = self.k_norm(self.k_proj(x).unflatten(-1, (self.kv_heads, dh)))
        v = self.v_proj(x).unflatten(-1, (self.kv_heads, dh))
        q, k = (_rope(t, packed.cos, packed.sin) for t in (q, k))
        attend = (flash_attention_varlen if flash
                  else flash_attention_varlen_plain)
        o = attend(q, k, v, packed.layout, causal=True)
        return self.out_proj(o.flatten(1))


def _rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
          ) -> torch.Tensor:
    """Rotate-half RoPE over the whole head: x (N, heads, dh), tables (N,
    dh) in x's dtype."""
    x1, x2 = x.chunk(2, dim=-1)
    return x * cos[:, None] + torch.cat([-x2, x1], dim=-1) * sin[:, None]


class SwiGLU(nn.Module):
    """The dense layers' feed-forward: W_2(silu(W_1 x) * W_3 x)."""

    def __init__(self, hidden: int, width: int) -> None:
        super().__init__()
        self.w1 = nn.Linear(hidden, width, bias=False)
        self.w3 = nn.Linear(hidden, width, bias=False)
        self.w2 = nn.Linear(width, hidden, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.w2(F.silu(self.w1(x)) * self.w3(x))


class MoE(nn.Module):
    """The sigmoid-routed mixture of experts, with no host sync (the module
    docstring). Expert weights are stacked: ``w1``, ``w3`` (experts, width,
    hidden) and ``w2`` (experts, hidden, width), each expert's as a Linear
    holds it. ``capture``: a list to which each forward appends its chosen
    experts, (N, k) int64 on the device; None keeps nothing."""

    def __init__(self, cfg: LFM2MoEConfig) -> None:
        super().__init__()
        h, e, de = cfg.hidden_dim, cfg.num_experts, cfg.expert_dim
        self.top_k = cfg.experts_per_token
        self.norm_topk = cfg.norm_topk_prob
        self.scaling = cfg.routed_scaling
        self.gate = nn.Linear(h, e, bias=False)
        self.expert_bias = nn.Parameter(torch.zeros(e))
        self.w1 = nn.Parameter(torch.empty(e, de, h))
        self.w3 = nn.Parameter(torch.empty(e, de, h))
        self.w2 = nn.Parameter(torch.empty(e, h, de))
        self.capture: Optional[list] = None

    def route(self, x: torch.Tensor):
        """(chosen experts (N, k) int64, their weights (N, k) float32)."""
        s = torch.sigmoid(F.linear(x.float(), self.gate.weight.float()))
        _, chosen = torch.topk(s + self.expert_bias.float(), self.top_k,
                               dim=-1)
        g = s.gather(1, chosen)
        if self.norm_topk:
            g = g / (g.sum(-1, keepdim=True) + 1e-6)
        return chosen, g * self.scaling

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        global MOE_PAIRS, MOE_LAYERS
        n, k = x.shape[0], self.top_k
        chosen, g = self.route(x)
        if self.capture is not None:
            self.capture.append(chosen)
        # the (token, expert) pairs sorted by expert, and each expert's end
        flat = chosen.flatten()
        order = torch.argsort(flat, stable=True)
        ends = torch.zeros(self.w1.shape[0], dtype=torch.int32,
                           device=x.device).scatter_add_(
            0, flat, torch.ones_like(flat, dtype=torch.int32)).cumsum(
            0, dtype=torch.int32)
        xs = x.index_select(0, order // k)
        act = (F.silu(torch._grouped_mm(xs, self.w1.transpose(1, 2),
                                        offs=ends))
               * torch._grouped_mm(xs, self.w3.transpose(1, 2), offs=ends))
        ys = torch._grouped_mm(act, self.w2.transpose(1, 2), offs=ends)
        # back into (token, slot) order, summed by the gate weights
        inv = torch.empty_like(order).scatter_(
            0, order, torch.arange(order.numel(), device=x.device))
        ys = ys.index_select(0, inv).view(n, k, -1)
        MOE_PAIRS += n * k
        MOE_LAYERS += 1
        return torch.bmm(g.to(ys.dtype)[:, None], ys)[:, 0]


class LFM2Block(nn.Module):
    def __init__(self, cfg: LFM2MoEConfig, index: int) -> None:
        super().__init__()
        self.index = index
        self.is_conv = cfg.layer_types[index] == "conv"
        self.op_norm = RMSNorm(cfg.hidden_dim, cfg.norm_eps)
        if self.is_conv:
            self.conv = ShortConv(cfg)
        else:
            self.attn = GQAttention(cfg)
        self.ffn_norm = RMSNorm(cfg.hidden_dim, cfg.norm_eps)
        self.is_moe = index >= cfg.num_dense_layers
        self.ffn = (MoE(cfg) if self.is_moe
                    else SwiGLU(cfg.hidden_dim, cfg.mlp_dim))

    def forward(self, x: torch.Tensor, h: torch.Tensor, norm: RMSNorm,
                packed: _Packed, flash: bool):
        """(x, h): the residual stream and this layer's ``op_norm`` of it in,
        the stream after the layer and ``norm`` of it (the next layer's
        ``op_norm``, or the final norm) out. Each residual add and the norm
        after it are one launch, outside the spans."""
        if self.is_conv:
            with profiling.span("encoder.conv", {"layer": self.index}):
                out = self.conv(h, packed)
        else:
            with profiling.span("encoder.attention", {"layer": self.index}):
                out = self.attn(h, packed, flash)
        x, h = self.ffn_norm.add(x, out)
        if not self.is_moe:
            return norm.add(x, self.ffn(h))
        with profiling.span("encoder.moe", {"layer": self.index,
                                            "tokens": x.shape[0]}):
            out = self.ffn(h)
        return norm.add(x, out)


class LFM2MoEModel(nn.Module):
    """Token embedding -> LFM2 blocks -> RMSNorm -> each text's last token,
    L2-normalized. ``forward(ids, layout)`` takes packed texts ((N,) ids,
    their ``Varlen``; every text holds at least one token, the tokenizer's
    first id) and returns (rows, hidden) float32."""

    def __init__(self, cfg: LFM2MoEConfig) -> None:
        super().__init__()
        self.cfg = cfg
        self.embed = nn.Embedding(cfg.vocab_size, cfg.hidden_dim)
        self.layers = nn.ModuleList(
            LFM2Block(cfg, i) for i in range(cfg.num_layers))
        self.norm = RMSNorm(cfg.hidden_dim, cfg.norm_eps)

    def packs(self, lens: np.ndarray) -> bool:
        """Every batch runs packed: the model has no padded forward."""
        return True

    def moe_layers(self) -> List[MoE]:
        return [b.ffn for b in self.layers if b.is_moe]

    def set_capture(self, capture: Optional[list]) -> None:
        """Every MoE layer appends its chosen experts to ``capture`` (one
        (N, k) tensor a layer a forward, in layer order); None stops."""
        for m in self.moe_layers():
            m.capture = capture

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Seeded init: kernels N(0, 1/fan_in) (the conv's fan-in is its
        taps), the embedding N(0, 1), norms 1, expert biases
        N(0, 0.01^2)."""
        with torch.no_grad():
            for name, p in self.named_parameters():
                if name.endswith("norm.weight"):
                    p.fill_(1.0)
                    continue
                x = torch.randn(p.shape, generator=generator,
                                device=generator.device)
                if name.endswith("expert_bias"):
                    x.mul_(0.01)
                elif not name.startswith("embed"):  # (..., out, fan_in)
                    x.mul_(p.shape[-1] ** -0.5)
                p.copy_(x)

    def _packed(self, layout: Varlen, dtype: torch.dtype) -> _Packed:
        c = self.cfg
        pos = layout.pos
        cos = sin = None
        if "full_attention" in c.layer_types:
            dh = c.hidden_dim // c.num_heads
            inv = 1.0 / (c.rope_theta ** (torch.arange(
                0, dh, 2, device=pos.device, dtype=torch.float32) / dh))
            f = pos.float()[:, None] * inv[None]
            emb = torch.cat([f, f], dim=-1)
            cos, sin = emb.cos().to(dtype), emb.sin().to(dtype)
        return _Packed(layout, cos, sin)

    def forward(self, ids: torch.Tensor, layout: Varlen) -> torch.Tensor:
        # the attention kernel unless "stock" (on a CPU tensor the kernel's
        # wrapper runs its plain version)
        flash = self.cfg.attention != "stock"
        x = self.embed(ids)
        packed = self._packed(layout, x.dtype)
        h = self.layers[0].op_norm(x)
        norms = [b.op_norm for b in self.layers[1:]] + [self.norm]
        for layer, norm in zip(self.layers, norms):
            x, h = layer(x, h, norm, packed, flash)
        last = (layout.cu_seqlens[1:] - 1).long()
        return l2_head(self.cfg, h.index_select(0, last).float())


def build_model(cfg: LFM2MoEConfig, device: torch.device, seed: int = 0,
                state_dict: Optional[dict] = None):
    """(The model on ``device`` in ``cfg.dtype``, None: no float32
    masters), built once: on the meta device, then given ``state_dict``'s
    tensors themselves where they are already of that device and dtype
    (``load_state_dict(assign=True)``: no copy), or a seeded init."""
    dtype = getattr(torch, cfg.dtype)
    model = on_meta(LFM2MoEModel, cfg)
    if state_dict is None:
        model = model.to_empty(device=device)
        model.reset_parameters(torch.Generator(device=device).manual_seed(
            seed))
        model = model.to(dtype)
    else:
        model.load_state_dict(
            {k: v.to(device=device, dtype=dtype)
             for k, v in state_dict.items()}, assign=True)
    return model.eval(), None
