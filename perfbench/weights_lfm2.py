"""The LFM2-MoE encoder's weights, made on the device leaf by leaf in the
configuration's dtype from the run's seed, and handed to the program and
to the reference alike.

Names follow the program's module (``models/lfm2_moe.py``'s state dict);
each leaf has a generator of its own, seeded from the run's seed and the
leaf's name. Dense kernels, stacked expert kernels and the router are
(..., out, in) and N(0, 1/in); the depthwise conv (hidden, 1, taps) is
N(0, 1/taps); the embedding N(0, 1); every RMSNorm weight 1 + N(0, 0.05^2);
each MoE layer's expert bias N(0, 0.01^2), which moves the choice of
experts near a tie but not their weights.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from .traffic import sub_seed

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def layer_types(cfg: dict) -> List[str]:
    """The kind of each of the configuration's layers."""
    return list(cfg["layer_types"][: cfg["num_hidden_layers"]])


def dense_layers(cfg: dict) -> int:
    return min(cfg["num_dense_layers"], cfg["num_hidden_layers"])


def head_dim(cfg: dict) -> int:
    return cfg["hidden_size"] // cfg["num_attention_heads"]


def shapes(cfg: dict) -> List[Tuple[str, Tuple[int, ...]]]:
    """Every weight's name and shape, in the program's order."""
    h, dh = cfg["hidden_size"], head_dim(cfg)
    heads, kv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    e, de = cfg["num_experts"], cfg["moe_intermediate_size"]
    out = [("embed.weight", (cfg["vocab_size"], h))]
    for i, kind in enumerate(layer_types(cfg)):
        p = f"layers.{i}."
        out.append((p + "op_norm.weight", (h,)))
        if kind == "conv":
            out += [(p + "conv.in_proj.weight", (3 * h, h)),
                    (p + "conv.conv.weight", (h, 1, cfg["conv_L_cache"])),
                    (p + "conv.out_proj.weight", (h, h))]
        else:
            out += [(p + "attn.q_proj.weight", (heads * dh, h)),
                    (p + "attn.k_proj.weight", (kv * dh, h)),
                    (p + "attn.v_proj.weight", (kv * dh, h)),
                    (p + "attn.out_proj.weight", (h, heads * dh)),
                    (p + "attn.q_norm.weight", (dh,)),
                    (p + "attn.k_norm.weight", (dh,))]
        out.append((p + "ffn_norm.weight", (h,)))
        if i < dense_layers(cfg):
            m = cfg["intermediate_size"]
            out += [(p + "ffn.w1.weight", (m, h)), (p + "ffn.w3.weight", (m, h)),
                    (p + "ffn.w2.weight", (h, m))]
        else:
            out += [(p + "ffn.expert_bias", (e,)),
                    (p + "ffn.w1", (e, de, h)), (p + "ffn.w3", (e, de, h)),
                    (p + "ffn.w2", (e, h, de)),
                    (p + "ffn.gate.weight", (e, h))]
    out.append(("norm.weight", (h,)))
    return out


def make(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The weights of ``seed`` on ``device``, in the configuration's
    dtype."""
    dtype = DTYPES[cfg["dtype"]]
    out: Dict[str, torch.Tensor] = {}
    for name, shape in shapes(cfg):
        g = torch.Generator(device=device).manual_seed(
            sub_seed(seed, f"weights:{name}"))
        w = torch.randn(shape, generator=g, device=device, dtype=dtype)
        if name.endswith("norm.weight"):
            w.mul_(0.05).add_(1.0)
        elif name.endswith("expert_bias"):
            w.mul_(0.01)
        elif name != "embed.weight":
            w.mul_(shape[-1] ** -0.5)
        out[name] = w
    return out
