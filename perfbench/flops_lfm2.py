"""The LFM2-MoE encoder's operations and bytes, beside ``flops.py``'s
peaks: the forward over texts of given real token counts, the weights a
forward reads, and the routed experts' work that ``moe_roofline.mine``
divides.

Per token, a conv layer's products are its in-projection (hidden x 3
hidden) and out-projection (hidden x hidden); an attention layer's its
four projections (q and out hidden x hidden, k and v hidden x H_kv Dh)
and, over a text of n tokens, the causal Q K^T and P V over n (n + 1) / 2
(query, key) pairs of every head; a dense layer's SwiGLU three hidden x
width products; a MoE layer's router (hidden x experts) and the experts
actually routed, k a token, each three hidden x expert-width products.
Norms, RoPE, the convolution's taps, the gates and the pooling are not
counted. An operation is two of a multiply-add.
"""
from __future__ import annotations

import math
from typing import Iterable, Tuple

from .weights_lfm2 import dense_layers, head_dim, layer_types, shapes


def layer_macs_per_token(cfg: dict) -> float:
    """Multiply-adds of every layer's products for one token (attention's
    two products over the keys aside)."""
    h, dh = cfg["hidden_size"], head_dim(cfg)
    kv = cfg["num_key_value_heads"]
    macs = 0.0
    for i, kind in enumerate(layer_types(cfg)):
        macs += (4 * h * h if kind == "conv"
                 else 2 * h * h + 2 * h * kv * dh)
        if i < dense_layers(cfg):
            macs += 3 * h * cfg["intermediate_size"]
        else:
            macs += h * cfg["num_experts"] + (
                cfg["num_experts_per_tok"] * 3 * h
                * cfg["moe_intermediate_size"])
    return macs


def encoder_forward_ops(cfg: dict, lengths: Iterable[int]) -> float:
    """Forward operations over texts of these real token counts."""
    n_attn = sum(k != "conv" for k in layer_types(cfg))
    h = cfg["num_attention_heads"] * head_dim(cfg)
    tokens = pairs = 0.0
    for n in lengths:
        tokens += n
        pairs += n * (n + 1) / 2.0
    return 2.0 * (layer_macs_per_token(cfg) * tokens
                  + n_attn * 2.0 * h * pairs)


def encoder_weight_bytes(cfg: dict, itemsize: int) -> float:
    """The bytes of every weight but the embedding table, every expert's
    included, read once."""
    return float(itemsize * sum(
        math.prod(s) for n, s in shapes(cfg) if n != "embed.weight"))


def moe_ops_bytes(cfg: dict, pairs: int, layers: int,
                  itemsize: int = 2) -> Tuple[float, float]:
    """The routed experts' work over ``pairs`` token-expert pairs in
    ``layers`` MoE layer forwards: their products, and each layer's expert
    weights read once with the permuted tokens in and their outputs out."""
    h, de, e = (cfg["hidden_size"], cfg["moe_intermediate_size"],
                cfg["num_experts"])
    ops = 2.0 * pairs * 3 * h * de
    nbytes = itemsize * (layers * e * 3.0 * h * de + 2.0 * pairs * h)
    return ops, nbytes
