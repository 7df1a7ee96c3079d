"""Flax encoder parameters -> the port's ``state_dict``.

The JAX package's ``SentenceTransformerModel`` parameter tree, as nested
dicts of numpy arrays (``jax.tree.map(np.asarray, params)``):

    token_embed/embedding (V, D)          pos_embed/embedding (max_len, D)
    LayerNorm_0/{scale,bias}  (after the embeddings)
    LayerNorm_1/{scale,bias}  (final)
    layer_i/LayerNorm_0, layer_i/LayerNorm_1
    layer_i/MultiHeadDotProductAttention_0/{query,key,value}
        kernel (D, H, Dh), bias (H, Dh)
    layer_i/MultiHeadDotProductAttention_0/out
        kernel (H, Dh, D), bias (D,)
    layer_i/Dense_0 kernel (D, mlp)       layer_i/Dense_1 kernel (mlp, D)

Flax kernels are (in, out); ``nn.Linear`` weights are (out, in).
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _ln(tree: Mapping, prefix: str) -> Dict[str, torch.Tensor]:
    return {f"{prefix}.weight": _t(tree["scale"]),
            f"{prefix}.bias": _t(tree["bias"])}


def _dense(tree: Mapping, prefix: str) -> Dict[str, torch.Tensor]:
    kernel = np.asarray(tree["kernel"], np.float32)
    d_in = kernel.shape[0]
    return {f"{prefix}.weight": _t(kernel.reshape(d_in, -1).T),
            f"{prefix}.bias": _t(np.asarray(tree["bias"]).reshape(-1))}


def _dense_out(tree: Mapping, prefix: str) -> Dict[str, torch.Tensor]:
    kernel = np.asarray(tree["kernel"], np.float32)  # (H, Dh, D)
    return {f"{prefix}.weight": _t(kernel.reshape(-1, kernel.shape[-1]).T),
            f"{prefix}.bias": _t(tree["bias"])}


def flax_to_state_dict(params: Mapping, num_layers: int
                       ) -> Dict[str, torch.Tensor]:
    """Map the flax parameter tree onto ``SentenceTransformerModel``'s
    ``state_dict`` keys (float32 tensors on the CPU)."""
    sd = {
        "token_embed.weight": _t(params["token_embed"]["embedding"]),
        "pos_embed.weight": _t(params["pos_embed"]["embedding"]),
        **_ln(params["LayerNorm_0"], "ln_embed"),
        **_ln(params["LayerNorm_1"], "ln_final"),
    }
    for i in range(num_layers):
        layer = params[f"layer_{i}"]
        attn = layer["MultiHeadDotProductAttention_0"]
        p = f"layers.{i}"
        sd.update(_ln(layer["LayerNorm_0"], f"{p}.ln_attn"))
        sd.update(_ln(layer["LayerNorm_1"], f"{p}.ln_mlp"))
        for name in ("query", "key", "value"):
            sd.update(_dense(attn[name], f"{p}.attn.{name}"))
        sd.update(_dense_out(attn["out"], f"{p}.attn.out"))
        sd.update(_dense(layer["Dense_0"], f"{p}.mlp_in"))
        sd.update(_dense(layer["Dense_1"], f"{p}.mlp_out"))
    return sd
