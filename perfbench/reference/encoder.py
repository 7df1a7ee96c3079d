"""The sentence encoder's forward in plain PyTorch: token and position
embeddings, a LayerNorm, pre-LN blocks (multi-head self-attention over the
real keys, a tanh-approximate or exact GELU MLP, each on a residual), a
final LayerNorm, the masked mean over the real tokens and L2
normalization. Products go through ``precision.matmul``; norms, softmax and
pooling run in the precision's compute dtype."""
from __future__ import annotations

import math
from typing import Dict

import torch
from torch.nn import functional as F

from . import precision as P


def _ln(x, w, b, eps):
    return F.layer_norm(x, (x.shape[-1],), w.to(x.dtype), b.to(x.dtype), eps)


def _dense(x, w, b, prec):
    return P.matmul(x, w.t(), prec).to(x.dtype) + b.to(x.dtype)


def forward(cfg: dict, w: Dict[str, torch.Tensor], ids: torch.Tensor,
            mask: torch.Tensor, prec: str = "f64") -> torch.Tensor:
    """Unit embeddings (B, hidden) in the compute dtype of ``prec``."""
    dt = P.compute_dtype(prec)
    eps = cfg["layer_norm_eps"]
    heads = cfg["num_attention_heads"]
    b, t = ids.shape
    x = (w["token_embed.weight"][ids].to(dt)
         + w["pos_embed.weight"][:t].to(dt)[None])
    x = _ln(x, w["ln_embed.weight"], w["ln_embed.bias"], eps)
    keep = mask.bool()
    tanh = cfg["hidden_act"] == "gelu_pytorch_tanh"
    for i in range(cfg["num_hidden_layers"]):
        p = f"layers.{i}."
        hdn = _ln(x, w[p + "ln_attn.weight"], w[p + "ln_attn.bias"], eps)
        q, k, v = (_dense(hdn, w[p + f"attn.{n}.weight"],
                          w[p + f"attn.{n}.bias"], prec)
                   .view(b, t, heads, -1).transpose(1, 2)
                   for n in ("query", "key", "value"))
        s = P.matmul(q, k.transpose(-1, -2), prec).to(dt)
        s = s / math.sqrt(q.shape[-1])
        s = s.masked_fill(~keep[:, None, None, :], float("-inf"))
        o = P.matmul(torch.softmax(s, dim=-1), v, prec).to(dt)
        o = o.transpose(1, 2).reshape(b, t, -1)
        x = x + _dense(o, w[p + "attn.out.weight"], w[p + "attn.out.bias"],
                       prec)
        hdn = _ln(x, w[p + "ln_mlp.weight"], w[p + "ln_mlp.bias"], eps)
        hdn = _dense(hdn, w[p + "mlp_in.weight"], w[p + "mlp_in.bias"], prec)
        hdn = F.gelu(hdn, approximate="tanh" if tanh else "none")
        x = x + _dense(hdn, w[p + "mlp_out.weight"], w[p + "mlp_out.bias"],
                       prec)
    x = _ln(x, w["ln_final.weight"], w["ln_final.bias"], eps)
    m = mask.to(dt)[..., None]
    pooled = (x * m).sum(1) / m.sum(1).clamp(min=1.0)
    return pooled / pooled.norm(dim=-1, keepdim=True).clamp(min=1e-12)


def encode(cfg: dict, w: Dict[str, torch.Tensor], texts, prec: str = "f64",
           block: int = 256, device="cpu") -> torch.Tensor:
    """Embeddings of ``texts`` (len, hidden), in blocks of rows."""
    from .tokenizer import encode as tokenize

    outs = []
    for s in range(0, len(texts), block):
        ids, mask = tokenize(texts[s: s + block], cfg["vocab_size"],
                             cfg["max_position_embeddings"])
        outs.append(forward(cfg, w, torch.from_numpy(ids).to(device),
                            torch.from_numpy(mask).to(device), prec))
    return torch.cat(outs)
