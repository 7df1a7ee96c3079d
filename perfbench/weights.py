"""The encoder's weights, made on the device from the run's seed in a few
large draws and handed to the program and to the reference alike.

Names follow the program's module (``SentenceTransformerModel``'s state
dict), which is how the benchmark hands them over: each dense kernel is
(out, in) and N(0, 1/in), embeddings N(0, 1/hidden), biases N(0, 0.02^2),
LayerNorm scales 1 + N(0, 0.05^2) and shifts N(0, 0.02^2), all float32.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from .traffic import sub_seed


def shapes(cfg: dict) -> List[Tuple[str, Tuple[int, ...]]]:
    """Every weight's name and shape, in the program's order."""
    h, mlp = cfg["hidden_size"], cfg["intermediate_size"]
    out = [("token_embed.weight", (cfg["vocab_size"], h)),
           ("pos_embed.weight", (cfg["max_position_embeddings"], h)),
           ("ln_embed.weight", (h,)), ("ln_embed.bias", (h,))]
    for i in range(cfg["num_hidden_layers"]):
        p = f"layers.{i}."
        out += [(p + "ln_attn.weight", (h,)), (p + "ln_attn.bias", (h,))]
        for name in ("query", "key", "value", "out"):
            out += [(p + f"attn.{name}.weight", (h, h)),
                    (p + f"attn.{name}.bias", (h,))]
        out += [(p + "ln_mlp.weight", (h,)), (p + "ln_mlp.bias", (h,)),
                (p + "mlp_in.weight", (mlp, h)), (p + "mlp_in.bias", (mlp,)),
                (p + "mlp_out.weight", (h, mlp)),
                (p + "mlp_out.bias", (h,))]
    out += [("ln_final.weight", (h,)), ("ln_final.bias", (h,))]
    return out


def make(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The weights of ``seed`` on ``device``: one standard normal draw for
    all of them, cut and scaled leaf by leaf (views, no copies)."""
    spec = shapes(cfg)
    total = sum(int(torch.Size(s).numel()) for _, s in spec)
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, "weights"))
    flat = torch.randn(total, generator=g, device=device)
    out: Dict[str, torch.Tensor] = {}
    off = 0
    h = cfg["hidden_size"]
    for name, shape in spec:
        n = int(torch.Size(shape).numel())
        w = flat[off: off + n].view(shape)
        off += n
        if len(shape) == 2:
            fan_in = h if "embed" in name else shape[1]
            w.mul_(fan_in ** -0.5)
        elif name.startswith("ln") or ".ln_" in name:
            if name.endswith("weight"):
                w.mul_(0.05).add_(1.0)
            else:
                w.mul_(0.02)
        else:
            w.mul_(0.02)
        out[name] = w
    return out
