"""Cross-encoder reranker: full query-document attention in one transformer.

The port's copy of ``semanticsearch_tpu/models/rerankers/cross_encoder.py``:
``[CLS] + query + document`` packed into one sequence with segment
embeddings, run through the sentence encoder's own ``TransformerBlock``
stack (``models/encoder.py``), scored by a tanh pooler and a dense head
over the CLS state. The blocks always take the stock attention path, as
the JAX model builds them without flash attention. The trunk computes in
``dtype``; the CLS state is cast to float32 before the head, whose
parameters stay float32.

:func:`transfer_from_encoder` warm-starts the model from a trained sentence
encoder (the token table, both LayerNorms, every shared
block, the position rows at packed positions 1..N).
"""
from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from ...core.config import EncoderConfig
from ..encoder import _LN_EPS, TransformerBlock
from .base import pad_mask, register_model


@register_model("cross_encoder")
class CrossEncoder(nn.Module):
    """(left_ids, right_ids) -> (B,) relevance scores via joint attention.
    ``embed_dim`` doubles as the transformer's hidden size."""

    # the packed width varies with the (left, right) lengths only
    length_bucketable = True

    def __init__(self, vocab_size: int, embed_dim: int = 128,
                 num_layers: int = 2, num_heads: int = 4, mlp_dim: int = 256,
                 dropout_rate: float = 0.1, max_positions: int = 512,
                 dtype: str = "float32") -> None:
        super().__init__()
        self.max_positions = max_positions
        block_cfg = EncoderConfig(
            vocab_size=vocab_size, hidden_dim=embed_dim,
            num_layers=num_layers, num_heads=num_heads, mlp_dim=mlp_dim,
            dropout_rate=dropout_rate, max_len=max_positions, dtype=dtype,
            attention="stock")
        self.embedding = nn.Embedding(vocab_size, embed_dim)
        self.seg_embed = nn.Embedding(2, embed_dim)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embed = nn.Embedding(max_positions, embed_dim)
        self.ln_embed = nn.LayerNorm(embed_dim, eps=_LN_EPS)
        self.layers = nn.ModuleList(
            TransformerBlock(block_cfg) for _ in range(num_layers))
        self.ln_final = nn.LayerNorm(embed_dim, eps=_LN_EPS)
        self.pool_dense = nn.Linear(embed_dim, embed_dim)
        self.score = nn.Linear(embed_dim, 1)
        trunk_dtype = getattr(torch, dtype)
        for name, child in self.named_children():
            if name not in ("pool_dense", "score"):
                child.to(trunk_dtype)
        self.cls_token.data = self.cls_token.data.to(trunk_dtype)

    def forward(self, left_ids, right_ids):
        b = left_ids.shape[0]
        lm, rm = pad_mask(left_ids), pad_mask(right_ids)
        ids = torch.cat([left_ids, right_ids], dim=1)
        seg = torch.cat([torch.zeros_like(left_ids),
                         torch.ones_like(right_ids)], dim=1)
        x = self.embedding(ids) + self.seg_embed(seg)
        x = torch.cat([self.cls_token.expand(b, 1, x.shape[-1]), x], dim=1)
        t = x.shape[1]
        if t > self.max_positions:
            raise ValueError(
                f"packed sequence {t} > max_positions {self.max_positions}")
        x = x + self.pos_embed(torch.arange(t, device=x.device))[None]
        x = self.ln_embed(x)
        mask = torch.cat([torch.ones_like(lm[:, :1]), lm, rm], dim=1)
        for layer in self.layers:
            x = layer(x, mask, False)
        x = self.ln_final(x)
        h = torch.tanh(self.pool_dense(x[:, 0].float()))
        return self.score(h)[..., 0]


def transfer_from_encoder(model: CrossEncoder, encoder: nn.Module
                          ) -> Dict[str, torch.Tensor]:
    """A CrossEncoder ``state_dict`` warm-started from a trained sentence
    encoder (``models/encoder.py::SentenceTransformerModel``); neither
    module changes.

    Copies the token table, both LayerNorms and every transformer block the
    two stacks share; the encoder's position rows land at packed positions
    1..N (position 0 is the CLS slot). The CLS vector, segment table and
    scoring head keep the model's values. Shape mismatches (heads
    included) raise ValueError, as a partial transfer would train and
    converge worse silently."""
    state_dict, enc_sd = model.state_dict(), encoder.state_dict()
    out = dict(state_dict)
    enc_table = enc_sd["token_embed.weight"]
    my_table = state_dict["embedding.weight"]
    if enc_table.shape != my_table.shape:
        raise ValueError(
            f"encoder token table {tuple(enc_table.shape)} != cross-encoder "
            f"{tuple(my_table.shape)} — vocab or hidden size mismatch")
    out["embedding.weight"] = enc_table.clone()

    for ln in ("ln_embed", "ln_final"):
        keys = (f"{ln}.weight", f"{ln}.bias")
        if not all(k in enc_sd and k in state_dict for k in keys):
            raise ValueError(f"missing {ln} in one of the trees")
        for k in keys:
            out[k] = enc_sd[k].clone()

    for i, layer in enumerate(model.layers):
        if i >= len(encoder.layers):
            raise ValueError(
                f"cross-encoder has {len(model.layers)} layers but the "
                f"encoder checkpoint stops before layer_{i} — match "
                "num_layers to the encoder's")
        prefix = f"layers.{i}."
        mine = {k: v for k, v in state_dict.items() if k.startswith(prefix)}
        theirs = {k: v for k, v in enc_sd.items() if k.startswith(prefix)}
        if (layer.attn.num_heads != encoder.layers[i].attn.num_heads
                or sorted(mine) != sorted(theirs)
                or any(mine[k].shape != theirs[k].shape for k in mine)):
            raise ValueError(
                f"layer_{i}: encoder block shapes do not match the "
                "cross-encoder's (heads/mlp_dim/hidden mismatch)")
        out.update({k: v.clone() for k, v in theirs.items()})

    enc_pos = enc_sd["pos_embed.weight"]
    my_pos = state_dict["pos_embed.weight"].clone()
    if enc_pos.shape[1] != my_pos.shape[1]:
        raise ValueError("pos_embed width mismatch")
    n = min(enc_pos.shape[0], my_pos.shape[0] - 1)
    my_pos[1: 1 + n] = enc_pos[:n]
    out["pos_embed.weight"] = my_pos
    return out
