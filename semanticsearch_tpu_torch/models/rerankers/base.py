"""Reranker registry + shared pieces.

The port's copy of ``semanticsearch_tpu/models/rerankers/base.py``. Every
model scores (left_ids, right_ids) -> (B,) float32 with padding masks
derived from id 0. Module and parameter names follow the flax trees where
the layer kinds allow, so ``models/convert.py::reranker_state_dict`` maps
one onto the other.
"""
from __future__ import annotations

from typing import Callable, Dict, Sequence

import torch
from torch import nn
from torch.nn import functional as F

from ..encoder import Dropout

MODEL_REGISTRY: Dict[str, Callable] = {}


def register_model(name: str):
    def deco(cls):
        MODEL_REGISTRY[name.lower()] = cls
        return cls
    return deco


def get_model_class(name: str):
    key = name.lower().replace("-", "_")
    if key not in MODEL_REGISTRY:
        raise KeyError(f"unknown reranker {name!r}; have {sorted(MODEL_REGISTRY)}")
    return MODEL_REGISTRY[key]


def make_model(name: str, vocab_size: int, embed_dim: int = 100, **kw):
    return get_model_class(name)(vocab_size=vocab_size, embed_dim=embed_dim, **kw)


def pad_mask(ids: torch.Tensor) -> torch.Tensor:
    """Mask of non-pad positions (pad id = 0), float32."""
    return (ids != 0).float()


def same_pad(kernel: int):
    """flax ``padding="SAME"`` at stride 1: (before, after) with the odd
    element after, so an even kernel of 2 pads (0, 1)."""
    return (kernel - 1) // 2, kernel - 1 - (kernel - 1) // 2


class MLPHead(nn.Module):
    """Small scoring head: ReLU hidden layers ``Dense_i`` + one output."""

    def __init__(self, in_dim: int, hidden: Sequence[int] = (),
                 dropout_rate: float = 0.0) -> None:
        super().__init__()
        dims = [in_dim, *hidden]
        self.n_hidden = len(hidden)
        for i in range(len(hidden)):
            setattr(self, f"Dense_{i}", nn.Linear(dims[i], dims[i + 1]))
        setattr(self, f"Dense_{len(hidden)}", nn.Linear(dims[-1], 1))
        self.dropout = Dropout(dropout_rate)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n_hidden):
            x = F.relu(getattr(self, f"Dense_{i}")(x))
        x = self.dropout(x)
        return getattr(self, f"Dense_{self.n_hidden}")(x)[..., 0]
