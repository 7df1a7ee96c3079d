"""KNRM and Conv-KNRM kernel-pooling rerankers.

The port's copy of ``semanticsearch_tpu/models/rerankers/knrm.py``: KNRM
kernel_num=21, sigma=0.1, exact_sigma=0.001; Conv-KNRM filters=128, tanh
n-gram convolutions (``padding="SAME"``, so n = 2 pads one position after),
max_ngram=3, crossmatch, kernel_num=11.
"""
from __future__ import annotations

from typing import List

import torch
from torch import nn
from torch.nn import functional as F

from ...ops.matching import cosine_match_matrix, kernel_mus_sigmas, kernel_pooling
from .base import pad_mask, register_model, same_pad


def _kernel_bank(module: nn.Module, kernel_num, sigma, exact_sigma) -> None:
    mus, sigmas = kernel_mus_sigmas(kernel_num, sigma, exact_sigma)
    module.register_buffer("mus", mus, persistent=False)
    module.register_buffer("sigmas", sigmas, persistent=False)


@register_model("knrm")
class KNRM(nn.Module):
    def __init__(self, vocab_size: int, embed_dim: int = 100,
                 kernel_num: int = 21, sigma: float = 0.1,
                 exact_sigma: float = 0.001) -> None:
        super().__init__()
        self.embedding = nn.Embedding(vocab_size, embed_dim)
        self.out = nn.Linear(kernel_num, 1)
        _kernel_bank(self, kernel_num, sigma, exact_sigma)

    def forward(self, left_ids, right_ids):
        lm, rm = pad_mask(left_ids), pad_mask(right_ids)
        mm = cosine_match_matrix(self.embedding(left_ids),
                                 self.embedding(right_ids))
        phi = kernel_pooling(mm, lm, rm, self.mus, self.sigmas)
        return self.out(phi)[..., 0]


class _NGramConv(nn.Module):
    """1D convolutions ``conv_{n}``, one representation per n-gram size
    (tanh, SAME)."""

    def __init__(self, in_dim: int, filters: int, max_ngram: int) -> None:
        super().__init__()
        self.max_ngram = max_ngram
        for n in range(1, max_ngram + 1):
            setattr(self, f"conv_{n}", nn.Conv1d(in_dim, filters, n))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = x.transpose(1, 2)  # (B, D, T)
        reps = []
        for n in range(1, self.max_ngram + 1):
            h = getattr(self, f"conv_{n}")(F.pad(x, same_pad(n)))
            reps.append(torch.tanh(h.transpose(1, 2)))  # (B, T, filters)
        return reps


@register_model("conv_knrm")
class ConvKNRM(nn.Module):
    def __init__(self, vocab_size: int, embed_dim: int = 100,
                 filters: int = 128, max_ngram: int = 3,
                 use_crossmatch: bool = True, kernel_num: int = 11,
                 sigma: float = 0.1, exact_sigma: float = 0.001) -> None:
        super().__init__()
        self.use_crossmatch = use_crossmatch
        self.embedding = nn.Embedding(vocab_size, embed_dim)
        self.ngrams = _NGramConv(embed_dim, filters, max_ngram)
        n_maps = max_ngram * max_ngram if use_crossmatch else max_ngram
        self.out = nn.Linear(n_maps * kernel_num, 1)
        _kernel_bank(self, kernel_num, sigma, exact_sigma)

    def forward(self, left_ids, right_ids):
        lm, rm = pad_mask(left_ids), pad_mask(right_ids)
        l_reps = self.ngrams(self.embedding(left_ids))
        r_reps = self.ngrams(self.embedding(right_ids))
        feats = []
        for i, lr in enumerate(l_reps):
            for j, rr in enumerate(r_reps):
                if not self.use_crossmatch and i != j:
                    continue
                mm = cosine_match_matrix(lr, rr)
                feats.append(kernel_pooling(mm, lm, rm, self.mus,
                                            self.sigmas))
        return self.out(torch.cat(feats, dim=1))[..., 0]
