"""Match-matrix and kernel-pooling ops shared by the rerankers.

The port's copy of ``semanticsearch_tpu/ops/matching.py``. These are plain
PyTorch: in the JAX package they are XLA programs, not Pallas kernels.
KNRM's Gaussian kernel bank places mu at ``1/(K-1) + 2i/(K-1) - 1`` with
the last kernel clamped to the exact-match kernel (mu = 1, exact_sigma);
pooling is ``sum_left log1p(sum_right exp(...))`` with the pad positions
masked out of every sum.
"""
from __future__ import annotations

from typing import Tuple

import torch


def kernel_mus_sigmas(kernel_num: int, sigma: float, exact_sigma: float
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """MatchZoo KNRM kernel bank: evenly spaced mus + an exact-match kernel
    (float32, on the CPU)."""
    i = torch.arange(kernel_num, dtype=torch.float32)
    mus = 1.0 / (kernel_num - 1) + (2.0 * i) / (kernel_num - 1) - 1.0
    exact = mus > 1.0
    mus = torch.where(exact, torch.tensor(1.0), mus)
    sigmas = torch.where(exact, torch.tensor(exact_sigma, dtype=torch.float32),
                         torch.tensor(sigma, dtype=torch.float32))
    return mus, sigmas


def cosine_match_matrix(left_emb: torch.Tensor, right_emb: torch.Tensor
                        ) -> torch.Tensor:
    """(B, L, D) x (B, R, D) -> (B, L, R) float32 cosine match matrix.

    Rows are scaled by the rsqrt of the squared norm clamped at 1e-18, not
    divided by a clamped norm: exactly-zero embedding rows are real inputs
    (an encoder-transferred table's pad row is zero) and must give a zero
    row, with finite gradients."""
    def unit(x):
        x = x.float()
        sq = (x * x).sum(dim=-1, keepdim=True)
        return x * torch.rsqrt(torch.clamp(sq, min=1e-18))

    return torch.einsum("bld,brd->blr", unit(left_emb), unit(right_emb))


def kernel_pooling(mm: torch.Tensor, left_mask: torch.Tensor,
                   right_mask: torch.Tensor, mus: torch.Tensor,
                   sigmas: torch.Tensor) -> torch.Tensor:
    """RBF soft-TF pooling: (B, L, R) match matrix -> (B, K) features.

    phi_k = sum_i mask_i * log1p( sum_j mask_j * exp(-(M_ij-mu_k)^2 / 2s_k^2) )
    """
    lm = left_mask.float()
    pair_mask = lm[:, :, None] * right_mask.float()[:, None, :]
    diff = mm[..., None] - mus  # (B, L, R, K)
    k = torch.exp(-0.5 * (diff * diff) / (sigmas ** 2))
    k = k * pair_mask[..., None]
    kde = torch.log1p(k.sum(dim=2))  # (B, L, K)
    kde = kde * lm[:, :, None]
    return kde.sum(dim=1)  # (B, K)


def topk_flat(values: torch.Tensor, k: int) -> torch.Tensor:
    """Top-k of the flattened trailing dims: (B, ...) -> (B, k), descending
    (MVLSTM's top-k interaction pooling)."""
    return torch.topk(values.reshape(values.shape[0], -1), k, dim=1).values
