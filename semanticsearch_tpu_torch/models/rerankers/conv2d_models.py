"""MatchPyramid and ArcII: 2D-convolution match-matrix rerankers.

The port's copy of ``semanticsearch_tpu/models/rerankers/conv2d_models.py``.
The convolutions run channels-first (NCHW) in torch; both models flatten in
the flax order (NHWC) before their ``out`` layer, so the converted Dense
rows line up. MatchPyramid's pooling bins are the JAX package's, with
Python's ``round`` (half to even), not ``adaptive_max_pool2d``'s floor and
ceil bins.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from ...ops.matching import cosine_match_matrix
from ..encoder import Dropout
from .base import pad_mask, register_model, same_pad


def _bins(n: int, out: int):
    edges = [round(i * n / out) for i in range(out + 1)]
    return [(edges[i], max(edges[i + 1], edges[i] + 1)) for i in range(out)]


def _adaptive_max_pool_2d(x: torch.Tensor, out_hw: Tuple[int, int]
                          ) -> torch.Tensor:
    """(B, C, H, W) -> (B, C, out_h, out_w): the max over the JAX
    package's static bins (boundaries ``round(i * h / out_h)``, each bin at
    least one row wide)."""
    h, w = x.shape[2], x.shape[3]
    rows = []
    for h0, h1 in _bins(h, out_hw[0]):
        strip = x[:, :, h0:h1, :].amax(dim=2)  # (B, C, W)
        rows.append(torch.stack([strip[:, :, w0:w1].amax(dim=2)
                                 for w0, w1 in _bins(w, out_hw[1])], dim=-1))
    return torch.stack(rows, dim=2)


def _same_conv2d(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    (kh, kw) = conv.kernel_size
    return conv(F.pad(x, (*same_pad(kw), *same_pad(kh))))


def _flatten_nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


@register_model("match_pyramid")
class MatchPyramid(nn.Module):
    def __init__(self, vocab_size: int, embed_dim: int = 100,
                 kernel_count: Sequence[int] = (16, 32),
                 kernel_size: Sequence[Tuple[int, int]] = ((3, 3), (3, 3)),
                 dpool_size: Tuple[int, int] = (3, 10),
                 dropout_rate: float = 0.3) -> None:
        super().__init__()
        self.dpool_size = tuple(dpool_size)
        self.embedding = nn.Embedding(vocab_size, embed_dim)
        in_ch = 1
        self.n_conv = len(kernel_count)
        for i, (cnt, ks) in enumerate(zip(kernel_count, kernel_size)):
            setattr(self, f"conv_{i}", nn.Conv2d(in_ch, cnt, tuple(ks)))
            in_ch = cnt
        self.dropout = Dropout(dropout_rate)
        self.out = nn.Linear(in_ch * self.dpool_size[0] * self.dpool_size[1], 1)

    def forward(self, left_ids, right_ids):
        lm, rm = pad_mask(left_ids), pad_mask(right_ids)
        mm = cosine_match_matrix(self.embedding(left_ids),
                                 self.embedding(right_ids))
        x = (mm * lm[:, :, None] * rm[:, None, :])[:, None]  # (B, 1, L, R)
        for i in range(self.n_conv):
            x = F.relu(_same_conv2d(getattr(self, f"conv_{i}"), x))
        x = _flatten_nhwc(_adaptive_max_pool_2d(x, self.dpool_size))
        return self.out(self.dropout(x))[..., 0]


@register_model("arcii")
class ArcII(nn.Module):
    # fixed-stride pools + flatten make the head's width a function of the
    # left and right lengths: ``out`` takes its width from the first input
    # or from the state_dict it loads
    length_bucketable = False

    def __init__(self, vocab_size: int, embed_dim: int = 100,
                 kernel_1d_count: int = 32, kernel_1d_size: int = 3,
                 kernel_2d_count: Sequence[int] = (64, 64),
                 kernel_2d_size: Sequence[Tuple[int, int]] = ((3, 3), (3, 3)),
                 pool_2d_size: Sequence[Tuple[int, int]] = ((3, 3), (3, 3)),
                 dropout_rate: float = 0.3) -> None:
        super().__init__()
        self.embedding = nn.Embedding(vocab_size, embed_dim)
        self.conv1d_left = nn.Conv1d(embed_dim, kernel_1d_count,
                                     kernel_1d_size)
        self.conv1d_right = nn.Conv1d(embed_dim, kernel_1d_count,
                                      kernel_1d_size)
        self.pools = [tuple(p) for p in pool_2d_size]
        in_ch = kernel_1d_count
        self.n_conv = len(kernel_2d_count)
        for i, (cnt, ks) in enumerate(zip(kernel_2d_count, kernel_2d_size)):
            setattr(self, f"conv2d_{i}", nn.Conv2d(in_ch, cnt, tuple(ks)))
            in_ch = cnt
        self.dropout = Dropout(dropout_rate)
        self.out = nn.LazyLinear(1)

    def _conv1d(self, conv: nn.Conv1d, x: torch.Tensor) -> torch.Tensor:
        x = F.pad(x.transpose(1, 2), same_pad(conv.kernel_size[0]))
        return conv(x)  # (B, C, T)

    def forward(self, left_ids, right_ids):
        le = self._conv1d(self.conv1d_left, self.embedding(left_ids))
        re_ = self._conv1d(self.conv1d_right, self.embedding(right_ids))
        # cross 2D map x[b, c, i, j] = le[b, c, i] + re[b, c, j]
        x = le[:, :, :, None] + re_[:, :, None, :]
        lm, rm = pad_mask(left_ids), pad_mask(right_ids)
        x = x * (lm[:, None, :, None] * rm[:, None, None, :])
        for i in range(self.n_conv):
            x = F.relu(_same_conv2d(getattr(self, f"conv2d_{i}"), x))
            x = F.max_pool2d(x, self.pools[i], self.pools[i])
        return self.out(self.dropout(_flatten_nhwc(x)))[..., 0]
