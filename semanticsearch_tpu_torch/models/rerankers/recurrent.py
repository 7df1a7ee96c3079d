"""Recurrent rerankers: ESIM, MatchLSTM, MVLSTM.

The port's copy of ``semanticsearch_tpu/models/rerankers/recurrent.py``.
``torch.nn.LSTM`` carries the recurrences (``lax.scan`` over flax's
``OptimizedLSTMCell`` in JAX; the gates are i, f, g, o in both, and flax's
input kernels have no bias, so ``bias_ih`` is zero after conversion). The
bidirectional LSTMs run unpacked over the pad positions too, as flax's
``RNN(reverse=True, keep_order=True)`` does without ``seq_lengths``; the
masks act after the recurrence.

ESIM hidden 200; MatchLSTM hidden 100; MVLSTM hidden 128, top_k 10, mlp 128.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from ...ops.matching import topk_flat
from ..encoder import Dropout
from .base import pad_mask, register_model

NEG_BIG = -1e9


def _bilstm(in_dim: int, hidden: int) -> nn.LSTM:
    return nn.LSTM(in_dim, hidden, batch_first=True, bidirectional=True)


def _fill_neg_big(x, keep):
    return x.masked_fill(~keep.bool(), NEG_BIG)


def _masked_softmax(logits, mask, dim):
    return torch.softmax(_fill_neg_big(logits, mask), dim=dim)


def _masked_max(x, mask):
    return _fill_neg_big(x, mask[..., None]).amax(dim=1)


def _masked_mean(x, mask):
    m = mask[..., None].to(x.dtype)
    return (x * m).sum(dim=1) / torch.clamp(m.sum(dim=1), min=1.0)


@register_model("esim")
class ESIM(nn.Module):
    def __init__(self, vocab_size: int, embed_dim: int = 100,
                 hidden_size: int = 200, dropout_rate: float = 0.2) -> None:
        super().__init__()
        h = hidden_size
        self.embedding = nn.Embedding(vocab_size, embed_dim)
        self.dropout = Dropout(dropout_rate)
        self.encode = _bilstm(embed_dim, h)
        self.projection = nn.Linear(8 * h, h)
        self.compose = _bilstm(h, h)
        self.mlp = nn.Linear(8 * h, h)
        self.out = nn.Linear(h, 1)

    def forward(self, left_ids, right_ids):
        lm, rm = pad_mask(left_ids), pad_mask(right_ids)
        le = self.dropout(self.embedding(left_ids))
        re_ = self.dropout(self.embedding(right_ids))
        a = self.encode(le)[0]    # (B, L, 2H)
        b = self.encode(re_)[0]   # (B, R, 2H)
        # cross attention with both-side masking
        e = torch.einsum("bld,brd->blr", a, b)
        att_ab = _masked_softmax(e, rm[:, None, :], dim=2)  # each l over r
        att_ba = _masked_softmax(e, lm[:, :, None], dim=1)  # each r over l
        a_align = torch.einsum("blr,brd->bld", att_ab, b)
        b_align = torch.einsum("blr,bld->brd", att_ba, a)

        def enhance(x, y):
            return torch.cat([x, y, x - y, x * y], dim=-1)

        a_m = F.relu(self.projection(enhance(a, a_align)))
        b_m = F.relu(self.projection(enhance(b, b_align)))
        a_c = self.compose(a_m)[0]
        b_c = self.compose(b_m)[0]
        v = torch.cat([_masked_max(a_c, lm), _masked_mean(a_c, lm),
                       _masked_max(b_c, rm), _masked_mean(b_c, rm)], dim=-1)
        v = self.dropout(F.relu(self.mlp(v)))
        return self.out(v)[..., 0]


@register_model("match_lstm")
class MatchLSTM(nn.Module):
    def __init__(self, vocab_size: int, embed_dim: int = 100,
                 hidden_size: int = 100, dropout_rate: float = 0.2) -> None:
        super().__init__()
        h = hidden_size
        self.embedding = nn.Embedding(vocab_size, embed_dim)
        self.encode = _bilstm(embed_dim, h)
        self.projection = nn.Linear(8 * h, h)
        self.compose = nn.LSTM(h, h, batch_first=True)
        self.dropout = Dropout(dropout_rate)
        self.out = nn.Linear(h, 1)

    def forward(self, left_ids, right_ids):
        lm, rm = pad_mask(left_ids), pad_mask(right_ids)
        a = self.encode(self.embedding(left_ids))[0]   # query (B, L, 2H)
        b = self.encode(self.embedding(right_ids))[0]  # doc   (B, R, 2H)
        # each doc position attends over the query; the match-LSTM composes
        # the [doc; attended query; diff; product] sequence
        e = torch.einsum("brd,bld->brl", b, a)
        att = _masked_softmax(e, lm[:, None, :], dim=2)
        b_align = torch.einsum("brl,bld->brd", att, a)
        m = torch.cat([b, b_align, b - b_align, b * b_align], dim=-1)
        m = F.relu(self.projection(m))
        v = _masked_max(self.compose(m)[0], rm)
        return self.out(self.dropout(v))[..., 0]


@register_model("mvlstm")
class MVLSTM(nn.Module):
    def __init__(self, vocab_size: int, embed_dim: int = 100,
                 hidden_size: int = 128, top_k: int = 10,
                 mlp_hidden: int = 128, dropout_rate: float = 0.5) -> None:
        super().__init__()
        self.top_k = top_k
        self.embedding = nn.Embedding(vocab_size, embed_dim)
        self.encode = _bilstm(embed_dim, hidden_size)
        self.mlp = nn.Linear(top_k, mlp_hidden)
        self.dropout = Dropout(dropout_rate)
        self.out = nn.Linear(mlp_hidden, 1)

    def forward(self, left_ids, right_ids):
        lm, rm = pad_mask(left_ids), pad_mask(right_ids)
        a = self.encode(self.embedding(left_ids))[0]
        b = self.encode(self.embedding(right_ids))[0]
        inter = torch.einsum("bld,brd->blr", a, b)
        inter = _fill_neg_big(inter, lm[:, :, None] * rm[:, None, :])
        v = F.relu(self.mlp(topk_flat(inter, self.top_k)))
        return self.out(self.dropout(v))[..., 0]
