"""Exact top-k by inner product over the index's rows, as the index
states it: rows L2-normalized in float32 and stored in the index's dtype,
each query rounded to that dtype, scores summed in float64 (or in a
control's precision). Rows are taken in blocks, so no (queries, rows)
score matrix is ever whole."""
from __future__ import annotations

from typing import Tuple

import torch

from . import precision as P

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
_BLOCK = 1 << 17


def stored_rows(raw: torch.Tensor, dtype: str) -> torch.Tensor:
    """The index's rows from the raw corpus: unit rows in ``dtype``."""
    x = raw.float()
    x = x / torch.clamp(torch.linalg.norm(x, dim=1, keepdim=True), min=1e-9)
    return x.to(DTYPES[dtype])


def _blocks(q: torch.Tensor, rows: torch.Tensor, dtype: str, prec: str):
    qd = q.to(DTYPES[dtype])
    for s in range(0, rows.shape[0], _BLOCK):
        yield s, P.matmul(qd, rows[s: s + _BLOCK].t(), prec).to(
            P.compute_dtype(prec))


def topk(q: torch.Tensor, rows: torch.Tensor, dtype: str, k: int,
         prec: str = "f64") -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, ids) of the top-k of every query, best first."""
    best_v = best_i = None
    for s, blk in _blocks(q, rows, dtype, prec):
        v, i = torch.topk(blk, min(k, blk.shape[1]), dim=1)
        i = i + s
        if best_v is not None:
            v, i = torch.cat([best_v, v], 1), torch.cat([best_i, i], 1)
            v, j = torch.topk(v, k, dim=1)
            i = torch.gather(i, 1, j)
        best_v, best_i = v, i
    return best_v, best_i


def judge(q: torch.Tensor, rows: torch.Tensor, dtype: str,
          ids: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's k best scores of every query, and its scores at
    the answered ``ids`` (each (S, k), float64)."""
    ids = ids.to(rows.device, torch.int64)
    at = torch.zeros(ids.shape, dtype=torch.float64, device=rows.device)
    best = None
    for s, blk in _blocks(q, rows, dtype, "f64"):
        inside = (ids >= s) & (ids < s + blk.shape[1])
        local = (ids - s).clamp(0, blk.shape[1] - 1)
        at = torch.where(inside, torch.gather(blk, 1, local), at)
        v = torch.topk(blk, min(k, blk.shape[1]), dim=1).values
        best = v if best is None else torch.topk(
            torch.cat([best, v], 1), k, dim=1).values
    return best, at
