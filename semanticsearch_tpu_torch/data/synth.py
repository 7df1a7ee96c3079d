"""Synthetic unit-norm corpus rows from an integer hash of (row, column).

The port's copy of the row hash in ``tools/synth_corpus.py``: the same
murmur-style mix, so row ``i`` here equals row ``i`` of the JAX benches'
synthetic corpus. Computed on the device in int64 with 32-bit wraparound,
in blocks, so a shard-sized corpus is made where it is used.
"""
from __future__ import annotations

import torch

_M1, _M2, _M3, _MIX = 2654435761, 40503, 977, 0x5BD1E995
_U32 = 0xFFFFFFFF


def unit_rows(row_ids: torch.Tensor, d: int,
              dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(len(row_ids), d) L2-normalized rows for int row ids, on the ids'
    device: x = hash(row, col) / 2^32 - 0.5, normalized in float32, then
    cast to ``dtype``."""
    r = row_ids.to(torch.int64)[:, None]
    j = torch.arange(d, dtype=torch.int64, device=row_ids.device)[None, :]
    h = (r * _M1 + j * _M2 + _M3) & _U32
    h = h ^ (h >> 13)
    h = (h * _MIX) & _U32  # < 2^63: exact in int64
    h = h ^ (h >> 15)
    x = h.to(torch.float32) / float(2 ** 32) - 0.5
    x = x / torch.sqrt(torch.sum(x * x, dim=1, keepdim=True))
    return x.to(dtype)


def corpus(n: int, d: int, dtype: torch.dtype = torch.bfloat16,
           device="cuda", start: int = 0, block: int = 1 << 16
           ) -> torch.Tensor:
    """Rows ``start .. start+n-1`` as one (n, d) tensor on ``device``."""
    out = torch.empty((n, d), dtype=dtype, device=device)
    for s in range(0, n, block):
        ids = torch.arange(start + s, start + min(s + block, n),
                           device=device)
        out[s: s + ids.numel()] = unit_rows(ids, d, dtype)
    return out
