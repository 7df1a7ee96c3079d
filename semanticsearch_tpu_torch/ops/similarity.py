"""Sentence-similarity math for chunking: normalize, sim matrix, rank matrix.

Counterpart of ``semanticsearch_tpu/ops/similarity.py``:

- :func:`similarity_matrix` is ``E @ E.T`` accumulated in float32. On a
  CUDA tensor it launches the hand-written Hopper kernel
  ``csrc/similarity.cu``: the upper triangle only, mirrored as it is
  stored (bit-symmetric), on ``wgmma`` behind a TMA ring, f32 input through
  the 3xTF32 split of ``csrc/tf32x3.cuh`` and bf16 input as it is; one
  fixed k order per element, so bit-reproducible. :func:`similarity_plan`
  gives its tiles, ring and scratch. On a CPU tensor it computes
  :func:`similarity_matrix_plain`. It also takes a batch (B, n, d) of
  zero-padded documents, which is how the splitter and the grouper call it.
  :func:`similarity_matrix_pallas` is the same function under the name of
  the JAX package's blockwise kernel.
- :func:`rank_matrix_global`: C99's row-rank + column-rank of every entry by
  a double stable argsort, O(n^2 log n).
- :func:`rank_matrix_local`: C99's local-mask rank as a sum over the
  (mask x mask) shifts of the matrix.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import _build

# launches of the Gram-matrix kernel (csrc/similarity.cu) in this process,
# on f32 and on bf16 input
SIM_LAUNCHES = 0
SIM_BF16_LAUNCHES = 0
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def l2_normalize(x: torch.Tensor, axis: int = -1, eps: float = 1e-9
                 ) -> torch.Tensor:
    norm = torch.linalg.norm(x, dim=axis, keepdim=True)
    return x / torch.clamp(norm, min=eps)


def similarity_matrix_plain(emb: torch.Tensor) -> torch.Tensor:
    """``emb @ emb^T`` over the last two axes by ``torch.matmul``: what CPU
    tensors run, and what the kernel is compared with.

    The product is taken in float64 and rounded once to float32. No global
    setting can lower it (``allow_tf32`` and
    ``set_float32_matmul_precision`` act on float32 products only), and it
    is the correctly rounded float32 answer whatever the order of summation:
    exact wherever the float32 kernel's sums are exact."""
    emb = emb.to(torch.float64)
    return torch.matmul(emb, emb.transpose(-1, -2)).to(torch.float32)


# the kernel's geometry (csrc/similarity.cu, qc_mainloop.cuh)
_TILE = 128             # rows of a CTA's row blocks; documents of <= 64 rows stack
_BOX_BYTES = 128 * 128  # one TMA box: 128 rows x one 128-byte K chunk
_SMEM_LIMIT = 232448    # dynamic shared memory a block can get
_SMEM_FIXED = 1024 + 128  # alignment slack and the ring's barriers
_MAX_STAGES = 8
_STAGING_BYTES = 128 * (136 + 132) * 4  # the epilogue's two staged tiles
_MAX_DOCS = 65535       # documents a launch takes


@functools.lru_cache(maxsize=256)
def similarity_plan(b: int, n: int, d: int, dtype=torch.float32) -> dict:
    """How ``csrc/similarity.cu`` runs a (b, n, d) batch: pure Python, as
    ``ops/topk.py::pass_a_plan`` is (cached: the dict is shared, read it
    only).

    A CTA owns one 128 x 128 tile (ti <= tj) of a document's upper
    triangle: ``tiles_per_doc`` = ceil(n / 128) row tiles, ``pairs`` =
    tiles (tiles + 1) / 2 CTAs a document; documents of n <= 128 rows take
    one diagonal tile each, ``docs_per_tile`` = 128 // n of them stacked.
    Each of the CTA's two consumer warpgroups multiplies its 64 rows by
    the tile's 128 columns, or only by its own 64 (``wg_cols``) where no
    document crosses the two halves (one tile a document, 64 % n == 0).
    E is read as it is through a TMA map whose rows must be whole 16-byte
    units: a width that is not a multiple of 4 (f32) or 8 (bf16) is padded
    with zero columns to ``pitch`` by one copy (``col_pad`` columns,
    ``scratch_bytes``, freed when the call returns). A ring stage holds a
    128-byte K chunk (32 f32 or 64 bf16 columns) of each operand box a CTA
    reads (one box a document when it has one tile, else two), and for f32
    input (``split``: 3xTF32) one more box for the lo plane of the box the
    consumers split in place; the ring is as deep as fits 232,448 bytes, at
    most 8 stages and no more than the chunks of a row. After the last
    multiply the ring's room (at least 137,216 bytes) stages the tile and
    its transpose for coalesced stores."""
    if dtype not in _KERNEL_DTYPES:
        raise NotImplementedError(
            f"the similarity kernel takes float32 or bfloat16; got {dtype}")
    split = dtype == torch.float32
    elem = 4 if split else 2
    vec = 16 // elem
    pitch = -(-d // vec) * vec
    kchunks = -(-pitch * elem // 128)
    tiles = -(-n // _TILE)
    group = _TILE // n if tiles == 1 else 1
    pairs = tiles * (tiles + 1) // 2
    stage_bytes = ((1 if tiles == 1 else 2) + (1 if split else 0)) * _BOX_BYTES
    stages = max(1, min(kchunks, _MAX_STAGES,
                        (_SMEM_LIMIT - _SMEM_FIXED) // stage_bytes))
    ctas = 0
    for b0 in range(0, b, _MAX_DOCS):
        nb = min(_MAX_DOCS, b - b0)
        ctas += -(-nb // group) if tiles == 1 else nb * pairs
    return {"tile": _TILE, "tiles_per_doc": tiles, "docs_per_tile": group,
            "wg_cols": 64 if tiles == 1 and 64 % n == 0 else 128,
            "pairs": pairs, "ctas": ctas, "launches": -(-b // _MAX_DOCS),
            "split": split, "pitch": pitch, "col_pad": pitch - d,
            "kchunks": kchunks, "stage_bytes": stage_bytes, "stages": stages,
            "smem_bytes": _SMEM_FIXED + max(stages * stage_bytes,
                                            _STAGING_BYTES),
            "scratch_bytes": b * n * pitch * elem if pitch != d else 0}


def _gram_entry():
    """``similarity_gram`` of csrc/similarity.cu, its C signature set."""
    fn = _build.load("similarity").similarity_gram
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 5
                       + [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)])
    return fn


def similarity_matrix(emb: torch.Tensor) -> torch.Tensor:
    """Similarity matrix of L2-normalized embeddings, (n, d) -> (n, n) or
    (B, n, d) -> (B, n, n), float32.

    Full-precision accumulate: segmentation boundary decisions are sensitive
    to small similarity differences, so the product never runs in plain TF32
    or bf16. A CUDA tensor must be float32 (the kernel's 3xTF32 split) or
    bfloat16 (whose products are exact in f32) and reaches the kernel or an
    error.
    """
    global SIM_LAUNCHES, SIM_BF16_LAUNCHES
    if emb.ndim not in (2, 3):
        raise ValueError(f"similarity_matrix: emb of shape {tuple(emb.shape)}; "
                         "expected (n, d) or (B, n, d)")
    if emb.device.type == "cpu":
        return similarity_matrix_plain(emb)
    if emb.device.type != "cuda":
        raise ValueError(f"similarity_matrix: tensor on {emb.device}")
    if emb.dtype not in _KERNEL_DTYPES:
        raise NotImplementedError(
            f"the similarity kernel takes float32 or bfloat16; got {emb.dtype}")
    batch = emb if emb.ndim == 3 else emb[None]
    b, n, d = batch.shape
    if min(b, n, d) < 1:
        raise ValueError(f"similarity kernel: empty input {tuple(emb.shape)}")
    if b * n >= 2 ** 31:
        raise ValueError(f"similarity kernel: {b} x {n} rows exceed 2^31")
    plan = similarity_plan(b, n, d, emb.dtype)
    batch = batch.contiguous()
    if plan["col_pad"]:  # whole 16-byte rows for the tensor map
        batch = torch.nn.functional.pad(batch, (0, plan["col_pad"]))
    if batch.data_ptr() % 16:  # TMA reads from a 16-byte aligned base
        batch = batch.clone()
    out = torch.empty((b, n, n), dtype=torch.float32, device=emb.device)
    launched = ctypes.c_int(0)  # one launch per 65,535 documents
    args = (batch.data_ptr(), out.data_ptr(), b, n, plan["pitch"],
            _KERNEL_DTYPES[emb.dtype], plan["stages"],
            torch._C._cuda_getCurrentRawStream(emb.device.index),
            ctypes.byref(launched))
    if emb.device.index == torch.cuda.current_device():
        status = _gram_entry()(*args)
    else:
        with torch.cuda.device(emb.device):
            status = _gram_entry()(*args)
    if emb.dtype == torch.float32:
        SIM_LAUNCHES += launched.value
    else:
        SIM_BF16_LAUNCHES += launched.value
    _build.check(status, "similarity_matrix")
    return out if emb.ndim == 3 else out[0]


def similarity_matrix_pallas(emb: torch.Tensor, block: int = 512
                             ) -> torch.Tensor:
    """The JAX package's blockwise ``E @ E.T`` for large matrices. Here one
    kernel serves every size, so this is :func:`similarity_matrix`; the
    kernel chooses its own tile and ``block`` is accepted and unused."""
    return similarity_matrix(emb)


def adjacent_similarities(emb: torch.Tensor) -> torch.Tensor:
    """Cosine similarity of consecutive sentence pairs: (n-1,) vector."""
    return (emb[:-1] * emb[1:]).to(torch.float32).sum(dim=-1)


def analyze_similarity_distribution(s) -> dict:
    """Percentile stats of the upper-triangle similarities, for
    auto-parameter diagnostics and data-quality reports."""
    if isinstance(s, torch.Tensor):
        s = s.detach().cpu().numpy()
    s = np.asarray(s)
    n = s.shape[0]
    if n < 2:
        return {"count": 0}
    vals = s[np.triu_indices(n, 1)]
    return {
        "count": int(vals.size),
        "mean": float(vals.mean()),
        "std": float(vals.std()),
        "min": float(vals.min()),
        "max": float(vals.max()),
        "p10": float(np.percentile(vals, 10)),
        "p25": float(np.percentile(vals, 25)),
        "p50": float(np.percentile(vals, 50)),
        "p75": float(np.percentile(vals, 75)),
        "p90": float(np.percentile(vals, 90)),
    }


def sort_ranks(s: torch.Tensor, dim: int) -> torch.Tensor:
    """Rank of every entry along ``dim`` by a double argsort (int64).

    The first sort is stable, as ``jnp.argsort`` is: tied entries take
    consecutive ranks in index order. The second inverts a permutation and
    has no ties to break.
    """
    order = torch.argsort(s, dim=dim, stable=True)
    return torch.argsort(order, dim=dim, stable=True)


def _row_ranks(s: torch.Tensor) -> torch.Tensor:
    """Per-row rank (number of strictly smaller entries) via double argsort.

    With ties, double-argsort assigns distinct consecutive ranks within a tie
    group (sorted-position semantics) rather than a strict '< count'; for
    C99's block-density statistics over real-valued cosine matrices ties are
    measure-zero and the downstream segmentation is rank-scale invariant.
    """
    return sort_ranks(s, 1).to(torch.float32)


def rank_matrix_global(s: torch.Tensor) -> torch.Tensor:
    """C99 global rank matrix: row-rank + column-rank of each entry."""
    return _row_ranks(s) + _row_ranks(s.T).T


def rank_matrix_local(s: torch.Tensor, mask_size: int = 11) -> torch.Tensor:
    """C99 local rank: fraction of entries in a (mask x mask) window around
    (i, j) strictly smaller than S[i, j], clipped at the matrix border.

    A sum over the (di, dj) shifts; each shift contributes an indicator of
    "window member smaller than center". O(n^2 * mask^2) work.
    """
    n = s.shape[0]
    m = max(3, mask_size | 1)
    half = m // 2
    # Pad with +inf so out-of-range neighbors never count as "smaller",
    # and a validity mask to get the clipped window size.
    pad = (half, half, half, half)
    sp = torch.nn.functional.pad(s, pad, value=float("inf"))
    valid = torch.nn.functional.pad(torch.ones_like(s, dtype=torch.float32), pad)
    count = torch.zeros_like(s)
    denom = torch.zeros_like(s)
    zero = torch.zeros((), dtype=torch.float32, device=s.device)
    for di in range(m):
        for dj in range(m):
            win = sp[di: di + n, dj: dj + n]
            vld = valid[di: di + n, dj: dj + n]
            count = count + torch.where(win < s, vld, zero)
            denom = denom + vld
    return count / torch.clamp(denom, min=1.0)
