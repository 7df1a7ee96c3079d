"""Exact inner-product top-k over a corpus embedding matrix.

Counterpart of ``semanticsearch_tpu/ops/topk.py``. Two searches run on
hand-written Hopper kernels for CUDA tensors, and on their plain versions
for CPU tensors:

* the two-pass search of :func:`topk_scores_twopass` (k < 128). Pass A,
  :func:`segtopk_pass_a`, scores every query against the whole corpus and
  keeps, per query, the ``k_sel`` best SEGMENTS by their maximum score, a
  segment being ``L2`` consecutive rows (``csrc/segtopk.cu``, with an int8
  variant, :func:`segtopk_pass_a_int8`, and an overlap schedule,
  :func:`segtopk_pass_a_overlap`). Pass B, :func:`pass_b_rescore`,
  rescores the candidate segments' rows exactly and keeps each query's top
  k (``csrc/pass_b.cu``; plain XLA in the JAX package).
* the fused top-k of :func:`topk_scores_fused` (any k up to
  :data:`FUSED_MAX_K`): one pass that keeps an exact running top-k per query
  (``csrc/topk_fused.cu``), the counterpart of ``topk_scores_pallas``.

On bf16 and int8 operands both kernels run one Hopper main loop
(``csrc/qc_mainloop.cuh``: TMA loads into an ``mbarrier`` ring, ``wgmma`` on
a resident query tile; s8 ``wgmma`` for int8) and select in the accumulator
registers; pass A's overlap schedule runs the same loop on a ring longer
than a tile, so its two consumer warpgroups drift out of phase; bf16 rows
wider than the resident query tile allows (:func:`pass_a_max_d`) take pass
A's wide schedule, the same products and epilogue with the query tile
streamed through the ring beside the corpus tile
(``csrc/qs_mainloop.cuh``, :func:`pass_a_wide_plan`). Their tiles,
ring stages and corpus splits are planned here (:func:`pass_a_plan`,
:func:`pass_a_int8_plan`, :func:`overlap_plan`, :func:`fused_plan`) and
handed to the C entry points. f32 operands (an ``IndexConfig(dtype=
"float32")`` index) run each kernel's f32 schedule: the same epilogues on a
3xTF32 main loop (``csrc/tf32_mainloop.cuh``: both operands streamed, each
value split into TF32 hi and lo parts, three TF32 ``wgmma`` products per
step, the small terms summed apart), equal to the exact f32 product on
integer-valued rows and within about 2^-21 |q| |c| of it elsewhere, inside
the D * 2^-24 an f32 index may differ by (:func:`pass_a_f32_plan`,
:func:`fused_f32_plan`; widths padded to a multiple of 4 by one copy).

The true top-k rows lie in the top-k segments by maximum: were a top-k row's
segment ranked below k, k segments would each hold a row scoring at least as
high. One extra segment covers the single segment that straddles the corpus
end, whose zero pad rows score 0 and can inflate its maximum.

Unlike the TPU kernel, which read a swizzled copy of the corpus so that a
segment's scores landed on one vector lane, the Hopper kernel reads the
natural row-major layout (segment ``s`` is rows ``[s*L2, (s+1)*L2)``), so an
index holds one copy of its corpus. ``swizzle_corpus`` stays for callers
that hold the swizzled layout.

Ties follow the JAX package: :func:`topk_scores_ref`, the fused search and
:func:`topk_scores_chunked` keep the lower row id; the two-pass search keeps
the candidate that comes first in pass A's order (segment maximum
descending, segment id ascending), as ``jax.lax.top_k`` does. ``torch.topk``
gives no order among equals, so every selection here is a stable sort.
"""
from __future__ import annotations

import ctypes
import functools
import warnings
from typing import Optional, Tuple

import torch

from ..core import profiling
from . import _build

NEG_INF = -1e30
_LANE = 128
# queries per two-pass call; larger batches run in chunks of this size
_MAX_TWOPASS_Q = 32768
# the fused kernel keeps k up to this (csrc/topk_fused.cu, MAX_K)
FUSED_MAX_K = 2048
# launches of each kernel in this process, by wrapper and schedule: pass A
# (csrc/segtopk.cu) in its bf16, overlap, int8 and f32 schedules (the f32
# schedule counted apart for each of the two wrappers that reach it), and
# the fused top-k (csrc/topk_fused.cu) in bf16 and f32
SEGTOPK_LAUNCHES = 0
SEGTOPK_WIDE_LAUNCHES = 0
SEGTOPK_OVERLAP_LAUNCHES = 0
SEGTOPK_INT8_LAUNCHES = 0
SEGTOPK_F32_LAUNCHES = 0
SEGTOPK_OVERLAP_F32_LAUNCHES = 0
TOPK_FUSED_LAUNCHES = 0
TOPK_FUSED_F32_LAUNCHES = 0
# calls of pass B (csrc/pass_b.cu), bf16 and f32 alike: one a call,
# whatever number of kernels the call launches
PASS_B_LAUNCHES = 0


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _top_sorted(vals: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k along dim 1 with ``jax.lax.top_k``'s tie rule: among equal
    values the earlier position wins."""
    v, order = torch.sort(vals, dim=1, descending=True, stable=True)
    return v[:, :k], order[:, :k]


def _scores(queries: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """(Q, R) float32 scores; bf16/fp16 inputs are widened first, so every
    product is exact and only the accumulation rounds, as with
    ``preferred_element_type=float32`` in the JAX package."""
    return queries.float() @ rows.float().T


# ------------------------------------------------------------------ plain ops

def topk_scores_ref(
    queries: torch.Tensor, corpus: torch.Tensor, k: int = 10,
    block_n: int = 4096,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reference top-k: scan corpus blocks, merging a running top-k.
    Returns (values f32, indices int32), both (Q, k); ties keep the lower
    row id (the running list precedes each new block)."""
    q = queries.shape[0]
    n = corpus.shape[0]
    best_v = torch.full((q, k), NEG_INF, dtype=torch.float32,
                        device=queries.device)
    best_i = torch.zeros((q, k), dtype=torch.int64, device=queries.device)
    for off in range(0, _round_up(n, block_n), block_n):
        blk = corpus[off: off + block_n]
        scores = _scores(queries, blk)
        if blk.shape[0] < block_n:  # zero pad rows, masked like the JAX scan
            scores = torch.cat([scores, torch.full(
                (q, block_n - blk.shape[0]), NEG_INF, dtype=torch.float32,
                device=scores.device)], dim=1)
        col = torch.arange(off, off + block_n, device=queries.device)
        vals = torch.cat([best_v, scores], dim=1)
        idxs = torch.cat([best_i, col.expand(q, block_n)], dim=1)
        best_v, sel = _top_sorted(vals, k)
        best_i = torch.gather(idxs, 1, sel)
    return best_v, best_i.to(torch.int32)


def swizzle_corpus(corpus: torch.Tensor, block_n: int = 8192) -> torch.Tensor:
    """The JAX pass-A layout: within each block_n-row block, position
    j*128 + s holds natural row s*L + j (L = block_n/128), zero-padded to a
    block multiple."""
    n, d = corpus.shape
    n_pad = _round_up(n, block_n)
    if n_pad != n:
        corpus = torch.cat([corpus, corpus.new_zeros(n_pad - n, d)])
    L = block_n // _LANE
    return (corpus.reshape(n_pad // block_n, _LANE, L, d)
            .transpose(1, 2).reshape(n_pad, d))


def _unswizzle(corpus_swizzled: torch.Tensor, block_n: int,
               width: Optional[int] = None) -> torch.Tensor:
    """Natural row order of a swizzled layout; with ``width``, written into
    that many columns, zero past its own (the one copy either way)."""
    n_pad, d = corpus_swizzled.shape
    L = block_n // _LANE
    nat = corpus_swizzled.reshape(n_pad // block_n, L, _LANE, d).transpose(1, 2)
    if width is None or width == d:
        return nat.reshape(n_pad, d)
    out = corpus_swizzled.new_zeros((n_pad, width))
    out[:, :d].view(n_pad // block_n, _LANE, L, d).copy_(nat)
    return out


def _int8_into(q: torch.Tensor, width: Optional[int]) -> torch.Tensor:
    """Rounded, clamped values ``q`` as int8, written straight into a zeroed
    tensor ``width`` columns wide when that is wider (zero columns change no
    product)."""
    if width is None or width == q.shape[-1]:
        return q.to(torch.int8)
    out = torch.zeros((*q.shape[:-1], width), dtype=torch.int8, device=q.device)
    out[..., :q.shape[-1]] = q
    return out


def quantize_int8_global(x: torch.Tensor, width: Optional[int] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8: returns (q8, scale). With ``width``, q8 is
    that many columns wide, zero past x's own."""
    s = torch.clamp(x.float().abs().max() / 127.0, min=1e-12)
    q = torch.clamp(torch.round(x.float() / s), -127, 127)
    return _int8_into(q, width), s


SEL_BLOCK = 256        # stage-2 block width
SEL_SUB = 32           # stage-3 sub-block width inside the gathered tile
SEL_STAGE3_MIN = 8192  # stage 3 only when the gathered tile is this wide


def block_topk(S: torch.Tensor, kp: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-kp over wide rows by staged selection: block maxima, the
    top kp+8 blocks (ids sorted ascending before the gather, so ties keep
    the lower column), once more over SEL_SUB-wide sub-blocks when the
    gathered tile is wide, then an exact top-kp. Returns (vals, columns)."""
    Q, Dp = S.shape
    if Dp <= 4 * SEL_BLOCK or Dp % SEL_BLOCK:
        return _top_sorted(S, kp)
    nb = Dp // SEL_BLOCK
    Sb = S.reshape(Q, nb, SEL_BLOCK)
    m = min(nb, kp + 8)
    _, tb = _top_sorted(Sb.amax(dim=2), m)
    tb = torch.sort(tb, dim=1).values
    G = torch.gather(Sb, 1, tb[:, :, None].expand(Q, m, SEL_BLOCK))
    width = m * SEL_BLOCK
    Gf = G.reshape(Q, width)
    if width < SEL_STAGE3_MIN or SEL_BLOCK % SEL_SUB:
        vals, loc = _top_sorted(Gf, kp)
    else:
        ns = width // SEL_SUB
        Gs = Gf.reshape(Q, ns, SEL_SUB)
        ms = min(ns, kp + 8)
        _, ts = _top_sorted(Gs.amax(dim=2), ms)
        ts = torch.sort(ts, dim=1).values
        G2 = torch.gather(Gs, 1, ts[:, :, None].expand(Q, ms, SEL_SUB))
        vals, l2 = _top_sorted(G2.reshape(Q, ms * SEL_SUB), kp)
        sub = torch.gather(ts, 1, l2 // SEL_SUB)
        loc = sub * SEL_SUB + (l2 % SEL_SUB)
    block = torch.gather(tb, 1, loc // SEL_BLOCK)
    return vals, block * SEL_BLOCK + (loc % SEL_BLOCK)


def topk_scores_chunked(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    k: int,
    chunk: int = 262144,
    valid_n: int = -1,
    score_budget_bytes: int = 1 << 30,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k for wide k (>= 128): column-chunked ``Q @ C.T`` with
    :func:`block_topk` reducing each (Q, chunk) score tile at once and a
    running merge, so the corpus-wide score matrix never exists. The chunk
    shrinks so one f32 score tile fits ``score_budget_bytes``. Ties keep the
    lower row id."""
    q = queries.shape[0]
    n = corpus.shape[0]
    vn = n if valid_n < 0 else valid_n
    k_eff = min(k, n)
    max_chunk = max(SEL_BLOCK, score_budget_bytes // (4 * max(q, 1)))
    chunk = min(chunk, _round_up(max_chunk, SEL_BLOCK) - SEL_BLOCK
                if max_chunk % SEL_BLOCK else max_chunk)
    chunk = max(SEL_BLOCK, chunk - chunk % SEL_BLOCK)
    dev = queries.device

    def sel(off: int, rows: torch.Tensor, kp: int):
        s = _scores(queries, rows)
        col = torch.arange(off, off + rows.shape[0], device=dev)
        s = torch.where(col[None, :] < vn, s, torch.full_like(s, NEG_INF))
        v, i = block_topk(s, kp)
        return v, i + off

    if n <= chunk:
        vals, idx = sel(0, corpus, k_eff)
    else:
        vals = torch.full((q, k_eff), NEG_INF, dtype=torch.float32, device=dev)
        idx = torch.zeros((q, k_eff), dtype=torch.int64, device=dev)
        for off in range(0, n, chunk):
            rows = corpus[off: off + chunk]
            nv, ni = sel(off, rows, min(k_eff, rows.shape[0]))
            vals, s = _top_sorted(torch.cat([vals, nv], dim=1), k_eff)
            idx = torch.gather(torch.cat([idx, ni], dim=1), 1, s)
    if k_eff < k:
        vals = torch.cat([vals, torch.full((q, k - k_eff), NEG_INF,
                                           dtype=vals.dtype, device=dev)], 1)
        idx = torch.cat([idx, torch.zeros((q, k - k_eff), dtype=idx.dtype,
                                          device=dev)], 1)
    return vals, idx.to(torch.int32)


def _on_card(what: str, *tensors: torch.Tensor) -> bool:
    """True for CUDA tensors on one device, False for CPU tensors; raises
    on a mix."""
    devs = {t.device for t in tensors}
    if all(d.type == "cpu" for d in devs):
        return False
    if len(devs) != 1 or next(iter(devs)).type != "cuda":
        raise ValueError(f"{what}: tensors on {sorted(map(str, devs))}")
    return True


@functools.lru_cache(maxsize=None)
def _sm_count(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


# ------------------------------------------------------------ tile planning
#
# The wgmma kernels (csrc/qc_mainloop.cuh) keep a query tile of 64 or 128
# rows resident in shared memory and stream the corpus through a ring of
# 2-4 stages of 128 rows x 128 bytes (64 bf16 or 128 int8 columns). The f32
# schedules (csrc/tf32_mainloop.cuh) stream both operands: a stage is one
# 32-column K chunk of the query tile and of the corpus tile plus the
# corpus box's lo plane, so their shared memory does not grow with the
# width. The choice is made here, in pure functions the CPU tests reach,
# and handed to the C entry points, which recompute the byte count with the
# same formulas and refuse a plan that does not fit.

SMEM_LIMIT = 232448    # dynamic shared memory one block can get on sm_90
_CHUNK_BYTES = 128     # a ring stage's K chunk
_STAGE_BYTES = 128 * _CHUNK_BYTES
# (query rows per CTA, ring stages), in order of preference
_TILE_CHOICES = ((128, 4), (128, 3), (64, 4), (64, 3), (64, 2))


def _mainloop_bytes(bq: int, d: int, stages: int, elem: int = 2) -> int:
    """qc::mainloop_bytes: alignment slack, query tile (rows of ``elem``-byte
    values in whole 128-byte K chunks), ring, barriers."""
    return (1024 + bq * _round_up(d * elem, _CHUNK_BYTES)
            + stages * _STAGE_BYTES + 128)


def pass_a_smem_bytes(bq: int, d: int, stages: int, k_sel: int,
                      elem: int = 2) -> int:
    """Shared memory of the wgmma pass-A kernel on ``elem``-byte operands
    (2: bf16, 1: int8): the main loop's, then one (value, id) list per query
    row, ``k_sel`` entries at an odd stride."""
    return _mainloop_bytes(bq, d, stages, elem) + bq * (k_sel | 1) * 8


def fused_smem_bytes(bq: int, d: int, stages: int) -> int:
    """Shared memory of the fused kernel: the main loop's, a counter and a
    threshold per query row, a 1 KB histogram per consumer warp."""
    return _mainloop_bytes(bq, d, stages) + bq * 8 + (bq // 16) * 1024


def _widest(fits) -> int:
    """Largest multiple of 64 for which ``fits(d)`` holds."""
    d = 64
    while fits(d + 64):
        d += 64
    return d


@functools.lru_cache(maxsize=None)
def pass_a_max_d(k_sel: int, elem: int = 2) -> int:
    """The widest embedding the wgmma pass-A kernel takes at this ``k_sel``
    on ``elem``-byte operands: 64 query rows and two stages must fit (bf16:
    1,536 at k_sel 1, 1,024 at 128; int8: 3,072 and 2,048)."""
    return _widest(lambda d: pass_a_smem_bytes(64, d, 2, k_sel, elem)
                   <= SMEM_LIMIT)


@functools.lru_cache(maxsize=None)
def fused_max_d() -> int:
    """The widest embedding the fused kernel takes (1,472)."""
    return _widest(lambda d: fused_smem_bytes(64, d, 2) <= SMEM_LIMIT)


def _pick_tile(q: int, fits, choices=_TILE_CHOICES) -> Tuple[int, int]:
    for bq, stages in choices:
        if (bq == 64 or q > 64) and fits(bq, stages):
            return bq, stages
    raise ValueError("no tile fits the shared memory")


@functools.lru_cache(maxsize=1024)
def _pick_splits(n_qtiles: int, n_units: int, tiles_per_unit: int,
                 max_splits: int, sms: int) -> int:
    """Corpus splits for a grid of ``n_qtiles`` x splits CTAs, one CTA per
    SM at a time, over ``n_units`` indivisible units of ``tiles_per_unit``
    128-row tiles: the count that minimises (waves of CTAs) x (tiles per
    CTA + 2 for a CTA's fixed cost), among at most two waves' worth; the
    smallest such count, and only counts that leave no split empty."""
    upper = max(1, min(max_splits, n_units, -(-2 * sms // n_qtiles)))
    best, best_cost = 1, None
    for s in range(1, upper + 1):
        per = -(-n_units // s)
        s_eff = -(-n_units // per)
        cost = -(-n_qtiles * s_eff // sms) * (per * tiles_per_unit + 2)
        if best_cost is None or cost < best_cost:
            best, best_cost = s_eff, cost
    return best


def _segment_splits(q_tiles: int, n_segs: int, seg_rows: int,
                    sms: int) -> int:
    """Corpus splits of pass A, each a whole number of segments and of
    128-row tiles (:func:`_pick_splits`)."""
    unit = max(_LANE, seg_rows)
    n_units = max(1, -(-(n_segs * seg_rows) // unit))
    return _pick_splits(q_tiles, n_units, unit // _LANE, n_units, sms)


def _wgmma_pass_a_plan(q, d, k_sel, n_segs, seg_rows, sms, elem, what):
    widest = pass_a_max_d(k_sel, elem)
    if d > widest:
        raise ValueError(f"pass A ({what}) takes widths up to {widest} at "
                         f"k_sel={k_sel}, got {d}")
    bq, stages = _pick_tile(q, lambda b, s: pass_a_smem_bytes(
        b, d, s, k_sel, elem) <= SMEM_LIMIT)
    return {"bq": bq, "stages": stages,
            "n_splits": _segment_splits(-(-q // bq), n_segs, seg_rows, sms),
            "smem": pass_a_smem_bytes(bq, d, stages, k_sel, elem)}


def pass_a_plan(q: int, d: int, k_sel: int, n_segs: int, seg_rows: int,
                sms: int = 132) -> dict:
    """Tiles and grid of the bf16 pass-A kernel for ``q`` queries of width
    ``d`` over ``n_segs`` segments of ``seg_rows`` rows: ``bq`` query rows
    per CTA (128, or 64 for at most 64 queries or where 128 do not fit),
    ``stages`` ring stages, ``smem`` bytes, ``n_splits`` corpus splits
    (each a whole number of segments and of 128-row tiles). Raises
    ``ValueError`` past :func:`pass_a_max_d`."""
    return _wgmma_pass_a_plan(q, d, k_sel, n_segs, seg_rows, sms, 2, "bf16")


def pass_a_int8_plan(q: int, d: int, k_sel: int, n_segs: int, seg_rows: int,
                     sms: int = 132) -> dict:
    """:func:`pass_a_plan` for the int8 schedule (s8 ``wgmma``, one byte a
    value: a 128-byte K chunk holds 128 columns, so a query row takes half
    the shared memory). Raises ``ValueError`` past
    ``pass_a_max_d(k_sel, 1)``."""
    return _wgmma_pass_a_plan(q, d, k_sel, n_segs, seg_rows, sms, 1, "int8")


# the f32 schedules' tiles, in order of preference: 128 query rows a CTA
# (64 for a batch of at most 64), the deepest ring that fits
_F32_TILE_CHOICES = ((128, 4), (128, 3), (128, 2), (64, 4), (64, 3), (64, 2))


def _f32_mainloop_bytes(bq: int, stages: int) -> int:
    """tf32q::mainloop_bytes: alignment slack, ring (a stage: the query
    tile's K chunk, the corpus tile's and its lo plane), barriers."""
    return 1024 + stages * (bq * _CHUNK_BYTES + 2 * _STAGE_BYTES) + 128


def pass_a_f32_smem_bytes(bq: int, stages: int, k_sel: int) -> int:
    """Shared memory of pass A's f32 schedule: the 3xTF32 main loop's, then
    the lists as in :func:`pass_a_smem_bytes`; independent of the width."""
    return _f32_mainloop_bytes(bq, stages) + bq * (k_sel | 1) * 8


def pass_a_f32_plan(q: int, d: int, k_sel: int, n_segs: int, seg_rows: int,
                    sms: int = 132) -> dict:
    """Tiles and grid of pass A's f32 schedule at any width (``bq``,
    ``stages``, ``smem``, ``n_splits`` as in :func:`pass_a_plan`): 128
    query rows a CTA on 4 stages at k_sel up to 33, 3 up to 81, 2 past
    that (64 rows, for at most 64 queries, on 4 at every k_sel)."""
    del d  # the shared memory does not grow with the width
    bq, stages = _pick_tile(q, lambda b, s: pass_a_f32_smem_bytes(
        b, s, k_sel) <= SMEM_LIMIT, _F32_TILE_CHOICES)
    return {"bq": bq, "stages": stages,
            "n_splits": _segment_splits(-(-q // bq), n_segs, seg_rows, sms),
            "smem": pass_a_f32_smem_bytes(bq, stages, k_sel)}


# the wide schedule's tiles (csrc/qs_mainloop.cuh: a stage is one K chunk
# of the query tile and of the corpus tile), in order of preference
_WIDE_TILE_CHOICES = ((128, 6), (128, 4), (128, 3), (128, 2), (64, 6),
                      (64, 4), (64, 3), (64, 2))


def pass_a_wide_smem_bytes(bq: int, stages: int, k_sel: int) -> int:
    """Shared memory of pass A's wide schedule (qs::mainloop_bytes, then
    the lists): independent of the width."""
    return (1024 + stages * (bq * _CHUNK_BYTES + _STAGE_BYTES) + 128
            + bq * (k_sel | 1) * 8)


def pass_a_wide_plan(q: int, d: int, k_sel: int, n_segs: int, seg_rows: int,
                     sms: int = 132) -> dict:
    """Tiles and grid of pass A's wide schedule, bf16 at any width
    (``bq``, ``stages``, ``smem``, ``n_splits`` as in :func:`pass_a_plan`):
    128 query rows a CTA on 6 stages at every k_sel (64 rows for a batch of
    at most 64)."""
    del d  # the shared memory does not grow with the width
    bq, stages = _pick_tile(q, lambda b, s: pass_a_wide_smem_bytes(
        b, s, k_sel) <= SMEM_LIMIT, _WIDE_TILE_CHOICES)
    return {"bq": bq, "stages": stages,
            "n_splits": _segment_splits(-(-q // bq), n_segs, seg_rows, sms),
            "smem": pass_a_wide_smem_bytes(bq, stages, k_sel)}


# the ring's barriers (two per stage and the query tile's) fit 128 bytes for
# up to 7 stages
OVERLAP_MAX_STAGES = 7


def overlap_plan(q: int, d: int, k_sel: int, n_segs: int, seg_rows: int,
                 sms: int = 132) -> dict:
    """Tiles and grid of pass A's overlap schedule: :func:`pass_a_plan`'s
    (``bq``, ``stages``, ``smem``, ``n_splits``), with a 128-row CTA's ring
    made the deepest that fits, up to :data:`OVERLAP_MAX_STAGES` stages. A
    ring longer than a tile's K chunks (6 at D = 384) lets the CTA's two
    consumer warpgroups drift out of phase, one selecting while the other
    multiplies. A 64-row CTA has one consumer warpgroup and nothing to
    overlap: it keeps the default's plan. Takes every shape
    :func:`pass_a_plan` takes and raises ``ValueError`` where it does."""
    plan = pass_a_plan(q, d, k_sel, n_segs, seg_rows, sms)
    if plan["bq"] == 64:
        return plan
    stages = max(s for s in range(plan["stages"], OVERLAP_MAX_STAGES + 1)
                 if pass_a_smem_bytes(128, d, s, k_sel) <= SMEM_LIMIT)
    return {**plan, "stages": stages,
            "smem": pass_a_smem_bytes(128, d, stages, k_sel)}


def _fused_splits(q_tiles: int, k: int, vn: int, sms: int) -> int:
    """Corpus splits of the fused top-k: whole 128-row tiles, every split
    (the last too) of at least 4k rows."""
    n_tiles = max(1, -(-vn // _LANE))
    n_splits = _pick_splits(q_tiles, n_tiles, 1, max(1, vn // (4 * k)), sms)
    while n_splits > 1:
        rows = -(-n_tiles // n_splits) * _LANE
        if vn - (n_splits - 1) * rows >= 4 * k:
            break
        n_splits = -(-n_tiles // -(-n_tiles // (n_splits - 1)))
    return n_splits


def fused_plan(q: int, d: int, k: int, vn: int, sms: int = 132) -> dict:
    """Tiles and grid of the fused kernel for ``q`` queries of width ``d``
    and ``vn`` valid rows: ``bq``, ``stages``, ``smem`` as in
    :func:`pass_a_plan`; ``cap`` slots per (query, split) candidate buffer
    (2k + 128: a buffer is cut back to k when it passes 2k); ``n_splits``
    corpus splits, every one of at least 4k rows (a split's buffer and
    warm-up cost k slots per query however few rows it holds);
    ``scratch`` bytes of device memory the wrapper allocates for the call,
    freed after it: ``n_splits * q * (cap * 8 + 4)`` for the 8-byte
    candidate keys and the counters. Splits times query tiles stay within
    two waves of CTAs, so this is 1.1-1.4 GB at k = 2,048 for up to 32,768
    queries over 1.25M rows and grows with q past that (69 MB at the dense
    shape: 16,384 queries, k = 200, one split).
    Raises ``ValueError`` past :func:`fused_max_d`."""
    if d > fused_max_d():
        raise ValueError(f"the fused top-k takes widths up to "
                         f"{fused_max_d()}, got {d}")
    bq, stages = _pick_tile(q, lambda b, s: fused_smem_bytes(
        b, d, s) <= SMEM_LIMIT)
    n_splits = _fused_splits(-(-q // bq), k, vn, sms)
    cap = 2 * k + _LANE
    return {"bq": bq, "stages": stages, "n_splits": n_splits, "cap": cap,
            "smem": fused_smem_bytes(bq, d, stages),
            "scratch": n_splits * q * (cap * 8 + 4)}


def fused_f32_smem_bytes(bq: int, stages: int) -> int:
    """Shared memory of the fused kernel's f32 schedule: the 3xTF32 main
    loop's, then as in :func:`fused_smem_bytes`; independent of the
    width."""
    return _f32_mainloop_bytes(bq, stages) + bq * 8 + (bq // 16) * 1024


def fused_f32_plan(q: int, d: int, k: int, vn: int, sms: int = 132) -> dict:
    """:func:`fused_plan` for the f32 schedule at any width: 128 query rows
    a CTA (64 for at most 64 queries) on 4 stages, the same buffers
    (``cap``, ``scratch``) and splits of at least 4k rows."""
    del d  # the shared memory does not grow with the width
    bq, stages = _pick_tile(q, lambda b, s: fused_f32_smem_bytes(
        b, s) <= SMEM_LIMIT, _F32_TILE_CHOICES)
    n_splits = _fused_splits(-(-q // bq), k, vn, sms)
    cap = 2 * k + _LANE
    return {"bq": bq, "stages": stages, "n_splits": n_splits, "cap": cap,
            "smem": fused_f32_smem_bytes(bq, stages),
            "scratch": n_splits * q * (cap * 8 + 4)}


# ------------------------------------------------------------------- pass A

def segtopk_pass_a_plain(
    queries: torch.Tensor, corpus: torch.Tensor, n: int, seg_rows: int,
    k_sel: int, q_block: int = 1024, row_block: int = 1 << 16,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain pass A: (values f32, segment ids int32), both (Q, k_sel).

    Segment ``s`` covers natural rows ``[s*seg_rows, (s+1)*seg_rows)``; the
    segments holding at least one of the first ``n`` rows are ranked by
    their maximum score, descending, ties to the lower id. Rows at or past
    ``n`` inside the last segment score 0, as the zero pad rows of the JAX
    kernel do. With fewer than ``k_sel`` segments, slot ``j`` past them
    holds value NEG_INF and id ``-1-j``."""
    q = queries.shape[0]
    n_segs = -(-n // seg_rows)
    seg_end = n_segs * seg_rows
    row_block = _round_up(row_block, seg_rows)
    k_real = min(k_sel, n_segs)
    out_v = torch.full((q, k_sel), NEG_INF, dtype=torch.float32,
                       device=queries.device)
    out_i = -1 - torch.arange(k_sel, dtype=torch.int32, device=queries.device
                              ).expand(q, k_sel).clone()
    for q0 in range(0, q, q_block):
        qs = queries[q0: q0 + q_block]
        segmax = []
        for r0 in range(0, seg_end, row_block):
            r1 = min(r0 + row_block, seg_end)
            s = _scores(qs, corpus[r0: min(r1, n)])
            if s.shape[1] < r1 - r0:  # pad rows inside the last segment
                s = torch.cat([s, s.new_zeros(s.shape[0], r1 - r0 - s.shape[1])],
                              dim=1)
            segmax.append(s.reshape(s.shape[0], -1, seg_rows).amax(dim=2))
        v, i = _top_sorted(torch.cat(segmax, dim=1), k_real)
        out_v[q0: q0 + q_block, :k_real] = v
        out_i[q0: q0 + q_block, :k_real] = i.to(torch.int32)
    return out_v, out_i


def segtopk_pass_a_int8_plain(
    queries: torch.Tensor, corpus: torch.Tensor, n: int, seg_rows: int,
    k_sel: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain int8 pass A: :func:`segtopk_pass_a_plain` on int8 operands.
    Their products, summed in f32, are exact integers while 127*127*D stays
    below 2^24 (D < 1040), so the segment maxima equal the int32 maxima of
    the JAX kernel converted to f32."""
    if queries.dtype != torch.int8 or corpus.dtype != torch.int8:
        raise ValueError(f"int8 pass A takes int8 operands, got "
                         f"{queries.dtype} and {corpus.dtype}")
    return segtopk_pass_a_plain(queries, corpus, n, seg_rows, k_sel)


def _f32_operands(what: str, queries: torch.Tensor,
                  corpus: torch.Tensor) -> bool:
    """True for two f32 operands (the f32 schedule), False for two bf16
    ones; raises ``NotImplementedError`` for any other pair."""
    dtypes = {queries.dtype, corpus.dtype}
    if dtypes in ({torch.bfloat16}, {torch.float32}):
        return dtypes == {torch.float32}
    raise NotImplementedError(f"{what} takes two bfloat16 or two float32 "
                              f"operands, got {queries.dtype} and "
                              f"{corpus.dtype}")


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """``x`` contiguous and 16-byte aligned, copied only when it is not."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _pad_width(queries: torch.Tensor, corpus: torch.Tensor,
               dtype: torch.dtype, multiple: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Operands of ``dtype`` whose width is not a multiple of ``multiple``
    (the tensor maps need 16-byte rows) widened with zero columns, one copy
    each; a zero column adds exactly 0 to every product (and splits into hi
    = lo = 0 on the 3xTF32 path). Other widths and types are returned as
    they are."""
    d = queries.shape[1]
    if (queries.dtype != dtype or corpus.dtype != dtype
            or corpus.shape[1] != d or d % multiple == 0):
        return queries, corpus
    pad = _round_up(d, multiple) - d
    return (torch.nn.functional.pad(queries, (0, pad)),
            torch.nn.functional.pad(corpus, (0, pad)))


def _pad_f32_width(queries: torch.Tensor, corpus: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """f32 operands padded to a multiple of 4 columns (the f32 schedules)."""
    return _pad_width(queries, corpus, torch.float32, 4)


def _pad_bf16_width(queries: torch.Tensor, corpus: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """bf16 operands padded to a multiple of 8 columns (the bf16 schedules
    of pass A and the fused top-k)."""
    return _pad_width(queries, corpus, torch.bfloat16, 8)


# schedules of csrc/segtopk.cu: (mode, operand dtype, plan)
_PASS_A_MODES = {"bf16": (0, torch.bfloat16, pass_a_plan),
                 "overlap": (1, torch.bfloat16, overlap_plan),
                 "int8": (2, torch.int8, pass_a_int8_plan),
                 "f32": (3, torch.float32, pass_a_f32_plan),
                 "wide": (4, torch.bfloat16, pass_a_wide_plan)}


def _launch_pass_a(schedule: str, queries: torch.Tensor, corpus: torch.Tensor,
                   n: int, seg_rows: int, k_sel: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch one schedule of ``csrc/segtopk.cu`` on CUDA tensors, or
    raise."""
    mode, dtype, planner = _PASS_A_MODES[schedule]
    if queries.dtype != dtype or corpus.dtype != dtype:
        raise NotImplementedError(
            f"the {schedule} pass-A kernel takes {dtype} operands, got "
            f"{queries.dtype} and {corpus.dtype}")
    q, d = queries.shape
    vec = {0: 8, 1: 8, 2: 16, 3: 4, 4: 8}[mode]  # TMA rows: 16-byte pitches
    if corpus.shape[1] != d or d % vec:
        raise ValueError(f"pass A ({schedule}) needs matching widths that are "
                         f"multiples of {vec}, got {d} and {corpus.shape[1]}")
    if not (_LANE % seg_rows == 0 or seg_rows % _LANE == 0):
        raise ValueError(f"pass A needs segment rows dividing or divided by "
                         f"128, got {seg_rows}")
    if not 0 < k_sel <= _LANE or corpus.shape[0] < n:
        raise ValueError(f"pass A: k_sel={k_sel}, n={n}, corpus rows "
                         f"{corpus.shape[0]}")
    queries = _aligned(queries)
    corpus = _aligned(corpus)
    n_segs = -(-n // seg_rows)
    dev = queries.device
    plan = planner(q, d, k_sel, n_segs, seg_rows, _sm_count(dev))
    bq, stages, n_splits = plan["bq"], plan["stages"], plan["n_splits"]
    part_v = torch.empty((n_splits, q, k_sel), dtype=torch.float32, device=dev)
    part_i = torch.empty((n_splits, q, k_sel), dtype=torch.int32, device=dev)
    out_v = torch.empty((q, k_sel), dtype=torch.float32, device=dev)
    out_i = torch.empty((q, k_sel), dtype=torch.int32, device=dev)
    fn = _build.load("segtopk").segtopk_pass_a
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 10
                   + [ctypes.c_void_p])
    status = fn(queries.data_ptr(), corpus.data_ptr(), part_v.data_ptr(),
                part_i.data_ptr(), out_v.data_ptr(), out_i.data_ptr(),
                q, n, d, seg_rows, n_segs, k_sel, n_splits, mode, bq, stages,
                torch.cuda.current_stream(dev).cuda_stream)
    _build.check(status, f"segtopk_pass_a ({schedule})")
    return out_v, out_i


def segtopk_pass_a(
    queries: torch.Tensor, corpus: torch.Tensor, n: int, seg_rows: int,
    k_sel: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pass A of the two-pass top-k; same contract as
    :func:`segtopk_pass_a_plain`, which it runs for CPU tensors. For CUDA
    tensors it launches ``csrc/segtopk.cu`` (bf16 operands at a width not a
    multiple of 8, or the f32 schedule for f32 operands at a width not a
    multiple of 4, padded with zero columns; bf16 past
    :func:`pass_a_max_d` in the wide schedule) or raises."""
    global SEGTOPK_LAUNCHES, SEGTOPK_F32_LAUNCHES, SEGTOPK_WIDE_LAUNCHES
    if not _on_card("segtopk_pass_a", queries, corpus):
        return segtopk_pass_a_plain(queries, corpus, n, seg_rows, k_sel)
    if _f32_operands("the pass-A kernel", queries, corpus):
        out = _launch_pass_a("f32", *_pad_f32_width(queries, corpus), n,
                             seg_rows, k_sel)
        SEGTOPK_F32_LAUNCHES += 1
    else:
        queries, corpus = _pad_bf16_width(queries, corpus)
        if pass_a_schedule(queries.shape[1], k_sel) == "wide":
            out = _launch_pass_a("wide", queries, corpus, n, seg_rows, k_sel)
            SEGTOPK_WIDE_LAUNCHES += 1
        else:
            out = _launch_pass_a("bf16", queries, corpus, n, seg_rows, k_sel)
            SEGTOPK_LAUNCHES += 1
    return out


def pass_a_schedule(d: int, k_sel: int) -> str:
    """The bf16 schedule :func:`segtopk_pass_a` launches at width ``d``:
    "bf16" (the resident query tile) up to :func:`pass_a_max_d`, "wide"
    past it."""
    return "bf16" if d <= pass_a_max_d(k_sel) else "wide"


def segtopk_pass_a_overlap(
    queries: torch.Tensor, corpus: torch.Tensor, n: int, seg_rows: int,
    k_sel: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pass A in the overlap schedule (``_segtopk_kernel_overlap``):
    bit-identical to :func:`segtopk_pass_a`. For CPU tensors it runs
    :func:`segtopk_pass_a_plain`; for CUDA tensors it launches the overlap
    schedule of ``csrc/segtopk.cu`` (bf16 operands, a width not a multiple
    of 8 padded with zero columns; tiles from :func:`overlap_plan`), or for f32 operands the f32 schedule (the
    3xTF32 main loop, whose two consumer warpgroups move in step, so there
    is no phase to overlap: the default's launch), or raises."""
    global SEGTOPK_OVERLAP_LAUNCHES, SEGTOPK_OVERLAP_F32_LAUNCHES
    if not _on_card("segtopk_pass_a_overlap", queries, corpus):
        return segtopk_pass_a_plain(queries, corpus, n, seg_rows, k_sel)
    if _f32_operands("the pass-A kernel", queries, corpus):
        out = _launch_pass_a("f32", *_pad_f32_width(queries, corpus), n,
                             seg_rows, k_sel)
        SEGTOPK_OVERLAP_F32_LAUNCHES += 1
    else:
        out = _launch_pass_a("overlap", *_pad_bf16_width(queries, corpus),
                             n, seg_rows, k_sel)
        SEGTOPK_OVERLAP_LAUNCHES += 1
    return out


def segtopk_pass_a_int8(
    queries: torch.Tensor, corpus: torch.Tensor, n: int, seg_rows: int,
    k_sel: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pass A on int8 operands (the JAX kernel's int8 mode). For CPU
    tensors it runs :func:`segtopk_pass_a_int8_plain`; for CUDA tensors it
    launches the int8 schedule of ``csrc/segtopk.cu`` or raises. Operands
    of a width that is not a multiple of 16 are padded with zero columns
    (one copy each), which change no product."""
    global SEGTOPK_INT8_LAUNCHES
    if not _on_card("segtopk_pass_a_int8", queries, corpus):
        return segtopk_pass_a_int8_plain(queries, corpus, n, seg_rows, k_sel)
    d = queries.shape[1]
    if (queries.dtype == corpus.dtype == torch.int8 and corpus.shape[1] == d
            and d % 16):
        pad = _round_up(d, 16) - d
        queries = torch.nn.functional.pad(queries, (0, pad))
        corpus = torch.nn.functional.pad(corpus, (0, pad))
    out = _launch_pass_a("int8", queries, corpus, n, seg_rows, k_sel)
    SEGTOPK_INT8_LAUNCHES += 1
    return out


# ------------------------------------------------------------ fused top-k

def topk_scores_fused_plain(
    queries: torch.Tensor, corpus: torch.Tensor, k: int, valid_n: int = -1,
    block_n: int = 65536,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain fused top-k: (values f32, row ids int32), both (Q, k), ordered
    by value descending then row ascending; rows at or past ``valid_n``
    never appear, and slots past the real rows hold (NEG_INF, 0)."""
    vn = corpus.shape[0] if valid_n < 0 else valid_n
    return topk_scores_ref(queries, corpus[:vn], k=k, block_n=block_n)


def topk_scores_fused(
    queries: torch.Tensor, corpus: torch.Tensor, k: int, valid_n: int = -1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k for any k up to :data:`FUSED_MAX_K`; the contract of
    :func:`topk_scores_fused_plain`, which it runs for CPU tensors. For
    CUDA tensors it launches ``csrc/topk_fused.cu`` (bf16 operands at a
    width not a multiple of 8, or the f32 schedule for f32 operands at a
    width not a multiple of 4, padded with zero columns) or raises."""
    global TOPK_FUSED_LAUNCHES, TOPK_FUSED_F32_LAUNCHES
    if not 0 < k <= FUSED_MAX_K:
        raise ValueError(f"the fused top-k supports 1 <= k <= {FUSED_MAX_K} "
                         f"(FUSED_MAX_K), got k={k}")
    vn = corpus.shape[0] if valid_n < 0 else valid_n
    if not 0 <= vn <= corpus.shape[0]:
        raise ValueError(f"valid_n={valid_n} outside the corpus's "
                         f"{corpus.shape[0]} rows")
    if not _on_card("topk_scores_fused", queries, corpus):
        return topk_scores_fused_plain(queries, corpus, k, vn)
    f32 = _f32_operands("the fused top-k kernel", queries, corpus)
    q, d = queries.shape
    if corpus.shape[1] != d:
        raise ValueError(f"the fused top-k needs matching widths, got {d} "
                         f"and {corpus.shape[1]}")
    queries, corpus = (_pad_f32_width if f32 else _pad_bf16_width)(
        queries, corpus)
    d = queries.shape[1]
    queries = _aligned(queries)
    corpus = _aligned(corpus)
    dev = queries.device
    plan = (fused_f32_plan if f32 else fused_plan)(q, d, k, vn,
                                                   _sm_count(dev))
    n_splits, cap = plan["n_splits"], plan["cap"]
    keys = torch.empty((n_splits, q, cap), dtype=torch.int64, device=dev)
    counts = torch.empty((n_splits, q), dtype=torch.int32, device=dev)
    out_v = torch.empty((q, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((q, k), dtype=torch.int32, device=dev)
    fn = _build.load("topk_fused").topk_fused
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    status = fn(queries.data_ptr(), corpus.data_ptr(), keys.data_ptr(),
                counts.data_ptr(), out_v.data_ptr(), out_i.data_ptr(),
                q, vn, d, k, n_splits, plan["bq"], plan["stages"], cap,
                int(f32), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(status, "topk_fused (f32)" if f32 else "topk_fused")
    if f32:
        TOPK_FUSED_F32_LAUNCHES += 1
    else:
        TOPK_FUSED_LAUNCHES += 1
    return out_v, out_i


def topk_scores_pallas(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    k: int = 10,
    block_q: int = 128,
    block_n: int = 1024,
    interpret: bool = False,
    segmented: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k inner-product search: (values, indices), each (Q, k).
    The JAX signature; ``block_q``, ``block_n``, ``interpret`` and
    ``segmented`` have no role here (the Hopper kernel picks its own tiles;
    a CPU tensor takes the plain version). Runs :func:`topk_scores_fused`."""
    del block_q, block_n, interpret, segmented
    return topk_scores_fused(queries, corpus, k)


def topk_scores(
    queries: torch.Tensor, corpus: torch.Tensor, k: int = 10, **kw
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dispatch: the fused kernel for CUDA tensors, the reference scan for
    CPU tensors."""
    if queries.device.type == "cuda":
        return topk_scores_pallas(queries, corpus, k=k, **kw)
    return topk_scores_ref(queries, corpus, k=k)


# -------------------------------------------------------------- two-pass top-k

def _quantize_rows_int8(queries: torch.Tensor,
                        width: Optional[int] = None) -> torch.Tensor:
    """Per-row symmetric int8, the scale taken in the queries' own dtype
    as the JAX package does, rounding half to even; with ``width``, that
    many columns wide, zero past the queries' own."""
    sq = torch.clamp(queries.abs().amax(dim=1, keepdim=True) / 127.0,
                     min=1e-12)
    return _int8_into(torch.clamp(torch.round(queries.float() / sq.float()),
                                  -127, 127), width)


def topk_scores_twopass(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    k: int = 10,
    block_q: int = 256,
    block_n: int = 8192,
    q_chunk: int = 256,
    interpret: bool = False,
    corpus_swizzled: Optional[torch.Tensor] = None,
    gather_from_swizzled: bool = False,
    valid_n: int = -1,
    seg_split: int = 1,
    mxu_overlap: bool = False,
    pass_a_int8: bool = False,
    corpus_swizzled_q8: Optional[torch.Tensor] = None,
    k_sel_extra: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k inner-product search, two-pass: (values f32, indices
    int32), each (Q, k). Requires k < 128.

    Same signature and guards as the JAX function. ``block_n`` and
    ``seg_split`` set the segment length ``block_n/128/seg_split`` and the
    padding of ``corpus_swizzled``; ``block_q`` and ``interpret`` have no
    role here (the Hopper kernel picks its own tiles; a CPU tensor takes
    the plain pass A). ``gather_from_swizzled=True`` passes the swizzled
    layout as ``corpus`` with the true row count as ``valid_n``; it is read
    back into natural order once.

    ``mxu_overlap=True`` runs pass A in the overlap schedule
    (:func:`segtopk_pass_a_overlap`, bit-identical results).
    ``pass_a_int8=True`` runs pass A on int8 operands
    (:func:`segtopk_pass_a_int8`): the corpus quantized once with one
    global scale (or ``corpus_swizzled_q8``, a prequantized swizzled copy,
    read back into natural order once), each query row on the fly. Segment
    selection then carries the quantization noise, covered by
    ``k_sel_extra`` extra segments (default 5 in this mode); pass B
    rescores exactly either way, so the mode is statistically exact."""
    del block_q, interpret
    assert k < _LANE, f"segment top-k supports k < {_LANE}, got {k}"
    assert not (pass_a_int8 and mxu_overlap), (
        "pass_a_int8 and mxu_overlap are mutually exclusive (the overlap "
        "kernel was a measured dead end; it has no int8 variant)")
    if gather_from_swizzled:
        assert valid_n >= 0, (
            "gather_from_swizzled=True requires valid_n (the true corpus "
            "row count) — the padded layout's zero rows are not documents"
        )
    q, d = queries.shape
    n = valid_n if valid_n >= 0 else corpus.shape[0]
    n_pad = _round_up(n, block_n)
    L = block_n // _LANE
    assert L % seg_split == 0 and L >= seg_split, (
        f"seg_split={seg_split} must divide block_n/128={L}"
    )
    if gather_from_swizzled:
        swz = corpus if corpus_swizzled is None else corpus_swizzled
        assert swz.shape[0] == n_pad, (
            "single-copy mode expects the swizzled (padded) layout"
        )
        corpus = _unswizzle(swz, block_n)
    elif corpus_swizzled is not None:
        assert corpus_swizzled.shape[0] == n_pad, (
            f"corpus_swizzled has {corpus_swizzled.shape[0]} rows but this "
            f"block_n={block_n} pads the corpus to {n_pad} — it was built "
            "with a different block_n (swizzle_corpus and "
            "topk_scores_twopass must use the same value)"
        )
    L2 = L // seg_split  # rows per (fine) segment
    if pass_a_int8 and k_sel_extra == 0:
        k_sel_extra = 5  # noise margin: host sim covers 100% at +3
    k_sel = min(k + 1 + k_sel_extra, _LANE)
    if pass_a_int8:
        # the statistical-exactness contract must degrade loudly
        if k + 1 + k_sel_extra > _LANE:
            warnings.warn(
                f"pass_a_int8: k_sel clamped to the {_LANE}-lane scratch "
                f"(k={k}, k_sel_extra={k_sel_extra}) — the int8 noise margin "
                f"shrinks to {_LANE - 1 - k} segments; recall may drop "
                "below the host-simulated coverage", stacklevel=2)
        if d >= 1040:
            warnings.warn(
                f"pass_a_int8: d={d} >= 1040 — the int32 segment max can "
                "exceed 2^24 (127*127*d) and its f32 conversion is no "
                "longer exact; segment ordering may perturb selection",
                stacklevel=2)
        # the s8 kernel's TMA loads need widths that are multiples of 16:
        # the operands are quantized (or read back) straight into that width
        w8 = _round_up(d, 16)
        if corpus_swizzled_q8 is not None:
            assert corpus_swizzled_q8.dtype == torch.int8
            corpus_q8 = _unswizzle(corpus_swizzled_q8, block_n, w8)
        else:
            src = corpus_swizzled if (corpus_swizzled is not None
                                      and not gather_from_swizzled) else corpus
            if src is corpus_swizzled:
                corpus_q8 = _unswizzle(quantize_int8_global(src)[0], block_n,
                                       w8)
            else:
                corpus_q8, _ = quantize_int8_global(src, w8)

    out_v, out_i = [], []
    for s in range(0, max(q, 1), _MAX_TWOPASS_Q):
        qs = queries[s: s + _MAX_TWOPASS_Q]
        with profiling.span("index.pass_a"):
            if pass_a_int8:
                _, seg_ids = segtopk_pass_a_int8(
                    _quantize_rows_int8(qs, w8), corpus_q8, n, L2, k_sel)
            else:
                pass_a = (segtopk_pass_a_overlap if mxu_overlap
                          else segtopk_pass_a)
                _, seg_ids = pass_a(qs.to(corpus.dtype), corpus, n, L2,
                                    k_sel)
        with profiling.span("index.pass_b"):
            v, i = pass_b_rescore(qs.to(corpus.dtype), corpus, seg_ids, n,
                                  L2, k, q_chunk)
        out_v.append(v)
        out_i.append(i)
    if len(out_v) == 1:
        return out_v[0], out_i[0]
    return torch.cat(out_v), torch.cat(out_i)


# -------------------------------------------------------------------- pass B
#
# csrc/pass_b.cu runs pass B segment-major in three stages a query chunk:
# the (query, slot) pairs bucketed by segment, each work item (up to 16
# pairs of one segment) scored against the segment's rows staged once in
# shared memory, and each query's top k selected from the scores. The plan
# is made here.

# the scratch a call may hold (scores, pairs, segment arrays, work items);
# more queries run in chunks that fit it
PASS_B_SCRATCH_BYTES = 256 << 20
_PB_ITEM = 16            # pairs a work item (csrc/pass_b.cu QROWS)
_PB_SCORE_SMEM = 45056   # five score CTAs an SM (1 KB each reserved)
# launches of pass B's bucket stage alone (:func:`pass_b_buckets`)
PASS_B_BUCKET_LAUNCHES = 0


def _pass_b_seg_ints(n_segs: int) -> int:
    """Ints of each of the three segment arrays (counts then first pairs,
    cursors, first items): n_segs and three totals, rounded up to the
    scan's 8 a thread."""
    return _round_up(n_segs + 3, 8)


def _pass_b_items(pairs: int, n_segs: int) -> int:
    """Work items the score stage may take: each non-empty segment's pairs
    in items of at most 16, so at most pairs / 16 plus one a segment."""
    return -(-pairs // _PB_ITEM) + min(n_segs, pairs)


@functools.lru_cache(maxsize=256)
def pass_b_plan(q: int, k_sel: int, n: int, L2: int, d: int, elem: int,
                budget: int = PASS_B_SCRATCH_BYTES) -> dict:
    """The pass-B kernel's plan for ``q`` queries of ``k_sel`` segments of
    ``L2`` rows over ``n`` rows of width ``d`` (``elem`` bytes a value):

    * ``q_chunk``: queries a chunk, the most whose scratch (``scratch``
      bytes: the f32 scores, the int2 pairs, three int arrays a segment
      and the int4 work items, each region 16-byte aligned) fits
      ``budget``, at least one;
    * ``pairs``: the most (query, slot) pairs a score CTA takes, 16 (a
      work item: up to 16 pairs of one segment, one MMA tile of queries);
      ``grid``: score CTAs a full chunk, a work item each (at most pairs /
      16 plus one a segment; CTAs past the items return at once);
    * ``rt`` segment rows a tile (16 queries a tile), the width in chunks
      of ``dc`` columns (a multiple of 16, chunks of equal size as near as
      may be), and the score CTA's shared memory ``smem``: both tiles at a
      16-byte pad a row, and 4 bytes a pair; it fits five CTAs an SM at
      every width."""
    n_segs = -(-n // L2)

    def scratch(qc: int) -> int:
        pairs = qc * k_sel
        return (_round_up(4 * pairs * L2, 16) + _round_up(8 * pairs, 16)
                + 12 * _pass_b_seg_ints(n_segs)
                + 16 * _pass_b_items(pairs, n_segs))

    lo, hi = 1, max(q, 1)  # the most queries whose scratch fits, at least 1
    while lo < hi:
        mid = (lo + hi + 1) // 2
        lo, hi = (mid, hi) if scratch(mid) <= budget else (lo, mid - 1)
    rt = min(32, _round_up(L2, 8))
    pad = 16 // elem
    fixed = 4 * _PB_ITEM
    widest = ((_PB_SCORE_SMEM - fixed) // ((rt + _PB_ITEM) * elem)
              - pad) // 16 * 16
    chunks = -(-_round_up(d, 16) // widest)
    dc = _round_up(-(-d // chunks), 16)
    return {"q_chunk": lo, "pairs": _PB_ITEM,
            "grid": _pass_b_items(lo * k_sel, n_segs),
            "rt": rt, "dc": dc,
            "smem": (rt + _PB_ITEM) * (dc + pad) * elem + fixed,
            "n_segs": n_segs, "scratch": scratch(lo)}


def pass_b_buckets_plain(seg_ids: torch.Tensor, n: int, L2: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pass B's first stage in torch ops: the (query, slot) pairs of
    ``seg_ids`` (Q, k_sel) bucketed by segment. Returns ``pairs`` (Q *
    k_sel, 2) int32, whose first ``starts[-1]`` rows are (segment, query *
    k_sel + slot) sorted by segment, then by position, and -1 after; and
    ``starts`` (n_segs + 1) int32, each bucket's first row, then the
    number of pairs. Placeholders (ids < 0) and segments wholly past ``n``
    are dropped; a segment listed twice by one query is two pairs."""
    n_segs = -(-n // L2)
    flat = seg_ids.reshape(-1).long()
    keep = torch.nonzero((flat >= 0) & (flat < n_segs)).reshape(-1)
    order = torch.sort(flat[keep], stable=True).indices
    pos = keep[order]
    pairs = torch.full((flat.numel(), 2), -1, dtype=torch.int32,
                       device=seg_ids.device)
    pairs[: pos.numel(), 0] = flat[pos].int()
    pairs[: pos.numel(), 1] = pos.int()
    counts = torch.bincount(flat[keep], minlength=n_segs)
    starts = torch.zeros(n_segs + 1, dtype=torch.int64, device=seg_ids.device)
    starts[1:] = torch.cumsum(counts, 0)
    return pairs, starts.int()


def pass_b_items_plain(starts: torch.Tensor) -> torch.Tensor:
    """The score stage's work items from :func:`pass_b_buckets_plain`'s
    ``starts``: each non-empty bucket cut into items of at most 16 pairs,
    in segment order; (items, 3) int64 rows of (segment, first pair,
    pairs)."""
    starts = starts.long()
    counts = starts[1:] - starts[:-1]
    per_seg = (counts + _PB_ITEM - 1) // _PB_ITEM
    seg = torch.repeat_interleave(torch.arange(counts.numel()), per_seg)
    first = torch.cumsum(per_seg, 0) - per_seg
    j = torch.arange(seg.numel()) - torch.repeat_interleave(first, per_seg)
    lo = starts[seg] + j * _PB_ITEM
    return torch.stack([seg, lo, (counts[seg] - j * _PB_ITEM).clamp(
        max=_PB_ITEM)], 1)


def pass_b_buckets(seg_ids: torch.Tensor, n: int, L2: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`pass_b_buckets_plain` through the kernel's own first stage
    (``csrc/pass_b.cu``, ``pass_b_bucket``) for CUDA tensors, counted in
    ``PASS_B_BUCKET_LAUNCHES``; the plain version for CPU tensors. On the
    card the order inside a bucket follows the atomics and the rows past
    the pairs are unspecified."""
    global PASS_B_BUCKET_LAUNCHES
    q, k_sel = seg_ids.shape
    if not _on_card("pass_b_buckets", seg_ids) or q == 0:
        return pass_b_buckets_plain(seg_ids, n, L2)
    seg_ids = seg_ids.to(torch.int32).contiguous()
    dev = seg_ids.device
    n_segs = -(-n // L2)
    pairs = torch.empty((q * k_sel, 2), dtype=torch.int32, device=dev)
    segs = torch.empty(3 * _pass_b_seg_ints(n_segs), dtype=torch.int32,
                       device=dev)
    items = torch.empty((_pass_b_items(q * k_sel, n_segs), 4),
                        dtype=torch.int32, device=dev)
    fn = _build.load("pass_b").pass_b_bucket
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_longlong]
                   + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    _build.check(fn(seg_ids.data_ptr(), pairs.data_ptr(), segs.data_ptr(),
                    items.data_ptr(), q, n, L2, k_sel, _raw_stream(dev)),
                 "pass_b_bucket")
    PASS_B_BUCKET_LAUNCHES += 1
    return pairs, segs[: n_segs + 1]


def pass_b_rescore_plain(queries: torch.Tensor, corpus: torch.Tensor,
                         seg_ids: torch.Tensor, n: int, L2: int, k: int,
                         q_chunk: int = 256
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain pass B: gather every candidate segment's rows and rescore them
    exactly, ``q_chunk`` queries at a time; ids < 0 are pass A's "fewer
    than k_sel real segments" placeholders. The contract is
    :func:`pass_b_rescore`'s."""
    q, k_sel = seg_ids.shape
    seg_ids = seg_ids.long()
    j_off = torch.arange(L2, device=queries.device)
    cand_rows = (seg_ids.clamp(min=0)[:, :, None] * L2 + j_off).reshape(q, -1)
    cand_valid = ((seg_ids[:, :, None] >= 0)
                  .expand(q, k_sel, L2).reshape(q, -1)) & (cand_rows < n)
    safe_rows = cand_rows.clamp(max=n - 1)
    out_v, out_i = [], []
    for s in range(0, q, q_chunk):
        blocks = corpus[safe_rows[s: s + q_chunk]].float()  # (qc, C, D)
        scores = torch.bmm(blocks, queries[s: s + q_chunk].float()[:, :, None]
                           )[:, :, 0]
        scores = torch.where(cand_valid[s: s + q_chunk], scores,
                             torch.full_like(scores, NEG_INF))
        v, sel = _top_sorted(scores, k)
        out_v.append(v)
        out_i.append(torch.gather(cand_rows[s: s + q_chunk], 1, sel))
    return torch.cat(out_v), torch.cat(out_i).to(torch.int32)


def _raw_stream(dev: torch.device) -> int:
    """The current stream's ``cudaStream_t`` on ``dev``, by the call
    PyTorch's own generated code makes (``torch.cuda.current_stream`` builds
    a Stream object first, a third of pass B's host time at the serve
    shape)."""
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is None:
        return torch.cuda.current_stream(dev).cuda_stream
    return raw(dev.index)


@functools.lru_cache(maxsize=None)
def _pass_b_entry():
    """The kernel's C entry point, its signature set once."""
    fn = _build.load("pass_b").pass_b_rescore
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_longlong]
                   + [ctypes.c_int] * 10 + [ctypes.c_void_p])
    return fn


def pass_b_rescore(queries: torch.Tensor, corpus: torch.Tensor,
                   seg_ids: torch.Tensor, n: int, L2: int, k: int,
                   q_chunk: int = 256,
                   scratch_budget: int = PASS_B_SCRATCH_BYTES
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pass B of the two-pass top-k: (values f32, row ids int32), each
    (Q, k). Candidate ``s * L2 + j`` of query ``q`` is row
    ``max(seg_ids[q, s], 0) * L2 + j``, valid iff ``seg_ids[q, s] >= 0``
    and the row is below ``n``; it scores its dot product with the query in
    f32 (NEG_INF when invalid, and then it is not read). The top k come by
    value descending, ties to the earlier candidate; NEG_INF slots carry
    their candidates' rows.

    For CPU tensors it runs :func:`pass_b_rescore_plain` (``q_chunk``
    bounds its buffer). For CUDA tensors it runs ``csrc/pass_b.cu`` on bf16
    or f32 operands of any width, or raises: another dtype
    (``NotImplementedError``), k outside 1..k_sel * L2 (``ValueError``).
    The kernel works segment-major, planned by :func:`pass_b_plan`: each
    query chunk whose scratch fits ``scratch_budget`` bytes (one
    ``torch.empty``) is one memset and four kernels (the pairs bucketed by
    segment in two, scored against each segment's rows read once, each
    query's top k selected), with no host synchronisation; one call counts
    one launch in ``PASS_B_LAUNCHES``."""
    global PASS_B_LAUNCHES
    q, k_sel = seg_ids.shape
    d = queries.shape[1]
    if queries.shape[0] != q or corpus.shape[1] != d or corpus.shape[0] < n:
        raise ValueError(f"pass B: queries {tuple(queries.shape)}, corpus "
                         f"{tuple(corpus.shape)}, seg_ids {(q, k_sel)}, "
                         f"n={n}")
    if not 0 < k <= k_sel * L2:
        raise ValueError(f"pass B keeps 1 <= k <= k_sel * L2 = {k_sel * L2} "
                         f"candidates, got k={k}")
    if not _on_card("pass_b_rescore", queries, corpus, seg_ids):
        return pass_b_rescore_plain(queries, corpus, seg_ids, n, L2, k,
                                    q_chunk)
    f32 = _f32_operands("the pass-B kernel", queries, corpus)
    dev = queries.device
    out_v = torch.empty((q, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((q, k), dtype=torch.int32, device=dev)
    if q == 0:
        return out_v, out_i
    queries = _aligned(queries)
    corpus = corpus.contiguous()
    seg_ids = seg_ids.to(torch.int32).contiguous()
    elem = corpus.element_size()
    vec = (16 // elem if corpus.data_ptr() % 16 == 0 and (d * elem) % 16 == 0
           else 1)
    plan = pass_b_plan(q, k_sel, n, L2, d, elem, scratch_budget)
    scratch = torch.empty(plan["scratch"], dtype=torch.uint8, device=dev)
    status = _pass_b_entry()(
        queries.data_ptr(), corpus.data_ptr(), seg_ids.data_ptr(),
        out_v.data_ptr(), out_i.data_ptr(), scratch.data_ptr(), q, n, d, L2,
        k_sel, k, int(f32), vec, plan["q_chunk"], _sm_count(dev), plan["dc"],
        plan["rt"], _raw_stream(dev))
    _build.check(status, "pass_b_rescore (f32)" if f32 else "pass_b_rescore")
    PASS_B_LAUNCHES += 1
    return out_v, out_i
