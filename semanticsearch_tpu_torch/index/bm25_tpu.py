"""Device-resident BM25 top-k: the lexical serve leg on the CUDA device.

Counterpart of ``semanticsearch_tpu/index/bm25_tpu.py`` (same path and class
name), on one CUDA device (or the CPU, for tests) or column-sharded over a
mesh. The host BM25 kernels
(``native/semsearch_native.cpp``) traverse postings one query at a time; a
serve host has few cores while every other leg of the query rides the card.
This module moves the dominant share of lexical scoring onto it.

DESIGN: frequency-split exact scoring.

- Build time: the top-``n_dense_terms`` vocabulary terms by document
  frequency become a dense int8 contribution matrix ``C`` (B, D):
  ``C[t, d] = round(contrib[t, d] / s_t)`` with per-term scale
  ``s_t = max_d |contrib| / 127``, where ``contrib = idf * (k1+1) * quot`` is
  exactly the quantity the host kernels accumulate. These are the
  stopword-class terms whose long postings dominate host cost.
- Query time: per-term scales fold into the query weights, which upload as
  a small COO and densify on the card; the frequent part of every score is
  a product ``S = Wq @ C`` followed by an exact staged selection
  (``ops/topk.py::block_topk``). Rare query terms keep their short postings
  on the host (``bm25_rare_touch``).
- Exactness: the product is approximate, with an error bounded per query
  (``err_ub``). Per query the candidate set is the device top-K' plus every
  rare-touched document; candidates are rescored exactly in
  ``BM25Okapi.get_topk``'s f32 order (``bm25_device_post``), and a
  certificate checks that no non-candidate can beat the exact k-th score
  (its true score is at most ``v_K' + err_ub``). Certified queries equal
  ``BM25Okapi.get_topk`` (scores and lower-id tie policy); the rest (and
  fewer than k positive matches, or a non-positive boundary) go to the
  host top-k in one batched native call, so the output is always exact.
- Residual pass (default on): a second int8 matrix holds the first
  quantization's residuals (scale about s/254), shrinking ``err_ub`` about
  100x so that certification nearly always succeeds, at 2x the matrix.

Weights (residual mode): ``"int8"`` splits each query's folded weights into
int8 parts with per-query scales, ``w ~= a*hi8 + (a/254)*mid8`` against C
and ``c*lo8`` against C_lo: three int8 x int8 -> int32 products
(``torch._int_mm``), exact, so the JAX package's error budget holds as it
is. ``"bf16"`` splits them into bf16 head and tail against C and one bf16
pass against C_lo; the products must leave in f32 with f32 accumulation
(``torch.mm(..., out_dtype=torch.float32)`` on the card, an f32 GEMM of the
exactly widened operands on the CPU). Every int8 x bf16 product is exact in
f32; only the accumulation rounds. With n dense terms in a query the three
products add at most 3n nonzero terms and the sum of the three one more
rounding; each rounding is at most 2^-23 (truncation) of a partial sum
bounded by ``smax``, the sum of the terms' magnitudes, and a tensor-core
accumulator that aligns a block of products to its largest exponent
truncates each block at most once more. So ``err_ub`` adds
``smax * (3n + 1) * 2^-22`` (``(n + 1) * 2^-22`` without the residual) on
top of the JAX package's ``smax * 1e-6``.

Layout: ``torch._int_mm`` runs at the int8 tensor-core rate only on a
column-major right operand, several times slower on a row-major one
(``chip_smoke.py`` phase 8 times both on an H100). So the matrix lives on
the card transposed, one row of [C | C_lo] per document: a column chunk's
right operands are views, never copies.

Scoring is column-chunked (``_SCORE_CHUNK`` documents a step): each (Q,
chunk) score tile is top-K'-selected at once and merged into a running
candidate set, so the corpus-wide score matrix never exists.

The int8 matrix can persist beside the index (``cache_dir``), fingerprinted
against the BM25 statistics, in the JAX package's file format: a restart
memmaps it instead of re-quantizing.

Mesh (``mesh=``, more than one row shard): the matrix's document columns
shard over the mesh, padded to ``SEL_BLOCK`` times the shard count; each
shard scores and selects its own columns (K' at most its column count) and
the candidate lists merge as the dense leg's do
(``parallel/sharding.py::merge_candidates``: concatenated in shard order, a
stable top-K', across processes through the mesh's group).
"""
from __future__ import annotations

import json
import os
import time
from collections import Counter
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..core.logging import get_logger
from ..core.mesh import local_row_devices, local_rows, n_row_shards
from ..ops.topk import SEL_BLOCK, _top_sorted, block_topk
from .bm25 import BM25Okapi

logger = get_logger("bm25_tpu")

# document-column width of one scoring step: 262,144 columns keep a (1024,
# chunk) f32 score tile at 1 GB next to the resident matrix (JAX package's
# measured trade between per-chunk select-and-merge epilogues and memory)
_SCORE_CHUNK = 262144
# documents a step when the host matrix is uploaded and transposed
_UPLOAD_COLS = 65536


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _bf16(x: np.ndarray) -> np.ndarray:
    """f32 values rounded to bfloat16 (nearest, ties to even), back in f32."""
    t = torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32))
    return t.to(torch.bfloat16).float().numpy()


class DeviceBM25:
    """Exact BM25 top-k with the frequent-term scoring on the card.

    ``n_dense_terms``: dense-matrix vocabulary budget B (top df-ranked
    terms). ``topk_device``: K' candidates fetched per query.
    ``query_chunk``: queries a device step. ``score_chunk_cols``: documents
    a scoring step (default ``_SCORE_CHUNK``; tests shrink it).
    ``residual``, ``weights`` and ``cache_dir``: see the module docstring.
    """

    _CACHE_META = "device_bm25.meta.json"
    _CACHE_CC = "device_bm25.cc.int8"
    _CACHE_AUX = "device_bm25.aux.npz"

    def __init__(
        self,
        bm25: BM25Okapi,
        n_dense_terms: int = 4096,
        topk_device: int = 256,
        query_chunk: int = 1024,
        mesh=None,
        residual: bool = True,
        score_chunk_cols: int | None = None,
        weights: str = "bf16",
        cache_dir: str | None = None,
        device="cuda",
    ) -> None:
        if weights not in ("bf16", "int8"):
            raise ValueError(f"weights must be bf16|int8, got {weights!r}")
        if weights == "int8" and not residual:
            # non-residual error is dominated by C's int8 rounding: an int8
            # weight split buys nothing there
            raise ValueError(
                "weights='int8' requires residual=True (the int8 split "
                "replaces the residual mode's three bf16 passes; "
                "non-residual scoring is a single bf16 pass already)")
        self.mesh = mesh
        n_shards = n_row_shards(mesh) if mesh is not None else 1
        self._n_shards = n_shards
        if n_shards > 1:
            self._shards = local_rows(mesh)
            self._shard_devices = local_row_devices(mesh)
            device = self._shard_devices[0]
        else:
            self._shards = [0]
            self._shard_devices = [torch.device(device)]
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run on the CPU")
        self.bm = bm25
        self.weights = weights
        self.score_chunk_cols = int(score_chunk_cols or _SCORE_CHUNK)
        self.topk_device = max(1, min(int(topk_device), bm25.n_docs))
        if n_shards > 1:
            # per-shard K' cannot exceed the shard's column count
            self.topk_device = min(self.topk_device,
                                   -(-bm25.n_docs // n_shards))
        self.query_chunk = int(query_chunk)
        bm25._ensure_inverted()
        n_vocab = len(bm25.vocab)
        self.n_docs = bm25.n_docs
        df = np.diff(bm25._inv_indptr)
        B = max(1, min(int(n_dense_terms), n_vocab))
        # top-B terms by df (ties: lower term id): the long postings
        order = np.lexsort((np.arange(n_vocab), -df))
        self.dense_terms = np.sort(order[:B]).astype(np.int64)
        self.B = B
        # term id -> dense row (-1 = rare, postings stay on the host)
        self.term_row = np.full(n_vocab, -1, np.int64)
        self.term_row[self.dense_terms] = np.arange(B)

        self.residual = bool(residual)
        contrib_base = (bm25.idf * (bm25.k1 + 1.0)).astype(np.float32)
        self.scale = np.zeros(B, np.float32)
        self.scale_lo = np.zeros(B, np.float32)
        # built straight into the cache's layout, [C; C_lo] rows with the
        # columns padded to the selection block times the shard count; a
        # cache_dir build streams into a disk-backed memmap, one term row at
        # a time
        d_pad = _round_up(max(self.n_docs, 1), SEL_BLOCK * n_shards)
        cc_shape = (2 * B if self.residual else B, d_pad)

        CC = self._load_cache(cache_dir, cc_shape) if cache_dir else None
        if CC is None:
            cc_tmp = None
            if cache_dir:
                # pid-unique tmp: two processes building at once must not
                # truncate each other's live mapping
                cc_tmp = (os.path.join(cache_dir, self._CACHE_CC)
                          + f".{os.getpid()}.tmp")
                try:
                    os.makedirs(cache_dir, exist_ok=True)
                    n_bytes = int(cc_shape[0]) * int(cc_shape[1])
                    fd = os.open(cc_tmp,
                                 os.O_CREAT | os.O_RDWR | os.O_TRUNC, 0o644)
                    try:
                        # a real allocation: ENOSPC surfaces here, not as a
                        # SIGBUS at writeback
                        if hasattr(os, "posix_fallocate"):
                            os.posix_fallocate(fd, 0, n_bytes)
                        else:  # pragma: no cover (non-POSIX)
                            os.ftruncate(fd, n_bytes)
                    finally:
                        os.close(fd)
                    CC = np.memmap(cc_tmp, dtype=np.int8, mode="r+",
                                   shape=cc_shape)
                except OSError as exc:  # cache unusable -> in-RAM build
                    logger.warning("device-BM25 cache dir unusable (%s); "
                                   "building in RAM", exc)
                    try:
                        os.unlink(cc_tmp)
                    except OSError:
                        pass
                    cache_dir = None
                    CC = np.zeros(cc_shape, np.int8)
            else:
                CC = np.zeros(cc_shape, np.int8)
            C = CC[:B]
            C_lo = CC[B:] if self.residual else None
            for row, t in enumerate(self.dense_terms):
                s, e = bm25._inv_indptr[t], bm25._inv_indptr[t + 1]
                contrib = contrib_base[t] * bm25._inv_quot[s:e]
                amax = float(np.max(np.abs(contrib))) if e > s else 0.0
                if amax == 0.0:
                    continue
                sc = amax / 127.0
                self.scale[row] = sc
                q8 = np.clip(np.rint(contrib / sc), -127, 127)
                docs = bm25._inv_docs[s:e]
                C[row, docs] = q8.astype(np.int8)
                if self.residual:
                    # the int8 rounding's residual, quantized again:
                    # |contrib - q8*sc - q8_lo*sc_lo| <= 0.5*sc_lo
                    resid = contrib.astype(np.float64) - q8 * float(sc)
                    rmax = float(np.max(np.abs(resid)))
                    if rmax > 0.0:
                        sc_lo = rmax / 127.0
                        self.scale_lo[row] = np.float32(sc_lo)
                        C_lo[row, docs] = np.clip(
                            np.rint(resid / sc_lo), -127, 127
                        ).astype(np.int8)
            if cache_dir:
                CC = self._commit_cache(cache_dir, CC, cc_tmp, cc_shape)
        self._upload(CC)
        self.stats: Dict[str, float] = {
            "queries": 0, "fallbacks": 0,
            "t_split_s": 0.0, "t_dispatch_s": 0.0, "t_rare_s": 0.0,
            "t_device_s": 0.0, "t_post_s": 0.0, "t_fallback_s": 0.0,
        }

    # ---------------------------------------------------------------- cache
    # Three files: the matrix as raw int8 (memmap-loadable), the scales as
    # npz, and a fingerprint json written last (tmp + os.replace), so a
    # crash mid-save never leaves a cache that validates. The JAX package
    # writes the same files.

    def _fingerprint(self, cc_shape) -> Dict:
        bm = self.bm
        return {
            "version": 1,
            "n_docs": int(bm.n_docs),
            "n_vocab": len(bm.vocab),
            "n_postings": int(bm._inv_indptr[-1]),
            "k1": float(bm.k1),
            "b": float(bm.b),
            "B": int(self.B),
            "residual": bool(self.residual),
            "cc_shape": [int(s) for s in cc_shape],
            # content checksums over the stats the matrix is built from
            "idf_sum": float(np.sum(bm.idf, dtype=np.float64)),
            "quot_sum": float(np.sum(bm._inv_quot, dtype=np.float64)),
        }

    def _sweep_dead_tmps(self, cache_dir: str) -> None:
        """Remove build tmps left by crashed builders (their pid is in the
        name); a live sibling's tmp stays."""
        if not os.path.isdir("/proc"):  # pragma: no cover (non-Linux)
            return
        prefix = self._CACHE_CC + "."
        try:
            names = os.listdir(cache_dir)
        except OSError:
            return
        for n in names:
            if not (n.startswith(prefix) and n.endswith(".tmp")):
                continue
            pid = n[len(prefix):-4]
            if pid.isdigit() and not os.path.exists(f"/proc/{pid}"):
                try:
                    os.unlink(os.path.join(cache_dir, n))
                    logger.info("removed dead builder tmp %s", n)
                except OSError:
                    pass

    def _load_cache(self, cache_dir: str, cc_shape):
        self._sweep_dead_tmps(cache_dir)
        meta_p = os.path.join(cache_dir, self._CACHE_META)
        try:
            with open(meta_p) as f:
                meta = json.load(f)
        except (OSError, ValueError):
            return None
        if meta != self._fingerprint(cc_shape):
            logger.info("device-BM25 cache stale (fingerprint mismatch), "
                        "rebuilding")
            return None
        try:
            aux = np.load(os.path.join(cache_dir, self._CACHE_AUX))
            if not np.array_equal(aux["dense_terms"], self.dense_terms):
                return None
            cc = np.memmap(os.path.join(cache_dir, self._CACHE_CC),
                           dtype=np.int8, mode="r", shape=tuple(cc_shape))
        except (OSError, ValueError, KeyError):
            return None
        self.scale = aux["scale"].astype(np.float32)
        self.scale_lo = aux["scale_lo"].astype(np.float32)
        logger.info("device-BM25 matrix loaded from cache (%s, %.2f GB "
                    "memmap)", cache_dir, cc.nbytes / 1e9)
        return cc

    def _commit_cache(self, cache_dir: str, CC, cc_tmp: str, cc_shape):
        """Publish the freshly built matrix (a live memmap on its pid-unique
        tmp): flush, rename into place, write aux then meta, and return a
        read-only memmap of the published file. On any failure return the
        build mapping itself: its bytes are right whatever the filesystem
        did, so only the cache is lost."""
        cc_p = os.path.join(cache_dir, self._CACHE_CC)
        aux_p = os.path.join(cache_dir, self._CACHE_AUX)
        meta_p = os.path.join(cache_dir, self._CACHE_META)
        try:
            CC.flush()
            os.replace(cc_tmp, cc_p)
            with open(aux_p + ".tmp", "wb") as f:
                np.savez(f, scale=self.scale, scale_lo=self.scale_lo,
                         dense_terms=self.dense_terms)
            os.replace(aux_p + ".tmp", aux_p)
            with open(meta_p + ".tmp", "w") as f:
                json.dump(self._fingerprint(cc_shape), f)
            os.replace(meta_p + ".tmp", meta_p)
            logger.info("device-BM25 matrix cached to %s (%.2f GB)",
                        cache_dir, cc_shape[0] * cc_shape[1] / 1e9)
            return np.memmap(cc_p, dtype=np.int8, mode="r",
                             shape=tuple(cc_shape))
        except OSError as exc:
            # never serve a previously published file here: it may hold
            # another corpus than self.scale describes
            logger.warning("device-BM25 cache commit failed: %s; serving "
                           "from the in-process build mapping", exc)
            try:
                os.unlink(cc_tmp)
            except OSError:
                pass
            return CC

    # --------------------------------------------------------------- device
    def _upload(self, CC: np.ndarray) -> None:
        """The matrix on the card, one row per document: each shard's
        ``self._CTs`` entry is (shard columns, n_mats * Bp) int8 with C in
        columns [0, B) and C_lo in [Bp, Bp + B), Bp = B rounded up to 8
        (``_int_mm`` takes inner widths in multiples of 8; the pad columns
        are zero); ``self._CT`` is the one matrix when unsharded. Uploaded
        and transposed ``_UPLOAD_COLS`` documents at a time, so the host
        never holds a second copy."""
        B = self.B
        self._Bp = Bp = _round_up(B, 8)
        n_mats = 2 if self.residual else 1
        cols = CC.shape[1] // self._n_shards
        self._CTs = []
        for shard, dev in zip(self._shards, self._shard_devices):
            base = shard * cols
            CT = torch.zeros((cols, n_mats * Bp), dtype=torch.int8,
                             device=dev)
            for c0 in range(0, cols, _UPLOAD_COLS):
                c1 = min(c0 + _UPLOAD_COLS, cols)
                blk = torch.from_numpy(np.array(
                    CC[:, base + c0: base + c1])).to(dev)
                CT[c0:c1, :B] = blk[:B].t()
                if self.residual:
                    CT[c0:c1, Bp: Bp + B] = blk[B:].t()
            self._CTs.append(CT)
        self._CT = self._CTs[0] if self._n_shards == 1 else None
        # query rows a device step: _int_mm takes more than 16
        self._rows = _round_up(max(self.query_chunk, 17), 8)

    def _densify(self, wq: torch.Tensor):
        """The query weights, dense on the card, from the packed COO ``wq``
        (3, P) f32: [query row; column; value], columns [0, B) against C,
        [B, 2B) the second part against C, [2B, 3B) against C_lo. int8
        mode: (W (3, rows, Bp) int8, scales (3, rows) f32, from the
        trailing ``rows`` columns); bf16 mode: the bf16 weights against C
        and, with the residual, against [C | C_lo]."""
        rows, B, Bp = self._rows, self.B, self._Bp
        dev = wq.device
        if self.weights == "int8":
            n_coo = wq.shape[1] - rows
            qi = wq[0, :n_coo].long()
            col = wq[1, :n_coo].long()
            W = torch.zeros((3, rows, Bp), dtype=torch.int8, device=dev)
            W[col // B, qi, col % B] = wq[2, :n_coo].to(torch.int8)
            return W, wq[:, n_coo:]
        qi = wq[0].long()
        col = wq[1].long()
        val = wq[2].to(torch.bfloat16)  # exact: bf16-rounded on the host
        if not self.residual:
            W = torch.zeros((rows, Bp), dtype=torch.bfloat16, device=dev)
            W[qi, col] = val
            return (W,)
        head = col < B
        W_a = torch.zeros((rows, Bp), dtype=torch.bfloat16, device=dev)
        W_a[qi[head], col[head]] = val[head]
        # the tail against C at [0, B), the residual weights at [Bp, Bp+B)
        tail = col - B
        tail = torch.where(tail >= B, tail - B + Bp, tail)
        W_b = torch.zeros((rows, 2 * Bp), dtype=torch.bfloat16, device=dev)
        W_b[qi[~head], tail[~head]] = val[~head]
        return W_a, W_b

    def _score_cols(self, W, Cc: torch.Tensor) -> torch.Tensor:
        """(rows, cols) f32 approximate frequent-term scores of one column
        chunk ``Cc`` (cols, n_mats * Bp) of the transposed matrix."""
        Bp = self._Bp
        if self.weights == "int8":
            W8, scales = W
            C_hi, C_lo = Cc[:, :Bp].t(), Cc[:, Bp:].t()  # column-major
            # three exact int8 x int8 -> int32 products, combined in f32
            # as (s0*hi + s1*mid) + s2*lo, the JAX package's order
            S = torch._int_mm(W8[0], C_hi).float().mul_(scales[0][:, None])
            S.add_(torch._int_mm(W8[1], C_hi).float()
                   .mul_(scales[1][:, None]))
            S.add_(torch._int_mm(W8[2], C_lo).float()
                   .mul_(scales[2][:, None]))
            return S
        if Cc.device.type == "cuda":
            Cb = Cc.to(torch.bfloat16)

            def mm(a, b):  # bf16 x bf16, f32 accumulation and result
                return torch.mm(a, b, out_dtype=torch.float32)
        else:
            Cb = Cc.float()

            def mm(a, b):  # the exactly widened operands, an f32 GEMM
                return a.float() @ b
        if not self.residual:
            return mm(W[0], Cb.t())
        W_a, W_b = W
        return mm(W_a, Cb[:, :Bp].t()) + mm(W_b, Cb.t())

    def _select(self, wq: torch.Tensor, kp: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(rows, kp) best approximate scores and their columns over the
        whole corpus, pad columns included (they score exactly 0 and are
        masked after the selection, as in the JAX package): each column
        chunk's tile is selected at once and merged into the running set in
        ascending column order, and a stable merge keeps the earlier
        (lower) column among equal values. Sharded, each shard's pad
        columns are masked before the shards' lists merge."""
        if self._n_shards == 1:
            vals, idx = self._select_shard(wq, self._CT, kp)
            return torch.where(idx < self.n_docs, vals,
                               torch.full_like(vals, -float("inf"))), idx
        from ..parallel.sharding import merge_candidates

        parts_v, parts_i = [], []
        for shard, CT in zip(self._shards, self._CTs):
            v, i = self._select_shard(wq.to(CT.device, non_blocking=True),
                                      CT, kp)
            gi = i + shard * CT.shape[0]
            v = torch.where(gi < self.n_docs, v,
                            torch.full_like(v, -float("inf")))
            parts_v.append(v.to(self.device, non_blocking=True))
            parts_i.append(gi.to(self.device, non_blocking=True))
        return merge_candidates(self.mesh, torch.stack(parts_v),
                                torch.stack(parts_i), kp)

    def _select_shard(self, wq: torch.Tensor, CT: torch.Tensor, kp: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One matrix's (rows, kp) best approximate scores and their local
        columns, pad columns unmasked."""
        W = self._densify(wq)
        lc = CT.shape[0]
        chunk = max(SEL_BLOCK, self.score_chunk_cols
                    - self.score_chunk_cols % SEL_BLOCK)
        vals = idx = None
        for c0 in range(0, lc, chunk):
            Cc = CT[c0: c0 + chunk]
            v, i = block_topk(self._score_cols(W, Cc),
                              min(kp, Cc.shape[0]))
            i = i + c0
            if vals is None:
                vals, idx = v, i
            else:
                vals, sel = _top_sorted(torch.cat([vals, v], dim=1), kp)
                idx = torch.gather(torch.cat([idx, i], dim=1), 1, sel)
        if vals.shape[1] < kp:  # fewer columns than kp: out-of-corpus pads
            pad = kp - vals.shape[1]
            vals = torch.cat([vals, vals.new_full((vals.shape[0], pad),
                                                  -float("inf"))], dim=1)
            idx = torch.cat([idx, idx.new_full((idx.shape[0], pad), lc)],
                            dim=1)
        return vals, idx

    # --------------------------------------------------------------- helpers
    def _rare_touched(self, rare_t, rare_w):
        """Exact rare-part scores: (docs asc, scores) touched by rare terms
        (the plain version of ``bm25_rare_touch`` for one query)."""
        bm = self.bm
        if not len(rare_t):
            return (np.zeros(0, np.int32), np.zeros(0, np.float32))
        docs_parts, contrib_parts = [], []
        for t, w in zip(rare_t, rare_w):
            s, e = bm._inv_indptr[t], bm._inv_indptr[t + 1]
            docs_parts.append(bm._inv_docs[s:e])
            contrib_parts.append(
                ((np.float32(w) * bm.idf[t]) * np.float32(bm.k1 + 1.0))
                * bm._inv_quot[s:e]
            )
        docs = np.concatenate(docs_parts)
        contrib = np.concatenate(contrib_parts)
        udocs, inv = np.unique(docs, return_inverse=True)
        acc = np.zeros(udocs.size, np.float32)
        np.add.at(acc, inv, contrib)
        return udocs.astype(np.int32), acc

    def rare_touch_plain(self, r_indptr, r_tids, r_w):
        """``bm25_rare_touch``'s plain version: (indptr, docs, scores)."""
        ti = [0]
        td_parts, ts_parts = [], []
        for qi in range(len(r_indptr) - 1):
            rs, re = int(r_indptr[qi]), int(r_indptr[qi + 1])
            d, s = self._rare_touched(r_tids[rs:re], r_w[rs:re])
            td_parts.append(d)
            ts_parts.append(s)
            ti.append(ti[-1] + d.size)
        return (np.asarray(ti, np.int64),
                np.concatenate(td_parts) if td_parts
                else np.zeros(0, np.int32),
                np.concatenate(ts_parts) if ts_parts
                else np.zeros(0, np.float32))

    def _exact_scores(self, q_tids: np.ndarray, q_w: np.ndarray,
                      docs: np.ndarray) -> np.ndarray:
        """Exact BM25 of one query against chosen docs, accumulated in
        ascending-term order with ``BM25Okapi.get_topk``'s f32 ops."""
        bm = self.bm
        out = np.zeros(docs.size, np.float32)
        k1p1 = np.float32(bm.k1 + 1.0)
        for j in np.argsort(q_tids):
            t = int(q_tids[j])
            s, e = int(bm._inv_indptr[t]), int(bm._inv_indptr[t + 1])
            if s == e:
                continue
            seg = bm._inv_docs[s:e]  # ascending doc ids within a term
            pos = np.searchsorted(seg, docs)
            pos_c = np.minimum(pos, seg.size - 1)
            hit = (seg[pos_c] == docs) & (pos < seg.size)
            if hit.any():
                out[hit] += ((q_w[j] * bm.idf[t]) * k1p1) \
                    * bm._inv_quot[s:e][pos_c[hit]]
        return out

    def device_post_plain(self, vals, idx, touch, q_indptr_a, q_tids_a,
                          q_w_a, err_ubs, k: int):
        """``bm25_device_post``'s plain version: exact-scores every
        candidate; (idx (Q, k), scores (Q, k), fallback flags (Q,))."""
        touch_indptr, touch_docs, _ = touch
        Q = len(q_indptr_a) - 1
        idx_out = np.zeros((Q, k), np.int64)
        sc_out = np.zeros((Q, k), np.float32)
        flags = np.zeros(Q, np.uint8)
        for qi in range(Q):
            ts_, te_ = int(touch_indptr[qi]), int(touch_indptr[qi + 1])
            cand = np.unique(np.concatenate([idx[qi], touch_docs[ts_:te_]]))
            # pad columns (>= n_docs) enter the device top-K' when fewer
            # than K' docs score above 0: drop them, and bound every
            # non-candidate by 0 (all docs with approx > 0 are candidates)
            pads = bool(cand[-1] >= self.n_docs) if cand.size else False
            if pads:
                cand = cand[cand < self.n_docs]
            qs_, qe_ = int(q_indptr_a[qi]), int(q_indptr_a[qi + 1])
            exact = self._exact_scores(q_tids_a[qs_:qe_], q_w_a[qs_:qe_],
                                       cand)
            t_order = np.lexsort((cand, -exact))
            kth = float(exact[t_order[k - 1]]) if exact.size >= k else -np.inf
            v_last = 0.0 if pads else float(vals[qi, -1])
            v_out = (v_last + float(err_ubs[qi])) \
                if cand.size < self.n_docs else -np.inf
            kth_val = kth if exact.size >= k else 0.0
            if v_out >= kth or exact.size < k or kth_val <= 0.0:
                flags[qi] = 1
                continue
            top = t_order[:k]
            idx_out[qi] = cand[top]
            sc_out[qi] = exact[top]
        return idx_out, sc_out, flags

    # ----------------------------------------------------------------- main
    def get_topk_batch(
        self, queries_tokens: Sequence[Sequence[str]], k: int
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Exact batched top-k: (idx (Q,k) i64, scores (Q,k) f32), equal to
        ``BM25Okapi.get_topk`` (ties to the lower doc id; lowest-id
        zero-score fill when fewer than k docs match, by host fallback)."""
        return self.finish_topk_batch(
            self.start_topk_batch(queries_tokens, k))

    def start_topk_batch(self, queries_tokens: Sequence[Sequence[str]],
                         k: int):
        """Launch the device phase of a batched top-k and return a handle:
        splits the queries, uploads the sparse weights, launches the
        scoring and selection (asynchronous) and the copy of their result
        into pinned host memory, then runs the rare-term traversal on the
        host while the card computes. ``get_topk_batch`` = start + finish."""
        k_eff = min(k, self.n_docs)
        nq = len(queries_tokens)
        states = []
        if nq and k_eff:
            for start in range(0, nq, self.query_chunk):
                qs = queries_tokens[start: start + self.query_chunk]
                states.append((start, qs, self._dispatch_chunk(qs, k_eff)))
        return (nq, k_eff, states)

    def finish_topk_batch(self, handle) -> Tuple[np.ndarray, np.ndarray]:
        """Wait for a :meth:`start_topk_batch` handle's device result, then
        rescore exactly and certify."""
        nq, k_eff, states = handle
        idx_out = np.zeros((nq, k_eff), np.int64)
        sc_out = np.zeros((nq, k_eff), np.float32)
        for start, qs, st in states:
            self._finish_chunk(qs, st, k_eff, idx_out[start:], sc_out[start:])
        return idx_out, sc_out

    def _split(self, qs):
        """Host query split (batched numpy over every (query, term) pair):
        the packed weight COO, each query's error budget, its rare terms
        (a CSR) and its full term list (a CSR, ascending term ids)."""
        bm = self.bm
        Q = len(qs)
        n_b = self.B
        vocab = bm.vocab
        q_of_l: List[int] = []
        tid_l: List[int] = []
        cnt_l: List[float] = []
        for qi, toks in enumerate(qs):
            cnt = Counter(t for t in toks if t in vocab)
            for tok, c in cnt.items():
                q_of_l.append(qi)
                tid_l.append(vocab[tok])
                cnt_l.append(float(c))
        q_of = np.asarray(q_of_l, np.int64)
        tids = np.asarray(tid_l, np.int64)
        cnts = np.asarray(cnt_l, np.float64)
        rows_all = (self.term_row[tids] if tids.size
                    else np.zeros(0, np.int64))
        dm = rows_all >= 0
        dq = q_of[dm]
        drow = rows_all[dm]
        w64 = cnts[dm]
        # rare entries stay query-grouped (q_of is emitted query-major)
        rq = q_of[~dm]
        r_tids_a = tids[~dm]
        r_w_a = cnts[~dm].astype(np.float32)
        r_indptr_a = np.zeros(Q + 1, np.int64)
        np.add.at(r_indptr_a, rq + 1, 1)
        np.cumsum(r_indptr_a, out=r_indptr_a)
        n_dense = np.bincount(dq, minlength=Q).astype(np.float64)

        # the int8 scale folds into the weight: S is directly the
        # approximate frequent-part score; every rounding leftover is
        # computed exactly in f64 for the error budget
        t64 = w64 * self.scale[drow]
        err_acc = np.zeros(Q, np.float64)
        scales_blk = None
        if self.weights == "int8":
            # per-query int8 weight split: w ~= a*hi8 + (a/254)*mid8, the
            # residual weights one int8 at c; scales rounded to f32 first
            l64 = w64 * self.scale_lo[drow]
            amax = np.zeros(Q, np.float64)
            cmax = np.zeros(Q, np.float64)
            if dq.size:
                np.maximum.at(amax, dq, np.abs(t64))
                np.maximum.at(cmax, dq, np.abs(l64))
            a = np.where(amax > 0, amax / 127.0, 1.0)
            a = a.astype(np.float32).astype(np.float64)
            b = (a / 254.0).astype(np.float32).astype(np.float64)
            c = np.where(cmax > 0, cmax / 127.0, 1.0)
            c = c.astype(np.float32).astype(np.float64)
            ad, bd, cd = a[dq], b[dq], c[dq]
            w_hi8 = np.clip(np.rint(t64 / ad), -127, 127)
            w_mid8 = np.clip(np.rint((t64 - w_hi8 * ad) / bd), -127, 127)
            left = np.abs(t64 - w_hi8 * ad - w_mid8 * bd)
            w_lo8 = np.clip(np.rint(l64 / cd), -127, 127)
            left_lo = np.abs(l64 - w_lo8 * cd)
            np.add.at(err_acc, dq,
                      0.5 * w64 * self.scale_lo[drow]
                      + (left + left_lo) * 127.0)
            smax_acc = np.zeros(Q, np.float64)
            np.add.at(smax_acc, dq,
                      (np.abs(w_hi8) * ad + np.abs(w_mid8) * bd
                       + np.abs(w_lo8) * cd) * 127.0)
            # int32 accumulation is exact: the JAX package's budget
            err_ubs = (err_acc * (1.0 + 1e-5) + smax_acc * 1e-6
                       + 1e-6).astype(np.float32)
            wq_qi = np.concatenate([dq, dq, dq])
            wq_col = np.concatenate([drow, drow + n_b, drow + 2 * n_b])
            wq_val = np.concatenate([w_hi8, w_mid8, w_lo8]).astype(
                np.float32)
            scales_blk = np.zeros((3, self._rows), np.float32)
            scales_blk[0, :Q] = a
            scales_blk[1, :Q] = b
            scales_blk[2, :Q] = c
        elif not self.residual:
            ws_hi = _bf16(t64.astype(np.float32))
            # int8 rounding (<= 0.5 * s_t a matched term) plus the exact
            # bf16 weight rounding times |C8| <= 127, plus the f32
            # accumulation slack of the module docstring
            np.add.at(err_acc, dq, 0.5 * t64 + np.abs(t64 - ws_hi) * 127.0)
            smax_acc = np.zeros(Q, np.float64)
            np.add.at(smax_acc, dq, np.abs(ws_hi) * 127.0)
            err_ubs = (err_acc * (1.0 + 1e-5)
                       + smax_acc * (1e-6 + (n_dense + 1) * 2.0 ** -22)
                       + 1e-6).astype(np.float32)
            wq_qi, wq_col, wq_val = dq, drow, ws_hi
        else:
            # f32 weight split into bf16 head and tail against C, plus the
            # residual-matrix pass
            ws_hi = _bf16(t64.astype(np.float32))
            ws_mid = _bf16((t64 - ws_hi).astype(np.float32))
            left = np.abs(t64 - ws_hi - ws_mid)
            l64 = w64 * self.scale_lo[drow]
            ws_lo = _bf16(l64.astype(np.float32))
            left_lo = np.abs(l64 - ws_lo)
            np.add.at(err_acc, dq,
                      0.5 * w64 * self.scale_lo[drow]
                      + (left + left_lo) * 127.0)
            smax_acc = np.zeros(Q, np.float64)
            np.add.at(smax_acc, dq,
                      (np.abs(ws_hi) + np.abs(ws_mid) + np.abs(ws_lo))
                      * 127.0)
            err_ubs = (err_acc * (1.0 + 1e-5)
                       + smax_acc * (1e-6 + (3 * n_dense + 1) * 2.0 ** -22)
                       + 1e-6).astype(np.float32)
            wq_qi = np.concatenate([dq, dq, dq])
            wq_col = np.concatenate([drow, drow + n_b, drow + 2 * n_b])
            wq_val = np.concatenate([ws_hi, ws_mid, ws_lo])
        n_w = wq_qi.size
        # one packed (3, n_w [+ rows]) f32 upload: f32 carries the row and
        # column ids (< 2^24) and the bf16/int8 values exactly
        wq = np.zeros((3, n_w + (self._rows if scales_blk is not None
                                 else 0)), np.float32)
        wq[0, :n_w] = wq_qi
        wq[1, :n_w] = wq_col
        wq[2, :n_w] = wq_val
        if scales_blk is not None:
            wq[:, n_w:] = scales_blk

        # full per-query term lists (ascending tid) for the exact rescoring
        fq = np.concatenate([dq, rq])
        ft = np.concatenate([self.dense_terms[drow], r_tids_a])
        fw = np.concatenate([w64, r_w_a.astype(np.float64)])
        order = np.lexsort((ft, fq))
        q_tids_a = ft[order]
        q_w_a = fw[order].astype(np.float32)
        q_indptr_a = np.zeros(Q + 1, np.int64)
        np.add.at(q_indptr_a, fq + 1, 1)
        np.cumsum(q_indptr_a, out=q_indptr_a)
        return (wq, err_ubs, (r_indptr_a, r_tids_a, r_w_a),
                (q_indptr_a, q_tids_a, q_w_a))

    def _dispatch_chunk(self, qs, k):
        """Host split, weight upload, asynchronous device scoring and
        selection with the copy of its result to pinned host memory, then
        the rare-posting traversal while the card works."""
        from ..native import bm25_rare_touch

        t0 = time.perf_counter()
        bm = self.bm
        wq, err_ubs, rare, full = self._split(qs)
        self.stats["t_split_s"] += time.perf_counter() - t0
        t0 = time.perf_counter()
        host = torch.from_numpy(wq)
        on_card = self.device.type == "cuda"
        if on_card:
            host = host.pin_memory()
        vals, idx = self._select(host.to(self.device, non_blocking=True),
                                 self.topk_device)
        # one (rows, 2K') int32 result, scores bit-cast, fetched in one copy
        packed = torch.cat([vals.contiguous().view(torch.int32),
                            idx.to(torch.int32)], dim=1)
        if on_card:
            out = torch.empty(packed.shape, dtype=torch.int32,
                              pin_memory=True)
            out.copy_(packed, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record()
        else:
            out, ready = packed, None
        self.stats["t_dispatch_s"] += time.perf_counter() - t0
        t0 = time.perf_counter()
        r_indptr_a, r_tids_a, r_w_a = rare
        cap = int(np.sum(bm._inv_indptr[r_tids_a + 1]
                         - bm._inv_indptr[r_tids_a]))
        touch = bm25_rare_touch(bm._inv_indptr, bm._inv_docs, bm._inv_quot,
                                bm.idf, bm.k1, r_indptr_a, r_tids_a, r_w_a,
                                cap)
        self.stats["t_rare_s"] += time.perf_counter() - t0
        return full, err_ubs, touch, (out, ready)

    def _fetch(self, result, Q: int):
        """(vals (Q, K') f32, idx (Q, K') i64) of a dispatched chunk."""
        out, ready = result
        if ready is not None:
            ready.synchronize()
        packed = out[:Q].numpy()
        kp = self.topk_device
        vals = np.ascontiguousarray(packed[:, :kp]).view(np.float32)
        return vals, packed[:, kp:].astype(np.int64)

    def _finish_chunk(self, qs, state, k, idx_out, sc_out) -> None:
        """Wait for the device candidates, rescore exactly and certify
        (``bm25_device_post``), and resolve uncertified queries with one
        batched host top-k."""
        from ..native import bm25_device_post

        (q_indptr_a, q_tids_a, q_w_a), err_ubs, touch, result = state
        bm = self.bm
        Q = len(qs)
        t0 = time.perf_counter()
        vals, idx = self._fetch(result, Q)
        self.stats["queries"] += Q
        self.stats["t_device_s"] += time.perf_counter() - t0
        t0 = time.perf_counter()
        touch_indptr, touch_docs, _ = touch
        n_pairs = int(touch_indptr[Q])
        n_idx, n_sc, flags = bm25_device_post(
            bm._inv_indptr, bm._inv_docs, bm._inv_quot, bm.idf, bm.k1,
            vals, idx, self.topk_device,
            touch_indptr[: Q + 1].copy(), touch_docs[:n_pairs].copy(),
            q_indptr_a, q_tids_a, q_w_a, err_ubs, self.n_docs, k)
        idx_out[:Q] = n_idx
        sc_out[:Q] = n_sc
        self.stats["t_post_s"] += time.perf_counter() - t0
        t0 = time.perf_counter()
        flagged = np.nonzero(flags)[0]
        if flagged.size:
            self.stats["fallbacks"] += int(flagged.size)
            fi, fs = bm.get_topk_batch([qs[qi] for qi in flagged], k)
            idx_out[flagged] = fi
            sc_out[flagged] = fs
        self.stats["t_fallback_s"] += time.perf_counter() - t0
