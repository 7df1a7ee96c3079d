"""ctypes loader and wrappers of the native host kernels
(``native/semsearch_native.cpp``).

The library compiles on first use,

    g++ -O3 -march=native -ffp-contract=off -fPIC -std=c++17 -shared

(``$CXX`` when set) into ``build/torch_native/`` beside the package (listed
in ``.gitignore``), named by a hash of the source, the compiler, the flags
and the host CPU: ``-march=native`` changes the code but never a result bit
(no ``-ffast-math``), and a library built for one CPU must not load on
another. Concurrent first uses (test workers, serve processes) build under
a file lock into a temporary name and ``os.replace`` it into place, so a
process never loads a half-written library.

A library that does not build or load raises :class:`NativeError`; no
caller falls back to the numpy code, which stays as the plain version the
tests hold these kernels against. Each wrapper counts its calls in a module
integer (``HASH_TOKENIZE_CALLS``, ...), as the kernel wrappers count their
launches.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parent / "semsearch_native.cpp"
BUILD_DIR = (Path(__file__).resolve().parent.parent.parent / "build"
             / "torch_native")
CXX_FLAGS = ["-O3", "-march=native", "-ffp-contract=off", "-fPIC",
             "-std=c++17", "-shared", "-Wall"]

HASH_TOKENIZE_CALLS = 0
SUBWORD_TOKENIZE_CALLS = 0
BM25_SCORE_CALLS = 0
BM25_TOPK_CALLS = 0
BM25_TOPK_MAXSCORE_CALLS = 0
BM25_RARE_TOUCH_CALLS = 0
BM25_DEVICE_POST_CALLS = 0

_lib: Optional[ctypes.CDLL] = None
_LOCK = threading.Lock()


class NativeError(RuntimeError):
    """The native library could not be built or loaded."""


def reset_counts() -> None:
    """Every wrapper's call count to 0."""
    global HASH_TOKENIZE_CALLS, SUBWORD_TOKENIZE_CALLS, BM25_SCORE_CALLS
    global BM25_TOPK_CALLS, BM25_TOPK_MAXSCORE_CALLS, BM25_RARE_TOUCH_CALLS
    global BM25_DEVICE_POST_CALLS
    HASH_TOKENIZE_CALLS = SUBWORD_TOKENIZE_CALLS = BM25_SCORE_CALLS = 0
    BM25_TOPK_CALLS = BM25_TOPK_MAXSCORE_CALLS = BM25_RARE_TOUCH_CALLS = 0
    BM25_DEVICE_POST_CALLS = 0


def _cxx() -> str:
    return os.environ.get("CXX") or "g++"


def _cpu_id() -> str:
    """What -march=native compiles for: the CPU's model name and flags."""
    keep = []
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key = line.split(":", 1)[0].strip()
                if key in ("model name", "flags", "Features", "CPU part"):
                    keep.append(line.strip())
                elif not line.strip() and keep:
                    break  # the first processor's block is enough
    except OSError:
        pass
    return platform.machine() + "\n" + "\n".join(keep)


def _target() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(("\0" + _cxx() + "\0" + " ".join(CXX_FLAGS) + "\0"
                   + _cpu_id()).encode())
    return BUILD_DIR / f"libsemsearch_native-{digest.hexdigest()[:12]}.so"


def build() -> Path:
    """Compile the library if this source, compiler, flag set and CPU have
    none yet; returns its path. Raises :class:`NativeError` on failure."""
    out = _target()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / (out.name + ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # one builder; the rest wait
        if out.exists():
            return out
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        try:
            proc = subprocess.run([_cxx(), *CXX_FLAGS, "-o", str(tmp),
                                   str(SOURCE)], capture_output=True,
                                  text=True)
        except OSError as exc:
            raise NativeError(f"cannot run {_cxx()}: {exc}") from exc
        if proc.returncode != 0 or not tmp.exists():
            try:
                tmp.unlink()
            except OSError:
                pass
            raise NativeError(f"{_cxx()} failed for {SOURCE.name} (exit "
                              f"{proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, out)
    return out


_I64 = ctypes.POINTER(ctypes.c_int64)
_I32 = ctypes.POINTER(ctypes.c_int32)
_F32 = ctypes.POINTER(ctypes.c_float)
_U8 = ctypes.POINTER(ctypes.c_ubyte)
_ARGTYPES = {
    "hash_tokenize_batch": [_U8, _I64, ctypes.c_int64, ctypes.c_int32,
                            ctypes.c_int32, ctypes.c_int32, _I32, _I32],
    "subword_tokenize_batch": [_U8, _I64, ctypes.c_int64, _U8, _I64, _I32,
                               ctypes.c_int64, ctypes.c_int32,
                               ctypes.c_int32, _I32, _I32],
    "bm25_score_batch": [_I64, _I32, _F32, _F32, ctypes.c_int64, _I64, _I64,
                         _F32, ctypes.c_int64, ctypes.c_float, _F32],
    "bm25_topk_batch": [_I64, _I32, _F32, _F32, ctypes.c_int64, _I64, _I64,
                        _F32, ctypes.c_int64, ctypes.c_float, ctypes.c_int32,
                        ctypes.c_int32, _I64, _F32],
    "bm25_topk_maxscore_batch": [_I64, _I32, _F32, _F32, _F32,
                                 ctypes.c_int64, _I64, _I64, _F32,
                                 ctypes.c_int64, ctypes.c_float,
                                 ctypes.c_int32, ctypes.c_int32, _I64, _F32],
    "bm25_rare_touch": [_I64, _I32, _F32, _F32, ctypes.c_float, _I64, _I64,
                        _F32, ctypes.c_int64, _I64, _I32, _F32],
    "bm25_device_post": [_I64, _I32, _F32, _F32, ctypes.c_float, _F32, _I64,
                         ctypes.c_int32, _I64, _I32, _I64, _I64, _F32, _F32,
                         ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
                         _I64, _F32, _U8],
}


def get_lib() -> ctypes.CDLL:
    """The loaded library, built on first use; raises :class:`NativeError`
    when it cannot be built or loaded."""
    global _lib
    with _LOCK:
        if _lib is None:
            path = build()
            try:
                lib = ctypes.CDLL(str(path))
                for name, argtypes in _ARGTYPES.items():
                    getattr(lib, name).argtypes = argtypes
            except (OSError, AttributeError) as exc:
                raise NativeError(f"cannot load {path}: {exc}") from exc
            _lib = lib
        return _lib


def _ptr(a: np.ndarray, dtype, ctype):
    if a.dtype != dtype or not a.flags["C_CONTIGUOUS"]:
        raise TypeError(f"native kernels take C-contiguous {np.dtype(dtype)} "
                        f"arrays, got {a.dtype} (contiguous: "
                        f"{a.flags['C_CONTIGUOUS']})")
    return a.ctypes.data_as(ctype)


def _i64p(a):
    return _ptr(a, np.int64, _I64)


def _i32p(a):
    return _ptr(a, np.int32, _I32)


def _f32p(a):
    return _ptr(a, np.float32, _F32)


def _u8p(a):
    return _ptr(a, np.uint8, _U8)


def _text_blob(texts: Sequence[str]) -> Tuple[np.ndarray, np.ndarray]:
    """UTF-8 bytes of every text, concatenated (NUL-terminated), and the
    (n+1) int64 offsets into them."""
    blobs = [t.encode("utf-8") for t in texts]
    offsets = np.zeros(len(blobs) + 1, np.int64)
    np.cumsum([len(b) for b in blobs], out=offsets[1:])
    return np.frombuffer(b"".join(blobs) + b"\x00", dtype=np.uint8), offsets


def hash_tokenize_batch(texts: Sequence[str], vocab_size: int, max_len: int,
                        add_cls: bool) -> Tuple[np.ndarray, np.ndarray]:
    """FNV-1a hashing tokenizer: (ids, mask), both (len(texts), max_len)
    int32; the contract of ``models/tokenizer.py::HashingTokenizer``."""
    global HASH_TOKENIZE_CALLS
    lib = get_lib()
    buf, offsets = _text_blob(texts)
    ids = np.zeros((len(texts), max_len), np.int32)
    mask = np.zeros((len(texts), max_len), np.int32)
    lib.hash_tokenize_batch(_u8p(buf), _i64p(offsets), len(texts),
                            vocab_size, max_len, int(add_cls), _i32p(ids),
                            _i32p(mask))
    HASH_TOKENIZE_CALLS += 1
    return ids, mask


def subword_tokenize_batch(texts: Sequence[str], piece_tables, max_len: int,
                           add_cls: bool) -> Tuple[np.ndarray, np.ndarray]:
    """WordPiece greedy longest-match over a trained vocabulary: (ids,
    mask), both (len(texts), max_len) int32. ``piece_tables`` is
    ``SubwordTokenizer._native_tables()``: (piece bytes u8, piece offsets
    i64 (n+1), piece ids i32 (n))."""
    global SUBWORD_TOKENIZE_CALLS
    lib = get_lib()
    blob, p_offsets, piece_ids = piece_tables
    buf, offsets = _text_blob(texts)
    ids = np.zeros((len(texts), max_len), np.int32)
    mask = np.zeros((len(texts), max_len), np.int32)
    lib.subword_tokenize_batch(_u8p(buf), _i64p(offsets), len(texts),
                               _u8p(blob), _i64p(p_offsets), _i32p(piece_ids),
                               len(piece_ids), max_len, int(add_cls),
                               _i32p(ids), _i32p(mask))
    SUBWORD_TOKENIZE_CALLS += 1
    return ids, mask


def bm25_score_batch(doc_indptr: np.ndarray, doc_termids: np.ndarray,
                     doc_quot: np.ndarray, idf: np.ndarray,
                     q_indptr: np.ndarray, q_termids: np.ndarray,
                     q_weights: np.ndarray, k1: float) -> np.ndarray:
    """BM25 of every query against every document of a doc-major CSR:
    (n_queries, n_docs) f32. ``doc_termids`` ascending within each
    document, ``q_termids`` within each query (a merge join);
    ``q_weights`` holds each query term's occurrence count."""
    global BM25_SCORE_CALLS
    lib = get_lib()
    n_docs = len(doc_indptr) - 1
    n_queries = len(q_indptr) - 1
    out = np.zeros((n_queries, n_docs), np.float32)
    lib.bm25_score_batch(_i64p(doc_indptr), _i32p(doc_termids),
                         _f32p(doc_quot), _f32p(idf), n_docs,
                         _i64p(q_indptr), _i64p(q_termids),
                         _f32p(q_weights), n_queries, ctypes.c_float(k1),
                         _f32p(out))
    BM25_SCORE_CALLS += 1
    return out


def bm25_topk_batch(inv_indptr: np.ndarray, inv_docs: np.ndarray,
                    inv_quot: np.ndarray, idf: np.ndarray, n_docs: int,
                    q_indptr: np.ndarray, q_termids: np.ndarray,
                    q_weights: np.ndarray, k1: float, k: int,
                    n_threads: int = 1) -> Tuple[np.ndarray, np.ndarray]:
    """Serve-time BM25 top-k over term-major postings, threaded across
    queries with the GIL released: (idx (Q, k) i64, scores (Q, k) f32),
    the sparse-path contract of ``BM25Okapi.get_topk`` (ties to the lower
    doc id, lowest-id zero-score fill). Each thread holds about 5 * n_docs
    bytes of scratch."""
    global BM25_TOPK_CALLS
    lib = get_lib()
    n_queries = len(q_indptr) - 1
    idx = np.zeros((n_queries, k), np.int64)
    scores = np.zeros((n_queries, k), np.float32)
    lib.bm25_topk_batch(_i64p(inv_indptr), _i32p(inv_docs), _f32p(inv_quot),
                        _f32p(idf), n_docs, _i64p(q_indptr),
                        _i64p(q_termids), _f32p(q_weights), n_queries,
                        ctypes.c_float(k1), k, n_threads, _i64p(idx),
                        _f32p(scores))
    BM25_TOPK_CALLS += 1
    return idx, scores


def bm25_topk_maxscore_batch(inv_indptr: np.ndarray, inv_docs: np.ndarray,
                             inv_quot: np.ndarray, idf: np.ndarray,
                             term_ub: np.ndarray, n_docs: int,
                             q_indptr: np.ndarray, q_termids: np.ndarray,
                             q_weights: np.ndarray, k1: float, k: int,
                             n_threads: int = 1
                             ) -> Tuple[np.ndarray, np.ndarray]:
    """MaxScore-pruned top-k (Turtle and Flood): the results of
    :func:`bm25_topk_batch` exactly, skipping documents whose terms' upper
    bounds (``term_ub``, each term's largest contribution) prove they cannot
    enter the top-k."""
    global BM25_TOPK_MAXSCORE_CALLS
    lib = get_lib()
    n_queries = len(q_indptr) - 1
    idx = np.zeros((n_queries, k), np.int64)
    scores = np.zeros((n_queries, k), np.float32)
    lib.bm25_topk_maxscore_batch(
        _i64p(inv_indptr), _i32p(inv_docs), _f32p(inv_quot), _f32p(idf),
        _f32p(term_ub), n_docs, _i64p(q_indptr), _i64p(q_termids),
        _f32p(q_weights), n_queries, ctypes.c_float(k1), k, n_threads,
        _i64p(idx), _f32p(scores))
    BM25_TOPK_MAXSCORE_CALLS += 1
    return idx, scores


def bm25_rare_touch(inv_indptr, inv_docs, inv_quot, idf, k1, r_indptr,
                    r_tids, r_w, capacity: int
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Each query's documents touched by its rare terms, ascending, with
    their exact rare-term scores: (indptr (Q+1), docs, scores), a CSR.
    ``capacity`` bounds the touched entries (the rare terms' summed df)."""
    global BM25_RARE_TOUCH_CALLS
    lib = get_lib()
    n_queries = len(r_indptr) - 1
    out_indptr = np.zeros(n_queries + 1, np.int64)
    out_docs = np.zeros(max(capacity, 1), np.int32)
    out_scores = np.zeros(max(capacity, 1), np.float32)
    lib.bm25_rare_touch(_i64p(inv_indptr), _i32p(inv_docs), _f32p(inv_quot),
                        _f32p(idf), ctypes.c_float(k1), _i64p(r_indptr),
                        _i64p(r_tids), _f32p(r_w), n_queries,
                        _i64p(out_indptr), _i32p(out_docs),
                        _f32p(out_scores))
    BM25_RARE_TOUCH_CALLS += 1
    return out_indptr, out_docs, out_scores


def bm25_device_post(inv_indptr, inv_docs, inv_quot, idf, k1, vals, idx,
                     kp: int, touch_indptr, touch_docs, q_indptr, q_tids,
                     q_w, err_ub, n_docs: int, k: int
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The device BM25 leg's host post: merge each query's device top-K'
    candidates with its rare-touched documents, rescore them exactly in
    ``BM25Okapi.get_topk``'s f32 order and certify the top k against
    ``err_ub``. Returns (idx (Q, k), scores (Q, k), fallback flags (Q,)):
    a flagged query's rows are left for the host top-k."""
    global BM25_DEVICE_POST_CALLS
    lib = get_lib()
    n_queries = len(q_indptr) - 1
    idx_out = np.zeros((n_queries, k), np.int64)
    sc_out = np.zeros((n_queries, k), np.float32)
    flags = np.zeros(n_queries, np.uint8)
    lib.bm25_device_post(
        _i64p(inv_indptr), _i32p(inv_docs), _f32p(inv_quot), _f32p(idf),
        ctypes.c_float(k1), _f32p(vals), _i64p(idx), kp,
        _i64p(touch_indptr), _i32p(touch_docs), _i64p(q_indptr),
        _i64p(q_tids), _f32p(q_w), _f32p(err_ub), n_queries, n_docs, k,
        _i64p(idx_out), _f32p(sc_out), _u8p(flags))
    BM25_DEVICE_POST_CALLS += 1
    return idx_out, sc_out, flags
