"""Non-contiguous semantic grouping: RMT-filtered similarity + clustering.

Counterpart of ``semanticsearch_tpu/chunking/grouping.py``, itself a
behavioral rebuild of ``Method/Semantic_Grouping_Optimized.py``:

1. Similarity matrix on the device (the hand-written Gram-matrix kernel,
   ``ops.similarity.similarity_matrix``), sharpened with a z-score sigmoid
   (tau=0.15, reference ``:100-108``), diagonal cleared, centrality for
   exemplars.
2. RMT filter: eigendecompose (``torch.linalg.eigh`` on the device for large
   matrices — the reference calls LAPACK ``eigh`` on host, ``:133-165``),
   keep the top-k eigenvalues, flatten the rest to their mean (noise floor),
   reconstruct, clamp >= 0.
3. Clustering engines:
   - ``spectral``: symmetric kNN graph, normalized Laplacian, eigengap auto-K,
     k-means on row-normalized eigenvectors (reference ``:270-341``). This is
     the default on-device-friendly engine (the reference treats spectral as
     the equivalent fallback of its modularity path, ``:387-393``).
   - ``modularity``: multiscale Louvain over the RMT-filtered similarity with
     a resolution sweep + co-association consensus + spectral-on-consensus
     (reference ``:168-268``); in-repo dense Louvain, no networkx dependency.
4. Post-processing: split over-cap clusters via 2-way spectral when separable,
   merge undersized clusters on positive semantic gain, refine loose clusters,
   greedy adjacent merge, one-pass boundary reassignment (reference
   ``:403-588``), with the same auto-parameter derivations.
"""
from __future__ import annotations

import json
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..core.config import ChunkingConfig
from ..ops.similarity import similarity_matrix
from .splitter import pad_documents

Chunk = Tuple[str, str, Optional[str]]


# --------------------------------------------------------------------------
# Matrix preparation (device ops)
# --------------------------------------------------------------------------

def sharpen_similarity(S: np.ndarray, tau: float = 0.15) -> np.ndarray:
    """Z-score sigmoid sharpening around the global mean; zero diagonal."""
    S = np.asarray(S, dtype=np.float64)
    mu = float(S.mean())
    sd = float(S.std() + 1e-9)
    out = 1.0 / (1.0 + np.exp(-((S - mu) / sd) / max(tau, 1e-9)))
    np.fill_diagonal(out, 0.0)
    return out


# Below this size a device eigendecomposition is pure launch and copy
# overhead — host LAPACK is faster until the O(n^3) work is real.
_EIGH_DEVICE_MIN_N = 512


def _eigh(S_sym: np.ndarray, device="cuda"):
    """Full symmetric eigendecomposition, ascending: host LAPACK below
    _EIGH_DEVICE_MIN_N, ``torch.linalg.eigh`` in float32 on ``device`` at
    and above it.

    The device route decomposes at the true ``n``: the JAX package pads the
    matrix to a static bucket only to spare its compiler one program per
    matrix size, and its padding leaves eigenvalues and eigenvectors as they
    are, so nothing here depends on it."""
    n = S_sym.shape[0]
    if n < _EIGH_DEVICE_MIN_N:
        return np.linalg.eigh(S_sym)
    m = torch.from_numpy(np.ascontiguousarray(S_sym, dtype=np.float32))
    evals, evecs = torch.linalg.eigh(m.to(device))
    return evals.cpu().numpy(), evecs.cpu().numpy()


def rmt_filter(S: np.ndarray, keep_eigs: int = 3, device="cuda"
               ) -> np.ndarray:
    """Keep top-k eigencomponents, average the rest (noise floor).

    Eigendecomposition runs on ``device`` for large matrices and on host
    LAPACK below _EIGH_DEVICE_MIN_N.
    """
    S_sym = 0.5 * (S + S.T)
    evals, evecs = _eigh(S_sym, device)
    # ascending from eigh -> descending
    evals, evecs = evals[::-1], evecs[:, ::-1]
    k = int(max(1, min(keep_eigs, S.shape[0])))
    if k < evals.size:
        noise = float(evals[k:].mean())
        evals = np.concatenate([evals[:k], np.full(evals.size - k, noise)])
    out = (evecs * evals) @ evecs.T
    out = np.maximum(out, 0.0)
    np.fill_diagonal(out, 0.0)
    return out


# --------------------------------------------------------------------------
# Graph construction + spectral engine
# --------------------------------------------------------------------------

def build_knn_graph(S: np.ndarray, k: int, floor: float) -> np.ndarray:
    """Symmetric weighted kNN graph with an edge floor."""
    n = S.shape[0]
    k_eff = max(1, min(k, n - 1))
    W = np.zeros((n, n))
    # top k_eff per row with self EXCLUDED BEFORE the cut: every caller
    # zeroes the diagonal, so the old "select k+1 and drop self" approach
    # never actually dropped anything — each node got k+1 neighbors, one
    # degree denser than configured
    Sx = S.copy()
    np.fill_diagonal(Sx, -np.inf)
    order = np.argsort(-Sx, axis=1)[:, :k_eff]
    for i in range(n):
        for j in order[i]:
            if Sx[i, j] >= floor:
                W[i, j] = S[i, j]
    return np.maximum(W, W.T)


def normalized_laplacian(W: np.ndarray) -> np.ndarray:
    d = W.sum(axis=1)
    with np.errstate(divide="ignore"):
        dis = np.where(d > 0, 1.0 / np.sqrt(d), 0.0)
    return np.eye(W.shape[0]) - (dis[:, None] * W * dis[None, :])


def kmeans(X: np.ndarray, k: int, n_init: int = 5, max_iter: int = 100,
           seed: int = 0) -> np.ndarray:
    """Plain Lloyd k-means with multi-restart (vectorized numpy)."""
    rng = np.random.RandomState(seed)
    best_labels, best_inertia = None, np.inf
    for _ in range(n_init):
        centers = X[rng.choice(X.shape[0], size=k, replace=False)].copy()
        labels = np.zeros(X.shape[0], dtype=int)
        for _ in range(max_iter):
            d2 = ((X[:, None, :] - centers[None]) ** 2).sum(axis=2)
            labels = d2.argmin(axis=1)
            new_centers = np.stack([
                X[labels == c].mean(axis=0) if np.any(labels == c) else centers[c]
                for c in range(k)
            ])
            if np.linalg.norm(new_centers - centers) < 1e-6:
                centers = new_centers
                break
            centers = new_centers
        inertia = float(((X - centers[labels]) ** 2).sum())
        if inertia < best_inertia:
            best_inertia, best_labels = inertia, labels.copy()
    return best_labels.astype(int)


def spectral_labels_auto_k(W: np.ndarray, kmax: int, seed: int = 0,
                           device="cuda") -> Optional[np.ndarray]:
    """Eigengap-selected K spectral clustering on a weighted graph."""
    n = W.shape[0]
    if n <= 2 or np.allclose(W, 0.0):
        return None
    L = normalized_laplacian(W)
    evals, evecs = _eigh(L, device)
    kmax_eff = max(2, min(kmax, n - 1))
    gaps = np.diff(evals[: kmax_eff + 1])
    k = 2 if gaps.size == 0 else int(np.clip(np.argmax(gaps) + 1, 2, kmax_eff))
    U = evecs[:, :k]
    U = U / (np.linalg.norm(U, axis=1, keepdims=True) + 1e-9)
    return kmeans(U, k=k, n_init=5, max_iter=100, seed=seed)


# --------------------------------------------------------------------------
# Dense Louvain modularity (in-repo; replaces networkx + python-louvain)
# --------------------------------------------------------------------------

def louvain_labels(A: np.ndarray, gamma: float = 1.0, seed: int = 0,
                   max_levels: int = 5, max_sweeps: int = 20
                   ) -> Optional[np.ndarray]:
    """Two-phase Louvain on a dense weighted adjacency with resolution gamma.

    Standard modularity: Q = (1/2m) sum_ij [A_ij - gamma k_i k_j / 2m] d(ci,cj).
    """
    A = np.asarray(A, dtype=np.float64)
    n0 = A.shape[0]
    m2 = A.sum()
    if m2 <= 0 or n0 < 2:
        return None

    node_map = np.arange(n0)  # original node -> current supernode
    cur = A.copy()

    for _level in range(max_levels):
        n = cur.shape[0]
        deg = cur.sum(axis=1)
        comm = np.arange(n)
        sigma_tot = deg.copy()
        rng = np.random.RandomState(seed)
        improved_any = False
        for _sweep in range(max_sweeps):
            moved = 0
            order = rng.permutation(n)
            for i in order:
                ci = comm[i]
                ki = deg[i]
                # weights from i to each community (exclude self-loop weight)
                w_ic = np.bincount(comm, weights=cur[i], minlength=n)
                w_ic[comm[i]] -= cur[i, i]
                sigma_tot[ci] -= ki
                # gain of joining community c:
                #   w_ic[c] - gamma * ki * sigma_tot[c] / m2
                gains = w_ic - gamma * ki * sigma_tot / m2
                cand = np.nonzero(w_ic > 0)[0]
                best_c, best_gain = ci, gains[ci]
                for c in cand:
                    if gains[c] > best_gain + 1e-12:
                        best_gain, best_c = gains[c], c
                sigma_tot[best_c] += ki
                if best_c != ci:
                    comm[i] = best_c
                    moved += 1
            if moved == 0:
                break
            improved_any = True
        if not improved_any:
            break
        # Aggregate communities into supernodes.
        uniq, new_ids = np.unique(comm, return_inverse=True)
        k = uniq.size
        if k == n:
            break
        # agg = M^T cur M with M the community one-hot — two matmuls instead
        # of an O(n^2) Python double loop
        M = np.zeros((n, k))
        M[np.arange(n), new_ids] = 1.0
        agg = M.T @ cur @ M
        node_map = new_ids[node_map]
        cur = agg
        if k <= 1:
            break

    _, labels = np.unique(node_map, return_inverse=True)
    return labels.astype(int)


def modularity_multiscale_labels(
    S_filtered: np.ndarray,
    gamma_start: float = 0.7,
    gamma_end: float = 1.6,
    gamma_step: float = 0.15,
    edge_floor: float = 0.4,
    kmax_cap: int = 16,
    seed: int = 0,
    device="cuda",
) -> Optional[np.ndarray]:
    """Resolution sweep -> co-association consensus -> spectral on consensus
    (reference ``Semantic_Grouping_Optimized.py:168-268``)."""
    n = S_filtered.shape[0]
    if n <= 2:
        return None
    A = np.where(S_filtered >= edge_floor, S_filtered, 0.0)
    np.fill_diagonal(A, 0.0)
    if np.allclose(A, 0.0):
        return None

    label_list = []
    gamma = float(gamma_start)
    step = gamma_step if gamma_step > 0 else 0.2
    while gamma <= gamma_end + 1e-9:
        labels = louvain_labels(A, gamma=gamma, seed=seed)
        if labels is not None:
            k = int(labels.max() + 1)
            if 2 <= k <= max(2, min(kmax_cap, n - 1)):
                label_list.append(labels)
        gamma += step
    if not label_list:
        return None

    # Co-association consensus matrix.
    C = np.zeros((n, n))
    for lab in label_list:
        C += (lab[:, None] == lab[None, :]).astype(float)
    C /= len(label_list)
    np.fill_diagonal(C, 0.0)
    triu = C[np.triu_indices(n, 1)]
    thr = float(np.quantile(triu, 0.5)) if triu.size else 0.0
    Wc = np.where(C >= thr, C, 0.0)
    Wc = np.maximum(Wc, Wc.T)
    if np.allclose(Wc, 0.0):
        return label_list[-1]
    labels = spectral_labels_auto_k(Wc, kmax=kmax_cap, seed=seed,
                                    device=device)
    return labels if labels is not None else label_list[-1]


# --------------------------------------------------------------------------
# Post-processing: split / merge / refine / reassign
# --------------------------------------------------------------------------

class _GroupScorer:
    """Mean within/between similarity over the sharpened matrix."""

    def __init__(self, S: np.ndarray) -> None:
        self.S = S

    def between(self, A: List[int], B: List[int]) -> float:
        if not A or not B:
            return 0.0
        return float(self.S[np.ix_(A, B)].mean())

    def within(self, A: List[int]) -> float:
        if len(A) <= 1:
            return 1.0
        sub = self.S[np.ix_(A, A)]
        iu = np.triu_indices(len(A), 1)
        vals = sub[iu]
        return float(vals.mean()) if vals.size else 1.0


def _spectral_split_k2(members: List[int], W_all: np.ndarray,
                       scorer: _GroupScorer) -> Optional[Tuple[List[int], List[int]]]:
    """2-way spectral split, accepted only when separation is negative
    (between-mean below mean within), reference ``:410-430``."""
    if len(members) < 4:
        return None
    subW = W_all[np.ix_(members, members)]
    L = normalized_laplacian(subW)
    try:
        _, evecs = np.linalg.eigh(L)
    except np.linalg.LinAlgError:
        return None
    U = evecs[:, :2]
    U = U / (np.linalg.norm(U, axis=1, keepdims=True) + 1e-9)
    lab2 = kmeans(U, k=2, n_init=5, max_iter=100, seed=1)
    left = [members[i] for i in range(len(members)) if lab2[i] == 0]
    right = [members[i] for i in range(len(members)) if lab2[i] == 1]
    if not left or not right:
        return None
    sep = scorer.between(left, right) - 0.5 * (
        scorer.within(left) + scorer.within(right)
    )
    if sep < 0.0:
        return sorted(left), sorted(right)
    return None


def group_by_similarity(
    S_sharp: np.ndarray,
    cfg: ChunkingConfig = ChunkingConfig(),
    seed: int = 0,
    device="cuda",
) -> List[List[int]]:
    """Cluster n sentences from their sharpened similarity matrix.

    Returns groups of sentence indices (each sorted ascending), covering all
    sentences. ``device`` is where eigendecompositions of at least
    _EIGH_DEVICE_MIN_N rows run.
    """
    n = S_sharp.shape[0]
    if n <= 1:
        return [list(range(n))] if n else []
    scorer = _GroupScorer(S_sharp)

    # ---- auto parameters (reference :343-359, :405-408, :447-466) ----
    auto = cfg.auto_params
    if auto:
        knn_k = int(max(5, min(32, round(n * 0.06))))
        pos = S_sharp[S_sharp > 0.0]
        edge_floor = float(np.quantile(pos, 0.80)) if pos.size else 0.4
        kmax = int(max(2, min(16, max(2, n // 6))))
    else:
        knn_k = int(cfg.knn_k if cfg.knn_k is not None else max(5, min(20, n - 1)))
        edge_floor = float(cfg.edge_floor)
        kmax = int(cfg.spectral_kmax if cfg.spectral_kmax is not None
                   else max(2, min(10, max(2, n // 5))))

    W_all = build_knn_graph(S_sharp, knn_k, edge_floor)

    # ---- engine selection ----
    labels = None
    if cfg.engine == "modularity":
        S_f = rmt_filter(S_sharp, keep_eigs=max(1, cfg.rmt_keep_eigs),
                         device=device)
        labels = modularity_multiscale_labels(
            S_f, edge_floor=edge_floor, kmax_cap=kmax, seed=seed,
            device=device,
        )
    if labels is None:
        labels = spectral_labels_auto_k(W_all, kmax=kmax, seed=seed,
                                        device=device)
    if labels is None:
        return [list(range(n))]

    groups: List[List[int]] = [[] for _ in range(int(labels.max()) + 1)]
    for i, lab in enumerate(labels):
        groups[int(lab)].append(i)
    groups = [sorted(g) for g in groups if g]

    # ---- split over-cap clusters (:432-442) ----
    cap_soft = cfg.cap_soft
    if auto and cap_soft is None:
        cap_soft = max(20, n // 4)
    elif cap_soft is None:
        cap_soft = max(20, n // 3)
    new_groups: List[List[int]] = []
    for g in groups:
        if len(g) > cap_soft:
            sp = _spectral_split_k2(g, W_all, scorer)
            if sp is not None and all(len(x) >= max(2, cfg.small_group_min) for x in sp):
                new_groups.extend(sp)
                continue
        new_groups.append(g)
    groups = new_groups

    # ---- merge undersized clusters on positive gain (:444-491) ----
    if auto:
        sizes = [len(g) for g in groups]
        min_len = int(max(2, np.percentile(sizes, 10))) if len(sizes) >= 5 else 2
        pos = S_sharp[S_sharp > 0.0]
        tau_merge = float(np.quantile(pos, 0.65)) if pos.size else cfg.tau_merge
    else:
        min_len = max(2, cfg.small_group_min)
        tau_merge = float(cfg.tau_merge)
    merged: List[List[int]] = []
    where: dict = {}  # original group index -> its slot in ``merged``
    consumed = set()
    for i, g in enumerate(groups):
        if i in consumed:
            continue
        if len(g) >= min_len:
            where[i] = len(merged)
            merged.append(g)
            continue
        best_j, best_gain = None, 0.0
        for j, h in enumerate(groups):
            if j == i or j in consumed:
                continue
            if scorer.between(g, h) < tau_merge:
                continue
            gain = scorer.within(sorted(g + h)) - 0.5 * (
                scorer.within(g) + scorer.within(h)
            )
            if gain > best_gain:
                best_gain, best_j = gain, j
        if best_j is not None:
            if best_j in where:
                # the partner was emitted on an earlier iteration: grow
                # THAT cluster in place — appending a fresh copy would
                # duplicate its sentences across two output clusters
                slot = where[best_j]
                merged[slot] = sorted(merged[slot] + g)
            else:
                consumed.add(best_j)
                where[best_j] = len(merged)
                merged.append(sorted(groups[best_j] + g))
        else:
            where[i] = len(merged)
            merged.append(g)

    # ---- refine loose clusters + greedy adjacent merge (:494-553) ----
    internal = [scorer.within(g) for g in merged]
    low_thr = float(np.percentile(internal, 25)) if len(internal) >= 2 else 0.0
    refined: List[List[int]] = []
    for g in merged:
        if len(g) >= 6 and scorer.within(g) < max(0.5, low_thr):
            sp = _spectral_split_k2(g, W_all, scorer)
            if sp is not None:
                left, right = sp
                parent = scorer.within(g)
                if scorer.within(left) > parent and scorer.within(right) > parent:
                    refined.extend([sorted(left), sorted(right)])
                    continue
        refined.append(g)
    pos = S_sharp[S_sharp > 0.0]
    global_merge_thr = float(np.quantile(pos, 0.60)) if pos.size else 0.5
    merged_adj: List[List[int]] = []
    i = 0
    while i < len(refined):
        cur = refined[i]
        j = i + 1
        while j < len(refined):
            inter = scorer.between(cur, refined[j])
            cmp_thr = 0.9 * min(
                max(scorer.within(cur), 1e-6), max(scorer.within(refined[j]), 1e-6)
            )
            if inter >= max(cmp_thr, global_merge_thr):
                cur = sorted(cur + refined[j])
                j += 1
            else:
                break
        merged_adj.append(cur)
        i = j
    merged = merged_adj

    # ---- one-pass boundary reassignment (:555-588) ----
    if len(merged) >= 2:
        if auto:
            delta = float(pos.std()) * 0.1 if pos.size else cfg.reassign_delta
        else:
            delta = float(cfg.reassign_delta)
        member_of = {}
        for cid, g in enumerate(merged):
            for x in g:
                member_of[x] = cid
        for x in range(n):
            cur = member_of.get(x)
            if cur is None:
                continue
            others = [y for y in merged[cur] if y != x]
            cur_mean = float(np.mean(S_sharp[x, others])) if others else 0.0
            best_c, best = cur, cur_mean
            for c2, h in enumerate(merged):
                if c2 == cur or not h:
                    continue
                m = float(np.mean(S_sharp[x, h]))
                if m > best + delta:
                    best, best_c = m, c2
            if best_c != cur:
                merged[cur] = [y for y in merged[cur] if y != x]
                merged[best_c] = sorted(merged[best_c] + [x])
                member_of[x] = best_c
    return [sorted(set(g)) for g in merged if g]


def batched_similarity_matrices(
    embs_list, bucket: Optional[int] = None, device="cuda"
) -> List[np.ndarray]:
    """Similarity matrices for MANY documents in one device call (zero-padded
    to a bucket; padded blocks sliced away). One kernel launch and one copy
    to the host per bucket instead of one per document. ``embs_list`` holds
    numpy arrays or tensors (on any device)."""
    if not len(embs_list):
        return []
    emb, lens_t = pad_documents(embs_list, bucket, device)
    S_all = similarity_matrix(emb).cpu().numpy()
    return [S_all[i, :n, :n] for i, n in enumerate(lens_t.tolist())]


def chunk_passage_grouping(
    doc_id: str,
    sentences: List[str],
    embeddings: np.ndarray,
    cfg: ChunkingConfig = ChunkingConfig(),
    collect_metadata: bool = False,
    seed: int = 0,
    sim_matrix: Optional[np.ndarray] = None,
    device="cuda",
) -> List[Chunk]:
    """Emit grouped (chunk_id, chunk_text, metadata) triples for one document.

    Output contract matches ``semantic_grouping_main``
    (``Semantic_Grouping_Optimized.py:590-654``): clusters in index order,
    optional exemplar/centrality metadata, whole-document fallback.
    ``sim_matrix`` optionally supplies a precomputed matrix from
    :func:`batched_similarity_matrices`.
    """
    if not sentences:
        return []
    if len(sentences) == 1:
        return [(f"{doc_id}_single", sentences[0], None)]

    if sim_matrix is not None:
        S = np.asarray(sim_matrix)
    else:
        emb_t = torch.from_numpy(np.asarray(embeddings, np.float32)).to(device)
        S = similarity_matrix(emb_t).cpu().numpy()
    S_sharp = sharpen_similarity(S, tau=cfg.sigmoid_tau_group)
    n = len(sentences)
    centrality = S_sharp.sum(axis=1) / max(n - 1, 1)

    groups = group_by_similarity(S_sharp, cfg, seed=seed, device=device)

    out: List[Chunk] = []
    for i, g in enumerate(groups):
        members = [idx for idx in sorted(set(g)) if 0 <= idx < n]
        if not members:
            continue
        text = " ".join(sentences[idx] for idx in members).strip()
        if not text:
            continue
        cid = f"{doc_id}_cluster{i}"
        meta = None
        if collect_metadata:
            m = {
                "chunk_id": cid,
                "sent_indices": ",".join(map(str, members)),
                "n": len(members),
                "method_used": cfg.engine,
            }
            exemplar = max(members, key=lambda t: centrality[t])
            sims_ex = [float(S[exemplar, j]) for j in members if j != exemplar]
            if sims_ex:
                m.update(
                    exemplar=exemplar,
                    sim_mean=round(float(np.mean(sims_ex)), 4),
                    sim_min=round(float(np.min(sims_ex)), 4),
                    sim_max=round(float(np.max(sims_ex)), 4),
                    sim_std=round(float(np.std(sims_ex)), 4),
                    exemplar_centrality=round(float(centrality[exemplar]), 4),
                )
            meta = json.dumps(m, ensure_ascii=False)
        out.append((cid, text, meta))

    if not out:
        return [(f"{doc_id}_fallback", " ".join(sentences), None)]
    return out
