"""Visual debugging exports for chunking decisions.

Rebuild of the reference controller's debug visuals
(``data_process/simple_chunk_controller.py:670-1050``): per-document cosine
heatmaps with chunk-boundary overlays, multi-panel boundary-signal plots
(adjacent similarity, valley strength, C99 cuts) with the selected boundaries
annotated, grouping color strips showing cluster membership per sentence, and
optional ideal-boundary overlays loaded from ``{doc_id}.bounds`` files (the
``tideal_bounds/`` slots, reference ``:892-908``).

The port's own copy of ``semanticsearch_tpu/chunking/visualize.py``: the
similarity and rank matrices of :func:`export_document_debug` run on
``device`` (the similarity kernel on a card), the plots on the host.
Matplotlib is imported lazily; every function degrades to a no-op return of
None when it is unavailable.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np


def _plt():
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        return plt
    except Exception:
        return None


def load_ideal_bounds(bounds_dir: str, doc_id: str) -> Optional[List[int]]:
    """Read a ``{doc_id}.bounds`` file: whitespace/newline-separated sentence
    indices marking ideal boundaries (reference tideal_bounds contract)."""
    path = os.path.join(bounds_dir, f"{doc_id}.bounds")
    if not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            return sorted({int(tok) for tok in f.read().split()})
    except ValueError:
        return None


def plot_similarity_heatmap(
    sim_matrix: np.ndarray,
    boundaries: Sequence[int],
    out_path: str,
    doc_id: str = "",
    ideal_bounds: Optional[Sequence[int]] = None,
) -> Optional[str]:
    """Cosine heatmap with chunk boundaries (white) and ideal bounds (cyan)."""
    plt = _plt()
    if plt is None:
        return None
    fig, ax = plt.subplots(figsize=(8, 7))
    im = ax.imshow(np.asarray(sim_matrix), cmap="viridis", interpolation="nearest")
    for b in boundaries:
        ax.axhline(b - 0.5, color="white", linewidth=1.2)
        ax.axvline(b - 0.5, color="white", linewidth=1.2)
    for b in ideal_bounds or []:
        ax.axhline(b - 0.5, color="cyan", linewidth=0.8, linestyle="--")
        ax.axvline(b - 0.5, color="cyan", linewidth=0.8, linestyle="--")
    ax.set_title(f"sentence similarity — {doc_id}")
    fig.colorbar(im, ax=ax, fraction=0.046)
    fig.tight_layout()
    fig.savefig(out_path, dpi=110)
    plt.close(fig)
    return out_path


def plot_boundary_signals(
    adj_sims: Sequence[float],
    out_path: str,
    doc_id: str = "",
    valley_bounds: Optional[Sequence[int]] = None,
    c99_bounds: Optional[Sequence[int]] = None,
    final_bounds: Optional[Sequence[int]] = None,
    smoothed: Optional[Sequence[float]] = None,
    ideal_bounds: Optional[Sequence[int]] = None,
    valley_cands: Optional[Sequence] = None,
    c99_curve: Optional[tuple] = None,
) -> Optional[str]:
    """Four DISTINCT signal panels with NMS decision annotations (reference
    4-panel plot, ``simple_chunk_controller.py:731-943``):

    1. raw + smoothed adjacent similarity
    2. valley strength/score stems — kept boundaries solid red, candidates
       suppressed by NMS/first-index dashed gray
    3. C99 root-segment cut-gain profile + chosen cuts
    4. final boundaries over the smoothed signal — union candidates that
       lost the hybrid vote / final NMS dashed gray

    ``valley_cands``: (pos, strength, score) triples from
    ``splitter.valley_candidates``; ``c99_curve``: (positions, gains) from
    ``splitter.c99_gain_curve``.
    """
    plt = _plt()
    if plt is None:
        return None
    adj = np.asarray(adj_sims, dtype=float)
    x = np.arange(1, adj.size + 1)
    fig, axes = plt.subplots(4, 1, figsize=(10, 10), sharex=True)

    # 1 — adjacent similarity
    ax = axes[0]
    ax.plot(x, adj, lw=0.9, label="adj sim")
    if smoothed is not None:
        ax.plot(np.arange(1, len(smoothed) + 1), smoothed, lw=0.9,
                label="smoothed", alpha=0.7)
    ax.legend(loc="lower right", fontsize=7)
    ax.set_ylabel("adjacent similarity", fontsize=8)

    # 2 — valley strength/score with NMS decisions
    ax = axes[1]
    kept_v = set(valley_bounds or [])
    if valley_cands:
        for pos, strength, score in valley_cands:
            kept = pos in kept_v
            ax.vlines(pos, 0, strength,
                      color="red" if kept else "gray",
                      lw=1.4 if kept else 0.9,
                      linestyle="-" if kept else "--", alpha=0.9)
            ax.plot(pos, score, "o", ms=3,
                    color="darkred" if kept else "gray", alpha=0.8)
        ax.plot([], [], color="red", label="kept")
        ax.plot([], [], color="gray", linestyle="--", label="NMS-suppressed")
        ax.plot([], [], "o", ms=3, color="darkred", label="score")
        ax.legend(loc="upper right", fontsize=7)
    ax.set_ylabel("valley strength", fontsize=8)

    # 3 — C99 gain profile
    ax = axes[2]
    if c99_curve is not None and len(c99_curve[0]):
        ax.plot(c99_curve[0], c99_curve[1], lw=0.9, color="tab:green",
                label="first-cut gain")
        ax.axhline(0.0, color="black", lw=0.5, alpha=0.5)
        ax.legend(loc="upper right", fontsize=7)
    for b in c99_bounds or []:
        ax.axvline(b, color="red", lw=1.2, alpha=0.9)
    ax.set_ylabel("C99 gain profile", fontsize=8)

    # 4 — final decision
    ax = axes[3]
    base = np.asarray(smoothed, dtype=float) if smoothed is not None else adj
    ax.plot(np.arange(1, base.size + 1), base, lw=0.9, alpha=0.8)
    final_set = set(final_bounds or [])
    union = set(valley_bounds or []) | set(c99_bounds or [])
    for b in sorted(union - final_set):
        ax.axvline(b, color="gray", lw=0.9, linestyle="--", alpha=0.7)
    for b in sorted(final_set):
        ax.axvline(b, color="red", lw=1.4, alpha=0.9)
    for b in ideal_bounds or []:
        ax.axvline(b, color="cyan", lw=0.8, linestyle=":", alpha=0.9)
    ax.set_ylabel("final boundaries", fontsize=8)

    axes[-1].set_xlabel("boundary index (between sentence i and i+1)")
    fig.suptitle(f"boundary signals — {doc_id}")
    fig.tight_layout()
    fig.savefig(out_path, dpi=110)
    plt.close(fig)
    return out_path


def plot_grouping_strip(
    labels: Sequence[int],
    out_path: str,
    doc_id: str = "",
) -> Optional[str]:
    """Color strip: one cell per sentence, colored by cluster id."""
    plt = _plt()
    if plt is None:
        return None
    lab = np.asarray(labels, dtype=int)
    fig, ax = plt.subplots(figsize=(10, 1.4))
    ax.imshow(lab[None, :], aspect="auto", cmap="tab20",
              interpolation="nearest")
    ax.set_yticks([])
    ax.set_xlabel("sentence index")
    ax.set_title(f"cluster membership — {doc_id}", fontsize=9)
    fig.tight_layout()
    fig.savefig(out_path, dpi=110)
    plt.close(fig)
    return out_path


def groups_to_labels(groups: Sequence[Sequence[int]], n: int) -> np.ndarray:
    labels = np.zeros(n, dtype=int)
    for cid, g in enumerate(groups):
        for i in g:
            if 0 <= i < n:
                labels[i] = cid
    return labels


def export_document_debug(
    doc_id: str,
    embeddings: np.ndarray,
    groups: Sequence[Sequence[int]],
    output_dir: str,
    bounds_dir: Optional[str] = None,
    device="cuda",
) -> Dict[str, Optional[str]]:
    """One-call export of all three visuals for a chunked document; the
    matrices are computed on ``device``."""
    import torch

    from ..ops.similarity import (
        adjacent_similarities,
        rank_matrix_global,
        similarity_matrix,
    )
    from .splitter import (
        c99_boundaries,
        c99_gain_curve,
        median_smooth,
        valley_boundaries,
        valley_candidates,
    )

    os.makedirs(output_dir, exist_ok=True)
    emb = np.asarray(embeddings, np.float32)
    n = emb.shape[0]
    emb_dev = torch.from_numpy(emb).to(device)
    S_dev = similarity_matrix(emb_dev)
    S = S_dev.cpu().numpy()
    adj = adjacent_similarities(emb_dev).cpu().numpy()
    boundaries = sorted(g[0] for g in groups if g and g[0] > 0)
    ideal = load_ideal_bounds(bounds_dir, doc_id) if bounds_dir else None

    # distinct per-method signals for the 4-panel plot
    smoothed = median_smooth(adj, 3)
    v_cands = valley_candidates(smoothed)
    v_bounds = valley_boundaries(smoothed)
    R = rank_matrix_global(S_dev).cpu().numpy()
    c_curve = c99_gain_curve(R)
    c_bounds = c99_boundaries(R)
    return {
        "heatmap": plot_similarity_heatmap(
            S, boundaries, os.path.join(output_dir, f"{doc_id}_heatmap.png"),
            doc_id, ideal_bounds=ideal,
        ),
        "signals": plot_boundary_signals(
            adj, os.path.join(output_dir, f"{doc_id}_signals.png"),
            doc_id, valley_bounds=v_bounds, c99_bounds=c_bounds,
            final_bounds=boundaries, smoothed=smoothed, ideal_bounds=ideal,
            valley_cands=v_cands, c99_curve=c_curve,
        ),
        "strip": plot_grouping_strip(
            groups_to_labels(groups, n),
            os.path.join(output_dir, f"{doc_id}_strip.png"), doc_id,
        ),
    }
