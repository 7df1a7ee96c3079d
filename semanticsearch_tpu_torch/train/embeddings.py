"""Pretrained embedding initialization for the rerankers.

The port's copy of ``semanticsearch_tpu/train/embeddings.py``: a GloVe-format
text file read from local disk into an L2-normalized (vocab, dim) matrix
(pad row zero, out-of-file rows N(0, 0.1) from the same numpy generator),
the matrix put into a reranker's ``state_dict``, and the trained sentence
encoder's float32 master token table as the zero-egress alternative.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def load_word_embeddings(
    path: str,
    vocab: Dict[str, int],
    vocab_size: int,
    embed_dim: int,
    seed: int = 42,
    normalize: bool = True,
) -> np.ndarray:
    """An (vocab_size, embed_dim) float32 init matrix from a GloVe-format
    file: pad (id 0) zero, vocabulary terms found in the file their
    vector, the rest N(0, 0.1); non-pad rows L2-normalized. Raises
    FileNotFoundError for a missing file and ValueError when no term of
    the vocabulary matches at ``embed_dim``."""
    rng = np.random.default_rng(seed)
    mat = rng.normal(0.0, 0.1, size=(vocab_size, embed_dim)).astype(np.float32)
    mat[0] = 0.0  # pad

    found = 0
    with open(path, "r", encoding="utf-8", errors="ignore") as f:
        for line in f:
            parts = line.rstrip("\n").split(" ")
            if len(parts) != embed_dim + 1:
                continue
            idx = vocab.get(parts[0])
            if idx is None or idx <= 0 or idx >= vocab_size:
                continue
            try:
                mat[idx] = np.asarray(parts[1:], dtype=np.float32)
                found += 1
            except ValueError:
                continue
    if found == 0:
        raise ValueError(
            f"no vocabulary terms matched {path!r} at dim {embed_dim} — "
            "wrong file or wrong embedding_dim?")
    if normalize:
        norms = np.linalg.norm(mat[1:], axis=1, keepdims=True)
        mat[1:] = mat[1:] / np.maximum(norms, 1e-9)
    return mat


def apply_embedding_init(state_dict: Dict[str, torch.Tensor],
                         matrix: np.ndarray) -> Dict[str, torch.Tensor]:
    """``state_dict`` with its ``embedding.weight`` (every reranker's token
    table) replaced by ``matrix``. Shape-checked."""
    table = state_dict["embedding.weight"]
    if tuple(table.shape) != tuple(matrix.shape):
        raise ValueError(
            f"embedding init shape {matrix.shape} != model table "
            f"{tuple(table.shape)}")
    out = dict(state_dict)
    out["embedding.weight"] = torch.as_tensor(
        np.asarray(matrix, np.float32)).to(table.device)
    return out


def encoder_token_embeddings(encoder, normalize: bool = True) -> np.ndarray:
    """Reranker embedding init from a trained sentence encoder's float32
    master token table: rows L2-normalized, the pad row (id 0) zero. Use
    with ``RerankTrainer(embedding_matrix=...)`` and ``embedding_dim``
    equal to the encoder's hidden size."""
    mat = encoder.master.token_embed.weight.detach().float().cpu().numpy(
    ).copy()
    mat[0] = 0.0
    if normalize:
        norms = np.linalg.norm(mat[1:], axis=1, keepdims=True)
        mat[1:] = mat[1:] / np.maximum(norms, 1e-9)
    return mat
