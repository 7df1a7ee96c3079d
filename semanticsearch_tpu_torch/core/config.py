"""Configuration dataclasses of the serving path.

The port's own copy of ``EncoderConfig``, ``RankingConfig`` and
``IndexConfig`` from ``semanticsearch_tpu/core/config.py``: same fields, same
defaults, so an index directory's ``meta.json`` and a config override written
for one package read the same in the other.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class EncoderConfig:
    """Sentence-encoder model config (default: 6 layers, 384 wide, 12
    heads, MLP 1536, 256 tokens)."""

    vocab_size: int = 30522
    hidden_dim: int = 384
    num_layers: int = 6
    num_heads: int = 12
    mlp_dim: int = 1536
    max_len: int = 256
    dropout_rate: float = 0.0
    dtype: str = "bfloat16"
    pooling: str = "mean"  # mean | cls
    normalize: bool = True  # L2-normalize sentence embeddings
    # attention implementation: "auto" = the flash kernel on a CUDA device
    # once max_len >= 1024 (and dropout is 0), plain torch math otherwise;
    # "flash" / "stock" force it
    attention: str = "auto"


@dataclass(frozen=True)
class RankingConfig:
    """Hybrid cosine+BM25+RRF ranking config."""

    upper_percentile: float = 80.0
    lower_percentile: float = 20.0
    rrf_k: int = 60
    # weighted-RRF mixing weight: dense leg gets 2*alpha, lexical
    # 2*(1-alpha); None = unweighted fusion
    fusion_alpha: Optional[float] = None
    # serve-time neural rerank blend (the rerank stage is not ported yet)
    rerank_blend: float = 1.0
    bm25_k1: float = 1.5
    bm25_b: float = 0.75
    bm25_epsilon: float = 0.25
    min_group_size: int = 2
    bm25_threads: int = 0   # host top-k threads; 0 = auto
    # device-resident lexical leg: not ported yet (the engine raises)
    lexical_device: bool = False
    lexical_dense_terms: int = 4096
    lexical_topk_device: int = 64
    lexical_residual: bool = True
    lexical_weights: str = "int8"
    lexical_cache: bool = False

    def resolved_bm25_threads(self) -> int:
        if self.bm25_threads > 0:
            return self.bm25_threads
        return min(4, os.cpu_count() or 1)


@dataclass(frozen=True)
class IndexConfig:
    """Exact dense retrieval index config."""

    embed_dim: int = 384
    shard_axis: str = "data"
    top_k: int = 10
    query_batch: int = 128
    block_rows: int = 16384  # rows per block: segments are
    seg_split: int = 4       # block_rows/128/seg_split rows long
    dtype: str = "bfloat16"
