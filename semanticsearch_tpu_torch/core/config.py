"""Typed configuration tree and the registry of named configs.

The port's own copy of ``semanticsearch_tpu/core/config.py``: same
dataclasses, same fields, same defaults, so an index directory's
``meta.json`` and a config override written for one package read the same
in the other. The registry holds the seven named chunking configurations,
``default`` and ``serve_device``.
"""
from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass, field
from typing import Any, ClassVar, Dict, Optional, Tuple


def _replace_from_dict(obj, overrides: Dict[str, Any]):
    """Recursively apply a nested dict of overrides onto a dataclass tree."""
    updates = {}
    for key, val in overrides.items():
        if not hasattr(obj, key):
            raise KeyError(f"{type(obj).__name__} has no config field {key!r}")
        cur = getattr(obj, key)
        if dataclasses.is_dataclass(cur) and isinstance(val, dict):
            updates[key] = _replace_from_dict(cur, val)
        else:
            updates[key] = val
    return dataclasses.replace(obj, **updates)


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

    # the block's architecture: the pre-LN BERT block of models/encoder.py
    # (:class:`LFM2MoEConfig` names its own); a class attribute, so the
    # fields stay the JAX package's field for field
    arch: ClassVar[str] = "bert"


# LFM2-8B-A1B's published layer pattern: 18 gated short convolutions and 6
# grouped-query attention layers (2, 6, 10, 14, 18, 21)
LFM2_LAYER_TYPES = tuple(
    "full_attention" if i in (2, 6, 10, 14, 18, 21) else "conv"
    for i in range(24))


@dataclass(frozen=True)
class LFM2MoEConfig(EncoderConfig):
    """A causal LFM2-MoE language model served as a retrieval encoder
    (``models/lfm2_moe.py``), the port's own: gated short convolutions and
    grouped-query causal attention with RoPE, a dense SwiGLU in the first
    ``num_dense_layers`` layers and a sigmoid-routed mixture of experts in
    the rest, each text pooled at its last token. Defaults are
    LFM2-8B-A1B's published sizes, but ``max_len``, which bounds the
    tokens a text keeps (RoPE has no table). ``mlp_dim`` is the dense
    layers' SwiGLU width, ``num_heads`` the query heads. Inference only:
    the encoder holds serving weights in ``dtype`` and no float32
    masters."""

    arch: ClassVar[str] = "lfm2_moe"
    vocab_size: int = 65536
    hidden_dim: int = 2048
    num_layers: int = 24
    num_heads: int = 32
    mlp_dim: int = 7168
    max_len: int = 512
    pooling: str = "last"
    attention: str = "flash"
    num_kv_heads: int = 8
    layer_types: Tuple[str, ...] = LFM2_LAYER_TYPES
    num_dense_layers: int = 2
    num_experts: int = 32
    experts_per_token: int = 4
    expert_dim: int = 1792
    norm_topk_prob: bool = True
    routed_scaling: float = 1.0
    conv_kernel: int = 3
    rope_theta: float = 1e6
    norm_eps: float = 1e-5

    def __post_init__(self) -> None:
        if len(self.layer_types) != self.num_layers or not set(
                self.layer_types) <= {"conv", "full_attention"}:
            raise ValueError(f"layer_types must name 'conv' or "
                             f"'full_attention' for each of the "
                             f"{self.num_layers} layers")
        # heads matter only where a layer attends
        if "full_attention" in self.layer_types and (
                self.hidden_dim % self.num_heads or self.num_kv_heads < 1
                or self.num_heads % self.num_kv_heads):
            raise ValueError(f"{self.num_heads} query heads must divide the "
                             f"width {self.hidden_dim} and be a multiple of "
                             f"{self.num_kv_heads} K/V heads")
        if not 0 <= self.num_dense_layers <= self.num_layers:
            raise ValueError(f"num_dense_layers {self.num_dense_layers} of "
                             f"{self.num_layers} layers")
        if not 0 < self.experts_per_token <= self.num_experts:
            raise ValueError(f"{self.experts_per_token} experts a token of "
                             f"{self.num_experts}")
        if self.pooling != "last":
            raise ValueError("an LFM2-MoE encoder pools each text's last "
                             "token (pooling='last')")


@dataclass(frozen=True)
class ChunkingConfig:
    """Chunking method config: the splitter's and the grouper's parameters."""

    method: str = "splitter"  # splitter | grouping | char
    # shared
    auto_params: bool = True
    collect_metadata: bool = False
    # splitter params
    min_boundary_spacing: int = 2
    min_first_boundary_index: int = 3
    smooth_adj_window: int = 3
    valley_tau: float = 0.12
    hybrid_mode: str = "union_weighted"  # union_weighted | union | intersection
    vote_thr: float = 0.75
    c99_stopping: str = "gain"  # gain | profile
    c99_min_gain: float = 0.01
    c99_knee_c: float = 1.2
    c99_use_local_rank: bool = False
    c99_mask_size: int = 11
    soft_cap: Optional[int] = None
    soft_cap_delta: int = 2
    # DP-optimal refinement over the candidate cuts
    use_dp_refine: bool = False
    dp_penalty: Optional[float] = None  # None = derive from the signal
    # scales the derived penalty: < 1.0 admits more cuts (finer chunks);
    # ignored when dp_penalty is set
    dp_penalty_scale: float = 1.0
    # grouping params
    engine: str = "spectral"  # spectral | modularity (host-side)
    knn_k: Optional[int] = None
    edge_floor: float = 0.25
    spectral_kmax: Optional[int] = None
    rmt_keep_eigs: int = 3
    sigmoid_tau_group: float = 0.15
    cap_soft: Optional[int] = None
    small_group_min: int = 2
    tau_merge: float = 0.38
    reassign_delta: float = 0.02
    # char splitter params
    char_chunk_size: int = 1000
    char_overlap: int = 100
    # longest document, in sentences, that is chunked whole; the length
    # buckets of the batched signals go up to it (4096 covers the reference
    # corpus's longest document, 3,939 sentences)
    max_sentences: int = 4096
    # grouping documents of at least this many sentences go through the
    # ring-exchange similarity path on a multi-device mesh
    sp_min_sentences: int = 2048


@dataclass(frozen=True)
class RankingConfig:
    """Hybrid cosine+BM25+RRF ranking config."""

    upper_percentile: float = 80.0
    lower_percentile: float = 20.0
    rrf_k: int = 60
    # weighted-RRF mixing weight: dense leg gets 2*alpha, lexical
    # 2*(1-alpha); None = unweighted fusion
    fusion_alpha: Optional[float] = None
    # serve-time neural rerank blend: 1.0 reorders the fused head by the
    # reranker's scores alone, beta < 1 fuses its ranks with the fusion's
    # (HybridQueryEngine.tune_rerank_blend picks it)
    rerank_blend: float = 1.0
    bm25_k1: float = 1.5
    bm25_b: float = 0.75
    bm25_epsilon: float = 0.25
    min_group_size: int = 2
    bm25_threads: int = 0   # host top-k threads; 0 = auto
    # device-resident lexical leg (index/bm25_tpu.py): the frequent terms'
    # dense int8 contribution matrix scored on the card, rare-term postings
    # and the exact certification on the host; False = host kernels
    lexical_device: bool = False
    lexical_dense_terms: int = 4096  # dense matrix budget B (B*D int8)
    lexical_topk_device: int = 64    # candidates fetched per query (K')
    # residual int8 pass: ~100x tighter certification bound, 2x the matrix
    lexical_residual: bool = True
    # query weights in residual mode: "int8" (three exact int8 products)
    # or "bf16" (an f32 -> bf16 x2 split, f32 accumulation)
    lexical_weights: str = "int8"
    # persist the built int8 matrix in the index directory
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


@dataclass(frozen=True)
class TrainConfig:
    """Reranker config, field for field the JAX package's. Serving reads
    ``model``, ``embedding_dim`` and the fixed lengths from a checkpoint's
    metadata (``index/rerank_service.py``); the training fields have no
    reader until training is ported."""

    model: str = "knrm"
    epochs: int = 10
    batch_size: int = 32
    # None = the optimizer's conventional default (adadelta 1.0, adam 1e-3)
    learning_rate: Optional[float] = None
    optimizer: str = "adadelta"  # adadelta | adam
    loss: str = "hinge"  # hinge | rank_xent
    num_dup: int = 1
    num_neg: int = 1
    fixed_length_left: int = 16
    fixed_length_right: int = 128
    filter_low_freq: int = 5
    embedding_dim: int = 100
    vocab_size: int = 30000
    seed: int = 42
    clip_norm: Optional[float] = None
    eval_metrics: tuple = ("ndcg@3", "ndcg@5", "map")
    embedding_init_path: Optional[str] = None
    subword_tokenizer_path: Optional[str] = None
    keep_best: bool = False
    patience: int = 0
    length_buckets: tuple = ()
    distill_weight: float = 0.0
    distill_scale: float = 1.0


@dataclass(frozen=True)
class Config:
    """Top-level config tree."""

    name: str = "default"
    encoder: EncoderConfig = field(default_factory=EncoderConfig)
    chunking: ChunkingConfig = field(default_factory=ChunkingConfig)
    ranking: RankingConfig = field(default_factory=RankingConfig)
    index: IndexConfig = field(default_factory=IndexConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    seed: int = 42

    def override(self, **nested: Any) -> "Config":
        return _replace_from_dict(self, nested)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, default=str)


# --- named-config registry ---------------------------------------------------
NAMED_CONFIGS: Dict[str, Config] = {}


def register_config(name: str, cfg: Config) -> Config:
    NAMED_CONFIGS[name] = dataclasses.replace(cfg, name=name)
    return NAMED_CONFIGS[name]


def get_named_config(name: str) -> Config:
    if name not in NAMED_CONFIGS:
        raise KeyError(
            f"Unknown config {name!r}; available: {sorted(NAMED_CONFIGS)}"
        )
    return NAMED_CONFIGS[name]


_base = Config()
# the seven named chunking configurations
register_config("semantic_splitter", _base.override(chunking={"method": "splitter"}))
register_config(
    "semantic_splitter_intersection",
    _base.override(chunking={"method": "splitter", "hybrid_mode": "intersection", "auto_params": False}),
)
register_config(
    "semantic_splitter_union",
    _base.override(chunking={"method": "splitter", "hybrid_mode": "union", "auto_params": False}),
)
register_config(
    "semantic_grouping", _base.override(chunking={"method": "grouping", "engine": "spectral"})
)
register_config(
    "semantic_grouping_modularity",
    _base.override(chunking={"method": "grouping", "engine": "modularity"}),
)
register_config(
    "text_splitter_char",
    _base.override(chunking={"method": "char", "char_chunk_size": 1000, "char_overlap": 100}),
)
register_config(
    "semantic_splitter_dp",
    _base.override(chunking={"method": "splitter", "use_dp_refine": True}),
)
register_config("default", _base)
# the serving profile with every query-path leg on the card: the device
# BM25 leg (index/bm25_tpu.py) beside the dense top-k
register_config(
    "serve_device",
    _base.override(ranking={"lexical_device": True}),
)
