"""Serve-time neural reranking: load a trained reranker, score candidates.

The port's copy of ``semanticsearch_tpu/index/rerank_service.py``. The
hybrid engine's top-N fused candidates are rescored on the device by a
trained reranker checkpoint and reordered.

Every (query, chunk) pair of a whole query batch is packed into fixed-size
(rows, L) id blocks on a three-rung ladder (SCORE_BATCH / SCORE_BATCH_MID /
SCORE_BATCH_LARGE rows), padded with PAD rows whose scores are discarded:
few large blocks instead of many small launches, and the mid rung bounds
the pad waste for leftover counts between the rungs. Ids travel as int16
when the vocabulary fits and are widened on the device. Every block is
launched before any score is copied back, so block i+1's host packing and
upload overlap block i's compute.

Precision: the model computes in float32 (the cross-encoder's trunk in its
configured ``dtype``). On a CUDA device, its matrix products, convolutions
and LSTMs follow the caller's ``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32``: with both False the scores are f32
products; PyTorch's defaults let cuDNN use TF32. The service sets no
process-wide flag.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional, Sequence

import numpy as np
import torch

from ..core.checkpoint import load_metadata, restore_checkpoint
from ..core.config import TrainConfig
from ..core.logging import get_logger
from ..models.convert import reranker_state_dict
from ..models.encoder import _resolve_device
from ..models.rerankers import make_model
from ..train.vocab import Preprocessor

logger = get_logger("rerank")

SCORE_BATCH = 256
SCORE_BATCH_MID = 2048
SCORE_BATCH_LARGE = 8192
# past 3x the next-smaller rung of leftover pairs, one padded bigger block
# beats a train of small launches; the mid rung bounds the worst-case pad
# waste to ~2.7x
_LARGE_THRESHOLD = 3 * SCORE_BATCH_MID
_MID_THRESHOLD = 3 * SCORE_BATCH


def _block_size(remaining: int) -> int:
    if remaining > _LARGE_THRESHOLD:
        return SCORE_BATCH_LARGE
    if remaining > _MID_THRESHOLD:
        return SCORE_BATCH_MID
    return SCORE_BATCH


def _train_config(cfg_dict: dict) -> TrainConfig:
    """A TrainConfig from checkpoint metadata (JSON lists back to the
    tuples the frozen dataclass holds)."""
    names = {f.name for f in dataclasses.fields(TrainConfig)}
    return TrainConfig(**{k: tuple(v) if isinstance(v, list) else v
                          for k, v in cfg_dict.items() if k in names})


class RerankService:
    """A trained reranker + its preprocessor on one device, ready to score
    pairs."""

    def __init__(
        self,
        model_name: str,
        state_dict: dict,
        preprocessor: Preprocessor,
        cfg: Optional[TrainConfig] = None,
        model_kwargs: Optional[dict] = None,
        device="cuda",
    ) -> None:
        self.model_name = model_name
        self.pp = preprocessor
        self.cfg = cfg or TrainConfig(model=model_name)
        self.device = _resolve_device(device)
        # model_kwargs must match the checkpoint's architecture overrides
        # (e.g. a preset's kernel_num), or the weights do not fit
        self.model_kwargs = dict(model_kwargs or {})
        model = make_model(model_name, vocab_size=preprocessor.vocab_size,
                           embed_dim=self.cfg.embedding_dim,
                           **self.model_kwargs)
        model.load_state_dict(state_dict, strict=True)
        self.model = model.to(self.device).eval()
        # int16 ids halve the upload when the vocabulary fits
        self._wire_dtype = np.int16 if preprocessor.vocab_size < 2**15 \
            else np.int32

    # ---------------------------------------------------------------- loading
    @classmethod
    def load(cls, checkpoint_dir: str, device="cuda") -> "RerankService":
        """Restore the model name and config from the checkpoint metadata,
        the vocabulary from ``preprocessor.json`` and the trained weights
        (either layout, ``core/checkpoint.py``), converted to the port's
        module. The architecture is rebuilt from the persisted
        ``model_kwargs``; a tree that does not fit it raises."""
        device = _resolve_device(device)
        meta = load_metadata(checkpoint_dir) or {}
        cfg = _train_config(dict(meta.get("config", {})))
        pp = Preprocessor.load(os.path.join(checkpoint_dir,
                                            "preprocessor.json"))
        model_kwargs = dict(meta.get("model_kwargs") or {})
        params = restore_checkpoint(checkpoint_dir)["params"]
        state_dict = reranker_state_dict(cfg.model, params, **model_kwargs)
        logger.info("loaded %s reranker from %s (vocab %d)",
                    cfg.model, checkpoint_dir, pp.vocab_size)
        return cls(cfg.model, state_dict, pp, cfg=cfg,
                   model_kwargs=model_kwargs, device=device)

    # ---------------------------------------------------------------- scoring
    def _upload(self, host: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(host)
        if self.device.type == "cuda":
            t = t.pin_memory()
        return t.to(self.device, non_blocking=True)

    @torch.inference_mode()
    def score_pairs(
        self,
        query_texts: Sequence[str],
        chunk_texts: Sequence[str],
    ) -> np.ndarray:
        """Score aligned (query, chunk) text pairs: (N,) float32.

        Pairs are packed into fixed-shape blocks (``_block_size`` picks the
        ladder rung from the remaining count; pad rows' scores are
        discarded). Every block is launched before any score is copied
        back, in one copy."""
        n = len(query_texts)
        if len(chunk_texts) != n:
            raise ValueError(f"{n} queries vs {len(chunk_texts)} chunks")
        if n == 0:
            return np.zeros(0, np.float32)
        enc = self.pp.transform_pair(list(query_texts), list(chunk_texts))
        left, right = enc["left"], enc["right"]
        outs = []
        s = 0
        while s < n:
            bs = _block_size(n - s)
            e = min(s + bs, n)
            lb = np.zeros((bs, left.shape[1]), self._wire_dtype)
            rb = np.zeros((bs, right.shape[1]), self._wire_dtype)
            lb[: e - s] = left[s:e]
            rb[: e - s] = right[s:e]
            scores = self.model(self._upload(lb).long(),
                                self._upload(rb).long())
            outs.append(scores[: e - s].float())
            s = e
        return torch.cat(outs).cpu().numpy()
