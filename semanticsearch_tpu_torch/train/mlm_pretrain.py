"""Masked-language-model pretraining for the sentence encoder.

The port's counterpart of ``semanticsearch_tpu/train/mlm_pretrain.py``: an
unsupervised denoising pass over the user's own corpus before the
contrastive stage. 15% of each sequence's real-token positions (a static
count per batch) are replaced by uniformly random vocabulary ids, and the
model predicts the original ids there through a decoder tied to the
float32 master token table, so the parameter tree stays the encoder's.
The corruption draws from the same ``np.random.Generator`` calls as the
JAX package's, so the same seed corrupts the same positions to the same ids.
On a meshed encoder the batch's rows split over the data shards
(``SentenceEncoder.train_forward``) and the loss is taken on the first
device, the tied decoder a shard's rows at a time. On a mesh across
processes every process corrupts the whole global batch from the same
generator calls, forwards only its own rows, and takes their share of the
loss, Σ(nll·w) over them divided by Σw over the global batch; the shares
summed over the processes are the reported loss, and the masters'
gradients are summed as the contrastive trainer's are.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Sequence

import numpy as np
import torch
from torch.nn import functional as F

from ..core import profiling
from ..core.distributed import all_reduce_flat
from ..core.logging import get_logger
from ..models.encoder import SentenceEncoder, dropout_generator
from .encoder_train import adamw_for, train_step

logger = get_logger("mlm_pretrain")


@dataclass(frozen=True)
class MLMConfig:
    """Hyperparameters for corpus MLM pretraining."""

    epochs: int = 3
    batch_size: int = 64
    learning_rate: float = 3e-4
    warmup_frac: float = 0.05
    weight_decay: float = 0.01
    mask_prob: float = 0.15
    max_len: int = 128
    seed: int = 0


class MLMPretrainer:
    """Pretrain a SentenceEncoder's float32 masters on raw corpus text::

        MLMPretrainer(enc, MLMConfig(epochs=3)).fit(corpus_texts)
        ContrastiveEncoderTrainer(enc, ...).fit(pairs)   # then fine-tune
    """

    def __init__(self, encoder: SentenceEncoder,
                 cfg: MLMConfig = MLMConfig()) -> None:
        self.encoder = encoder
        self.cfg = cfg

    def _corrupt(self, rng: np.random.Generator, ids: np.ndarray,
                 mask: np.ndarray, n_mask: int):
        """Host-side corruption of one batch: (corrupt_ids, pos, targets,
        weights) with a static ``n_mask`` positions per row (rows with
        fewer real tokens get zero-weight padding slots)."""
        b, t = ids.shape
        vocab = self.encoder.cfg.vocab_size
        corrupt = ids.copy()
        pos = np.zeros((b, n_mask), np.int32)
        tgt = np.zeros((b, n_mask), np.int32)
        w = np.zeros((b, n_mask), np.float32)
        for r in range(b):
            real = np.nonzero(mask[r])[0]
            if real.size == 0:
                continue
            k = min(n_mask, real.size)
            sel = rng.choice(real, size=k, replace=False)
            pos[r, :k] = sel
            tgt[r, :k] = ids[r, sel]
            w[r, :k] = 1.0
            corrupt[r, sel] = rng.integers(0, vocab, size=k)
        return corrupt, pos, tgt, w

    def _loss(self, params, ids, mask, pos, tgt, w, gen):
        """This process's share of the global batch's loss: Σ(nll·w) over
        the rows it forwards, over Σw of the whole batch (every row in
        one process). The tied decoder runs a row shard at a time, as
        JAX's einsum partitioned over ``data`` does, so a shard's logits
        are the same products in one process and across processes."""
        enc = self.encoder
        h = enc.train_forward(ids, mask, params, return_tokens=True,
                              generator=gen, gather=False)  # (b, T, H) f32
        emb = params["token_embed.weight"]  # the tied decoder, f32 master
        shards = enc.local_shard_rows(ids.shape[0])
        lo = shards[0].start
        nums = []
        for s in shards:
            h_s = h[s.start - lo: s.stop - lo]
            hs = torch.gather(h_s, 1,
                              pos[s][..., None].expand(-1, -1, h.shape[-1]))
            logits = torch.einsum("bmh,vh->bmv", hs, emb)
            nll = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                                  tgt[s].reshape(-1), reduction="none")
            nums.append((nll * w[s].reshape(-1)).sum())
        return sum(nums[1:], nums[0]) / torch.clamp(w.sum(), min=1.0)

    def fit(self, texts: Sequence[str]) -> List[Dict[str, float]]:
        """Pretrain on raw texts; updates the encoder's masters and, after
        each epoch, its serving module."""
        cfg, enc = self.cfg, self.encoder
        texts = [t for t in texts if t]
        if not texts:
            raise ValueError("no pretraining texts")
        max_len = min(cfg.max_len, enc.cfg.max_len)
        with profiling.span("train.tokenize"):
            ids_full, mask_full = enc.tokenizer.encode_batch(
                texts, max_len=max_len)
        n = len(texts)
        bsz = min(cfg.batch_size, n)
        steps_per_epoch = -(-n // bsz)
        with profiling.span("train.optimizer"):
            opt = adamw_for(enc, steps_per_epoch * cfg.epochs,
                            cfg.learning_rate, cfg.warmup_frac,
                            cfg.weight_decay)
        n_mask = max(1, int(round(cfg.mask_prob * max_len)))
        history: List[Dict[str, float]] = []
        for epoch in range(cfg.epochs):
            t0 = time.perf_counter()
            rng_np = np.random.default_rng(cfg.seed + 7919 * (epoch + 1))
            order = rng_np.permutation(n)
            losses = []
            for si, s in enumerate(range(0, n, bsz)):
                with profiling.span("train.step", {"epoch": epoch,
                                                   "step": si}):
                    with profiling.span("train.upload"):
                        sel = order[s: s + bsz]
                        if len(sel) < bsz:  # wrap-around, as in pairs.py
                            sel = np.concatenate(
                                [sel, np.resize(order, bsz - len(sel))])
                        corrupt, pos, tgt, w = self._corrupt(
                            rng_np, ids_full[sel], mask_full[sel], n_mask)
                        up = [torch.from_numpy(x.astype(dt)).to(enc.device)
                              for x, dt in ((corrupt, np.int64),
                                            (mask_full[sel], np.int64),
                                            (pos, np.int64), (tgt, np.int64),
                                            (w, np.float32))]
                    gen = dropout_generator(enc.device, cfg.seed, epoch, si)
                    # fetched once per epoch
                    losses.append(train_step(enc, opt, self._loss, up, gen))
            with profiling.span("train.sync"):
                enc.sync()
                losses = torch.stack(losses)
                if enc.mesh is not None:  # the processes' shares, summed
                    all_reduce_flat(enc.mesh, [losses])
                loss = float(losses.mean())
            row = {"epoch": epoch, "loss": loss,
                   "time_s": time.perf_counter() - t0}
            history.append(row)
            logger.info("mlm epoch %d: %s", epoch, row)
        return history
