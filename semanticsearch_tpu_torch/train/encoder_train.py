"""Contrastive (InfoNCE) training for the sentence encoder.

The port's counterpart of ``semanticsearch_tpu/train/encoder_train.py``: a
dual-encoder InfoNCE objective over (query, positive chunk) pairs with
in-batch negatives and optional explicit hard negatives, AdamW on optax's
warmup-cosine schedule (``train/optim.py``), periodic hard-negative
re-mining (:func:`fit_with_mining`), and the encoder's checkpoint in the
JAX package's layout (:func:`save_encoder`, :func:`load_encoder`).

A step: queries padded to the trainer's fixed ``max_len_query``, chunks to
``max_len_chunk`` (both capped by the encoder's position table), hard
negatives stacked under the positives on the chunk side, two forwards of
the encoder on its float32 masters cast to ``cfg.dtype``
(``SentenceEncoder.train_forward``), a (B, B[+B]) logit matrix over the
temperature, and the symmetric softmax cross entropy over
``logits[:, :b]``. Trailing partial batches wrap around the epoch's
permutation. The losses stay on the device and are fetched once per epoch.

On a meshed encoder (``SentenceEncoder(mesh=...)``) the global batch's rows
split over the data shards (tensor parallel within each on a ``model``
axis) and the logits and loss are taken over the whole batch on the first
device, so every other row of the global batch, on any shard, is an
in-batch negative; the gradient flows back through the copies into the
one set of float32 masters. On a mesh across processes
(``core.distributed.global_mesh``) each process forwards its own block of
the query rows and of the chunk rows, both sides are gathered in process
order (differentiably), every process takes the same logits and loss, and
the masters' gradients are summed over the processes in one flat bucket
before the step (:func:`reduce_gradients`), so the masters stay equal on
every process.
"""
from __future__ import annotations

import dataclasses
import os
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.nn import functional as F

from ..core import profiling
from ..core.checkpoint import load_metadata, restore_checkpoint, save_checkpoint
from ..core.config import EncoderConfig
from ..core.distributed import all_reduce_flat, is_primary
from ..core.logging import get_logger
from ..models.convert import encoder_flax_tree, flax_to_state_dict
from ..models.encoder import SentenceEncoder, dropout_generator
from .optim import Optimizer, warmup_cosine_decay_schedule

logger = get_logger("encoder_train")


@dataclass(frozen=True)
class ContrastiveConfig:
    """Hyperparameters for dual-encoder InfoNCE training."""

    epochs: int = 10
    batch_size: int = 64
    learning_rate: float = 3e-4
    warmup_frac: float = 0.05     # fraction of total steps spent warming up
    weight_decay: float = 0.01
    temperature: float = 0.05     # sentence-transformers MNRL default scale
    symmetric: bool = True        # add the chunk->query direction
    max_len_query: int = 64
    max_len_chunk: int = 256
    use_hard_negatives: bool = True
    seed: int = 0


def pairs_from_labeled_rows(
    rows: Sequence[Dict[str, str]],
) -> Tuple[List[Tuple[str, str]], List[Optional[str]]]:
    """(query_text, positive_chunk) pairs and one hard negative each from
    labeled TSV rows (query_id/query_text/chunk_text/label): every label>0
    row is a pair; a label<=0 chunk of the same query (round-robin) is its
    hard negative, None when the query has none."""
    by_query: Dict[str, Dict[str, List[str]]] = {}
    qtext: Dict[str, str] = {}
    for r in rows:
        q = r.get("query_id") or r.get("query_text", "")
        qtext[q] = r.get("query_text") or q
        bucket = by_query.setdefault(q, {"pos": [], "neg": []})
        try:
            label = float(r.get("label", "0"))
        except ValueError:
            continue
        bucket["pos" if label > 0 else "neg"].append(
            r.get("chunk_text") or r.get("document", ""))
    pairs: List[Tuple[str, str]] = []
    hard: List[Optional[str]] = []
    for q, bucket in by_query.items():
        negs = bucket["neg"]
        for i, pos in enumerate(bucket["pos"]):
            pairs.append((qtext[q], pos))
            hard.append(negs[i % len(negs)] if negs else None)
    return pairs, hard


def mining_inputs_from_labeled_rows(
    rows: Sequence[Dict[str, str]],
    pairs: Sequence[Tuple[str, str]],
) -> Tuple[List[str], List[List[int]]]:
    """The mining corpus (every distinct chunk text of ``rows``) and, per
    pair of :func:`pairs_from_labeled_rows`, the corpus rows labeled
    positive for its query, so re-mining never picks a known positive."""
    corpus: List[str] = []
    idx: Dict[str, int] = {}
    pos_by_q: Dict[str, set] = {}
    for r in rows:
        text = r.get("chunk_text") or r.get("document", "")
        if not text:
            continue
        if text not in idx:
            idx[text] = len(corpus)
            corpus.append(text)
        try:
            label = float(r.get("label", "0"))
        except ValueError:
            continue
        if label > 0:
            # the query string pairs carry: query_text, else query_id
            q = r.get("query_text") or r.get("query_id") or ""
            pos_by_q.setdefault(q, set()).add(idx[text])
    relevant = [sorted(pos_by_q.get(q, ())) for q, _ in pairs]
    return corpus, relevant


def adamw_for(encoder: SentenceEncoder, total_steps: int,
              learning_rate: float, warmup_frac: float,
              weight_decay: float) -> Optimizer:
    """Both encoder trainers' optimizer: AdamW on the float32 masters with
    optax's warmup-cosine schedule, to a tenth of the peak."""
    schedule = warmup_cosine_decay_schedule(
        0.0, learning_rate, max(1, int(total_steps * warmup_frac)),
        max(2, total_steps), learning_rate * 0.1)
    return Optimizer(dict(encoder.master.named_parameters()), "adamw",
                     schedule, weight_decay=weight_decay)


def reduce_gradients(encoder: SentenceEncoder,
                     params: Dict[str, torch.Tensor]) -> None:
    """Sum the float32 masters' gradients over the processes of the
    encoder's mesh in one flat bucket (``core.distributed.all_reduce_flat``)
    so that every process takes the same step; a parameter without a
    gradient takes zeros, as the optimizer's step would give it. A no-op
    inside one process."""
    mesh = encoder.mesh
    if mesh is None or mesh.group is None:
        return
    for p in params.values():
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    all_reduce_flat(mesh, [p.grad for p in params.values()])


def train_step(encoder: SentenceEncoder, opt: Optimizer, loss_fn,
               batch: Sequence[torch.Tensor], generator) -> torch.Tensor:
    """Both encoder trainers' step on an uploaded batch: the gradients
    zeroed, the loss (``loss_fn(params, *batch, generator)``), its
    backward, the gradients' sum over the processes, and the optimizer's
    update. Returns the loss, detached and left on the device."""
    params = opt.params
    opt.zero_grad()
    with profiling.span("train.forward"):
        loss = loss_fn(params, *batch, generator)
    with profiling.span("train.backward"):
        loss.backward()
    with profiling.span("train.reduce"):
        reduce_gradients(encoder, params)
    with profiling.span("train.optimizer_step"):
        opt.step()
    return loss.detach()


class ContrastiveEncoderTrainer:
    """Train a SentenceEncoder's float32 masters with InfoNCE::

        enc = SentenceEncoder(cfg)
        ContrastiveEncoderTrainer(enc, ContrastiveConfig()).fit(pairs, negs)
        save_encoder(enc, "/path/to/ckpt")
    """

    def __init__(self, encoder: SentenceEncoder,
                 cfg: ContrastiveConfig = ContrastiveConfig(),
                 total_steps: Optional[int] = None) -> None:
        self.encoder = encoder
        self.cfg = cfg
        self._total_steps = total_steps  # resolved in fit() when None

    def _tokenize(self, texts: Sequence[str], max_len: int):
        ids, mask = self.encoder.tokenizer.encode_batch(texts,
                                                        max_len=max_len)
        return ids.astype(np.int64), mask.astype(np.int64)

    def _loss(self, params, q_ids, q_mask, c_ids, c_mask, gen):
        enc, cfg = self.encoder, self.cfg
        q = enc.train_forward(q_ids, q_mask, params, generator=gen)
        # chunk rows: [pos_0..pos_B-1] or [pos_0..pos_B-1, neg_0..neg_B-1];
        # column i is query i's positive, every other column a negative
        c = enc.train_forward(c_ids, c_mask, params, generator=gen)
        b = q.shape[0]
        logits = (q @ c.T) / cfg.temperature
        labels = torch.arange(b, device=q.device)
        l_qc = F.cross_entropy(logits, labels)
        if cfg.symmetric:
            return 0.5 * (l_qc + F.cross_entropy(logits[:, :b].T, labels))
        return l_qc

    def fit(self, pairs: Sequence[Tuple[str, str]],
            hard_negatives: Optional[Sequence[Optional[str]]] = None,
            eval_fn=None) -> List[Dict[str, float]]:
        """Train on (query, positive) pairs; updates the encoder's masters
        and, after each epoch, its serving module. ``hard_negatives[i]``
        (optional) is pair i's explicit negative; None reuses its positive.
        ``eval_fn(encoder)``, when given, is recorded after each epoch."""
        cfg, enc = self.cfg, self.encoder
        n = len(pairs)
        if n == 0:
            raise ValueError("no training pairs")
        use_hn = cfg.use_hard_negatives and hard_negatives is not None
        bsz = min(cfg.batch_size, n)
        steps_per_epoch = -(-n // bsz)
        total = self._total_steps or steps_per_epoch * cfg.epochs
        # sequence lengths are capped by the encoder's position table
        len_q = min(cfg.max_len_query, enc.cfg.max_len)
        len_c = min(cfg.max_len_chunk, enc.cfg.max_len)
        with profiling.span("train.tokenize"):
            q_ids, q_mask = self._tokenize([p[0] for p in pairs], len_q)
            c_ids, c_mask = self._tokenize([p[1] for p in pairs], len_c)
            if use_hn:
                n_ids, n_mask = self._tokenize(
                    [hn if hn is not None else pairs[i][1]
                     for i, hn in enumerate(hard_negatives)], len_c)

        with profiling.span("train.optimizer"):
            opt = adamw_for(enc, total, cfg.learning_rate, cfg.warmup_frac,
                            cfg.weight_decay)
        history: List[Dict[str, float]] = []
        for epoch in range(cfg.epochs):
            t0 = time.perf_counter()
            order = np.random.default_rng(cfg.seed + epoch).permutation(n)
            losses = []
            for si, s in enumerate(range(0, n, bsz)):
                with profiling.span("train.step", {"epoch": epoch,
                                                   "step": si}):
                    with profiling.span("train.upload"):
                        sel = order[s: s + bsz]
                        if len(sel) < bsz:  # wrap-around, as in pairs.py
                            sel = np.concatenate(
                                [sel, np.resize(order, bsz - len(sel))])
                        bc_ids, bc_mask = c_ids[sel], c_mask[sel]
                        if use_hn:
                            bc_ids = np.concatenate([bc_ids, n_ids[sel]])
                            bc_mask = np.concatenate([bc_mask, n_mask[sel]])
                        up = [torch.from_numpy(x).to(enc.device,
                                                     non_blocking=True)
                              for x in (q_ids[sel], q_mask[sel], bc_ids,
                                        bc_mask)]
                    gen = dropout_generator(enc.device, cfg.seed, epoch, si)
                    losses.append(train_step(enc, opt, self._loss, up, gen))
            with profiling.span("train.sync"):
                enc.sync()
                loss = float(torch.stack(losses).mean())
            row: Dict[str, float] = {
                "epoch": epoch,
                "loss": loss,
                "time_s": time.perf_counter() - t0,
            }
            if eval_fn is not None:
                row["eval"] = float(eval_fn(enc))
            history.append(row)
            logger.info("contrastive epoch %d: %s", epoch, row)
        return history


def mine_hard_negatives(
    encoder: SentenceEncoder,
    queries: Sequence[str],
    corpus_texts: Sequence[str],
    relevant_idx: Sequence[Sequence[int]],
    rank_floor: int = 0,
) -> List[str]:
    """For each query, the highest-scoring corpus text that is not in its
    ``relevant_idx`` row under the current encoder (the ANCE-style
    refresh); ``rank_floor`` skips that many top non-relevant hits. The
    scores are the host product of the encoded rows, so the same encoder
    picks the same negatives as the JAX package's."""
    if len(queries) != len(relevant_idx):
        raise ValueError(
            f"{len(queries)} queries vs {len(relevant_idx)} relevance rows")
    # one query text repeats once per positive: encode each distinct once
    uniq, inverse = np.unique(np.asarray(queries, dtype=object),
                              return_inverse=True)
    qe = encoder.encode([str(q) for q in uniq])[inverse]
    de = encoder.encode(list(corpus_texts))
    scores = qe @ de.T
    out: List[str] = []
    for i, rel in enumerate(relevant_idx):
        row = scores[i].copy()
        rel_rows = np.asarray(list(rel), dtype=np.int64)
        if rel_rows.size:
            row[rel_rows] = -np.inf
        order = np.argsort(-row)
        pick = order[min(rank_floor, len(order) - 1)]
        out.append(corpus_texts[int(pick)])
    return out


def fit_with_mining(
    encoder: SentenceEncoder,
    cfg: ContrastiveConfig,
    pairs: Sequence[Tuple[str, str]],
    corpus_texts: Sequence[str],
    relevant_idx: Sequence[Sequence[int]],
    initial_negatives: Optional[Sequence[Optional[str]]] = None,
    rounds: int = 2,
    rank_floor: int = 0,
) -> List[Dict[str, float]]:
    """``rounds`` training stages of ``cfg.epochs`` each: stage 0 on
    ``initial_negatives``, every later stage on negatives re-mined from the
    current encoder (:func:`mine_hard_negatives`), stage r seeded ``seed +
    101 r``. Returns the concatenated history with a ``round`` per row."""
    if rounds < 1:
        raise ValueError("rounds must be >= 1")
    history: List[Dict[str, float]] = []
    negs = initial_negatives
    queries = [p[0] for p in pairs]
    for r in range(rounds):
        if r > 0:
            negs = mine_hard_negatives(encoder, queries, corpus_texts,
                                       relevant_idx, rank_floor=rank_floor)
        stage_cfg = dataclasses.replace(cfg, seed=cfg.seed + 101 * r)
        hist = ContrastiveEncoderTrainer(encoder, stage_cfg).fit(
            pairs, hard_negatives=negs)
        for row in hist:
            row["round"] = r
        history.extend(hist)
    return history


def save_encoder(encoder: SentenceEncoder, path: str) -> str:
    """Write the encoder's float32 masters as the flax tree ``{"params":
    ...}`` with its config in the metadata, in the npz layout
    (``core/checkpoint.py``), which the JAX package's ``load_encoder``
    reads; a trained subword tokenizer goes beside it as
    ``tokenizer.json``. On a mesh across processes (whose masters are
    equal) only the primary process writes, and every process returns
    after the write."""
    cfg = encoder.cfg
    group = encoder.mesh.group if encoder.mesh is not None else None
    if group is None or is_primary():
        save_checkpoint(
            path,
            {"params": encoder_flax_tree(encoder.master.state_dict(),
                                         cfg.num_layers, cfg.num_heads)},
            metadata={"encoder_config": dataclasses.asdict(cfg),
                      "kind": "sentence_encoder"})
        if hasattr(encoder.tokenizer, "save"):
            encoder.tokenizer.save(os.path.join(path, "tokenizer.json"))
    if group is not None:
        torch.distributed.barrier(group=group)
    return path


def load_encoder(path: str, device="cuda", mesh=None) -> SentenceEncoder:
    """A SentenceEncoder from a checkpoint :func:`save_encoder` or the JAX
    package's ``save_encoder`` wrote (npz layout everywhere, orbax where
    ``tensorstore`` is installed), with its ``tokenizer.json`` when one was
    saved; on ``mesh`` when given."""
    meta = load_metadata(path) or {}
    cfg_dict = meta.get("encoder_config")
    if not cfg_dict:
        raise FileNotFoundError(f"no encoder metadata at {path}")
    cfg = EncoderConfig(**cfg_dict)
    tokenizer = None
    tok_path = os.path.join(path, "tokenizer.json")
    if os.path.exists(tok_path):
        from ..models.subword import SubwordTokenizer

        tokenizer = SubwordTokenizer.load(tok_path)
    params = restore_checkpoint(path)["params"]
    return SentenceEncoder(cfg, device=device, tokenizer=tokenizer,
                           state_dict=flax_to_state_dict(params,
                                                         cfg.num_layers),
                           mesh=mesh)
