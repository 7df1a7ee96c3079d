"""Reranker training: pairwise losses, optax optimizers, eval, checkpoints.

The port's counterpart of ``semanticsearch_tpu/train/trainer.py``: one
training step per pairwise-group batch (``train/pairs.py``), adadelta or
adam with optional global-norm clipping (``train/optim.py``),
RankHinge / RankCrossEntropy / margin-MSE distillation, per-epoch IR
metrics, best-epoch selection with patience, out-of-memory batch halving,
and step and epoch checkpoints in the JAX package's npz layout
(``core/checkpoint.py``) with the optimizer state as optax's tree, so a
run started by one package resumes in the other.

Parameters are the model's ``state_dict``; "params" below means one. The
port's init is its own (flax's cannot be reproduced): the model built
under ``torch.manual_seed(seed)``, LSTM ``bias_ih`` zero and frozen (flax's
LSTM cell has one bias per gate, which the converter puts in ``bias_hh``),
then the embedding matrix, then ``warm_start_fn``. Dropout masks of step
(epoch, i) come from a generator seeded by (seed, epoch, i), so a resumed
run replays the uninterrupted one.
"""
from __future__ import annotations

import dataclasses
import os
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
from torch.nn import functional as F

from ..core.checkpoint import load_metadata, restore_checkpoint, save_checkpoint
from ..core.config import TrainConfig
from ..core.logging import get_logger
from ..models.convert import reranker_flax_tree, reranker_tensors
from ..models.encoder import (_is_oom, _resolve_device, dropout_generator,
                              set_dropout_generator)
from ..models.rerankers import make_model
from .metrics import evaluate_ranking
from .optim import Optimizer
from .pairs import PairDataset

logger = get_logger("train")

Params = Dict[str, torch.Tensor]


# --------------------------------------------------------------------- losses

def rank_hinge_loss(scores: torch.Tensor, group_size: int,
                    margin: float = 1.0) -> torch.Tensor:
    """Pairwise hinge over groups of rows [pos, neg_1..neg_k]: the mean
    over (pos, neg) pairs of max(0, margin - (s_pos - s_neg))."""
    g = scores.reshape(-1, group_size)
    return torch.clamp(margin - (g[:, :1] - g[:, 1:]), min=0.0).mean()


def rank_xent_loss(scores: torch.Tensor, group_size: int) -> torch.Tensor:
    """RankCrossEntropy: softmax over each group, NLL of the positive."""
    g = scores.reshape(-1, group_size)
    return -F.log_softmax(g, dim=-1)[:, 0].mean()


def margin_mse_loss(scores: torch.Tensor, teacher: torch.Tensor,
                    group_size: int, scale: float = 1.0) -> torch.Tensor:
    """Margin-MSE distillation: mean((s_pos - s_neg) - scale (t_pos -
    t_neg))^2 over each group's (pos, neg) pairs."""
    g = scores.reshape(-1, group_size)
    t = teacher.reshape(-1, group_size)
    return (((g[:, :1] - g[:, 1:]) - (t[:, :1] - t[:, 1:]) * scale) ** 2
            ).mean()


def make_optimizer(cfg: TrainConfig, params: Dict[str, torch.Tensor]
                   ) -> Optimizer:
    """adam (default rate 1e-3) or adadelta (1.0), behind global-norm
    clipping when ``cfg.clip_norm`` is set; an explicit rate is used as
    given."""
    lr = cfg.learning_rate
    if cfg.optimizer == "adam":
        lr = 1e-3 if lr is None else lr
    elif cfg.optimizer == "adadelta":
        lr = 1.0 if lr is None else lr
    else:
        raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
    return Optimizer(params, cfg.optimizer, lr, clip_norm=cfg.clip_norm)


@dataclass
class TrainResult:
    params: Params
    history: List[Dict[str, float]] = field(default_factory=list)
    best_metrics: Dict[str, float] = field(default_factory=dict)


def _frozen(name: str) -> bool:
    """LSTM input biases: flax's cell has none, so they stay zero."""
    return ".bias_ih_l0" in name


class RerankTrainer:
    """Train one reranker on a PairDataset on ``device``; evaluate
    point-mode with IR metrics."""

    def __init__(
        self,
        model_name: str,
        vocab_size: int,
        cfg: TrainConfig = TrainConfig(),
        model_kwargs: Optional[Dict] = None,
        embedding_matrix=None,
        warm_start_fn: Optional[Callable[[Params], Params]] = None,
        device="cuda",
    ) -> None:
        """``embedding_matrix`` (vocab_size, embed_dim) replaces the
        table's random init (``train/embeddings.py``); ``warm_start_fn``
        (state_dict -> state_dict) runs last in :meth:`init_params`, e.g.
        ``transfer_from_encoder`` for the cross-encoder."""
        self.cfg = cfg
        self.device = _resolve_device(device)
        self._model_name = model_name
        self._vocab_size = vocab_size
        self._embedding_matrix = embedding_matrix
        self._warm_start_fn = warm_start_fn
        # kept for the checkpoint's metadata: evaluate_saved_model rebuilds
        # the same architecture from it
        self._model_kwargs = dict(model_kwargs or {})
        self.model = self._build().to(self.device)
        self._loss_fn = (rank_xent_loss if cfg.loss == "rank_xent"
                         else rank_hinge_loss)
        self._distill = cfg.distill_weight > 0.0

    def _build(self) -> torch.nn.Module:
        return make_model(self._model_name, vocab_size=self._vocab_size,
                          embed_dim=self.cfg.embedding_dim,
                          **self._model_kwargs)

    def init_params(self, dataset: PairDataset, seed: Optional[int] = None
                    ) -> Params:
        """The seeded initial ``state_dict`` (on the CPU): the model built
        under ``seed`` (default ``cfg.seed``), materialized on the
        dataset's first two rows, LSTM input biases zero, then the
        embedding matrix, then ``warm_start_fn``."""
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(self.cfg.seed if seed is None else seed)
            model = self._build()
            with torch.no_grad():  # materializes ArcII's lazy head
                model(torch.from_numpy(dataset.left[:2]).long(),
                      torch.from_numpy(dataset.right[:2]).long())
        params = {k: v.detach().clone() for k, v in model.state_dict().items()}
        for k, v in params.items():
            if _frozen(k):
                v.zero_()
        if self._embedding_matrix is not None:
            from .embeddings import apply_embedding_init

            params = apply_embedding_init(params, self._embedding_matrix)
        if self._warm_start_fn is not None:
            params = self._warm_start_fn(params)
        return params

    def _scores(self, dataset: PairDataset, batch_size: int = 128
                ) -> np.ndarray:
        """The current model's scores of every row (point mode)."""
        out = np.zeros(dataset.left.shape[0], np.float32)
        self.model.eval()
        with torch.no_grad():
            for batch in dataset.iter_point_batches(batch_size):
                scores = self.model(
                    torch.from_numpy(batch["left"]).long().to(self.device),
                    torch.from_numpy(batch["right"]).long().to(self.device)
                ).float().cpu().numpy()
                valid = batch["valid"]
                out[batch["row_ids"][valid]] = scores[valid]
        return out

    def predict(self, params: Params, dataset: PairDataset,
                batch_size: int = 128) -> np.ndarray:
        self.model.load_state_dict(params)
        return self._scores(dataset, batch_size)

    def evaluate(self, params: Params, dataset: PairDataset,
                 metrics=None) -> Dict[str, float]:
        return evaluate_ranking(
            dataset.query_ids, dataset.labels, self.predict(params, dataset),
            metrics=metrics or self.cfg.eval_metrics)

    def _tree(self, tensors: Optional[Params] = None) -> Dict[str, Any]:
        """The flax tree of the model's parameters, or of ``tensors``
        keyed like them (zero for the frozen ones)."""
        if tensors is None:
            return reranker_flax_tree(self.model)
        full = {k: torch.zeros_like(v)
                for k, v in self.model.state_dict().items()}
        full.update(tensors)
        return reranker_flax_tree(self.model, full)

    def _step(self, opt: Optimizer, batch: Dict, gen: torch.Generator
              ) -> torch.Tensor:
        cfg, model = self.cfg, self.model
        left = torch.from_numpy(batch["left"]).long().to(self.device)
        right = torch.from_numpy(batch["right"]).long().to(self.device)
        set_dropout_generator(model, gen)
        model.train()
        try:
            scores = model(left, right)
            loss = self._loss_fn(scores, batch["group_size"])
            if self._distill and "teacher" in batch:
                teacher = torch.from_numpy(batch["teacher"]).to(self.device)
                mse = margin_mse_loss(scores, teacher, batch["group_size"],
                                      cfg.distill_scale)
                loss = (1.0 - cfg.distill_weight) * loss \
                    + cfg.distill_weight * mse
            opt.zero_grad()
            loss.backward()
            opt.step()
        finally:
            model.eval()
            set_dropout_generator(model, None)
        return loss.detach()

    def fit(
        self,
        train_ds: PairDataset,
        test_ds: Optional[PairDataset] = None,
        checkpoint_dir: Optional[str] = None,
        resume_from: Optional[str] = None,
        checkpoint_every: Optional[int] = None,
        checkpoint_every_steps: Optional[int] = None,
    ) -> TrainResult:
        """Train; checkpoint every N epochs (``checkpoint_every``) or
        steps (``checkpoint_every_steps``) and resume from either. A step
        checkpoint holds the cursor (epoch, step in epoch): the pair
        sampler is deterministic in (seed, epoch), so resume continues
        with the next batch of the same stream; the global step and the
        batch size it was taken at come back from its metadata."""
        cfg = self.cfg
        if self._distill and train_ds.teacher is None:
            raise ValueError(
                "distill_weight > 0 but the training PairDataset carries no "
                "`teacher` scores — attach per-row teacher scores (e.g. the "
                "trained encoder's cosine for each (query, doc) row) or set "
                "distill_weight=0. Refusing to silently train undistilled.")
        self.model.load_state_dict(self.init_params(train_ds))
        trainable = {}
        for name, p in self.model.named_parameters():
            p.requires_grad_(not _frozen(name))
            if not _frozen(name):
                trainable[name] = p
        opt = make_optimizer(cfg, trainable)
        start_epoch, resume_step_in_epoch, step = 0, -1, 0
        batch_size = cfg.batch_size
        if resume_from:
            meta = load_metadata(resume_from) or {}
            has_cursor = "step_in_epoch" in meta
            state = restore_checkpoint(resume_from)
            tensors = reranker_tensors(self.model, state["params"])
            self.model.load_state_dict(tensors)
            opt.load_state_tree(state["opt_state"],
                                lambda t: reranker_tensors(self.model, t),
                                count=meta.get("global_step", 0))
            if has_cursor:  # mid-epoch: continue the same epoch
                start_epoch = int(np.asarray(state["epoch"]))
                resume_step_in_epoch = int(np.asarray(state["step_in_epoch"]))
            else:
                start_epoch = int(np.asarray(state["epoch"])) + 1
            # the step numbering continues, and the cursor counts batches
            # of the size that produced it (it may have been OOM-halved)
            step = int(meta.get("global_step", 0))
            saved_bs = meta.get("batch_size")
            if saved_bs is not None and int(saved_bs) != batch_size:
                logger.warning(
                    "resume: checkpoint was written at batch_size=%d "
                    "(config says %d); using the checkpoint's so the "
                    "step-in-epoch cursor skips the right batches",
                    int(saved_bs), batch_size)
                batch_size = int(saved_bs)
        length_buckets = tuple(cfg.length_buckets or ())
        if length_buckets and not getattr(self.model, "length_bucketable",
                                          True):
            logger.warning("%s has length-dependent parameters; ignoring "
                           "length_buckets=%s", type(self.model).__name__,
                           length_buckets)
            length_buckets = ()
        name = type(self.model).__name__
        history: List[Dict[str, float]] = []
        best: Dict[str, float] = {}
        best_params = None
        epochs_since_best = 0
        for epoch in range(start_epoch, cfg.epochs):
            t0 = time.perf_counter()
            losses: List = []
            skip_through = resume_step_in_epoch if epoch == start_epoch \
                else -1
            while True:  # out-of-memory batch halving
                try:
                    for step_in_epoch, batch in enumerate(
                            train_ds.iter_pair_batches(
                                batch_size=batch_size, num_dup=cfg.num_dup,
                                num_neg=cfg.num_neg, seed=cfg.seed,
                                epoch=epoch, resample=True,
                                length_buckets=length_buckets)):
                        if step_in_epoch <= skip_through:
                            continue  # trained before the resume
                        gen = dropout_generator(self.device, cfg.seed, epoch,
                                                step_in_epoch)
                        losses.append(self._step(opt, batch, gen))
                        step += 1
                        if checkpoint_dir and checkpoint_every_steps and (
                                step % checkpoint_every_steps == 0):
                            save_checkpoint(
                                os.path.join(checkpoint_dir, f"step_{step}"),
                                {"params": self._tree(),
                                 "opt_state": opt.state_tree(self._tree),
                                 "epoch": epoch,
                                 "step_in_epoch": step_in_epoch},
                                metadata={"model": name, "epoch": epoch,
                                          "step_in_epoch": step_in_epoch,
                                          "global_step": step,
                                          "batch_size": batch_size})
                    if losses:  # one fetch per epoch
                        losses = torch.stack(losses).cpu().tolist()
                    break
                except Exception as exc:
                    if not _is_oom(exc) or batch_size <= 1:
                        raise
                    batch_size = max(1, batch_size // 2)
                    losses = []
                    if skip_through >= 0:
                        # the cursor counts batches of the old size, and
                        # the batch plan is not a prefix-stable function of
                        # the size: retrain this epoch from step 0
                        logger.warning(
                            "OOM halved batch_size under a resume cursor; "
                            "restarting epoch %d from step 0", epoch)
                        skip_through = -1
                    logger.warning("OOM at epoch %d; retrying with "
                                   "batch_size=%d", epoch, batch_size)
            if not losses:
                if skip_through >= 0:
                    continue  # resumed exactly at this epoch's end
                raise RuntimeError(
                    "epoch ran 0 training steps: the dataset has no pairable "
                    "queries (every query needs at least one positive and one "
                    "negative example). Refusing to continue silently.")
            row: Dict[str, float] = {"epoch": epoch,
                                     "loss": float(np.mean(losses)),
                                     "time_s": time.perf_counter() - t0}
            if not np.isfinite(row["loss"]):
                logger.warning(
                    "epoch %d: NON-FINITE loss %s — training diverged "
                    "(check embedding init / learning rate); metrics from "
                    "this epoch are meaningless", epoch, row["loss"])
            if test_ds is not None:
                row.update(evaluate_ranking(
                    test_ds.query_ids, test_ds.labels, self._scores(test_ds),
                    metrics=cfg.eval_metrics))
                key = cfg.eval_metrics[0] if cfg.eval_metrics else "map"
                cur = row.get(key, 0.0)
                prev = best.get(key, -1.0) if best else -1.0
                if cur >= prev:
                    # a tie keeps the later epoch but does not reset the
                    # patience counter
                    best = {m: row[m] for m in cfg.eval_metrics if m in row}
                    best_params = {k: v.detach().clone() for k, v in
                                   self.model.state_dict().items()}
                    epochs_since_best = (0 if cur > prev
                                         else epochs_since_best + 1)
                else:
                    epochs_since_best += 1
            history.append(row)
            logger.info("epoch %d: %s", epoch, row)
            if checkpoint_dir and checkpoint_every and (
                    (epoch + 1) % checkpoint_every == 0):
                save_checkpoint(
                    os.path.join(checkpoint_dir, f"epoch_{epoch}"),
                    {"params": self._tree(),
                     "opt_state": opt.state_tree(self._tree),
                     "epoch": epoch},
                    metadata={"model": name, "epoch": epoch,
                              "global_step": step, "batch_size": batch_size})
            # after the periodic save, so the stopping epoch stays resumable
            if (cfg.keep_best and cfg.patience
                    and epochs_since_best >= cfg.patience):
                logger.info("early stop at epoch %d: no %s improvement for "
                            "%d epochs", epoch, cfg.eval_metrics[0]
                            if cfg.eval_metrics else "map", cfg.patience)
                break
        if cfg.keep_best and test_ds is not None and best_params is not None:
            self.model.load_state_dict(best_params)
        if checkpoint_dir:
            save_checkpoint(
                checkpoint_dir, {"params": self._tree()},
                metadata={"model": name,
                          "config": dataclasses.asdict(cfg) | {
                              "eval_metrics": list(cfg.eval_metrics)},
                          "model_kwargs": self._model_kwargs})
        params = {k: v.detach().clone()
                  for k, v in self.model.state_dict().items()}
        return TrainResult(params=params, history=history, best_metrics=best)
