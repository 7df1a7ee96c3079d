"""Cross-validation evaluation: train and score rerankers per fold.

The port's counterpart of ``semanticsearch_tpu/train/evaluate.py``: each
model is trained on every fold's train file (``data/folds.py``) with its own
``Preprocessor`` fit there, scored on the fold's test file with the
18-metric task, and aggregated to mean and std per metric; checkpoints
carry the model name, config and architecture in their metadata, so
:func:`evaluate_saved_model` rebuilds the model from the directory alone
(JAX-written and port-written alike). ``embedding_init_path`` takes a
GloVe-format file or ``encoder:<dir>``, a trained sentence encoder whose
float32 master token table seeds the reranker's (and whose whole block
stack warm-starts the cross-encoder).
"""
from __future__ import annotations

import csv
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..core.checkpoint import load_metadata, restore_checkpoint
from ..core.config import TrainConfig
from ..core.logging import get_logger
from ..data.folds import FoldPaths, load_fold_rows
from ..models.convert import reranker_tensors
from .metrics import DEFAULT_METRICS
from .pairs import PairDataset
from .trainer import RerankTrainer
from .vocab import Preprocessor

logger = get_logger("evaluate")


def dataset_from_fold(path: str, preprocessor: Preprocessor) -> PairDataset:
    rows = load_fold_rows(path)
    enc = preprocessor.transform_pair(rows["query_texts"], rows["chunk_texts"])
    return PairDataset(
        left=enc["left"], right=enc["right"],
        labels=np.asarray(rows["labels"], np.float32),
        query_ids=np.asarray(rows["query_ids"]),
    )


@dataclass
class CVResult:
    model: str
    per_fold: List[Dict[str, float]]
    # each fold's training history (epoch rows with loss and time)
    train_history: List[List[Dict[str, float]]] = field(default_factory=list)

    def mean_std(self) -> Dict[str, Dict[str, float]]:
        out: Dict[str, Dict[str, float]] = {}
        if not self.per_fold:
            return out
        for metric in self.per_fold[0]:
            vals = [f[metric] for f in self.per_fold]
            out[metric] = {"mean": float(np.mean(vals)),
                           "std": float(np.std(vals))}
        return out


class CVEvaluator:
    """Train and evaluate models across CV folds on ``device``, and
    aggregate."""

    def __init__(self, folds: Sequence[FoldPaths],
                 metrics: Sequence[str] = DEFAULT_METRICS,
                 device="cuda") -> None:
        self.folds = list(folds)
        self.metrics = tuple(metrics)
        self.device = device

    @staticmethod
    def _embedding_init(model_name: str, cfg: TrainConfig,
                        model_kwargs: Dict, pp: Preprocessor, sub_tok):
        """(embedding matrix, warm-start function) of ``cfg``'s
        ``embedding_init_path``."""
        path = cfg.embedding_init_path
        if not path:
            return None, None
        if path.startswith("encoder:"):
            from ..models.rerankers import transfer_from_encoder
            from .embeddings import encoder_token_embeddings
            from .encoder_train import load_encoder

            if sub_tok is None:
                raise ValueError(
                    "embedding_init_path='encoder:...' requires "
                    "subword_tokenizer_path (the reranker must share "
                    "the encoder's subword id space)")
            enc = load_encoder(path[len("encoder:"):], device="cpu")
            emb_init = encoder_token_embeddings(enc)
            if emb_init.shape != (pp.vocab_size, cfg.embedding_dim):
                raise ValueError(
                    f"encoder token table {emb_init.shape} does not "
                    f"match (vocab_size={pp.vocab_size}, "
                    f"embedding_dim={cfg.embedding_dim}); set "
                    "train.embedding_dim to the encoder hidden size "
                    "and use the encoder's tokenizer")
            if model_name.lower().replace("-", "_") != "cross_encoder":
                return emb_init, None
            # the cross-encoder shares the encoder's block structure: the
            # whole stack starts from the float32 masters

            def warm_start(params, _enc=enc.master):
                from ..models.rerankers import make_model

                model = make_model(model_name, vocab_size=pp.vocab_size,
                                   embed_dim=cfg.embedding_dim,
                                   **model_kwargs)
                model.load_state_dict(params)
                return transfer_from_encoder(model, _enc)

            return emb_init, warm_start
        if sub_tok is not None:
            # a word-vector file has no keys for subword piece ids
            raise ValueError(
                "embedding_init_path with a word-vector file does "
                "not compose with subword_tokenizer_path (piece "
                "ids have no word keys) — use the 'encoder:<ckpt>'"
                " scheme for subword-mode init")
        from .embeddings import load_word_embeddings

        return load_word_embeddings(path, pp.vocab, pp.vocab_size,
                                    cfg.embedding_dim, seed=cfg.seed), None

    def run_model(
        self,
        model_name: str,
        cfg: Optional[TrainConfig] = None,
        model_kwargs: Optional[Dict] = None,
        output_dir: Optional[str] = None,
    ) -> CVResult:
        cfg = cfg or TrainConfig(model=model_name)
        sub_tok = None
        if cfg.subword_tokenizer_path:
            from ..models.subword import SubwordTokenizer

            sub_tok = SubwordTokenizer.load(cfg.subword_tokenizer_path)
        per_fold: List[Dict[str, float]] = []
        histories: List[List[Dict[str, float]]] = []
        for k, fold in enumerate(self.folds, 1):
            pp = Preprocessor(
                fixed_length_left=cfg.fixed_length_left,
                fixed_length_right=cfg.fixed_length_right,
                filter_low_freq=cfg.filter_low_freq,
                subword=sub_tok,
            )
            train_rows = load_fold_rows(fold.train)
            pp.fit(train_rows["query_texts"] + train_rows["chunk_texts"])
            train_ds = dataset_from_fold(fold.train, pp)
            test_ds = dataset_from_fold(fold.test, pp)
            emb_init, warm_start = self._embedding_init(
                model_name, cfg, model_kwargs or {}, pp, sub_tok)
            trainer = RerankTrainer(
                model_name, vocab_size=pp.vocab_size, cfg=cfg,
                model_kwargs=model_kwargs, embedding_matrix=emb_init,
                warm_start_fn=warm_start, device=self.device)
            ckpt = (os.path.join(output_dir, model_name, f"fold_{k}")
                    if output_dir else None)
            # keep_best validates on the test fold each epoch, as the
            # reference's own loop does
            result = trainer.fit(
                train_ds, test_ds=test_ds if cfg.keep_best else None,
                checkpoint_dir=ckpt)
            if ckpt:
                pp.save(os.path.join(ckpt, "preprocessor.json"))
            fold_metrics = trainer.evaluate(result.params, test_ds,
                                            metrics=self.metrics)
            logger.info("%s fold %d: %s", model_name, k, fold_metrics)
            per_fold.append(fold_metrics)
            histories.append(result.history)
        return CVResult(model=model_name, per_fold=per_fold,
                        train_history=histories)

    def run_models(
        self,
        model_names: Sequence[str],
        cfgs: Optional[Dict[str, TrainConfig]] = None,
        output_dir: Optional[str] = None,
    ) -> List[CVResult]:
        return [self.run_model(name, cfg=(cfgs or {}).get(name),
                               output_dir=output_dir)
                for name in model_names]


def evaluate_saved_model(
    checkpoint_dir: str,
    test_fold: str,
    metrics: Sequence[str] = DEFAULT_METRICS,
    device="cuda",
) -> Dict[str, float]:
    """Load a saved checkpoint and its preprocessor and evaluate on one
    fold (the reference's artifact-reload path)."""
    meta = load_metadata(checkpoint_dir) or {}
    cfg_dict = dict(meta.get("config", {}))
    cfg_dict["eval_metrics"] = tuple(cfg_dict.get("eval_metrics", ("map",)))
    cfg = TrainConfig(**cfg_dict) if cfg_dict else TrainConfig()
    pp = Preprocessor.load(os.path.join(checkpoint_dir, "preprocessor.json"))
    trainer = RerankTrainer(cfg.model, vocab_size=pp.vocab_size, cfg=cfg,
                            model_kwargs=meta.get("model_kwargs") or {},
                            device=device)
    test_ds = dataset_from_fold(test_fold, pp)
    tree = restore_checkpoint(checkpoint_dir)["params"]
    return trainer.evaluate(reranker_tensors(trainer.model, tree), test_ds,
                            metrics=metrics)


def write_comparison_csv(results: Sequence[CVResult], path: str) -> None:
    """CV mean and std comparison table, one row per model."""
    if not results:
        return
    metrics = list(results[0].per_fold[0].keys()) if results[0].per_fold else []
    with open(path, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(["model"] + [f"{m}_mean" for m in metrics]
                        + [f"{m}_std" for m in metrics])
        for r in results:
            ms = r.mean_std()
            writer.writerow(
                [r.model]
                + [f"{ms[m]['mean']:.4f}" for m in metrics]
                + [f"{ms[m]['std']:.4f}" for m in metrics])


def format_comparison_table(results: Sequence[CVResult],
                            metrics: Sequence[str] = ("map", "ndcg@5")) -> str:
    lines = ["model".ljust(16) + "".join(m.ljust(18) for m in metrics)]
    for r in results:
        ms = r.mean_std()
        cells = [f"{ms[m]['mean']:.4f}±{ms[m]['std']:.4f}".ljust(18)
                 for m in metrics if m in ms]
        lines.append(r.model.ljust(16) + "".join(cells))
    return "\n".join(lines)
