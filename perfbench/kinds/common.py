"""Pieces the kinds share: the program's encoder and index built from
the benchmark's weights and corpus, the corpus itself, and small
statistics."""
from __future__ import annotations

import math
from typing import Dict, Sequence

import numpy as np
import torch

from perfbench import traffic


def encoder_config(cfg: dict):
    """The program's ``EncoderConfig`` for a configuration file."""
    from semanticsearch_tpu_torch.core.config import EncoderConfig

    return EncoderConfig(
        vocab_size=cfg["vocab_size"], hidden_dim=cfg["hidden_size"],
        num_layers=cfg["num_hidden_layers"],
        num_heads=cfg["num_attention_heads"],
        mlp_dim=cfg["intermediate_size"],
        max_len=cfg["max_position_embeddings"],
        dropout_rate=cfg["hidden_dropout_prob"], dtype=cfg["dtype"],
        pooling=cfg["pooling"], normalize=True, attention=cfg["attention"])


def index_config(cfg: dict):
    from semanticsearch_tpu_torch.core.config import IndexConfig

    ix = cfg["index"]
    return IndexConfig(embed_dim=cfg["hidden_size"], top_k=ix["top_k"],
                       block_rows=ix["block_rows"],
                       seg_split=ix["seg_split"], dtype=ix["dtype"])


def port_encoder(cfg: dict, weights: Dict[str, torch.Tensor], device):
    """The program's encoder on the benchmark's weights."""
    from semanticsearch_tpu_torch.models.encoder import SentenceEncoder

    return SentenceEncoder(encoder_config(cfg), device=device,
                           state_dict=weights)


def corpus_rows(cfg: dict, seed: int, device) -> torch.Tensor:
    """The dense corpus of ``seed``: standard normal rows (float32) made
    on ``device``, which the index normalizes and stores."""
    ix = cfg["index"]
    g = torch.Generator(device=device).manual_seed(
        traffic.sub_seed(seed, "corpus"))
    return torch.randn(ix["rows"], cfg["hidden_size"], generator=g,
                       device=device)


class Fetcher:
    """A pipelined client's copies to the host: a batch's results are
    copied into pinned host buffers as soon as its work is launched (the
    copy waits on the card for that work only, not for the next batch's,
    which is launched after it), and :meth:`wait` waits for that copy
    alone. Buffers rotate over ``slots`` batches in flight."""

    def __init__(self, device, slots: int = 3) -> None:
        self.cuda = torch.device(device).type == "cuda"
        self.slots = [dict() for _ in range(slots)]
        self.next = 0

    def start(self, tensors):
        if not self.cuda:
            return None, [t.cpu() for t in tensors]
        bufs = self.slots[self.next]
        self.next = (self.next + 1) % len(self.slots)
        out = []
        for j, t in enumerate(tensors):
            b = bufs.get(j)
            if b is None or b.shape != t.shape or b.dtype != t.dtype:
                b = bufs[j] = torch.empty(t.shape, dtype=t.dtype,
                                          pin_memory=True)
            b.copy_(t, non_blocking=True)
            out.append(b)
        ev = torch.cuda.Event()
        ev.record()
        return ev, out

    @staticmethod
    def wait(handle):
        ev, out = handle
        if ev is None:
            return out
        ev.synchronize()
        return [b.clone() for b in out]


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def memory_peak(device) -> int:
    if torch.device(device).type == "cuda":
        return int(torch.cuda.max_memory_allocated(device))
    return 0


def free(device) -> None:
    import gc

    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def report_setup(t_start: float, marks) -> None:
    """One line on standard error: the seconds of each part of set-up,
    from the process's start ("start": imports and argument parsing)."""
    import sys

    parts, last = [], t_start
    for name, t in marks:
        parts.append(f"{name} {t - last:.3f}")
        last = t
    print("set-up parts (s): " + ", ".join(parts), file=sys.stderr)


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile, linear between order statistics."""
    return float(np.percentile(np.asarray(values, np.float64), q))


def finite(x: float, cap: float = 1e9) -> float:
    """A compared number as JSON can hold it: NaN and infinity read as
    ``cap``, which no limit passes."""
    return cap if not math.isfinite(x) else min(float(x), cap)
