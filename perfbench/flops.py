"""The yardstick's arithmetic: the card's published peaks, the least time
a piece of work can take on it, and the operations of the work the cells
run.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at the full
700 W): 989 TFLOP/s bf16 and fp16, 495 TFLOP/s TF32 (the rate f32 work
reaches on the tensor cores), 1,979 TOP/s int8, 67 TFLOP/s f32 outside the
tensor cores, 3.35 TB/s of HBM3. A share of a peak reads the same work
against the same published rate whatever implements it: an f32 product
the program splits into three TF32 products counts once.
"""
from __future__ import annotations

from typing import Iterable, Tuple

PEAKS = {
    "bf16": 989e12,
    "fp16": 989e12,
    "tf32": 495e12,
    "int8": 1979e12,
    "f32": 67e12,
}
PEAK_BYTES_PER_S = 3.35e12


def bound_s(ops: float, nbytes: float, peak: str) -> Tuple[float, str]:
    """The least time on the card: operations at ``peak`` or bytes at the
    HBM rate, whichever is longer, and which one it was."""
    t_ops, t_mem = ops / PEAKS[peak], nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_mem), ("operations" if t_ops >= t_mem else "bytes")


def topk_ops_bytes(q: int, n: int, d: int, k: int, corpus_itemsize: int,
                   query_itemsize: int = 4) -> Tuple[float, float]:
    """An exact top-k of ``q`` queries over ``n`` rows of width ``d``: the
    score products, and each input byte read once and each output byte
    written once (k scores and k ids a query)."""
    ops = 2.0 * q * n * d
    nbytes = (float(n) * d * corpus_itemsize + float(q) * d * query_itemsize
              + 8.0 * q * k)
    return ops, nbytes


def encoder_layer_macs_per_token(hidden: int, mlp: int) -> int:
    """Multiply-adds of one pre-LN block's dense layers for one token: the
    four attention projections and the two MLP layers."""
    return 4 * hidden * hidden + 2 * hidden * mlp


def encoder_forward_ops(cfg: dict, lengths: Iterable[int]) -> float:
    """Forward operations of the encoder over sequences of these real
    token counts (padding excluded): every block's dense layers a token,
    and its two attention products over the real keys (``4 n^2 h`` a
    sequence of ``n`` tokens). Embedding lookups, norms, pooling and
    elementwise work are not counted."""
    h, mlp, layers = (cfg["hidden_size"], cfg["intermediate_size"],
                      cfg["num_hidden_layers"])
    per_tok = 2.0 * encoder_layer_macs_per_token(h, mlp)
    tokens = 0.0
    attn = 0.0
    for n in lengths:
        tokens += n
        attn += 4.0 * n * n * h
    return layers * (per_tok * tokens + attn)


def encoder_weight_bytes(cfg: dict, itemsize: int) -> float:
    """The bytes of the blocks' dense weights, read once."""
    h, mlp, layers = (cfg["hidden_size"], cfg["intermediate_size"],
                      cfg["num_hidden_layers"])
    return float(layers * encoder_layer_macs_per_token(h, mlp) * itemsize)


def train_step_ops(cfg: dict, lengths: Iterable[int]) -> float:
    """A training step's operations over sequences of these real token
    counts: the forward and a backward of twice its operations."""
    return 3.0 * encoder_forward_ops(cfg, lengths)
