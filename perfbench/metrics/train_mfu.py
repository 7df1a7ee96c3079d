"""A training step's share of the bf16 peak: the forward and backward
operations of the real tokens (three times the forward's) of the traced
steps, over the traced sub-window."""
from perfbench.flops import PEAKS

LAYER = "training"
MOVES = "train_tokens_per_s"


def read(run):
    s = run.get("trace")
    if s is None or "train_ops" not in run or s.window_s <= 0 \
            or s.busy_s <= 0:
        return None
    return 100.0 * run["train_ops"] / s.window_s / PEAKS[run["peak"]]
