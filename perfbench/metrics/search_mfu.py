"""The whole search step's share of the card's peak: the encoder's
operations over the real tokens (padding excluded) and the exact top-k's
2 Q N D, over the traced sub-window, against the configuration's
published peak."""
from perfbench.flops import PEAKS

LAYER = "search step"
MOVES = "search_qps"


def read(run):
    s = run.get("trace")
    if (s is None or "encoder_ops" not in run or s.window_s <= 0
            or s.busy_s <= 0):
        return None
    ops = run["encoder_ops"] + run["topk_ops"]
    return 100.0 * ops / s.window_s / PEAKS[run["peak"]]
