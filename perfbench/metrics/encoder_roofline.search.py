"""The encoder's share of its roofline in a search: the least time of the
forward over the real tokens (its dense and attention products at the
configuration's peak, or its weights, the embedding rows of the real
tokens and the pooled output at the HBM rate), over the device time of
every kernel launched under the span around ``encode_device``. Padding to
the length bucket shows here as work the bound does not count."""
from perfbench.flops import bound_s

LAYER = "encoder"
MOVES = "search_qps"


def read(run):
    s = run.get("trace")
    if s is None or "encoder_ops" not in run:
        return None
    t = s.span_device_s.get("encode", 0.0)
    if t <= 0:
        return None
    return 100.0 * bound_s(run["encoder_ops"], run["encoder_bytes"],
                           run["peak"])[0] / t
