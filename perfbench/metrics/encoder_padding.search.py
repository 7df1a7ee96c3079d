"""The share of the positions the encoder ran that were padding, over the
traced batches of a search: 100 x (1 - real tokens / positions run), from
the program's counters ``encoder.tokens_real`` and ``encoder.tokens_run``
(rows x length bucket of every forward, rows padded to a mesh's shards
included)."""
from perfbench import spans

LAYER = "encoder"
MOVES = "search_qps"


def read(run):
    if run.get("trace") is None:
        return None
    real = spans.counter("encoder.tokens_real")
    positions = spans.counter("encoder.tokens_run")
    if real is None or not positions:
        return None
    return 100.0 * (1.0 - real / positions)
