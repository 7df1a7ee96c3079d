"""The dense index's share of its roofline: the least time of an exact
top-k over Q x N x D (its products at the configuration's peak, or each
input byte read once and each output byte written once at the HBM rate),
over the device time of every kernel launched under the benchmark's span
around ``EmbeddingIndex.search_device``. Whatever kernels do the search,
it reads the same work."""
from perfbench.flops import bound_s

LAYER = "dense index"
MOVES = "search_qps"


def read(run):
    s = run.get("trace")
    if s is None or "topk_ops" not in run:
        return None
    t = s.span_device_s.get("search", 0.0)
    if t <= 0:
        return None
    return 100.0 * bound_s(run["topk_ops"], run["topk_bytes"],
                           run["peak"])[0] / t
