"""The LFM2-MoE encoder's expert layers against their roofline, over the
traced batches of the mining cell: the least time of the routed experts'
work (``flops_lfm2.moe_ops_bytes``: 2 x pairs x 3 x hidden x expert width
at the configuration's peak, or every expert's weights once a layer with
the permuted tokens in and out at the HBM rate) over the device time of
every kernel launched under the program's ``encoder.moe`` spans (routing,
sort, the grouped products and the combine). Pairs and layers are the
program's ``encoder.moe_pairs`` and ``encoder.moe_layers`` counters; a
program without them gives nothing to read."""
from perfbench import spans
from perfbench.flops import bound_s
from perfbench.flops_lfm2 import moe_ops_bytes

LAYER = "encoder"
MOVES = "search_qps"


def read(run):
    s = run.get("trace")
    if s is None or "config" not in run:
        return None
    pairs = spans.counter("encoder.moe_pairs")
    layers = spans.counter("encoder.moe_layers")
    t = spans.device_s(s, "encoder.moe")
    if not pairs or not layers or t <= 0:
        return None
    ops, nbytes = moe_ops_bytes(run["config"], pairs, layers)
    return 100.0 * bound_s(ops, nbytes, run["peak"])[0] / t
