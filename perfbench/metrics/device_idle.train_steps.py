"""The card's idle share over the steps of the traced training call, the
call's one-off work before them (tokenizing, the optimizer's build) left
out: the steps' extent runs from the first ``train.step`` span's start to
the end of the epoch's ``train.sync`` span, whose loss fetch waits for the
card to finish every step (the host's seconds in those spans, which follow
one another). The card was busy in it for the traced sub-window's busy
time less the device time of what was launched under ``train.tokenize``
and ``train.optimizer``, before the first step."""
from perfbench import spans

LAYER = "device"
MOVES = "train_tokens_per_s"


def read(run):
    s = run.get("trace")
    if s is None or s.busy_s <= 0:
        return None
    steps, sync = spans.host("train.step"), spans.host("train.sync")
    if steps is None or sync is None:
        return None
    extent = steps[0] + sync[0]
    busy = s.busy_s - sum(spans.device_s(s, n)
                          for n in ("train.tokenize", "train.optimizer"))
    if extent <= 0:
        return None
    return 100.0 * (1.0 - busy / extent)
