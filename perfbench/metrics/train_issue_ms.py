"""The host's milliseconds a training step in the traced call: the mean of
the program's ``train.step`` spans (the batch's upload, the loss, its
backward, the gradients' reduce and the optimizer's update, as issued;
launches return before the card runs them)."""
from perfbench import spans

LAYER = "training"
MOVES = "train_tokens_per_s"


def read(run):
    if run.get("trace") is None:
        return None
    steps = spans.host("train.step")
    if steps is None or steps[1] == 0:
        return None
    return 1e3 * steps[0] / steps[1]
