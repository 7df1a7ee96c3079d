"""The share of the traced sub-window of training steps in which nothing ran on
the card (no kernel, copy or fill)."""
LAYER = "device"
MOVES = "train_tokens_per_s"


def read(run):
    s = run.get("trace")
    if s is None or s.window_s <= 0 or s.busy_s <= 0:
        return None
    return 100.0 * (1.0 - s.busy_s / s.window_s)
