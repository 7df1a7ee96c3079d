"""The program's own spans and counters over a traced run's sub-window,
for the per-layer readers that take them.

The program's spans (``semanticsearch_tpu_torch/core/profiling.py``) are
on by themselves while the profiler of a traced run's sub-window runs; the
program keeps their host seconds and counts, and its counters' rise, over
the latest stretch in which they were on: that sub-window. In the trace a
span's name is followed by its arguments after a space, so the device
seconds of the trace's spans are summed here by the name before it. A
program without its own spans gives nothing to read, and neither do these
functions.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple


def window() -> Optional[dict]:
    """The program's last window of spans: ``spans``, host seconds and
    count by name, and ``counters``, each counter's rise. None when the
    program keeps none."""
    try:
        from semanticsearch_tpu_torch.core import profiling
    except ImportError:
        return None
    last = getattr(profiling, "last_window", None)
    return None if last is None else last()


def host(name: str) -> Optional[Tuple[float, int]]:
    """Host seconds and count of the program's spans called ``name`` in
    the window, or None when there were none."""
    w = window()
    if w is None or name not in w["spans"]:
        return None
    return tuple(w["spans"][name])


def counter(name: str) -> Optional[int]:
    """A program counter's rise over the window, or None."""
    w = window()
    if w is None:
        return None
    return w["counters"].get(name)


def device_s(summary, name: str) -> float:
    """Device seconds of the kernels, copies and fills launched under a
    span called ``name`` (whatever its arguments), from a traced run's
    summary."""
    per: Dict[str, float] = summary.span_device_s
    return sum(v for k, v in per.items() if k.split(" ", 1)[0] == name)
