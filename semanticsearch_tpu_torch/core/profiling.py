"""Step timers and profiler hooks.

Counterpart of ``semanticsearch_tpu/core/profiling.py`` on PyTorch. A
``StepTimer`` accumulates named phases; a phase given a CUDA tensor (or a
structure holding one) in ``block_on`` ends with a synchronize of that
tensor's device, because CUDA launches return before the card finishes.
``trace`` wraps ``torch.profiler.profile`` over the CPU and, where there is
a card, CUDA activities, and writes a Chrome trace (viewable in Perfetto or
``chrome://tracing``) into ``log_dir``.
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Iterator

import torch


def _cuda_devices(obj) -> set:
    """The CUDA devices of every tensor in ``obj`` (a tensor, or dicts,
    lists and tuples of them)."""
    if isinstance(obj, torch.Tensor):
        return {obj.device} if obj.is_cuda else set()
    if isinstance(obj, dict):
        obj = list(obj.values())
    if isinstance(obj, (list, tuple)):
        return set().union(*(_cuda_devices(x) for x in obj)) if obj else set()
    return set()


class StepTimer:
    """Accumulates per-phase wall times; waits for device work for
    accuracy."""

    def __init__(self) -> None:
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str, block_on=None) -> Iterator[None]:
        start = time.perf_counter()
        try:
            yield
        finally:
            for device in _cuda_devices(block_on):
                torch.cuda.synchronize(device)
            elapsed = time.perf_counter() - start
            self.totals[name] += elapsed
            self.counts[name] += 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            name: {
                "total_s": self.totals[name],
                "count": self.counts[name],
                "mean_s": self.totals[name] / max(1, self.counts[name]),
            }
            for name in self.totals
        }


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Profile the block (CPU and, with a card, CUDA activities) and write
    ``trace.json`` into ``log_dir``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
