"""Traced runs: the benchmark's spans, the device timeline of a steady
sub-window, and the summaries the per-layer readers and the result's
``breakdown`` take from it.

Spans are ``torch.profiler.record_function`` ranges that the benchmark
puts around its own calls into each layer of the program. A kernel's
device time goes to the spans that were open on the host thread when it
was launched (its launch and the kernel share a correlation id in the
trace). Only summaries are kept: device seconds a span, the device's busy
time (the union of every kernel, copy and fill on the card), the kernels
that took most time, and the card's idle gaps by the span the host was in.
"""
from __future__ import annotations

import contextlib
import json
import os
import tempfile
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
_NAME = 160  # characters of a kernel's name kept in the breakdown


class Tracer:
    """Spans where the benchmark calls into the program; a profiler over
    the sub-window between :meth:`start` and :meth:`stop` when enabled.
    With tracing off every span is a no-op."""

    def __init__(self, enabled: bool) -> None:
        self.enabled = enabled
        self._prof = None
        self._t0 = self._t1 = None
        self.summary: Optional["Summary"] = None

    def span(self, name: str):
        if not self.enabled:
            return contextlib.nullcontext()
        import torch

        return torch.profiler.record_function(name)

    def warm(self) -> None:
        """Start and stop the profiler once in set-up, so that the window
        does not pay its first start."""
        if not self.enabled:
            return
        import torch
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities):
            torch.zeros(1).add_(1)

    @property
    def active(self) -> bool:
        return self._prof is not None

    def start(self) -> None:
        """Open the traced sub-window: the card is drained first, so only
        work launched inside it lies in it."""
        if not self.enabled or self._prof is not None or self.summary:
            return
        import torch
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            torch.cuda.synchronize()
            activities.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=activities)
        self._prof.start()
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        """Close the sub-window once everything launched in it is done."""
        if self._prof is None:
            return
        import torch

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._t1 = time.perf_counter()
        self._prof.stop()
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        finally:
            os.unlink(path)
        self._prof = None
        self.summary = summarize(events, self._t1 - self._t0)


class Summary:
    def __init__(self, window_s: float, busy_s: float,
                 span_device_s: Dict[str, float],
                 device_ops: List[Tuple[str, float]],
                 idle_gaps: List[Tuple[str, float]]) -> None:
        self.window_s = window_s
        self.busy_s = busy_s
        self.span_device_s = span_device_s
        self.device_ops = device_ops
        self.idle_gaps = idle_gaps


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def summarize(events: List[dict], window_s: float) -> Summary:
    """The summaries of one exported trace (times in microseconds)."""
    device, launches, spans = [], {}, defaultdict(list)
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat = ev.get("cat", "")
        ts, dur = float(ev.get("ts", 0.0)), float(ev.get("dur", 0.0))
        if cat in _DEVICE_CATS:
            device.append(ev)
        elif cat in _LAUNCH_CATS:
            corr = (ev.get("args") or {}).get("correlation")
            if corr is not None:
                launches[corr] = (ev.get("tid"), ts)
        elif cat == "user_annotation":
            spans[ev.get("tid")].append((ts, ts + dur, ev.get("name", "")))

    def open_spans(tid, ts) -> List[str]:
        return [n for s, e, n in spans.get(tid, ()) if s <= ts <= e]

    span_us: Dict[str, float] = defaultdict(float)
    op_us: Dict[str, float] = defaultdict(float)
    intervals = []
    for ev in device:
        ts, dur = float(ev["ts"]), float(ev.get("dur", 0.0))
        intervals.append((ts, ts + dur))
        op_us[ev.get("name", "")[:_NAME]] += dur
        launch = launches.get((ev.get("args") or {}).get("correlation"))
        if launch is not None:
            for name in set(open_spans(*launch)):
                span_us[name] += dur
    busy = _union(intervals)
    busy_us = sum(e - s for s, e in busy)
    # the card's idle gaps between its first and last work, by the
    # innermost span the host was in when each began
    gap_us: Dict[str, float] = defaultdict(float)
    all_spans = [sp for v in spans.values() for sp in v]
    for (_, e0), (s1, _) in zip(busy, busy[1:]):
        inner = [sp for sp in all_spans if sp[0] <= e0 <= sp[1]]
        name = (min(inner, key=lambda sp: sp[1] - sp[0])[2] if inner
                else "outside the benchmark's spans")
        gap_us[name] += s1 - e0
    top_ops = sorted(op_us.items(), key=lambda kv: -kv[1])[:10]
    top_gaps = sorted(gap_us.items(), key=lambda kv: -kv[1])[:10]
    return Summary(
        window_s=window_s,
        busy_s=busy_us * 1e-6,
        span_device_s={k: v * 1e-6 for k, v in span_us.items()},
        device_ops=[[k, v * 1e-6] for k, v in top_ops],
        idle_gaps=[[k, v * 1e-6] for k, v in top_gaps],
    )
