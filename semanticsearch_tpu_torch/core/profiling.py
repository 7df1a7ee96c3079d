"""Step timers, the program's spans and counters, and profiler hooks.

Counterpart of ``semanticsearch_tpu/core/profiling.py`` on PyTorch. A
``StepTimer`` accumulates named phases; a phase given a CUDA tensor (or a
structure holding one) in ``block_on`` ends with a synchronize of that
tensor's device, because CUDA launches return before the card finishes.
``trace`` wraps ``torch.profiler.profile`` over the CPU and, where there is
a card, CUDA activities, and writes a Chrome trace (viewable in Perfetto or
``chrome://tracing``) into ``log_dir``.

Spans: the program marks where its work happens with :func:`span`, under
dotted names by layer (``encoder.``, ``index.``, ``train.``, ``serve.``,
``coalescer.``). Spans are off by default; :func:`enable` switches them on,
and they are on by themselves while a torch profiler runs (``trace``, the
benchmark's traced window, ``torch.profiler.profile``, or
``torch.autograd.profiler.emit_nvtx()`` for Nsight). Off, a span is one
shared no-op context. On, its host seconds add to in-memory totals by name
(:func:`span_totals`), and under a profiler it is also a
``torch.profiler.record_function`` range, so it lies on the profiler's
clock beside the kernels and copies launched inside it. A span's ``args``
(the ids that join spans, such as a batch number) follow its name in the
trace, after a space: torch's trace export drops a range's own argument
string.

Counters: the kernel wrappers, the native wrappers and the encoder keep
their counts as module integers where the work happens;
:func:`counters` reads them all under dotted names. :func:`last_window`
gives what the spans and the counters saw in the latest stretch in which
the spans were on.
"""
from __future__ import annotations

import contextlib
import importlib
import os
import re
import threading
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional, Tuple

import torch

# the package's root, for the modules :func:`counters` reads
_PACKAGE = __name__.rsplit(".", 2)[0]
# (prefix, module, pattern): the module integers read by :func:`counters`;
# the pattern's group, lower-cased, follows the prefix
_COUNTER_SOURCES = (
    ("launch", "ops.topk", r"(\w+)_LAUNCHES"),
    ("launch", "ops.flash_attention", r"(\w+)_LAUNCHES"),
    ("launch", "ops.similarity", r"(\w+)_LAUNCHES"),
    ("launch", "ops.short_conv", r"(\w+)_LAUNCHES"),
    ("launch", "ops.rms_norm", r"(\w+)_LAUNCHES"),
    ("native", "native", r"(\w+)_CALLS"),
    ("encoder", "models.encoder", r"(TOKENS_\w+|PACKED_FORWARDS)"),
    ("encoder", "models.lfm2_moe", r"(MOE_\w+)"),
)

_clock = time.perf_counter
_NULL = contextlib.nullcontext()
_LOCK = threading.Lock()
_enabled = False
# a profiler of trace() runs: it records every thread, and under it torch
# reports no profiler on any thread
_tracing = False
# host seconds and count by span name, since the process started or reset()
_totals: Dict[str, list] = defaultdict(lambda: [0.0, 0])
# the latest stretch in which spans were on: its spans' totals, and the
# counters when it opened and (once it has) when it closed
_window: Optional[dict] = None
_window_open = False
_window_thread = None  # the thread that opened it, which alone closes it


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


def enable(on: bool = True) -> bool:
    """Switch the spans on or off (a running torch profiler turns them on
    regardless); returns the previous setting."""
    global _enabled
    prev, _enabled = _enabled, bool(on)
    return prev


def enabled() -> bool:
    """Whether a span records now: switched on, or under a profiler."""
    return _enabled or _tracing or torch.autograd._profiler_enabled()


def counters() -> Dict[str, int]:
    """Every counter of the program under its dotted name, as it stands:
    kernel launches (``launch.segtopk``, ``launch.pass_b``,
    ``launch.flash``, ``launch.short_conv``, ...), native calls (``native.hash_tokenize``, ...)
    and the encoder's tokens (``encoder.tokens_real``,
    ``encoder.tokens_run``), packed forwards (``encoder.packed_forwards``)
    and an LFM2-MoE encoder's token-expert pairs and MoE layer forwards
    (``encoder.moe_pairs``, ``encoder.moe_layers``)."""
    out = {}
    for prefix, mod_name, pattern in _COUNTER_SOURCES:
        mod = importlib.import_module(f"{_PACKAGE}.{mod_name}")
        for attr, value in vars(mod).items():
            m = re.fullmatch(pattern, attr)
            if m and isinstance(value, int):
                out[f"{prefix}.{m.group(1).lower()}"] = value
    return out


def _open_window() -> None:
    global _window, _window_open, _window_thread
    start = counters()
    with _LOCK:
        if not _window_open:
            _window = {"spans": defaultdict(lambda: [0.0, 0]),
                       "start": start, "end": None}
            _window_open = True
            _window_thread = threading.get_ident()


def _close_window() -> None:
    global _window_open
    end = counters()
    with _LOCK:
        if _window_open:
            _window["end"] = end
            _window_open = False


class _Span:
    __slots__ = ("name", "_range", "_t0")

    def __init__(self, name: str, args: Optional[dict], traced: bool
                 ) -> None:
        self.name = name
        self._range = None
        if traced:  # a profiler (or emit_nvtx) takes the range
            label = " ".join([name] + [f"{k}={v}"
                                       for k, v in (args or {}).items()])
            self._range = torch.profiler.record_function(label)

    def __enter__(self) -> "_Span":
        if self._range is not None:
            self._range.__enter__()
        self._t0 = _clock()
        return self

    def __exit__(self, *exc) -> None:
        dt = _clock() - self._t0
        if self._range is not None:
            self._range.__exit__(*exc)
        with _LOCK:
            _add(_totals, self.name, dt)
            if _window is not None:
                _add(_window["spans"], self.name, dt)


def _add(table: Dict[str, list], name: str, seconds: float) -> None:
    entry = table[name]
    entry[0] += seconds
    entry[1] += 1


def span(name: str, args: Optional[dict] = None):
    """A context over the program's work under ``name``. ``args`` hold the
    ids that join spans, as ``{"batch": 3}``. Off,
    this is one shared no-op context: nothing is built and no clock is
    read. On without a profiler, only the host totals are kept."""
    traced = _tracing or torch.autograd._profiler_enabled()
    if not (_enabled or traced):
        # a profiler is on for its own thread: another thread's span
        # leaves the window open
        if _window_open and threading.get_ident() == _window_thread:
            _close_window()
        return _NULL
    if not _window_open:
        _open_window()
    return _Span(name, args, traced)


def span_totals() -> Dict[str, Tuple[float, int]]:
    """Host seconds and count of every span name, since the process
    started or :func:`reset`."""
    with _LOCK:
        return {k: (v[0], v[1]) for k, v in _totals.items()}


def last_window() -> Optional[dict]:
    """The latest stretch in which the spans were on, from its first span
    to the first span call after it (or to now, while none has come):
    ``spans``, host seconds and count by name, and ``counters``, each
    counter's rise over it. None before any span was on."""
    with _LOCK:
        if _window is None:
            return None
        spans = {k: (v[0], v[1]) for k, v in _window["spans"].items()}
        start, end = _window["start"], _window["end"]
    end = counters() if end is None else end
    return {"spans": spans,
            "counters": {k: v - start.get(k, 0) for k, v in end.items()}}


def reset() -> None:
    """Clear the span totals and the last window."""
    global _window, _window_open
    with _LOCK:
        _totals.clear()
        _window = None
        _window_open = False


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Profile the block (CPU and, with a card, CUDA activities, on every
    thread where this torch can) with the program's spans on, and write
    ``trace.json`` into ``log_dir``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    kwargs = {}
    try:
        kwargs["experimental_config"] = torch._C._profiler._ExperimentalConfig(
            profile_all_threads=True)
    except (AttributeError, TypeError):
        pass
    global _tracing
    os.makedirs(log_dir, exist_ok=True)
    try:
        with profile(activities=activities, **kwargs) as prof:
            _tracing = True
            yield
    finally:
        _tracing = False
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
