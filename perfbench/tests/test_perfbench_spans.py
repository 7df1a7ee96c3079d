"""The readers of the program's own spans and counters: each on a synthetic
summary and window, nothing to read without a trace, a window or (for the
card's idle share) device events, nothing on a program that keeps no
spans; and in a tiny traced run of each kind, the encoder's padding from
the program's counters equals the benchmark's own count of the traced
batches' real tokens, and the training step's host time is read."""
import pytest

from perfbench import spans
from perfbench.harness import Benchmark
from perfbench.tests import tiny
from perfbench.trace import Summary

PADDING = "encoder_padding.search"
STEP_MS = "train_issue_ms"
IDLE = "device_idle.train_steps"


def _read(metric, run):
    return Benchmark(tiny.REPO).reader(metric)(run)


def _summary(busy_s=0.9, span_device_s=None):
    return Summary(window_s=2.0, busy_s=busy_s,
                   span_device_s=span_device_s or {
                       "fit": 1.0, "train.optimizer": 0.05,
                       "train.tokenize": 0.05,
                       "train.step epoch=0 step=0": 0.4,
                       "train.step epoch=0 step=1": 0.4},
                   device_ops=[], idle_gaps=[])


WINDOW = {"spans": {"train.step": (0.8, 2), "train.sync": (0.2, 1),
                    "train.tokenize": (0.5, 1)},
          "counters": {"encoder.tokens_real": 25, "encoder.tokens_run": 100,
                       "launch.flash": 4}}


def test_readers_on_a_synthetic_window(monkeypatch):
    monkeypatch.setattr(spans, "window", lambda: WINDOW)
    run = {"trace": _summary()}
    assert _read(PADDING, run) == pytest.approx(75.0)
    assert _read(STEP_MS, run) == pytest.approx(400.0)
    # busy 0.9 s less 0.1 s before the steps, over 0.8 + 0.2 s of extent
    assert _read(IDLE, run) == pytest.approx(20.0)
    assert spans.device_s(run["trace"], "train.step") == pytest.approx(0.8)


def test_nothing_to_read(monkeypatch):
    monkeypatch.setattr(spans, "window", lambda: WINDOW)
    for metric in (PADDING, STEP_MS, IDLE):
        assert _read(metric, {}) is None
        assert _read(metric, {"trace": None}) is None
    # no device events: the idle share has nothing to divide
    assert _read(IDLE, {"trace": _summary(busy_s=0.0)}) is None
    assert _read(STEP_MS, {"trace": _summary(busy_s=0.0)}) == \
        pytest.approx(400.0)
    # a window of the search's spans alone
    monkeypatch.setattr(spans, "window", lambda: {
        "spans": {"encoder.forward": (0.1, 2)},
        "counters": {"encoder.tokens_real": 0, "encoder.tokens_run": 0}})
    for metric in (PADDING, STEP_MS, IDLE):
        assert _read(metric, {"trace": _summary()}) is None


def test_a_program_without_spans_gives_nothing(monkeypatch):
    from semanticsearch_tpu_torch.core import profiling

    monkeypatch.delattr(profiling, "last_window")
    assert spans.window() is None
    for metric in (PADDING, STEP_MS, IDLE):
        assert _read(metric, {"trace": _summary()}) is None


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("cell", [c for c in tiny.cells() if ".search_" in c])
def test_padding_equals_the_benchmarks_own_count(root, cell, capsys,
                                                 monkeypatch):
    kind = Benchmark(root).runner("search")
    work = kind._work
    seen = []

    def recorded(cfg, texts, n_batches):
        out = work(cfg, texts, n_batches)
        seen.append(out)
        return out
    monkeypatch.setattr(kind, "_work", recorded)
    rc, line = tiny.run_cell(root, cell, trace=1, seconds=5.0,
                             capsys=capsys)
    assert rc == 0 and line["correct"]
    (w,) = seen
    # every tiny query lies in the 64-token bucket
    assert tiny.CONFIG["max_position_embeddings"] == 64
    want = 100.0 * (1.0 - w["real_tokens"] / (64 * w["queries"]))
    assert line["metrics"][PADDING]["value"] == want
    assert spans.counter("encoder.tokens_real") == w["real_tokens"]
    assert STEP_MS not in line["metrics"] and IDLE not in line["metrics"]


def test_a_traced_fit_reads_its_steps(root, capsys):
    cell = next(c for c in tiny.cells() if ".train_" in c)
    rc, line = tiny.run_cell(root, cell, trace=1, seconds=2.0,
                             capsys=capsys)
    assert rc == 0 and line["correct"]
    seconds, count = spans.host("train.step")
    assert count == tiny.TRAIN_MIX["trace_steps"]
    assert line["metrics"][STEP_MS]["value"] == pytest.approx(
        1e3 * seconds / count)
    # no device events on the CPU
    assert IDLE not in line["metrics"] and PADDING not in line["metrics"]
