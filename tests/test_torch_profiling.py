"""The port's own spans and counters (``core/profiling.py``) on the CPU.

Off, a span is one shared no-op: it builds no ``record_function`` and
reads no clock. Under a torch profiler the spans are on by themselves, and
the exported trace holds them, nested, with their ids after the name: the
dense index's route, the encoder's forwards, a ``fit``'s steps in order,
and a pipelined search's dispatch and finish sharing each batch's number.
The encoder's token counters equal what the masks hold; the coalescer
counts the seconds its requests wait in its queue and ``/statz`` shows
them; ``HostSplit`` reads its parts from the spans. No program span takes
one of the benchmark's own span names."""
import ast
import json
import re
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from semanticsearch_tpu_torch.core import profiling
from semanticsearch_tpu_torch.core.config import EncoderConfig, IndexConfig
from semanticsearch_tpu_torch.core.mesh import MeshSpec, make_mesh
from semanticsearch_tpu_torch.data.tsv import write_tsv
from semanticsearch_tpu_torch.index import server as tserver
from semanticsearch_tpu_torch.index.engine import EmbeddingIndex
from semanticsearch_tpu_torch.index.query_engine import Hit, HybridQueryEngine
from semanticsearch_tpu_torch.models import encoder as encoder_mod
from semanticsearch_tpu_torch.models.encoder import SentenceEncoder
from semanticsearch_tpu_torch.tools.host_profile import PARTS, HostSplit
from semanticsearch_tpu_torch.train.encoder_train import (
    ContrastiveConfig, ContrastiveEncoderTrainer)

PACKAGE = Path(profiling.__file__).resolve().parents[1]
ENC = dict(vocab_size=500, hidden_dim=32, num_layers=1, num_heads=2,
           mlp_dim=64, max_len=256, dtype="float32")
# the names the benchmark puts around its calls into the program
BENCHMARK_SPANS = {"encode", "search", "sample", "copy", "fetch", "fit"}
WORDS = ("river water flows stone bridge solar energy panel market price "
         "grain harvest city road train station honey bees forest").split()


@pytest.fixture(autouse=True)
def _spans_off():
    prev = profiling.enable(False)
    profiling.reset()
    yield
    profiling.enable(prev)
    profiling.reset()


def _texts(rng, n, lo, hi):
    return [" ".join(rng.choice(WORDS, size=int(rng.integers(lo, hi))))
            for _ in range(n)]


def _traced(fn):
    """``fn()`` under a CPU profiler: (its result, the trace's spans as
    (name, start, end) in start order)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    path = Path(__import__("tempfile").mkdtemp()) / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    spans = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                   if e.get("cat") == "user_annotation")
    return out, [(n, s, e) for s, e, n in spans]


def _inside(inner, outer) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def test_spans_off_build_nothing_and_read_no_clock(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("built or read while the spans are off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(profiling, "_clock", refuse)
    assert not profiling.enabled()
    a = profiling.span("encoder.forward", {"L": 64, "rows": 8})
    b = profiling.span("index.search")
    assert a is b
    with a:
        pass
    assert profiling.span_totals() == {}
    assert profiling.last_window() is None


def test_spans_on_under_a_profiler_nest_with_their_args():
    rng = np.random.default_rng(0)
    corpus = rng.standard_normal((600, 16)).astype(np.float32)
    index = EmbeddingIndex.build(corpus, cfg=IndexConfig(
        embed_dim=16, block_rows=256, seg_split=2, dtype="float32"),
        device="cpu")
    q = torch.from_numpy(rng.standard_normal((5, 16)).astype(np.float32))
    _, spans = _traced(lambda: index.search_device(q, k=7))
    names = [n for n, _, _ in spans]
    assert names == ["index.search route=twopass Q=5 k=7", "index.pass_a",
                     "index.pass_b"]
    assert all(_inside(s, spans[0]) for s in spans[1:])
    assert spans[1][2] <= spans[2][1]
    totals = profiling.span_totals()
    assert {k: v[1] for k, v in totals.items()} == {
        "index.search": 1, "index.pass_a": 1, "index.pass_b": 1}
    assert totals["index.search"][0] >= totals["index.pass_a"][0] > 0
    # enabled by hand, the spans record without a profiler
    profiling.enable(True)
    index.search_device(q, k=7)
    assert profiling.span_totals()["index.search"][1] == 2


def test_trace_writes_the_spans_of_every_thread(tmp_path):
    index = EmbeddingIndex.build(
        np.random.default_rng(0).standard_normal((300, 8)).astype(np.float32),
        cfg=IndexConfig(embed_dim=8, block_rows=256, seg_split=2,
                        dtype="float32"), device="cpu")

    def worker():
        with profiling.span("serve.lexical_finish", {"batch": 7}):
            torch.ones(4).sum()

    with profiling.trace(str(tmp_path)):
        index.search_device(torch.ones(2, 8), k=3)
        th = threading.Thread(target=worker)
        th.start()
        th.join(30)
    assert not th.is_alive() and not profiling.enabled()
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    names = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert {"index.search route=twopass Q=2 k=3", "index.pass_a",
            "index.pass_b"} <= names
    if hasattr(torch._C._profiler, "_ExperimentalConfig"):
        assert "serve.lexical_finish batch=7" in names
    assert profiling.span_totals()["serve.lexical_finish"][1] == 1


def _counts():
    return (encoder_mod.TOKENS_REAL, encoder_mod.TOKENS_RUN,
            encoder_mod.PACKED_FORWARDS)


@pytest.mark.parametrize("shards", [1, 3])
def test_encoder_counters_hold_the_masks_tokens(shards):
    """Texts over the 64 and 128 buckets, through ``encode`` and
    ``encode_device``. On one device every forward runs packed, a batch of
    texts in input order: the positions run are the real tokens, one packed
    forward a batch, no reorder. On a mesh of three data shards the texts
    go by bucket, a batch's rows pad to a multiple of three and the padded
    rows count as run, and the outputs come back out of bucket order."""
    rng = np.random.default_rng(1)
    long = _texts(rng, 5, 70, 110)
    # a long text first, so a mesh's outputs come back out of bucket order
    texts = long[:2] + _texts(rng, 9, 2, 30) + long[2:]
    mesh = (make_mesh(MeshSpec(data=shards), [torch.device("cpu")] * shards)
            if shards > 1 else None)
    enc = SentenceEncoder(EncoderConfig(**ENC), device="cpu", seed=0,
                          mesh=mesh)
    _, mask = enc.tokenizer.encode_batch(texts, max_len=ENC["max_len"])
    lens = mask.sum(axis=1)
    real = int(lens.sum())
    batch = 4
    if shards == 1:
        run, packed = real, -(-len(texts) // batch)
    else:
        run, packed = 0, 0
        for L in (64, 128):
            n = int(((lens <= L) & (lens > L // 2 if L > 64 else True)).sum())
            rows = [min(batch, n - s) for s in range(0, n, batch)]
            run += sum(-(-r // shards) * shards * L for r in rows)
    before = _counts()
    enc.encode(texts, batch_size=batch)
    mid = _counts()
    assert tuple(m - b for m, b in zip(mid, before)) == (real, run, packed)
    window = lambda: enc.encode_device(texts, batch_size=batch)  # noqa: E731
    _, spans = _traced(window)
    after = _counts()
    assert tuple(a - m for a, m in zip(after, mid)) == (real, run, packed)
    counted = profiling.last_window()["counters"]
    assert counted["encoder.tokens_real"] == real
    assert counted["encoder.tokens_run"] == run
    assert counted["encoder.packed_forwards"] == packed
    assert profiling.counters()["encoder.tokens_run"] == after[1]
    assert profiling.counters()["encoder.packed_forwards"] == after[2]
    forwards = [n for n, _, _ in spans if n.startswith("encoder.forward")]
    others = [n for n, _, _ in spans if not n.startswith("encoder.forward")]
    if shards == 1:
        assert forwards == [
            f"encoder.forward rows={len(lens[s: s + batch])} "
            f"tokens={int(lens[s: s + batch].sum())}"
            for s in range(0, len(texts), batch)]
        assert others == ["encoder.tokenize"]
        return
    # the first text's bucket runs first
    assert forwards[0] == (f"encoder.forward L=128 "
                           f"rows={-(-batch // shards) * shards}")
    assert len(forwards) == 3 + 2
    assert others == ["encoder.tokenize", "encoder.reorder"]


def test_counters_read_the_launch_and_call_integers(monkeypatch):
    from semanticsearch_tpu_torch import native
    from semanticsearch_tpu_torch.ops import flash_attention, topk

    monkeypatch.setattr(topk, "SEGTOPK_LAUNCHES", 7)
    monkeypatch.setattr(topk, "PASS_B_LAUNCHES", 5)
    monkeypatch.setattr(flash_attention, "FLASH_LAUNCHES", 3)
    monkeypatch.setattr(native, "HASH_TOKENIZE_CALLS", 2)
    got = profiling.counters()
    assert (got["launch.segtopk"], got["launch.pass_b"], got["launch.flash"],
            got["native.hash_tokenize"]) == (7, 5, 3, 2)
    assert all(re.fullmatch(r"(launch|native|encoder)\.[a-z0-9_]+", k)
               for k in got)


def test_a_fit_gives_its_steps_in_order():
    rng = np.random.default_rng(2)
    enc = SentenceEncoder(EncoderConfig(**dict(ENC, max_len=64)),
                          device="cpu", seed=0)
    bs = 4
    qs, cs, ns = (_texts(rng, 3 * bs, 2, 8), _texts(rng, 3 * bs, 10, 30),
                  _texts(rng, 3 * bs, 10, 30))
    trainer = ContrastiveEncoderTrainer(enc, ContrastiveConfig(
        epochs=1, batch_size=bs, max_len_query=16, max_len_chunk=32))
    _, spans = _traced(lambda: trainer.fit(list(zip(qs, cs)), ns))
    top = [s for s in spans if not any(_inside(s, o) and s != o
                                       for o in spans)]
    assert [n for n, _, _ in top] == [
        "train.tokenize", "train.optimizer", "train.step epoch=0 step=0",
        "train.step epoch=0 step=1", "train.step epoch=0 step=2",
        "train.sync"]
    children = ["train.upload", "train.forward", "train.backward",
                "train.reduce", "train.optimizer_step"]
    for step in top[2:5]:
        inner = [n for n, s, e in spans if _inside((n, s, e), step)
                 and n.startswith("train.") and (n, s, e) != step]
        assert inner == children
    steps = profiling.last_window()["spans"]["train.step"]
    assert steps[1] == 3 and steps[0] > 0


@pytest.fixture(scope="module")
def engine(tmp_path_factory):
    rng = np.random.default_rng(3)
    tmp = tmp_path_factory.mktemp("spans")
    rows = [{"chunk_id": f"c{i}", "query_id": "", "document_id": f"d{i}",
             "chunk_text": t} for i, t in enumerate(_texts(rng, 40, 4, 20))]
    tsv = str(tmp / "chunks.tsv")
    write_tsv(tsv, rows, ["chunk_id", "query_id", "document_id",
                          "chunk_text"])
    enc = SentenceEncoder(EncoderConfig(**dict(ENC, max_len=64)),
                          device="cpu", seed=0)
    idx = IndexConfig(embed_dim=32, block_rows=256, seg_split=2,
                      dtype="float32")
    return HybridQueryEngine.build(tsv, enc, str(tmp / "idx"),
                                   index_cfg=idx, device="cpu")


def test_a_pipelined_search_joins_dispatch_and_finish(engine):
    rng = np.random.default_rng(4)
    batches = [_texts(rng, 3, 2, 6) for _ in range(3)]
    first = engine._batches
    _, spans = _traced(lambda: engine.search_pipelined(batches, k=5))
    ids = [first + i for i in range(3)]
    top = [n for n, s, e in spans
           if n.startswith(("serve.dispatch", "serve.finish"))]
    # batch i+1 is dispatched before batch i finishes
    assert top == [f"serve.dispatch batch={ids[0]}",
                   f"serve.dispatch batch={ids[1]}",
                   f"serve.finish batch={ids[0]}",
                   f"serve.dispatch batch={ids[2]}",
                   f"serve.finish batch={ids[1]}",
                   f"serve.finish batch={ids[2]}"]
    dispatch = next(s for s in spans if s[0] == top[0])
    finish = next(s for s in spans if s[0] == top[2])
    assert [n for n, s, e in spans if _inside((n, s, e), dispatch)
            and n.startswith("serve.") and n != top[0]] == [
        "serve.tokenize_lexical", "serve.lexical"]
    assert any(n.startswith("encoder.forward") and _inside((n, s, e),
                                                           dispatch)
               for n, s, e in spans)
    assert [n for n, s, e in spans if _inside((n, s, e), finish)
            and n != top[2]] == ["serve.lists", "serve.fuse"]


def test_host_split_reads_its_parts_from_the_spans(engine):
    rng = np.random.default_rng(5)
    batches = [_texts(rng, 4, 2, 6) for _ in range(3)]
    with HostSplit(engine) as split:
        for b in batches:
            engine.search(b, k=5)
        engine.search_pipelined(batches, k=5)
    s = split.seconds
    assert not profiling.enabled()
    assert all(s[p] >= 0 for p in PARTS)
    assert sum(s[p] for p in PARTS if p != "rest") <= s["total"]
    assert s["tokenize"] > 0 and s["bm25_topk"] > 0
    assert s["fetch_and_lists"] > 0 and s["rrf"] > 0
    assert split.line().startswith("tokenize ")


class _HeldEngine:
    """A stub engine whose first dispatch waits for ``release``, so the
    requests behind it wait in the coalescer's queue."""

    def __init__(self):
        self.release = threading.Event()
        self.started = threading.Event()

        class _Idx:
            size = 0

        self.index = _Idx()
        self._delta = None
        self._dead = set()
        self._device_bm25 = None

    def _dispatch_legs(self, queries, k, candidates, hybrid):
        self.started.set()
        self.release.wait(30)
        return {"queries": list(queries)}

    def _finish_legs(self, state, k, rerank_top):
        return [[Hit(chunk_id=q, score=1.0)] for q in state["queries"]]


def test_the_coalescer_counts_the_queue_wait():
    eng = _HeldEngine()
    srv = tserver.make_server(eng, port=0, coalesce=True, max_wait_ms=0.0)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    base = f"http://{srv.server_address[0]}:{srv.server_address[1]}"

    def post(q):
        req = urllib.request.Request(
            f"{base}/search", data=json.dumps({"queries": [q], "k": 1}
                                              ).encode(), method="POST")
        with urllib.request.urlopen(req, timeout=60) as r:
            return json.loads(r.read())

    try:
        first = threading.Thread(target=post, args=("a",))
        first.start()
        assert eng.started.wait(30)
        held = [threading.Thread(target=post, args=(q,)) for q in "bcd"]
        for t in held:
            t.start()
        time.sleep(0.6)
        eng.release.set()
        for t in [first] + held:
            t.join(60)
        with urllib.request.urlopen(f"{base}/statz", timeout=30) as r:
            stats = json.loads(r.read())["coalesce"]
    finally:
        srv.shutdown()
        srv.server_close()
        th.join(10)
    co = srv.coalescer
    assert co.dispatched >= 2
    # three requests waited about 0.6 s behind the held dispatch
    assert co.queue_wait_s >= 0.9
    assert 300 <= co.queue_wait_max_ms <= 1e3 * co.queue_wait_s
    assert stats["queue_wait_s"] == co.queue_wait_s
    assert stats["queue_wait_max_ms"] == co.queue_wait_max_ms


def _span_names():
    """Every name the package passes to ``profiling.span``."""
    names = []
    for path in PACKAGE.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "span"
                    and isinstance(node.func.value, ast.Name)
                    and node.func.value.id == "profiling"):
                arg = node.args[0]
                assert isinstance(arg, ast.Constant), (path, arg.lineno)
                names.append(arg.value)
    return names


def test_no_program_span_takes_a_benchmark_span_name():
    names = _span_names()
    assert len(set(names)) >= 25
    assert not set(names) & BENCHMARK_SPANS
    assert all(re.fullmatch(
        r"(encoder|index|train|serve|coalescer)\.[a-z_]+", n) for n in names)
