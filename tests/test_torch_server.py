"""The port's HTTP search server against the JAX package's.

The coalescer's tests of ``tests/test_query_engine.py`` run on the port's
``index/server.py`` with the same stub engine: concurrent searches merge
into power-of-two batches, an engine failure fails only its batch, a
mutation waits for the batch in flight and no later search jumps a
carried mutation, and the serial server answers a 32-client burst. Then a
real CPU engine over an index the JAX package built (its encoder saved by
the JAX ``save_encoder`` and loaded by both) answers ``/healthz``,
``/search``, ``/add``, ``/remove`` and ``/compact`` exactly as the JAX
server does, in both serving modes, under concurrent clients, and through
``python -m semanticsearch_tpu_torch.cli.main serve --port 0`` in a
subprocess."""
import json
import os
import shutil
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from semanticsearch_tpu.core.config import EncoderConfig as JCfg
from semanticsearch_tpu.index import server as jserver
from semanticsearch_tpu.index.query_engine import HybridQueryEngine as JEngine
from semanticsearch_tpu.models.encoder import SentenceEncoder as JEncoder
from semanticsearch_tpu.train.encoder_train import load_encoder as jload
from semanticsearch_tpu.train.encoder_train import save_encoder as jsave
from semanticsearch_tpu_torch.data.tsv import write_tsv
from semanticsearch_tpu_torch.index import server as tserver
from semanticsearch_tpu_torch.index.query_engine import Hit
from semanticsearch_tpu_torch.index.query_engine import (
    HybridQueryEngine as TEngine,
)
from semanticsearch_tpu_torch.train.encoder_train import load_encoder as tload

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENC = dict(vocab_size=500, hidden_dim=32, num_layers=1, num_heads=2,
           mlp_dim=64, max_len=32, dtype="float32")


class _StubServeEngine:
    """Fake engine: records every dispatch's batch shape and the grad mode
    it ran under, optionally sleeps in the finish (so concurrent requests
    pile up behind the dispatcher), and returns deterministic hits."""

    def __init__(self, search_delay_s=0.0, fail=False):
        self.calls = []  # (n_queries, k) per dispatch
        self.grad_enabled = []
        self.search_delay_s = search_delay_s
        self.fail = fail

        class _Idx:
            size = 0

        self.index = _Idx()
        self._delta = None
        self._dead = set()
        self._device_bm25 = None

    def _dispatch_legs(self, queries, k, candidates, hybrid):
        self.calls.append((len(queries), k))
        self.grad_enabled.append(torch.is_grad_enabled())
        if self.fail:
            raise RuntimeError("boom")
        return {"queries": list(queries)}

    def _finish_legs(self, state, k, rerank_top):
        if self.search_delay_s:
            time.sleep(self.search_delay_s)
        return [[Hit(chunk_id=f"{q}#{r}", score=np.float32(k - r),
                     dense_rank=np.int64(r + 1), lexical_rank=0)
                 for r in range(k)] for q in state["queries"]]

    def search(self, queries, k=10, hybrid=True, rerank_top=0):
        return self._finish_legs(
            self._dispatch_legs(queries, k, None, hybrid), k, rerank_top)


def _start(srv):
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    return t, f"http://{srv.server_address[0]}:{srv.server_address[1]}"


def _stop(srv, t):
    srv.shutdown()
    srv.server_close()
    t.join(timeout=10)
    assert not t.is_alive()


def _post(base, path, obj, timeout=60):
    req = urllib.request.Request(f"{base}{path}",
                                 data=json.dumps(obj).encode(), method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def _get(base, path, timeout=30):
    with urllib.request.urlopen(f"{base}{path}", timeout=timeout) as r:
        return json.loads(r.read())


def _run_clients(n, fn):
    errors = []
    barrier = threading.Barrier(n)

    def client(i):
        barrier.wait()
        try:
            fn(i)
        except Exception as exc:  # collected, asserted by the caller
            errors.append((i, exc))

    threads = [threading.Thread(target=client, args=(i,)) for i in range(n)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
        assert not th.is_alive()
    return errors


def test_coalescer_merges_concurrent_searches():
    """Concurrent small requests merge into few power-of-two batches of one
    k each, every client gets its own hits as JSON numbers, and the
    dispatcher runs the engine with autograd off."""
    eng = _StubServeEngine(search_delay_s=0.05)
    srv = tserver.make_server(eng, port=0, coalesce=True, max_wait_ms=100.0)
    t, base = _start(srv)
    try:
        results = {}

        def client(i):
            k = 3 if i % 2 == 0 else 5
            qs = [f"q{i}a", f"q{i}b"]
            results[i] = (k, qs, _post(base, "/search",
                                       {"queries": qs, "k": k}))

        assert not _run_clients(12, client)
        for i, (k, qs, out) in results.items():
            assert len(out["results"]) == 2
            for q, hits in zip(qs, out["results"]):
                assert [h["chunk_id"] for h in hits] == \
                    [f"{q}#{r}" for r in range(k)]
                assert [h["score"] for h in hits] == \
                    [float(k - r) for r in range(k)]
                assert [h["dense_rank"] for h in hits] == \
                    list(range(1, k + 1))
        assert sum(n for n, _ in eng.calls) >= 24
        assert len(eng.calls) <= 6, eng.calls
        assert any(n > 2 for n, _ in eng.calls), eng.calls
        assert all(n & (n - 1) == 0 for n, _ in eng.calls), eng.calls
        assert not any(eng.grad_enabled)
        stats = _get(base, "/statz")["coalesce"]
        assert stats["batches"] == len(eng.calls)
        assert stats["merged_requests"] >= 2
        assert stats["max_batch"] == 1024 and stats["max_wait_ms"] == 100.0
    finally:
        _stop(srv, t)


def test_coalescer_failure_isolated_per_batch():
    eng = _StubServeEngine(fail=True)
    srv = tserver.make_server(eng, port=0, coalesce=True, max_wait_ms=1.0)
    t, base = _start(srv)
    try:
        with pytest.raises(urllib.error.HTTPError) as err:
            _post(base, "/search", {"queries": ["x"], "k": 2})
        assert err.value.code == 500 and "boom" in err.value.read().decode()
        eng.fail = False
        out = _post(base, "/search", {"queries": ["x"], "k": 2})
        assert [h["chunk_id"] for h in out["results"][0]] == ["x#0", "x#1"]
    finally:
        _stop(srv, t)


def test_coalescer_pipelining_mutation_barrier():
    """A mutation behind a batch in flight runs only after that batch's
    results are delivered."""
    eng = _StubServeEngine(search_delay_s=0.05)
    order = []
    orig_finish = eng._finish_legs

    def finish_logged(state, k, rerank_top):
        out = orig_finish(state, k, rerank_top)
        order.append("finish")
        return out

    eng._finish_legs = finish_logged
    co = tserver._Coalescer(eng, max_batch=8, max_wait_s=0.02)
    try:
        search_op = tserver._Op("search", queries=["a", "b"],
                                params=(2, True, 0))
        mutate_op = tserver._Op("mutate", fn=lambda: order.append("mutate"))
        t1 = threading.Thread(target=co.submit, args=(search_op,))
        t1.start()
        time.sleep(0.005)
        t2 = threading.Thread(target=co.submit, args=(mutate_op,))
        t2.start()
        t1.join(timeout=30)
        t2.join(timeout=30)
        assert not t1.is_alive() and not t2.is_alive()
        assert search_op.error is None and mutate_op.error is None
        assert order == ["finish", "mutate"], order
        assert len(search_op.result) == 2
    finally:
        co.shutdown()
    with pytest.raises(RuntimeError, match="shutting down"):
        co.submit(tserver._Op("mutate", fn=lambda: None))


def test_coalescer_search_never_jumps_carried_mutation():
    eng = _StubServeEngine(search_delay_s=0.15)
    order = []
    orig_dispatch = eng._dispatch_legs

    def dispatch_logged(queries, k, candidates, hybrid):
        order.append(("search", len(queries), k))
        return orig_dispatch(queries, k, candidates, hybrid)

    eng._dispatch_legs = dispatch_logged
    co = tserver._Coalescer(eng, max_batch=8, max_wait_s=0.1)
    try:
        ops = [
            tserver._Op("search", queries=["a"], params=(3, True, 0)),
            tserver._Op("search", queries=["b"], params=(5, True, 0)),
            tserver._Op("mutate", fn=lambda: order.append("mutate")),
            tserver._Op("search", queries=["d"], params=(5, True, 0)),
        ]
        threads = []
        for i, op in enumerate(ops):
            time.sleep(0.03 if i else 0.0)
            th = threading.Thread(target=co.submit, args=(op,))
            th.start()
            threads.append(th)
        for th in threads:
            th.join(timeout=30)
            assert not th.is_alive()
        assert all(op.error is None for op in ops)
        assert order == [("search", 1, 3), ("search", 1, 5), "mutate",
                         ("search", 1, 5)], order
    finally:
        co.shutdown()


def test_serial_server_survives_connection_burst():
    assert tserver._SerialHTTPServer.request_queue_size >= 64
    assert tserver._CoalescingHTTPServer.request_queue_size >= 64
    eng = _StubServeEngine(search_delay_s=0.02)
    srv = tserver.make_server(eng, port=0)
    t, base = _start(srv)
    try:
        done = []

        def client(i):
            out = _post(base, "/search", {"queries": [f"q{i}"], "k": 2},
                        timeout=120)
            assert out["results"][0][0]["chunk_id"] == f"q{i}#0"
            done.append(i)

        errors = _run_clients(32, client)
        assert not errors, errors[:3]
        assert len(done) == 32
        assert not any(eng.grad_enabled)
    finally:
        _stop(srv, t)


def test_hit_dict_emits_python_numbers():
    h = Hit(chunk_id="c", score=np.float32(0.5), dense_rank=np.int64(2),
            lexical_rank=torch.tensor(3), rerank_score=np.float32(1.25))
    d = tserver._hit_dict(h)
    assert json.loads(json.dumps(d)) == {
        "chunk_id": "c", "score": 0.5, "dense_rank": 2, "lexical_rank": 3,
        "rerank_score": 1.25}
    assert "rerank_score" not in tserver._hit_dict(Hit("c", 0.5))


# ---------------------------------------------------------------- real

_TEXTS = [
    "volcanic eruption spewed lava and ash across the island",
    "the fishing quota for trawlers was reduced this season",
    "solar panels convert sunlight into electricity efficiently",
    "the ancient aqueduct carried water to the roman city",
    "high speed trains run between the two capital stations",
    "bees pollinate flowers and produce honey in the hive",
    "glaciers retreat as the mountain climate warms each decade",
    "the central bank raised interest rates to slow inflation",
]
QUERIES = ["fishing quota trawlers", "bees and honey", "solar electricity",
           "roman water aqueduct", "zzz unmatched"]


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """An index the JAX package built, and its encoder as the JAX
    ``save_encoder`` wrote it."""
    tmp = tmp_path_factory.mktemp("srv")
    chunks = str(tmp / "chunks.tsv")
    write_tsv(chunks, [{"chunk_id": f"c{i}", "query_id": "",
                        "document_id": f"d{i}", "chunk_text": t}
                       for i, t in enumerate(_TEXTS)],
              ["chunk_id", "query_id", "document_id", "chunk_text"])
    jenc = JEncoder(JCfg(**ENC), seed=3)
    jsave(jenc, str(tmp / "ckpt"))
    JEngine.build(chunks, jenc, str(tmp / "idx"))
    return str(tmp / "idx"), str(tmp / "ckpt")


def _engines(built, tmp_path):
    idx, ckpt = built
    shutil.copytree(idx, tmp_path / "j")
    shutil.copytree(idx, tmp_path / "t")
    j = JEngine.load(str(tmp_path / "j"), jload(ckpt))
    t = TEngine.load(str(tmp_path / "t"), tload(ckpt, device="cpu"),
                     device="cpu")
    return j, t


_ROUND = [
    ("GET", "/healthz", None),
    ("POST", "/search", {"queries": QUERIES[:3], "k": 3}),
    ("POST", "/search", {"queries": QUERIES, "k": 4, "hybrid": False}),
    ("POST", "/add", {"chunk_ids": ["c_new", "c_new2"],
                      "texts": ["quantum computer runs shor algorithm on "
                                "qubits", "wind turbines generate power"]}),
    ("POST", "/search", {"queries": ["quantum qubits shor", "wind power"],
                         "k": 3}),
    ("GET", "/statz", None),
    ("POST", "/remove", {"chunk_ids": ["c_new", "c3"]}),
    ("POST", "/search", {"queries": ["quantum qubits shor"] + QUERIES,
                         "k": 5}),
    ("POST", "/compact", {}),
    ("POST", "/search", {"queries": QUERIES, "k": 3}),
    ("GET", "/healthz", None),
    ("POST", "/search", {"queries": []}),
    ("POST", "/nope", {}),
]


def _replay(base):
    out = []
    for method, path, body in _ROUND:
        try:
            out.append(_post(base, path, body, timeout=120)
                       if method == "POST" else _get(base, path))
        except urllib.error.HTTPError as e:
            out.append((e.code, json.loads(e.read())))
    return out


@pytest.mark.parametrize("coalesce", [False, True])
def test_http_answers_equal_jax_server(built, tmp_path, coalesce):
    j, t = _engines(built, tmp_path)
    answers = []
    for mod, eng in ((jserver, j), (tserver, t)):
        srv = mod.make_server(eng, port=0, coalesce=coalesce,
                              max_wait_ms=5.0)
        th, base = _start(srv)
        try:
            answers.append(_replay(base))
        finally:
            _stop(srv, th)
    for (_, path, _), ja, ta in zip(_ROUND, *answers):
        if path == "/statz":  # the port's coalescer reports the same keys
            assert set(ta) == set(ja)
            ja = {k: v for k, v in ja.items() if k != "coalesce"}
            ta = {k: v for k, v in ta.items() if k != "coalesce"}
        assert ta == ja, path
    first = answers[1][1]["results"][0][0]
    assert first["chunk_id"] == "c1" and first["lexical_rank"] == 1
    assert answers[1][-2][0] == 400 and answers[1][-1][0] == 404
    assert answers[1][-3] == {"ok": True, "docs": 8}


def test_http_concurrent_clients_equal_engine(built, tmp_path):
    _, t = _engines(built, tmp_path)
    srv = tserver.make_server(t, port=0, coalesce=True, max_wait_ms=50.0)
    th, base = _start(srv)
    try:
        sent, got = {}, {}

        def client(i):
            qs = [QUERIES[(i + r) % len(QUERIES)] for r in range(1 + i % 3)]
            sent[i] = qs
            got[i] = _post(base, "/search", {"queries": qs, "k": 3},
                           timeout=120)["results"]

        assert not _run_clients(8, client)
        stats = _get(base, "/statz")["coalesce"]
    finally:
        _stop(srv, th)
    for i, qs in sent.items():
        want = [[tserver._hit_dict(h) for h in hits]
                for hits in t.search(qs, k=3)]
        assert got[i] == want
    assert stats["batches"] < 8


def test_http_serial_connection_hygiene(built, tmp_path):
    _, t = _engines(built, tmp_path)
    srv = tserver.make_server(t, port=0)
    th, base = _start(srv)
    host, port = srv.server_address
    try:
        with urllib.request.urlopen(f"{base}/healthz", timeout=30) as r:
            assert json.loads(r.read())["ok"] is True
            assert r.headers.get("Connection") == "close"
        for header, code in ((b"Content-Length: abc", b" 411 "),
                             (b"Content-Length: 999999999999", b" 413 ")):
            with socket.create_connection((host, port), timeout=30) as s:
                s.sendall(b"POST /search HTTP/1.1\r\nHost: x\r\n" + header
                          + b"\r\n\r\n")
                buf = b""
                s.settimeout(10)
                while True:  # the server closes the connection
                    chunk = s.recv(4096)
                    if not chunk:
                        break
                    buf += chunk
                assert code in buf.split(b"\r\n", 1)[0], buf[:200]
        assert _get(base, "/healthz")["ok"] is True
        with pytest.raises(urllib.error.HTTPError) as err:
            _post(base, "/add", {"chunk_ids": ["a"], "texts": ["x", "y"]})
        assert err.value.code == 400
    finally:
        _stop(srv, th)


def test_cli_serve_subprocess(built, tmp_path):
    """``python -m semanticsearch_tpu_torch.cli.main serve --port 0``
    prints its bound port and answers as the in-process engine."""
    idx, ckpt = built
    shutil.copytree(idx, tmp_path / "idx")
    proc = subprocess.Popen(
        [sys.executable, "-m", "semanticsearch_tpu_torch.cli.main",
         "--device", "cpu", "serve", "--index-dir", str(tmp_path / "idx"),
         "--encoder-ckpt", ckpt, "--port", "0", "--coalesce"],
        cwd=_ROOT, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
        text=True)
    try:
        line = proc.stdout.readline()
        assert line.startswith("serving http://127.0.0.1:"), line
        base = line.split()[1]
        assert int(base.rsplit(":", 1)[1]) > 0
        assert _get(base, "/healthz") == {"ok": True, "docs": 8}
        got = _post(base, "/search", {"queries": QUERIES, "k": 3})
    finally:
        proc.terminate()
        proc.wait(timeout=30)
        proc.stdout.close()
    t = TEngine.load(str(tmp_path / "idx"), tload(ckpt, device="cpu"),
                     device="cpu")
    assert got["results"] == [[tserver._hit_dict(h) for h in hits]
                              for hits in t.search(QUERIES, k=3)]
