"""Resident HTTP search server over a loaded :class:`HybridQueryEngine`.

Counterpart of ``semanticsearch_tpu/index/server.py`` over the port's
engine: the same endpoints, replies and serving modes. Load the index, the
encoder and (optionally cached) device BM25 matrix ONCE, then answer
queries over HTTP. One process per card; front with any standard load
balancer for more.

Protocol (JSON over HTTP/1.1, stdlib-only on both ends):

- ``GET  /healthz``  -> ``{"ok": true, "docs": N}`` (live count: base +
  delta adds - tombstones)
- ``GET  /statz``    -> freshness-layer sizes + device-BM25 phase
  timings/certificate stats + the coalescer's counters (batches, merged
  requests, and the seconds requests waited in its queue before their
  batch was dispatched: in all, and the longest)
- ``POST /search``   body ``{"queries": ["..."], "k": 10,
  "hybrid": true, "rerank_top": 0}`` -> ``{"results": [[hit, ...], ...]}``
  where hit = ``{chunk_id, score, dense_rank, lexical_rank
  [, rerank_score]}``.
- ``POST /add``      body ``{"chunk_ids": ["..."], "texts": ["..."]}``
  -> ``{"added": N, "docs": total}`` — serve-time freshness: new docs are
  embedded into the device-resident delta index and searchable on the
  NEXT request, no restart (engine.add_documents).
- ``POST /remove``   body ``{"chunk_ids": ["..."]}``
  -> ``{"removed": N, "docs": total}`` — tombstones, effective
  immediately (engine.remove_documents).
- ``POST /compact``  body ``{}`` -> ``{"ok": true, "docs": N}`` — fold
  delta + tombstones into the persisted layout (journaled crash-safe
  staged commit) and reload; the call blocks while it runs.

Two serving modes:

- ``coalesce=False`` (default): requests are served on a single thread.
  The engine already overlaps inside ``engine.search`` (every card launch
  is queued before any fetch), and serializing requests is the correct
  backpressure for one card. Batch queries client-side for throughput.
- ``coalesce=True``: REQUEST COALESCING for many concurrent small clients
  that cannot batch client-side. Connections are accepted on threads, but
  every engine operation is routed through ONE dispatcher thread (the
  engine still sees exactly one caller — same safety as the single-thread
  mode). The dispatcher merges /search requests that arrive within
  ``max_wait_ms`` of each other (and share k/hybrid/rerank_top) into one
  engine call of up to ``max_batch`` queries, then splits the results back
  per request: N per-request launches of the encoder and the top-k become
  one batched launch, and a merged batch's card work runs while the
  previous batch is fetched and fused (cross-batch pipelining over
  ``_dispatch_legs`` / ``_finish_legs``). Mutations (/add, /remove,
  /compact) pass through the same dispatcher as barriers: they never run
  concurrently with a search, and a client that issues add-then-search
  sequentially always sees its own write.

Every engine call runs under :func:`_engine_scope`: torch's grad mode and
current CUDA device are per thread, so the dispatcher (and the serial
server's accept thread) set them for themselves. Streams are per thread as
well; a new thread's current stream is the device's default stream, the one
the kernel wrappers launch on.
"""
from __future__ import annotations

import contextlib
import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, HTTPServer, ThreadingHTTPServer
from typing import Iterator

import torch

from ..core import profiling
from ..core.logging import get_logger

logger = get_logger("server")

_MAX_BODY = 64 << 20  # reject absurd request bodies before reading them
_MAX_ITEMS = 8192  # per-request query/add cap: one request must not be
# able to occupy the single serving thread for minutes


class _UnknownPath(Exception):
    """Routing miss -> 404. A dedicated type, NOT LookupError: KeyError and
    IndexError are LookupError subclasses, so catching LookupError for
    routing would also swallow real engine failures (e.g. an IndexError
    from a corrupt index) and misreport them as 404 without logging."""


@contextlib.contextmanager
def _engine_scope(engine) -> Iterator[None]:
    """The thread-local torch state every engine call needs: no autograd
    graph, and the engine's card as the current CUDA device (a fake engine
    in a test may have no device)."""
    device = getattr(engine.index, "device", None)
    with torch.no_grad():
        if device is not None and torch.device(device).type == "cuda":
            with torch.cuda.device(device):
                yield
        else:
            yield


def _hit_dict(h) -> dict:
    """A hit as JSON-able Python numbers (``json.dumps`` refuses numpy and
    torch scalars)."""
    d = {
        "chunk_id": str(h.chunk_id),
        "score": float(h.score),
        "dense_rank": int(h.dense_rank),
        "lexical_rank": int(h.lexical_rank),
    }
    if h.rerank_score is not None:
        d["rerank_score"] = float(h.rerank_score)
    return d


class _Op:
    """One queued engine operation; the submitting handler thread blocks on
    ``done`` until the dispatcher fills ``result`` or ``error``.
    ``submitted`` is the host clock at :meth:`_Coalescer.submit`."""

    __slots__ = ("kind", "queries", "params", "fn", "done", "result", "error",
                 "submitted")

    def __init__(self, kind, queries=None, params=None, fn=None):
        self.kind = kind          # "search" | "mutate"
        self.queries = queries    # search only: list[str]
        self.params = params      # search only: (k, hybrid, rerank_top)
        self.fn = fn              # mutate only: zero-arg callable
        self.done = threading.Event()
        self.result = None
        self.error = None
        self.submitted = 0.0


_SHUTDOWN = _Op("shutdown")


class _Coalescer:
    """Single dispatcher thread that owns every engine call.

    Handler threads ``submit()`` ops; searches arriving within
    ``max_wait_s`` of each other with identical params are merged into one
    ``engine.search`` call (up to ``max_batch`` total queries). Anything
    else — a search with different params, or a mutation — flushes the
    in-flight batch first, preserving arrival order across op kinds.
    """

    def __init__(self, engine, max_batch: int = 1024,
                 max_wait_s: float = 0.004, pipeline: bool = True):
        self.engine = engine
        self.max_batch = max(1, int(max_batch))
        self.max_wait_s = max(0.0, float(max_wait_s))
        self.pipeline = bool(pipeline)  # False: finish right after dispatch
        self.q: "queue.Queue[_Op]" = queue.Queue()
        self._closed = False
        self._close_lock = threading.Lock()
        self.batches = 0          # observability: engine.search calls made
        self.merged_requests = 0  # requests that rode a shared batch
        self.dispatched = 0       # merged batches dispatched
        # searches' time in the queue, from submit to their batch's
        # dispatch: summed, and the longest
        self.queue_wait_s = 0.0
        self.queue_wait_max_ms = 0.0
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="search-coalescer")
        self._thread.start()

    def submit(self, op: _Op):
        # the closed-check and the put must be one atomic step against
        # shutdown(): an op enqueued AFTER the dispatcher's final drain
        # would leave its handler thread blocked on ``done`` forever
        op.submitted = time.perf_counter()
        with self._close_lock:
            if self._closed:  # in-flight handler racing server_close: fail
                raise RuntimeError("server shutting down")  # fast, no hang
            self.q.put(op)
        op.done.wait()
        if op.error is not None:
            raise op.error
        return op.result

    def shutdown(self) -> None:
        with self._close_lock:
            if self._closed:
                return
            self._closed = True
            # under the lock: every op ever enqueued is now ordered BEFORE
            # this sentinel, so the dispatcher's drain sees all of them
            self.q.put(_SHUTDOWN)
        self._thread.join(timeout=10)

    # ---- dispatcher thread ----------------------------------------------
    def _run(self) -> None:
        with _engine_scope(self.engine):
            self._serve()

    def _serve(self) -> None:
        # ops pulled off the queue but not yet runnable this turn (searches
        # of a different param group, mutations, shutdown) — served in
        # arrival order on later turns, so heterogeneous-k client mixes
        # don't fragment each other's batches
        carry: "list[_Op]" = []
        shutdown = False
        # CROSS-BATCH PIPELINING (query_engine.search_pipelined's split):
        # a merged batch's card work is launched, then the dispatcher
        # returns to collecting; its fetch+fusion ("finish") runs under the
        # NEXT batch's collection, so arrivals during a batch's entire
        # compute+fetch coalesce into the next one. That self-regulation is
        # load-bearing: dispatching the next batch BEFORE finishing the
        # previous lets the dispatcher lap the arrival stream, and batches
        # shrink to per-request sizes. Mutations and shutdown barrier
        # through a finish.
        inflight = None  # (ops, n_queries, engine state, params)

        def finish_inflight() -> None:
            nonlocal inflight
            if inflight is None:
                return
            pending, inflight = inflight, None
            self._finish_search(pending)

        while not shutdown:
            if carry:
                op = carry.pop(0)
            elif inflight is not None:
                # never block with results in flight: their clients wait
                try:
                    op = self.q.get_nowait()
                except queue.Empty:
                    finish_inflight()
                    continue
            else:
                op = self.q.get()
            if op.kind == "shutdown":
                break
            if op.kind != "search":
                finish_inflight()  # mutations see every prior search done
                self._run_one(op)
                continue
            batch = [op]
            total = len(op.queries)

            def absorb(nxt) -> bool:
                nonlocal total
                if (nxt.kind == "search" and nxt.params == op.params
                        and total + len(nxt.queries) <= self.max_batch):
                    batch.append(nxt)
                    total += len(nxt.queries)
                    return True
                return False

            def absorb_from_queue(block: bool) -> bool:
                """Pull queued ops into the batch; non-matching ops go to
                carry. Returns False when collection must STOP (a mutation
                or shutdown arrived — later searches must not jump it)."""
                nonlocal shutdown
                deadline = time.monotonic() + self.max_wait_s
                while total < self.max_batch:
                    try:
                        if block:
                            timeout = deadline - time.monotonic()
                            if timeout <= 0:
                                return True
                            nxt = self.q.get(timeout=timeout)
                        else:
                            nxt = self.q.get_nowait()
                    except queue.Empty:
                        return True
                    if absorb(nxt):
                        continue
                    carry.append(nxt)
                    if nxt.kind != "search":  # mutation/shutdown: stop
                        shutdown = nxt.kind == "shutdown"  # promptly
                        return False
                return True

            # same-group ops already set aside by earlier turns merge first
            # (they arrived BEFORE anything now in the queue)
            carry = [c for c in carry if not absorb(c)]
            # a mutation/shutdown still in carry is a pending BARRIER:
            # queue ops arrived after it and must not jump it into this
            # batch, so queue absorption is off for this turn entirely
            barrier_pending = any(c.kind != "search" for c in carry)
            if inflight is not None:
                # the previous batch's fetch IS this batch's absorb window:
                # requests arriving during it merge here (no extra wait)
                keep_collecting = (not barrier_pending
                                   and absorb_from_queue(block=False))
                finish_inflight()
                if keep_collecting:
                    absorb_from_queue(block=False)
            elif not barrier_pending:
                # idle card: only the max_wait_s arrival window applies
                absorb_from_queue(block=True)
            inflight = self._dispatch_search(batch)
            if not self.pipeline:  # blocking mode (A/B + debugging escape)
                finish_inflight()
        finish_inflight()
        # fail anything still pending so no handler thread hangs forever
        for op in carry:
            if op.kind != "shutdown":
                op.error = RuntimeError("server shutting down")
                op.done.set()
        while True:
            try:
                op = self.q.get_nowait()
            except queue.Empty:
                return
            if op.kind != "shutdown":
                op.error = RuntimeError("server shutting down")
                op.done.set()

    def _run_one(self, op: _Op) -> None:
        try:
            op.result = op.fn()
        except BaseException as exc:  # delivered to the handler thread
            op.error = exc
        op.done.set()

    def _dispatch_search(self, batch):
        """Launch a merged batch's card work; results are delivered by
        ``_finish_search`` (the pipelined split of ``engine.search``).
        Returns the in-flight tuple, or None when the dispatch itself
        failed (the batch is already failed over)."""
        k, hybrid, rerank_top = batch[0].params
        now = time.perf_counter()
        for op in batch:
            wait = now - op.submitted
            self.queue_wait_s += wait
            self.queue_wait_max_ms = max(self.queue_wait_max_ms, 1e3 * wait)
        number = self.dispatched
        self.dispatched += 1
        try:
            all_q = [q for op in batch for q in op.queries]
            n = len(all_q)
            # pad the merged batch to the next power of two with copies of
            # its last query (dropped at the finish): coalesced sizes are
            # as varied as client arrival patterns, and the padding keeps
            # the batch shapes the encoder and the top-k kernels see to
            # log2(max_batch) + 1 (their tile plans and the allocator's
            # cached blocks), the JAX server's compiled signatures, at
            # under 2x the work
            target = 1
            while target < n:
                target <<= 1
            all_q.extend(all_q[-1:] * (target - n))
            with profiling.span("coalescer.batch",
                                {"batch": number, "requests": len(batch)}):
                state = self.engine._dispatch_legs(all_q, k, None, hybrid)
            return (batch, n, state, (k, rerank_top))
        except BaseException as exc:
            for op in batch:
                op.error = exc
                op.done.set()
            return None

    def _finish_search(self, pending) -> None:
        if pending is None:
            return
        batch, n, state, (k, rerank_top) = pending
        try:
            results = self.engine._finish_legs(state, k, rerank_top)[:n]
            self.batches += 1
            if len(batch) > 1:
                self.merged_requests += len(batch)
            off = 0
            for op in batch:
                op.result = results[off: off + len(op.queries)]
                off += len(op.queries)
        except BaseException as exc:
            for op in batch:
                op.error = exc
        for op in batch:
            op.done.set()


class _CoalescingHTTPServer(ThreadingHTTPServer):
    """Threaded accept loop whose ``server_close`` also stops the
    dispatcher thread (failing any queued requests loudly)."""

    daemon_threads = True
    coalescer: _Coalescer = None
    # listen(2) backlog. The stdlib default of 5 resets connection bursts:
    # once the accept queue is full Linux drops the client's handshake ACK,
    # the client believes it is connected, and when the server's SYN-ACK
    # retries exhaust it RSTs — the client sees ECONNRESET mid-response.
    # Size for serve-time bursts (the serial engine drains one multi-second
    # request at a time, so the queue really does reach client-count depth).
    request_queue_size = 128

    def server_close(self):  # noqa: N802 (stdlib name)
        super().server_close()
        if self.coalescer is not None:
            self.coalescer.shutdown()


class _SerialHTTPServer(HTTPServer):
    """One-connection-at-a-time server (coalesce=off): requests serialize
    on the accept loop itself, so waiting clients sit in the listen
    backlog — which therefore needs burst-depth, not the stdlib 5."""

    request_queue_size = 128


def make_server(engine, host: str = "127.0.0.1", port: int = 8080,
                coalesce: bool = False, max_batch: int = 1024,
                max_wait_ms: float = 4.0,
                coalesce_pipeline: bool = True) -> HTTPServer:
    """Build (not start) the HTTP server; ``.serve_forever()`` to run.

    Port 0 binds an ephemeral port (tests); the bound address is
    ``server.server_address``. ``coalesce=True`` serves connections on
    threads and merges concurrent /search requests into batched engine
    calls (see module docstring); ``max_wait_ms`` bounds the added latency
    (a lone request waits at most that long for company). Merged batches
    are padded up to the next power of two so the batch shapes the engine
    sees stay few — pick ``max_batch`` as a power of two.
    """
    coalescer = _Coalescer(engine, max_batch, max_wait_ms / 1e3,
                           pipeline=coalesce_pipeline) \
        if coalesce else None

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"  # keep-alive; Content-Length is
        # sent on every reply, so framing is always explicit
        # Requests serialize on ONE thread: a client that stalls mid-
        # request (never sends the request line, or undershoots its own
        # Content-Length) must not wedge the service — time out its socket
        # and move on
        timeout = 60

        # stdlib logs every request to stderr by default; route to our
        # namespaced logger at debug level instead
        def log_message(self, fmt, *args):  # noqa: N802 (stdlib name)
            logger.debug("%s %s", self.address_string(), fmt % args)

        def _reply(self, code: int, obj: dict) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            if coalescer is None:
                # Serial mode handles ONE connection at a time: a pooled
                # client (requests.Session, a fronting load balancer)
                # holding an idle keep-alive socket would head-of-line
                # block every other client for up to the 60 s timeout.
                # Close after every response; waiting clients then only
                # queue behind ACTIVE requests, never idle sockets. The
                # threaded coalescing mode keeps persistent connections.
                self.close_connection = True
                self.send_header("Connection", "close")
            self.end_headers()
            self.wfile.write(body)

        @staticmethod
        def _live_docs() -> int:
            # LIVE document count: base index + serve-time delta adds
            # - tombstoned rows (freshness pushes must be visible here)
            docs = int(engine.index.size)
            if engine._delta is not None:
                docs += int(engine._delta.n)
            return docs - len(engine._dead)

        def do_GET(self):  # noqa: N802
            if self.path == "/healthz":
                self._reply(200, {"ok": True, "docs": self._live_docs()})
            elif self.path == "/statz":
                # ops view: freshness-layer sizes + device-BM25 phase
                # timings/certificate stats (index/bm25_tpu.py::stats)
                self._reply(200, {
                    "docs": self._live_docs(),
                    "base_docs": int(engine.index.size),
                    "delta_docs": (int(engine._delta.n)
                                   if engine._delta is not None else 0),
                    "tombstones": len(engine._dead),
                    "device_bm25": (dict(engine._device_bm25.stats)
                                    if engine._device_bm25 is not None
                                    else None),
                    "coalesce": (None if coalescer is None else {
                        "batches": coalescer.batches,
                        "merged_requests": coalescer.merged_requests,
                        "queue_wait_s": coalescer.queue_wait_s,
                        "queue_wait_max_ms": coalescer.queue_wait_max_ms,
                        "max_batch": coalescer.max_batch,
                        "max_wait_ms": coalescer.max_wait_s * 1e3,
                    }),
                })
            else:
                self._reply(404, {"error": f"unknown path {self.path}"})

        @staticmethod
        def _str_list(req, key):
            v = req.get(key)
            if (not isinstance(v, list) or not v
                    or not all(isinstance(s, str) for s in v)):
                raise ValueError(
                    f"{key} must be a non-empty list of strings")
            if len(v) > _MAX_ITEMS:
                raise ValueError(
                    f"{key} has {len(v)} items (cap {_MAX_ITEMS}); "
                    "split into multiple requests")
            return v

        # every engine call goes through exactly one thread: the handler
        # itself (single-thread mode) or the coalescer's dispatcher
        @staticmethod
        def _search(queries, k, hybrid, rerank_top):
            if coalescer is not None:
                return coalescer.submit(_Op(
                    "search", queries=queries, params=(k, hybrid, rerank_top)))
            with _engine_scope(engine):
                return engine.search(queries, k=k, hybrid=hybrid,
                                     rerank_top=rerank_top)

        @staticmethod
        def _mutate(fn):
            if coalescer is not None:
                return coalescer.submit(_Op("mutate", fn=fn))
            with _engine_scope(engine):
                return fn()

        def _handle(self, req: dict) -> dict:
            if self.path == "/search":
                results = self._search(
                    self._str_list(req, "queries"),
                    k=int(req.get("k", 10)),
                    hybrid=bool(req.get("hybrid", True)),
                    rerank_top=int(req.get("rerank_top", 0)),
                )
                return {"results": [
                    [_hit_dict(h) for h in hits] for hits in results
                ]}
            if self.path == "/add":
                ids = self._str_list(req, "chunk_ids")
                texts = self._str_list(req, "texts")
                if len(ids) != len(texts):
                    raise ValueError("chunk_ids and texts length mismatch")
                self._mutate(lambda: engine.add_documents(ids, texts))
                return {"added": len(ids), "docs": self._live_docs()}
            if self.path == "/remove":
                n = self._mutate(lambda: engine.remove_documents(
                    self._str_list(req, "chunk_ids")))
                return {"removed": n, "docs": self._live_docs()}
            if self.path == "/compact":
                self._mutate(engine.compact)
                return {"ok": True, "docs": self._live_docs()}
            raise _UnknownPath(self.path)

        def do_POST(self):  # noqa: N802
            try:
                try:
                    n = int(self.headers.get("Content-Length", ""))
                except (TypeError, ValueError):
                    # absent/malformed framing (incl. chunked TE, which this
                    # server doesn't parse): the body's extent is unknown,
                    # so any leftover bytes would desync the next request
                    # on a kept-alive connection — reply and close it
                    self.close_connection = True
                    self._reply(411, {"error": "Content-Length required"})
                    return
                if n < 0 or n > _MAX_BODY:
                    # reject without reading; the unread body poisons the
                    # connection, so don't reuse it
                    self.close_connection = True
                    self._reply(413, {"error": "bad body size"})
                    return
                req = json.loads(self.rfile.read(n) or b"{}")
                self._reply(200, self._handle(req))
            except _UnknownPath:
                self._reply(404, {"error": f"unknown path {self.path}"})
            except (ValueError, TypeError) as exc:
                # request-shape errors from _handle's own parsing; engine
                # exceptions (incl. KeyError/IndexError) take the 500 path
                # below so they're logged as failures, not blamed on input
                self._reply(400, {"error": str(exc)})
            except Exception as exc:  # engine failure -> 500, keep serving
                logger.exception("%s failed", self.path)
                self._reply(500, {"error": f"{type(exc).__name__}: {exc}"})

    if coalescer is not None:
        srv = _CoalescingHTTPServer((host, port), Handler)
        srv.coalescer = coalescer
    else:
        srv = _SerialHTTPServer((host, port), Handler)
    logger.info("search server on http://%s:%d (docs=%d, coalesce=%s)",
                *srv.server_address, engine.index.size, coalesce)
    return srv
