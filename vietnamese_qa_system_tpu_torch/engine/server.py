"""HTTP serving layer with request micro-batching.

Counterpart of ``vietnamese_qa_system_tpu/engine/server.py`` for the
retrieval endpoints: concurrent requests land in a queue and one worker
drains up to ``max_batch`` of them into one batched retrieval call, so the
top-k kernel scores many queries per launch.  The worker thread launches on
its own current CUDA stream (the kernel wrappers look it up at each call).

Endpoints (JSON over stdlib http.server):

- ``GET /healthz`` -> {"ok": true, "index_size": N, "stats": {...}}
- ``POST /search`` {"query": str, "k": int?} -> ranked contexts
- ``POST /ingest`` {"texts": [str, ...], "sources": [str, ...]?} ->
  {"ids": [...]} -- online index growth (when built with an
  IngestPipeline).

``/qa`` and ``/generate`` need the reader LM, which is not ported yet.
"""

from __future__ import annotations

import json
import queue
import threading
import time
from concurrent.futures import Future
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional, Sequence

from ..ops.topk import MAX_K


class MicroBatcher:
    """Collects concurrent submissions into batched calls of ``fn``.

    ``fn`` maps a list of items to a list of results (same length/order).
    ``submit`` returns a Future resolved by the worker thread.  The first
    item of a batch is taken blocking; the worker then drains whatever
    arrives within ``max_wait_s`` (or until ``max_batch``), so an idle
    server adds zero latency and a loaded one amortizes dispatches.
    """

    def __init__(
        self,
        fn: Callable[[list], list],
        max_batch: int = 32,
        max_wait_s: float = 0.005,
    ):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.fn = fn
        self.max_batch = max_batch
        self.max_wait_s = max_wait_s
        self.stats = {"requests": 0, "batches": 0, "max_batch": 0}
        self._q: queue.SimpleQueue = queue.SimpleQueue()
        self._stop = False
        # serializes the stop-check+enqueue against close(): without it a
        # submit that passes the check while close() drains can land its
        # item in a queue nobody reads, leaving the Future to time out
        self._submit_lock = threading.Lock()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def submit(self, item) -> Future:
        fut: Future = Future()
        with self._submit_lock:
            if self._stop:
                raise RuntimeError("batcher is closed")
            self._q.put((item, fut))
        return fut

    def _loop(self) -> None:
        while not self._stop:
            try:
                batch = [self._q.get(timeout=0.05)]
            except queue.Empty:
                continue
            deadline = time.monotonic() + self.max_wait_s
            while len(batch) < self.max_batch:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    batch.append(self._q.get(timeout=remaining))
                except queue.Empty:
                    break
            items = [it for it, _ in batch]
            try:
                results = self.fn(items)
                if len(results) != len(items):
                    raise RuntimeError(
                        f"batch fn returned {len(results)} results "
                        f"for {len(items)} items"
                    )
                for (_, fut), res in zip(batch, results):
                    fut.set_result(res)
            except Exception as exc:  # noqa: BLE001 — fail the waiters, not the worker
                for _, fut in batch:
                    if not fut.done():
                        fut.set_exception(exc)
            self.stats["requests"] += len(batch)
            self.stats["batches"] += 1
            self.stats["max_batch"] = max(self.stats["max_batch"], len(batch))

    def close(self) -> None:
        with self._submit_lock:
            self._stop = True
        self._thread.join(timeout=1.0)
        # fail anything still queued instead of leaving its waiter to
        # hang until the request timeout
        while True:
            try:
                _, fut = self._q.get_nowait()
            except queue.Empty:
                break
            if not fut.done():
                fut.set_exception(RuntimeError("batcher closed"))


class ServingApp:
    """Request routing + batching over a Retriever (and an optional
    IngestPipeline for online growth)."""

    def __init__(
        self,
        retriever,
        *,
        ingest=None,
        k: int = 10,
        max_k: Optional[int] = None,
        max_batch: int = 32,
        max_wait_s: float = 0.005,
        timeout_s: float = 60.0,
        max_ingest_texts: int = 4096,
    ):
        self.retriever = retriever
        self.ingest = ingest
        self.k = k
        # every dispatch runs top-k at this one value and slices per request
        self.max_k = max(k, max_k or k)
        if self.max_k > MAX_K:
            raise ValueError(
                f"max_k={self.max_k} exceeds the top-k kernel limit {MAX_K}; "
                "failing at startup beats a 500 on every request"
            )
        self.timeout_s = timeout_s
        self.max_ingest_texts = max_ingest_texts
        # set once an ingest mutates the in-memory index, so the owner
        # knows a save is needed for the writes to survive a restart
        self.dirty = False
        # serializes index mutation against scoring
        self._lock = threading.Lock()
        # per-endpoint latency windows (seconds), newest-1024 each
        self._latencies: dict[str, list[float]] = {}
        self._lat_lock = threading.Lock()
        self._search_batcher = MicroBatcher(self._search_batch, max_batch, max_wait_s)

    # ---- batched backend (runs on the batcher worker thread) ----

    def _search_batch(self, items: list[tuple[str, int]]) -> list[dict]:
        queries = [q for q, _ in items]
        with self._lock:
            rows = self.retriever.search(queries, k=self.max_k)
        out = []
        for (_, kk), row in zip(items, rows):
            out.append(
                {
                    "results": [
                        {"id": r.id, "score": round(r.score, 6), "doc": r.doc, "source": r.source}
                        for r in row[:kk]
                    ]
                }
            )
        return out

    # ---- request entry points (called from HTTP handler threads) ----

    def _timed(self, endpoint: str, fut: Future):
        t0 = time.monotonic()
        try:
            return fut.result(timeout=self.timeout_s)
        finally:
            with self._lat_lock:
                lat = self._latencies.setdefault(endpoint, [])
                lat.append(time.monotonic() - t0)
                if len(lat) > 1024:
                    del lat[:-1024]

    def search(self, query: str, k: Optional[int] = None) -> dict:
        # validate BEFORE submit: a bad k must fail only its own request
        if k is None:
            k = self.k
        if isinstance(k, bool) or not isinstance(k, int) or not (1 <= k <= self.max_k):
            raise ValueError(f"'k' must be an int in [1, {self.max_k}], got {k!r}")
        return self._timed("search", self._search_batcher.submit((query, k)))

    def add_texts(self, texts: Sequence[str], sources=None) -> dict:
        if self.ingest is None:
            raise LookupError("no ingest pipeline configured")
        if not texts:
            raise ValueError("empty 'texts'")
        if len(texts) > self.max_ingest_texts:
            raise ValueError(
                f"too many texts in one request ({len(texts)} > {self.max_ingest_texts}); split the upload"
            )
        if sources is not None:
            if isinstance(sources, str) or not isinstance(sources, (list, tuple)):
                raise ValueError("'sources' must be a list of strings")
            if len(sources) != len(texts):
                raise ValueError(f"'sources' length {len(sources)} != 'texts' length {len(texts)}")
            if not all(s is None or isinstance(s, str) for s in sources):
                raise ValueError("'sources' entries must be strings (or null)")
        # the embed is pure and slow -- run it outside the lock; hold the
        # lock only for the index/docstore write
        texts = list(texts)
        vecs = self.ingest.embed_texts(texts)
        with self._lock:
            ids = self.ingest.index_vectors(vecs, texts, sources)
        self.dirty = True
        return {"ids": [int(i) for i in ids], "index_size": self.retriever.store.size}

    def health(self) -> dict:
        stats = {"search": dict(self._search_batcher.stats)}
        with self._lat_lock:
            snapshot = {k: list(v) for k, v in self._latencies.items()}
        for endpoint, lat in snapshot.items():
            window = sorted(lat)
            if window:
                stats.setdefault(endpoint, {})["latency_ms"] = {
                    "n": len(window),
                    "p50": round(window[len(window) // 2] * 1e3, 2),
                    "p95": round(window[int(len(window) * 0.95) if len(window) > 1 else 0] * 1e3, 2),
                    "max": round(window[-1] * 1e3, 2),
                }
        return {
            "ok": True,
            "index_size": self.retriever.store.size,
            "ingest": self.ingest is not None,
            "stats": stats,
        }

    def close(self) -> None:
        self._search_batcher.close()


def make_server(app: ServingApp, host: str = "127.0.0.1", port: int = 0):
    """ThreadingHTTPServer bound to ``app`` (port 0 = ephemeral).

    Threaded handlers matter: each request blocks on its Future while the
    batcher worker runs the device work, so concurrency is what lets
    batches form at all.
    """

    class Server(ThreadingHTTPServer):
        # stdlib default listen backlog is 5 — a burst of concurrent
        # clients (the whole point of micro-batching) gets connection
        # resets before the accept loop ever sees them
        request_queue_size = 128
        daemon_threads = True
        allow_reuse_address = True

    class Handler(BaseHTTPRequestHandler):
        # socket inactivity timeout (honored by StreamRequestHandler.setup):
        # a client that promises Content-Length bytes and stalls would
        # otherwise pin its handler thread forever
        timeout = 65
        # parsed before any body read: a lying Content-Length can't make
        # the server buffer an arbitrarily large body before the
        # max_ingest_texts check ever runs
        max_body_bytes = 64 << 20

        def log_message(self, *args) -> None:  # quiet by default
            pass

        def _reply(self, code: int, payload: dict) -> None:
            body = json.dumps(payload, ensure_ascii=False).encode("utf-8")
            self.send_response(code)
            self.send_header("Content-Type", "application/json; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self) -> None:
            if self.path == "/healthz":
                self._reply(200, app.health())
            else:
                self._reply(404, {"error": f"unknown path {self.path}"})

        def do_POST(self) -> None:
            try:
                n = int(self.headers.get("Content-Length", 0))
                if n < 0 or n > self.max_body_bytes:
                    self._reply(
                        413,
                        {"error": f"body of {n} bytes exceeds the "
                                  f"{self.max_body_bytes}-byte limit"},
                    )
                    return
                req = json.loads(self.rfile.read(n) or b"{}")
            except (ValueError, json.JSONDecodeError) as exc:
                self._reply(400, {"error": f"bad request body: {exc}"})
                return
            except (TimeoutError, OSError):
                # stalled or vanished client — nothing useful to reply to
                self.close_connection = True
                return
            if not isinstance(req, dict):
                self._reply(400, {"error": "request body must be a JSON object"})
                return
            try:
                if self.path == "/search":
                    query = req.get("query")
                    if not isinstance(query, str) or not query.strip():
                        self._reply(400, {"error": "missing 'query'"})
                        return
                    self._reply(200, app.search(query, req.get("k")))
                elif self.path == "/ingest":
                    texts = req.get("texts")
                    if not isinstance(texts, list) or not all(
                        isinstance(t, str) for t in texts
                    ):
                        self._reply(400, {"error": "'texts' must be a list of strings"})
                        return
                    self._reply(200, app.add_texts(texts, req.get("sources")))
                else:
                    self._reply(404, {"error": f"unknown path {self.path}"})
            except (LookupError, ValueError) as exc:
                self._reply(400, {"error": str(exc)})
            except Exception as exc:  # noqa: BLE001 — report, don't kill the server
                self._reply(500, {"error": f"{type(exc).__name__}: {exc}"})

    return Server((host, port), Handler)
