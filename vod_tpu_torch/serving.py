"""Thin cross-process search server (port of `vod_tpu/serving.py`).

A stdlib HTTP wrapper around a `HybridEngines` bundle: `/ping` for readiness,
`/stats` for the batcher's counts, `/search` for base64-numpy payloads.
Concurrent requests ride one device dispatch through `MicroBatcher`. The
engines' tensors stay on the card; each dispatch moves the query arrays there
and the results back. PyTorch runs eagerly, so there is no compile cache;
`warmup` still drives every batch bucket once before traffic.

Usage:
    server = SearchServer(engines, batch_window_ms=2)   # engines on "cuda"
    with server:                       # serves on a daemon thread
        out = SearchHttpClient(server.url).search(vector=..., top_k=10)
"""

from __future__ import annotations

import json
import queue
import threading
import typing as typ
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from vod_tpu_torch.search.base import SearchQueries
from vod_tpu_torch.search.hybrid import HybridEngines, hybrid_search
from vod_tpu_torch.search.io import decode_payload, encode_payload
from vod_tpu_torch.types.retrieval import RetrievalBatch


def free_port() -> int:
    """Parity: `vod_search/socket.py:4`."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class _Pending:
    __slots__ = ("arrays", "top_k", "rows", "event", "result", "error")

    def __init__(self, arrays: dict[str, np.ndarray], top_k: int, rows: int):
        self.arrays = arrays
        self.top_k = top_k
        self.rows = rows
        self.event = threading.Event()
        self.result: typ.Optional[dict[str, np.ndarray]] = None
        self.error: typ.Optional[BaseException] = None


def _bucket(n: int, max_batch: int) -> int:
    """Next power-of-two >= n, capped at max_batch: a handful of batch shapes,
    so the kernels and the allocator see a few sizes instead of every size."""
    b = 1
    while b < n:
        b *= 2
    return min(b, max_batch)


class MicroBatcher:
    """Micro-batching + shape-bucketing front for a batched search callable.

    One exhaustive scan costs nearly the same for 1 query as for 64 (it is
    bound by reading the corpus), so throughput comes from riding concurrent
    requests on ONE device dispatch.

    Semantics: `submit` blocks until the worker has (a) drained every
    compatible pending request up to `max_batch` rows — compatible = same
    top_k, same field set, same per-field trailing dims — or waited
    `window_ms` since the first pending request, (b) concatenated the rows,
    padded the batch up to the next power-of-two bucket by repeating the
    first row, (c) run `search_fn(arrays, top_k)`
    ONCE, and (d) split the row ranges back per request. Padding rows are
    computed and discarded.
    """

    def __init__(
        self,
        search_fn: typ.Callable[[dict[str, np.ndarray], int], dict[str, np.ndarray]],
        *,
        max_batch: int = 64,
        window_ms: float = 2.0,
    ):
        self.search_fn = search_fn
        self.max_batch = int(max_batch)
        self.window_s = float(window_ms) / 1e3
        self._q: "queue.Queue[_Pending]" = queue.Queue()
        # incompatible requests pulled mid-collection wait here and are
        # consumed AHEAD of _q next cycle (re-queuing at the tail would defer
        # a minority-key request behind newer arrivals, unboundedly under load)
        self._held: "list[_Pending]" = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()
        self.dispatches = 0  # observability: device dispatches issued
        self.requests = 0
        self._stats_lock = threading.Lock()  # handler threads are concurrent

    @staticmethod
    def _key(p: _Pending) -> tuple:
        return (p.top_k, tuple(sorted((k, v.shape[1:]) for k, v in p.arrays.items())))

    def _worker(self) -> None:
        while not self._stop.is_set():
            if self._held:  # deferred requests go first — bounded deferral
                first = self._held.pop(0)
            else:
                try:
                    first = self._q.get(timeout=0.1)
                except queue.Empty:
                    continue
            batch = [first]
            rows = first.rows
            key = self._key(first)
            deadline = _now() + self.window_s
            held_next: list[_Pending] = []
            # drain compatible held requests before touching the queue
            for p in self._held:
                if self._key(p) == key and rows + p.rows <= self.max_batch:
                    batch.append(p)
                    rows += p.rows
                else:
                    held_next.append(p)
            self._held = held_next
            while rows < self.max_batch:
                remaining = deadline - _now()
                if remaining <= 0:
                    break
                try:
                    nxt = self._q.get(timeout=remaining)
                except queue.Empty:
                    break
                if self._key(nxt) == key and rows + nxt.rows <= self.max_batch:
                    batch.append(nxt)
                    rows += nxt.rows
                else:
                    self._held.append(nxt)  # incompatible/overflow: next cycle
            self._run(batch, rows)

    def _run(self, batch: list[_Pending], rows: int) -> None:
        try:
            arrays = {
                k: np.concatenate([p.arrays[k] for p in batch], axis=0)
                for k in batch[0].arrays
            }
            bucket = _bucket(rows, max(self.max_batch, rows))
            if bucket > rows:  # pad by repeating the first row; discarded below
                pad = bucket - rows
                arrays = {
                    k: np.concatenate([v, np.repeat(v[:1], pad, axis=0)], axis=0)
                    for k, v in arrays.items()
                }
            out = self.search_fn(arrays, batch[0].top_k)
            with self._stats_lock:
                self.dispatches += 1
            start = 0
            for p in batch:
                p.result = {k: v[start : start + p.rows] for k, v in out.items()}
                start += p.rows
                p.event.set()
        except BaseException as exc:  # noqa: BLE001 - delivered to every waiter
            for p in batch:
                p.error = exc
                p.event.set()

    def submit(self, arrays: dict[str, np.ndarray], top_k: int) -> dict[str, np.ndarray]:
        if self._stop.is_set():
            raise RuntimeError("batcher closed")
        rows = next(iter(arrays.values())).shape[0]
        with self._stats_lock:
            self.requests += 1
        if rows > self.max_batch:  # oversized requests bypass the batcher
            out = self.search_fn(arrays, top_k)
            with self._stats_lock:
                self.dispatches += 1
            return out
        p = _Pending(arrays, int(top_k), rows)
        self._q.put(p)
        # bounded wait: a put() racing close()'s drain could otherwise park
        # this thread forever (close drains _q, then our put lands unseen).
        # Only give up once the worker is DEAD — an in-flight batch may still
        # complete and set the event during shutdown.
        while not p.event.wait(timeout=1.0):
            if self._stop.is_set() and not self._thread.is_alive():
                raise RuntimeError("batcher closed")
        if p.error is not None:
            raise p.error
        assert p.result is not None
        return p.result

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=2)
        # fail anything still pending (held or enqueued between the worker's
        # last check and stop) — otherwise its submitter waits forever
        pending = list(self._held)
        self._held = []
        while True:
            try:
                pending.append(self._q.get_nowait())
            except queue.Empty:
                break
        for p in pending:
            p.error = RuntimeError("batcher closed")
            p.event.set()


def _now() -> float:
    import time

    return time.monotonic()


class _HttpServer(ThreadingHTTPServer):
    # the stdlib default backlog of 5 resets connections when a few dozen
    # clients connect at once; concurrent clients are what the batcher is for
    request_queue_size = 128


class SearchServer:
    """Serve a HybridEngines bundle over HTTP on a daemon thread.

    `device` is where the engines live (default "cuda"); queries are moved
    there for each dispatch."""

    def __init__(
        self,
        engines: HybridEngines,
        *,
        weights: typ.Optional[dict[str, float]] = None,
        host: str = "127.0.0.1",
        port: typ.Optional[int] = None,
        batch_window_ms: float = 0.0,
        max_batch: int = 64,
        device: typ.Union[str, torch.device] = "cuda",
    ):
        self.device = torch.device(device)
        for engine in (e for e in (engines.dense, engines.sparse) if e is not None):
            # each index's tensor fields (a PQIndex or SparseIndex has no `vectors`)
            where = [v.device for v in vars(engine).values() if isinstance(v, torch.Tensor)]
            if where and where[0].type != self.device.type:
                raise ValueError(f"engines live on {where[0]}, but the server was asked for {self.device}")
        self.engines = engines
        self.weights = weights
        self.host = host
        self.port = port or free_port()
        self._httpd: typ.Optional[ThreadingHTTPServer] = None
        self._thread: typ.Optional[threading.Thread] = None
        # batch_window_ms > 0 rides concurrent requests on one device
        # dispatch (shape-bucketed — see MicroBatcher)
        self._batcher: typ.Optional[MicroBatcher] = None
        if batch_window_ms > 0:
            self._batcher = MicroBatcher(
                self._search_arrays, max_batch=max_batch, window_ms=batch_window_ms
            )

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def warmup(
        self,
        example: dict[str, np.ndarray],
        *,
        top_k: int = 10,
        batch_sizes: typ.Optional[typ.Sequence[int]] = None,
    ) -> None:
        """Drive the serving dispatch once at every padded batch bucket, so the
        first request of each size pays no first-call cost (kernel build and
        load, allocator growth) inside its latency. `example` is a one-row dict
        of query arrays with the field set / trailing dims / dtypes real
        requests will use. Default buckets = the MicroBatcher's power-of-two
        ladder up to max_batch (just [1] when batching is off)."""
        if batch_sizes is None:
            top = self._batcher.max_batch if self._batcher is not None else 1
            batch_sizes, b = [], 1
            while b <= top:
                batch_sizes.append(b)
                b *= 2
        for b in batch_sizes:
            arrays = {
                k: np.repeat(np.asarray(v)[:1], b, axis=0) for k, v in example.items()
            }
            self._search_arrays(arrays, top_k)

    def _search_arrays(
        self, arrays: dict[str, np.ndarray], top_k: int
    ) -> dict[str, np.ndarray]:
        sq = SearchQueries(
            **{k: torch.as_tensor(np.asarray(v), device=self.device) for k, v in arrays.items()}
        )
        with torch.inference_mode():
            merged, raw = hybrid_search(self.engines, sq, top_k, self.weights)
        out = {"scores": merged.scores, "indices": merged.indices}
        if merged.labels is not None:
            out["labels"] = merged.labels
        for name, v in raw.items():
            out[f"raw_{name}"] = v
        return {k: v.cpu().numpy() for k, v in out.items()}

    def _handle_search(self, payload: dict) -> dict:
        data = decode_payload(payload)
        top_k = int(data.pop("top_k", 10))
        arrays = {
            k: np.asarray(v)
            for k, v in data.items()
            if k in SearchQueries.__dataclass_fields__ and v is not None
        }
        if self._batcher is not None:
            out = self._batcher.submit(arrays, top_k)
        else:
            out = self._search_arrays(arrays, top_k)
        return encode_payload(out)

    def __enter__(self) -> "SearchServer":
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a: typ.Any) -> None:  # silence
                pass

            def do_GET(self) -> None:  # /ping readiness (`base.py:170`), /stats
                self.send_response(200)
                self.end_headers()
                if self.path == "/stats":
                    b = outer._batcher
                    stats = {
                        "batching": b is not None,
                        "requests": b.requests if b else None,
                        "dispatches": b.dispatches if b else None,
                    }
                    self.wfile.write(json.dumps(stats).encode())
                else:
                    self.wfile.write(b'{"ok": true}')

            def do_POST(self) -> None:
                length = int(self.headers["Content-Length"])
                payload = json.loads(self.rfile.read(length))
                try:
                    out = outer._handle_search(payload)
                    body = json.dumps(out).encode()
                    self.send_response(200)
                except Exception as exc:  # noqa: BLE001
                    body = json.dumps({"error": repr(exc)}).encode()
                    self.send_response(500)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self._httpd = _HttpServer((self.host, self.port), Handler)
        self._thread = threading.Thread(target=self._httpd.serve_forever, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc: typ.Any) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd = None
        if self._batcher is not None:
            self._batcher.close()


class SearchHttpClient:
    """Minimal client (parity: `FaissClient.search`, `client.py:64`)."""

    def __init__(self, url: str):
        self.url = url

    def ping(self) -> bool:
        try:
            with urllib.request.urlopen(self.url + "/ping", timeout=5) as r:
                return r.status == 200
        except Exception:
            return False

    def search(
        self,
        *,
        vector: typ.Optional[np.ndarray] = None,
        terms: typ.Optional[np.ndarray] = None,
        section_ids: typ.Optional[np.ndarray] = None,
        subset_ids: typ.Optional[np.ndarray] = None,
        top_k: int = 10,
    ) -> RetrievalBatch:
        payload = encode_payload(
            {
                "vector": vector,
                "terms": terms,
                "section_ids": section_ids,
                "subset_ids": subset_ids,
            }
        )
        payload["top_k"] = top_k
        req = urllib.request.Request(
            self.url + "/search",
            data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req, timeout=300) as r:
            out = decode_payload(json.loads(r.read()))
        if "error" in out:
            raise RuntimeError(out["error"])
        return RetrievalBatch(
            scores=out["scores"],
            indices=out["indices"],
            labels=out.get("labels"),
            meta={k[4:]: v for k, v in out.items() if k.startswith("raw_")},
        )
