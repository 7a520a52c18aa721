"""Serving front end: dynamic batching + a threaded HTTP server
(counterpart of fastdet/server.py).

A serving deployment needs a front end that keeps the card fed with full
batches while requests arrive one at a time, and that keeps batch shapes
to a few fixed sizes.

`DynamicBatcher` does both: concurrent requests coalesce into one
fixed-maximum batch, dispatched when the batch fills or the oldest
request has waited `max_wait_ms`.  While the device runs batch N, new
requests queue up and form batch N+1 — the same overlap discipline as
`serve.py::StreamingPipeline`, but request-driven instead of
list-driven.

`InferenceServer` puts an HTTP interface in front of a batch pipeline
(`fastdet_torch.serve.DevicePipeline`):

    POST /detect_raw  raw (X-Height, X-Width, 3) uint8 BGR pixels →
                   JSON detections (boxes in ORIGINAL image coordinates,
                   rescaled with the reference's non-aspect-preserving
                   h/H, w/W factors — test.py:57-68)
    POST /detect   image file bytes (jpeg/png/bmp) → the same
    GET  /healthz  liveness + model identity
    GET  /stats    request/batch counters (batch-size histogram tells
                   you whether the batcher is actually coalescing)

Stdlib-only (http.server + threads).  `cv2` is imported only for a
request that needs a JPEG decode or a resize, never for a raw request at
the model's size.  Every thread is a daemon; `shutdown()` stops the HTTP
loop, closes its socket and closes the batcher.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Any, Callable, List, Optional, Sequence

import numpy as np

_SENTINEL = object()


class _Pending:
    __slots__ = ("item", "event", "result", "error")

    def __init__(self, item):
        self.item = item
        self.event = threading.Event()
        self.result = None
        self.error: Optional[BaseException] = None


class DynamicBatcher:
    """Coalesce concurrent `submit` calls into batched `infer_fn` calls.

    infer_fn: Sequence[item] -> Sequence[result] (one result per item,
    same order).  A batch is dispatched when it reaches `max_batch`
    items or `max_wait_ms` after its first item arrived, whichever
    comes first.  One worker thread owns dispatch, so `infer_fn` never
    runs concurrently with itself (one stream feeds the card in order);
    requests submitted while it runs form the next batch.

    `stats` is maintained by the worker thread only; readers may see a
    slightly stale snapshot, never a torn one (dict item writes are
    atomic under the GIL).
    """

    def __init__(self, infer_fn: Callable[[Sequence[Any]], Sequence[Any]],
                 max_batch: int = 32, max_wait_ms: float = 5.0):
        import queue
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self._infer = infer_fn
        self._max_batch = max_batch
        self._max_wait = max_wait_ms / 1e3
        self._q: "queue.Queue" = queue.Queue()
        self._queue_mod = queue
        self.stats = {"requests": 0, "batches": 0, "max_batch": 0,
                      "batch_hist": {}}
        self._closed = False
        # orders submit's (check _closed, enqueue) against close's
        # (set _closed, enqueue sentinel): without it a request could
        # land BEHIND the sentinel and its caller would block forever
        # on event.wait()
        self._close_lock = threading.Lock()
        self._worker_thread = threading.Thread(target=self._worker,
                                               daemon=True)
        self._worker_thread.start()

    def submit(self, item: Any) -> Any:
        """Block until `item`'s result is ready; re-raises infer errors."""
        p = _Pending(item)
        with self._close_lock:
            if self._closed:
                raise RuntimeError("DynamicBatcher is closed")
            self._q.put(p)
        p.event.wait()
        if p.error is not None:
            # per-caller instance: the same exception object raised
            # concurrently in several waiter threads would have its
            # __traceback__ mutated cross-thread
            e = p.error
            try:
                copy = type(e)(*e.args)
            except Exception:  # noqa: BLE001 — exotic ctor: raise shared
                copy = e
            raise copy from e
        return p.result

    def close(self) -> None:
        """Drain queued requests, then stop the worker.

        The lock guarantees every request enqueued before the sentinel
        is FIFO-ahead of it, so the worker processes all of them before
        exiting; requests arriving after raise immediately."""
        with self._close_lock:
            if self._closed:
                return
            self._closed = True
            self._q.put(_SENTINEL)
        self._worker_thread.join()

    def _worker(self) -> None:
        Empty = self._queue_mod.Empty
        while True:
            first = self._q.get()
            if first is _SENTINEL:
                return
            batch: List[_Pending] = [first]
            stop_after = False
            deadline = time.monotonic() + self._max_wait
            while len(batch) < self._max_batch:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    nxt = self._q.get(timeout=remaining)
                except Empty:
                    break
                if nxt is _SENTINEL:
                    stop_after = True
                    break
                batch.append(nxt)
            try:
                results = self._infer([p.item for p in batch])
                if len(results) != len(batch):
                    raise RuntimeError(
                        f"infer_fn returned {len(results)} results for "
                        f"{len(batch)} items")
                for p, r in zip(batch, results):
                    p.result = r
            except BaseException as e:  # noqa: BLE001 — propagate to callers
                for p in batch:
                    p.error = e
            # stats BEFORE waking callers: a client reading /stats right
            # after its own response must see its request counted
            s = self.stats
            s["requests"] += len(batch)
            s["batches"] += 1
            s["max_batch"] = max(s["max_batch"], len(batch))
            hist = dict(s["batch_hist"])
            hist[str(len(batch))] = hist.get(str(len(batch)), 0) + 1
            s["batch_hist"] = hist
            for p in batch:
                p.event.set()
            if stop_after:
                return


class InferenceServer:
    """HTTP detection service over a batch pipeline.

    `pipeline` is any callable taking an (N,H,W,3) uint8 NHWC batch and
    returning a list of (n_i, 6) float arrays [x1,y1,x2,y2,conf,cls] in
    model input coordinates (`DevicePipeline` qualifies).  The server
    decodes each request's image, resizes it to the model size when it
    differs (non-letterbox INTER_LINEAR, reference datasets.py:107),
    batches across concurrent requests, and rescales boxes back to each
    request's original size.
    """

    def __init__(self, pipeline, cfg, names: Optional[List[str]] = None,
                 max_batch: int = 32, max_wait_ms: float = 5.0,
                 model_name: str = "yolo-fastestv2"):
        self._pipe = pipeline
        self._cfg = cfg
        self._names = names or [str(i) for i in range(cfg.classes)]
        self._model_name = model_name
        self._t0 = time.monotonic()
        self._batcher = DynamicBatcher(self._infer_batch,
                                       max_batch=max_batch,
                                       max_wait_ms=max_wait_ms)
        self._httpd = None
        self._serve_thread: Optional[threading.Thread] = None

    # --- batching core -------------------------------------------------
    @staticmethod
    def _bucket(n: int) -> int:
        """Next power of two ≥ n: coalesced batches arrive at any size
        1..max_batch and pad up to log2(max_batch)+1 fixed bucket sizes
        (≤2× padding waste), so cuDNN meets only a few shapes."""
        b = 1
        while b < n:
            b *= 2
        return b

    def _infer_batch(self, images: Sequence[np.ndarray]) -> List[np.ndarray]:
        n = len(images)
        batch = np.stack(list(images))
        pad = self._bucket(n) - n
        if pad:
            batch = np.concatenate(
                [batch, np.zeros((pad,) + batch.shape[1:], batch.dtype)])
        return self._pipe(batch)[:n]

    def detect_bytes(self, data: bytes) -> dict:
        """Image file bytes → JSON-ready dict (the POST /detect body)."""
        import cv2
        arr = np.frombuffer(data, np.uint8)
        img = cv2.imdecode(arr, cv2.IMREAD_COLOR)
        if img is None:
            raise ValueError("could not decode image bytes")
        return self.detect_image(img)

    def detect_raw(self, data: bytes, height: int, width: int) -> dict:
        """Raw (height, width, 3) uint8 BGR bytes → JSON-ready dict (the
        POST /detect_raw body; clients that already hold decoded pixels
        skip the server-side jpeg decode — the expensive host step)."""
        if height <= 0 or width <= 0 or len(data) != height * width * 3:
            raise ValueError(
                f"raw body is {len(data)} bytes, expected "
                f"{height}*{width}*3 = {height * width * 3}")
        img = np.frombuffer(data, np.uint8).reshape(height, width, 3)
        return self.detect_image(img)

    def detect_image(self, img: np.ndarray) -> dict:
        """Decoded HWC uint8 BGR image (any size) → JSON-ready dict."""
        h, w = img.shape[:2]
        if (h, w) != (self._cfg.height, self._cfg.width):
            import cv2
            img = cv2.resize(img, (self._cfg.width, self._cfg.height),
                             interpolation=cv2.INTER_LINEAR)
        rows = np.asarray(self._batcher.submit(img), np.float32)
        scale = np.array([w / self._cfg.width, h / self._cfg.height,
                          w / self._cfg.width, h / self._cfg.height],
                         np.float32)
        dets = []
        for row in rows:
            box = (row[:4] * scale).tolist()
            cls_id = int(row[5])
            dets.append({
                "box": [round(v, 2) for v in box],
                "score": round(float(row[4]), 4),
                "class_id": cls_id,
                "class_name": self._names[cls_id]
                if 0 <= cls_id < len(self._names) else str(cls_id),
            })
        return {"detections": dets, "count": len(dets),
                "image_size": [w, h]}

    # --- HTTP ----------------------------------------------------------
    def make_httpd(self, host: str = "127.0.0.1", port: int = 0,
                   quiet: bool = True):
        """Build (don't start) the ThreadingHTTPServer; port 0 = ephemeral."""
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def _send(self, code: int, payload: dict):
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/healthz":
                    self._send(200, {"ok": True,
                                     "model": server._model_name,
                                     "input_size": [server._cfg.width,
                                                    server._cfg.height]})
                elif self.path == "/stats":
                    s = dict(server._batcher.stats)
                    s["uptime_s"] = round(time.monotonic() - server._t0, 1)
                    self._send(200, s)
                else:
                    self._send(404, {"error": "not found"})

            def do_POST(self):
                if self.path not in ("/detect", "/detect_raw"):
                    self._send(404, {"error": "not found"})
                    return
                length = int(self.headers.get("Content-Length", 0))
                if length <= 0:
                    self._send(400, {"error": "empty body"})
                    return
                data = self.rfile.read(length)
                try:
                    if self.path == "/detect_raw":
                        h = int(self.headers.get("X-Height", 0))
                        w = int(self.headers.get("X-Width", 0))
                        self._send(200, server.detect_raw(data, h, w))
                    else:
                        self._send(200, server.detect_bytes(data))
                except ValueError as e:
                    self._send(400, {"error": str(e)})
                except Exception as e:  # noqa: BLE001 — report, don't die
                    self._send(500, {"error": repr(e)})

            def log_message(self, fmt, *args):
                if not quiet:
                    import sys
                    sys.stderr.write("%s - %s\n" % (self.address_string(),
                                                    fmt % args))

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        return self._httpd

    def start(self, host: str = "127.0.0.1", port: int = 0,
              quiet: bool = True) -> int:
        """Serve on a daemon thread; returns the bound port (port 0 =
        ephemeral).  Stop with `shutdown()`."""
        httpd = self.make_httpd(host, port, quiet=quiet)
        self._serve_thread = threading.Thread(target=httpd.serve_forever,
                                              daemon=True)
        self._serve_thread.start()
        return httpd.server_address[1]

    def serve_forever(self, host: str = "127.0.0.1", port: int = 8000,
                      quiet: bool = False) -> None:
        httpd = self.make_httpd(host, port, quiet=quiet)
        print(f"fastdet_torch server listening on http://{host}:"
              f"{httpd.server_address[1]}  (POST /detect_raw, POST /detect, "
              f"GET /healthz, GET /stats)")
        try:
            httpd.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            self.shutdown()

    def shutdown(self) -> None:
        """Stop the HTTP loop, close its socket, join the serving thread
        and close the batcher (queued requests finish first)."""
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._serve_thread is not None:
            self._serve_thread.join()
            self._serve_thread = None
        self._batcher.close()
