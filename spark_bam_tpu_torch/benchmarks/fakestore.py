"""An in-process fake object store (reference ``spark_bam_tpu/
benchmarks/fakestore.py``): ranged GETs on ``127.0.0.1`` with seeded
pathologies, the stand-in origin of the remote tests, the smoke's remote
phase and ``benchmarks/profile_remote.py``. It binds the loopback address
only and needs no network.

It serves one object (``data``/``key``) or many (``objects``) at any path
ending in a registered key; every other path answers 404, so a sidecar
probe reads as absent. Beyond ``latency_s`` a request:

- ``jitter_s``: uniform extra latency;
- ``straggler_rate`` / ``straggler_factor``: a seeded fraction takes
  ``factor`` times the base latency (the tail hedged GETs cut);
- ``throttle_rate`` / ``retry_after_s``: a seeded fraction answers 429
  with ``Retry-After``;
- ``bandwidth_Bps``: responses share one token bucket, so throughput stops
  growing with request depth once the pipe is full;
- ``ignore_range``: a 200 with the whole body despite ``Range``;
- ``require_bearer``: a 403 without ``Authorization: Bearer <token>``.

Each request draws from ``random.Random((seed << 20) ^ request_index)``,
so a seed replays the same storm.
"""

from __future__ import annotations

import http.server
import random
import sys
import threading
import time


class FakeObjectStore:
    """``with FakeObjectStore(data, key="obj.bam", latency_s=0.1) as s:``
    exposes ``s.url_base`` (http://127.0.0.1:port) and live ``s.stats``
    (``requests``, ``auth_failures``, ``stragglers``, ``throttles``)."""

    def __init__(
        self,
        data: bytes = b"",
        key: str = "remote.bam",
        latency_s: float = 0.0,
        require_bearer: str | None = None,
        objects: "dict[str, bytes] | None" = None,
        jitter_s: float = 0.0,
        straggler_rate: float = 0.0,
        straggler_factor: float = 10.0,
        throttle_rate: float = 0.0,
        retry_after_s: float = 0.05,
        bandwidth_Bps: float | None = None,
        seed: int = 0,
        ignore_range: bool = False,
    ):
        #: key → bytes; the single-object (data, key) form maps into it.
        self.objects = dict(objects) if objects is not None else {key: data}
        self.latency_s = latency_s
        self.require_bearer = require_bearer
        self.jitter_s = jitter_s
        self.straggler_rate = straggler_rate
        self.straggler_factor = straggler_factor
        self.throttle_rate = throttle_rate
        self.retry_after_s = retry_after_s
        self.bandwidth_Bps = bandwidth_Bps
        self.seed = seed
        self.ignore_range = ignore_range
        self.stats = {
            "requests": 0, "auth_failures": 0,
            "stragglers": 0, "throttles": 0,
        }
        self._lock = threading.Lock()
        self._bw_free_at = 0.0  # shared-pipe model: when the pipe frees up
        store = self

        class Handler(http.server.BaseHTTPRequestHandler):
            # HTTP/1.1 keep-alive, like a real object-store front end.
            # The default (HTTP/1.0, close-per-response) forces every GET
            # through a fresh TCP connect; under deep prefetch bursts the
            # listener backlog overflows and dropped SYNs retransmit after
            # ~1 s, which reads as fake 10×-RTT stragglers.
            protocol_version = "HTTP/1.1"

            def _empty(self, status: int, headers: dict | None = None):
                self.send_response(status)
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                self.send_header("Content-Length", "0")
                self.end_headers()

            def _object(self) -> bytes | None:
                for key, data in store.objects.items():
                    if self.path.endswith("/" + key):
                        return data
                return None

            def _gate(self) -> bytes | None:
                """Admission: accounting, latency model, 404/403/429.
                Returns the object bytes, or None when a response was
                already sent."""
                with store._lock:
                    store.stats["requests"] += 1
                    idx = store.stats["requests"]
                # Deterministic per-request pathology: same seed, same
                # request ordinal → same jitter/straggler/throttle draw.
                rng = random.Random((store.seed << 20) ^ idx)
                wait = store.latency_s
                if store.jitter_s:
                    wait += rng.uniform(0.0, store.jitter_s)
                if (
                    store.straggler_rate
                    and rng.random() < store.straggler_rate
                ):
                    with store._lock:
                        store.stats["stragglers"] += 1
                    wait *= store.straggler_factor
                if wait:
                    time.sleep(wait)
                if (
                    store.throttle_rate
                    and rng.random() < store.throttle_rate
                ):
                    with store._lock:
                        store.stats["throttles"] += 1
                    self._empty(
                        429, {"Retry-After": f"{store.retry_after_s:g}"}
                    )
                    return None
                data = self._object()
                if data is None:
                    self._empty(404)
                    return None
                if store.require_bearer is not None:
                    ok = (
                        self.headers.get("Authorization")
                        == f"Bearer {store.require_bearer}"
                    )
                    if not ok:
                        with store._lock:
                            store.stats["auth_failures"] += 1
                        self._empty(403)
                        return None
                return data

            def _pipe(self, nbytes: int) -> None:
                """Shared-bandwidth model: every response reserves pipe
                time; concurrent transfers queue behind each other, so
                aggregate throughput caps at ``bandwidth_Bps`` no matter
                the request depth."""
                if not store.bandwidth_Bps:
                    return
                cost = nbytes / store.bandwidth_Bps
                with store._lock:
                    now = time.monotonic()
                    start = max(now, store._bw_free_at)
                    store._bw_free_at = start + cost
                    done_at = store._bw_free_at
                delay = done_at - time.monotonic()
                if delay > 0:
                    time.sleep(delay)

            def do_HEAD(self):
                data = self._gate()
                if data is None:
                    return
                self.send_response(200)
                self.send_header("Content-Length", str(len(data)))
                self.send_header("Accept-Ranges", "bytes")
                self.end_headers()

            def do_GET(self):
                data = self._gate()
                if data is None:
                    return
                rng = self.headers.get("Range")
                if rng and not store.ignore_range:
                    lo_s, _, hi_s = rng.split("=")[1].partition("-")
                    lo = int(lo_s)
                    # RFC 9110: an open-ended "bytes=lo-" runs to the end.
                    hi = int(hi_s) if hi_s else len(data) - 1
                    hi = min(hi, len(data) - 1)
                    if lo >= len(data):
                        self.send_response(416)
                        self.send_header(
                            "Content-Range", f"bytes */{len(data)}"
                        )
                        self.send_header("Content-Length", "0")
                        self.end_headers()
                        return
                    body = data[lo:hi + 1]
                    self._pipe(len(body))
                    self.send_response(206)
                    self.send_header(
                        "Content-Range",
                        f"bytes {lo}-{lo + len(body) - 1}/{len(data)}",
                    )
                else:
                    body = data
                    self._pipe(len(body))
                    self.send_response(200)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):
                pass

        class _Server(http.server.ThreadingHTTPServer):
            daemon_threads = True
            request_queue_size = 128  # absorb depth-64 connect bursts

            def handle_error(self, request, client_address):
                # A reader that hung up mid-response (a hedge's loser, a
                # channel closed with read-ahead in flight) is no fault of
                # the store.
                if isinstance(sys.exc_info()[1], ConnectionError):
                    return
                super().handle_error(request, client_address)

        self._srv = _Server(("127.0.0.1", 0), Handler)
        self.url_base = f"http://127.0.0.1:{self._srv.server_port}"
        self._thread = threading.Thread(
            target=self._srv.serve_forever, daemon=True
        )
        self._thread.start()

    @property
    def data(self) -> bytes:
        """Single-object back-compat accessor (first registered object)."""
        return next(iter(self.objects.values()))

    @property
    def key(self) -> str:
        return next(iter(self.objects))

    def close(self):
        self._srv.shutdown()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
