"""HTTP(S) range-GET channel (reference ``spark_bam_tpu/core/remote.py``).

``HttpRangeChannel`` is the remote ``ByteChannel``: one ranged GET a
``_read_at`` over ``http.client`` (the standard library), a keep-alive
connection a thread (the inflate and prefetch layers fan ``read_at`` out
across threads), and auth headers that may be a dict or a callable
evaluated per request (a bearer token that rotates, an S3 SigV4
signature). A throttle or 5xx answer is retried with jittered backoff and
a server's ``Retry-After``; a 200 answer to a ranged request is refused
unless it is the honest whole object from byte 0 (a server that ignores
``Range`` would otherwise hand the decoder wrong bytes); a 206 that starts
elsewhere than asked is refused too. Latency hiding is composed around it
(``core/remote_plan.py``, ``core/prefetch.py``), not built in.
"""


from __future__ import annotations

import http.client
import math
import random
import threading
import time
import urllib.parse

from spark_bam_tpu_torch.core.channel import ByteChannel


def _content_range_start(content_range: str | None) -> int | None:
    """First byte position from ``Content-Range: bytes lo-hi/total``;
    None when absent or not a byte-range form (e.g. ``bytes */total``)."""
    if not content_range:
        return None
    value = content_range.strip()
    if not value.startswith("bytes"):
        return None
    span = value[len("bytes"):].strip().split("/", 1)[0]
    lo = span.split("-", 1)[0].strip()
    return int(lo) if lo.isdigit() else None


def _parse_retry_after(value: str | None) -> float:
    """``Retry-After`` as seconds: delta-seconds or an HTTP-date (RFC 9110
    §10.2.3 allows either form); unparseable/absent → 0 (jittered
    backoff applies)."""
    if not value:
        return 0.0
    try:
        wait = float(value)
        return wait if math.isfinite(wait) else 0.0
    except ValueError:
        pass
    try:
        from email.utils import parsedate_to_datetime

        dt = parsedate_to_datetime(value)
        # An HTTP-date already in the past must not yield a negative wait
        # (callers feed this to sleep schedules): retry immediately instead.
        return max(0.0, dt.timestamp() - time.time())
    except (TypeError, ValueError, OverflowError):
        return 0.0


class HttpRangeChannel(ByteChannel):
    """Seekable reads over HTTP/1.1 ``Range: bytes=…`` requests.

    Thread-safe: each thread gets its own keep-alive connection, so
    concurrent ``read_at`` calls (prefetch depth, inflate fan-out) become
    concurrent in-flight GETs.
    """

    #: transient statuses worth retrying (GCS/S3 throttling + 5xx blips)
    RETRY_STATUSES = (429, 500, 502, 503, 504)

    def __init__(self, url: str, headers=None,
                 timeout: float = 30.0, retries: int = 3):
        super().__init__()
        self._retries = max(0, retries)
        self.url = url
        u = urllib.parse.urlsplit(url)
        if u.scheme not in ("http", "https"):
            raise ValueError(f"not an http(s) url: {url}")
        self._secure = u.scheme == "https"
        self._host = u.hostname or ""
        self._port = u.port
        self._path = u.path or "/"
        if u.query:
            self._path += "?" + u.query
        # ``headers`` may be a dict (static) or a callable
        # ``headers(method) -> dict`` evaluated per request — auth schemes
        # that sign the method + a timestamp (S3 SigV4, expiring bearer
        # tokens) need fresh headers on every attempt.
        self._headers = headers if callable(headers) else dict(headers or {})
        self._timeout = timeout
        self._local = threading.local()
        self._conns: list[http.client.HTTPConnection] = []
        self._conns_lock = threading.Lock()
        self._size: int | None = None
        self._size_lock = threading.Lock()
        self._closed = False

    # ----------------------------------------------------------- transport
    def _conn(self) -> http.client.HTTPConnection:
        conn = getattr(self._local, "conn", None)
        if conn is None:
            cls = (
                http.client.HTTPSConnection if self._secure
                else http.client.HTTPConnection
            )
            conn = cls(self._host, self._port, timeout=self._timeout)
            self._local.conn = conn
            with self._conns_lock:
                self._conns.append(conn)
        return conn

    def _request(self, method: str, extra_headers: dict):
        """One request with a single retry on a stale keep-alive socket."""
        base = (
            self._headers(method) if callable(self._headers)
            else self._headers
        )
        for attempt in (0, 1):
            conn = self._conn()
            try:
                conn.request(
                    method, self._path, headers={**base, **extra_headers}
                )
                return conn.getresponse()
            except (http.client.HTTPException, ConnectionError, OSError):
                conn.close()
                self._local.conn = None
                if attempt:
                    raise

    def _request_retrying(self, method: str, extra_headers: dict):
        """One logical request absorbing transient failures: throttle/5xx
        statuses AND connection drops mid-body (the common object-store
        blip), with bounded jittered exponential backoff (lockstep
        prefetch workers must not re-fire in synchronized bursts), a
        server-provided ``Retry-After`` honored when positive, and an
        early exit when the channel closes mid-backoff. Returns
        (resp, body)."""
        delay = 0.1
        for attempt in range(self._retries + 1):
            final = attempt == self._retries or self._closed
            wait = 0.0
            try:
                resp = self._request(method, extra_headers)
                body = resp.read()
            except (http.client.HTTPException, ConnectionError, OSError):
                # Reset during read(): drop the stale keep-alive so the
                # next attempt reconnects; retryable like a 5xx.
                conn = getattr(self._local, "conn", None)
                if conn is not None:
                    conn.close()
                    self._local.conn = None
                if final:
                    raise
            else:
                if resp.status not in self.RETRY_STATUSES or final:
                    return resp, body
                wait = _parse_retry_after(resp.headers.get("Retry-After"))
            if wait <= 0:
                wait = delay * (0.5 + random.random())
            time.sleep(min(wait, 5.0))
            delay *= 4
        raise AssertionError("unreachable: final attempt returns or raises")

    def _read_at(self, pos: int, n: int) -> bytes:
        if n <= 0 or self._closed:
            return b""
        resp, body = self._request_retrying(
            "GET", {"Range": f"bytes={pos}-{pos + n - 1}"}
        )
        if resp.status == 206:
            content_range = resp.headers.get("Content-Range")
            self._learn_size(content_range)
            # Verify the 206 actually starts where we asked: a proxy or
            # misbehaving server answering a different range would
            # otherwise hand corrupt bytes to the decoder as if correct.
            got = _content_range_start(content_range)
            if got is not None and got != pos:
                from spark_bam_tpu_torch.core.guard import StructurallyInvalid

                raise StructurallyInvalid(
                    f"server answered range starting at {got}, "
                    f"requested {pos} (Content-Range: {content_range!r})",
                    path=self.url, pos=pos,
                )
            return body
        if resp.status == 200:
            # Server ignored the Range header and sent the full body. A
            # 200 is only honest when we asked from byte 0 and got at most
            # what we asked for; otherwise silently slicing would mask a
            # broken range path (and re-download the object per read).
            if pos == 0 and len(body) <= n:
                self._size = len(body)
                return body
            from spark_bam_tpu_torch.core.guard import StructurallyInvalid

            raise StructurallyInvalid(
                f"server ignored Range header (HTTP 200 full body, "
                f"{len(body)} bytes) for range {pos}+{n}",
                path=self.url, pos=pos,
            )
        if resp.status == 416:  # requested range past EOF
            self._learn_size(resp.headers.get("Content-Range"))
            return b""
        raise IOError(f"GET {self.url} range {pos}+{n}: HTTP {resp.status}")

    def _learn_size(self, content_range: str | None):
        # "bytes 0-99/12345" or "bytes */12345"
        if content_range and "/" in content_range:
            total = content_range.rsplit("/", 1)[1]
            if total.isdigit():
                self._size = int(total)

    @property
    def size(self) -> int:
        # Double-checked: the HEAD (with its retry backoff) runs outside
        # the lock so a throttled probe can't stall every thread that
        # touches ``size``; a rare duplicate probe is harmless.
        if self._size is None:
            resp, _ = self._request_retrying("HEAD", {})
            length = resp.headers.get("Content-Length")
            if resp.status == 404:
                # Distinguishable "missing" (sidecar probes rely on it);
                # other statuses are real errors and must propagate.
                raise FileNotFoundError(f"HEAD {self.url}: HTTP 404")
            if resp.status != 200 or length is None:
                raise IOError(
                    f"HEAD {self.url}: HTTP {resp.status}, no length"
                )
            with self._size_lock:
                if self._size is None:
                    self._size = int(length)
        return self._size

    def close(self) -> None:
        self._closed = True
        with self._conns_lock:
            for conn in self._conns:
                try:
                    conn.close()
                except Exception:
                    pass
            self._conns.clear()
