"""Minimal blocking client of the split service (reference
``spark_bam_tpu/serve/client.py``; it speaks to either package's server).

One socket, one request at a time. Raises :class:`ServeClientError` for
non-ok responses, so callers get typed failures.

``Overloaded`` responses are retried in place: the server's
``retry_after_ms`` hint, floored by the policy's backoff schedule, capped
at ``backoff_max`` and jittered, paces up to ``max_retries`` re-sends
before the error surfaces. Pass ``policy=None`` to fail fast instead.

``batch`` and ``aggregate`` requests survive a lost connection mid-stream:
the client keeps the frames it has read, reconnects and asks again with
``resume_from=<frames held>``; the reassembled list equals an undisturbed
response.

With ``transport="auto"`` (the default) each connection opens with a
``hello`` asking for the shared-memory frame transport; when granted the
client maps the server's ring segment and reads frames by descriptor.
Every failure on that path raises :class:`~.shm.ShmError`, a
``ConnectionError``, so it rides the same reconnect loop; after two shm
strikes the client stays on sockets (``transport="socket"`` forces that
from the start). ``map_frames=True`` returns frames as memoryviews into
the segment, acked at the next request or at :meth:`release_frames`.
"""

from __future__ import annotations

import json
import random
import socket
import struct
import time

from spark_bam_tpu_torch import obs
from spark_bam_tpu_torch.core.faults import FaultPolicy
from spark_bam_tpu_torch.serve import shm
from spark_bam_tpu_torch.serve.server import MAX_LINE, ServeAddress


class ServeClientError(RuntimeError):
    """Server answered ``ok: false``; ``error``/``retry_after_ms`` attached."""

    def __init__(self, resp: dict):
        self.resp = resp
        self.error = resp.get("error", "Internal")
        self.retry_after_ms = resp.get("retry_after_ms")
        super().__init__(f"{self.error}: {resp.get('message', '')}")


class ServeClient:
    def __init__(self, address, timeout: float = 120.0,
                 policy: "FaultPolicy | None" = FaultPolicy(),
                 transport: str = "auto", map_frames: bool = False):
        """``address`` is a spec string (``tcp:host:port`` / ``unix:path``),
        a ``(host, port)`` tuple, or a unix socket path. ``policy`` paces
        Overloaded retries (None = raise immediately). ``transport`` is
        ``"auto"`` (hello for shm, fall back to sockets) or ``"socket"``
        (never ask); ``map_frames`` returns shm frames as memoryviews
        with deferred acks instead of copied bytes."""
        self.policy = policy
        self._address = address
        self._timeout = timeout
        self._want_transport = transport
        self._map_frames = bool(map_frames)
        self._transport = "socket"
        self._segments: "dict[int, shm.SegmentReader]" = {}
        self._graveyard: "list[shm.SegmentReader]" = []
        self._deferred: "list[tuple[shm.SegmentReader, int, int]]" = []
        self._shm_strikes = 0
        self._next_id = 0
        self._connect()

    def _connect(self) -> None:
        address, timeout = self._address, self._timeout
        if isinstance(address, tuple):
            self._sock = socket.create_connection(address, timeout=timeout)
        else:
            addr = ServeAddress(str(address) if str(address).startswith(("unix:", "tcp:"))
                                else ("unix:" + str(address) if "/" in str(address)
                                      else str(address)))
            if addr.kind == "unix":
                self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
                self._sock.settimeout(timeout)
                self._sock.connect(addr.path)
            else:
                self._sock = socket.create_connection(
                    (addr.host, addr.port), timeout=timeout
                )
        self._rfile = self._sock.makefile("rb")
        self._handshake()

    def _reconnect(self) -> None:
        self.close(keep_segments=True)
        self._connect()

    # ----- transport negotiation -------------------------------------

    def _roundtrip(self, req: dict) -> dict:
        """One JSON line out, one in — control exchanges with no frames."""
        self._next_id += 1
        self._sock.sendall(
            (json.dumps({**req, "id": self._next_id}) + "\n").encode()
        )
        line = self._rfile.readline(MAX_LINE)
        if not line:
            raise ConnectionError("server closed the connection")
        return json.loads(line)

    def _handshake(self) -> None:
        """Ask for ``transport=shm`` unless told not to (or burned: two
        shm strikes pin the client to sockets — the universal fallback)."""
        self._transport = "socket"
        if self._want_transport == "socket" or self._shm_strikes >= 2:
            return
        resp = self._roundtrip({"op": "hello", "transport": "shm"})
        if not resp.get("ok") or resp.get("transport") != "shm":
            return
        try:
            self._open_segment(int(resp["segment_id"]), str(resp["segment"]))
        except (OSError, shm.ShmError, KeyError, ValueError):
            # Granted but unmappable (container boundary, permissions):
            # tell the server so it frees the ring and sends plain frames.
            obs.count("transport.downgrades")
            self._roundtrip({"op": "hello", "transport": "socket"})
            return
        self._transport = "shm"

    def _open_segment(self, seg_id: int, path: str) -> None:
        old = self._segments.pop(seg_id, None)
        if old is not None:
            # Frames already handed out may still view the old mapping
            # (map_frames / resume progress): keep it mapped until close.
            self._graveyard.append(old)
        try:
            self._segments[seg_id] = shm.SegmentReader(path, seg_id)
        except OSError as exc:
            raise shm.ShmError(f"cannot map segment {path}: {exc}") from exc

    @property
    def transport(self) -> str:
        """The negotiated transport of the CURRENT connection."""
        return self._transport

    def release_frames(self) -> None:
        """Ack every deferred (``map_frames``) range back to the server's
        reclaim cursor. Called automatically at the next request — by
        then the previous response's views must no longer be read."""
        deferred, self._deferred = self._deferred, []
        for reader, offset, length in deferred:
            reader.ack(offset, length)

    # ----- requests ---------------------------------------------------

    def request(self, op: str, **fields) -> dict:
        """Send one request and block for its response payload. Responses
        announcing ``binary_frames`` (``batch``/``aggregate``) have that many
        frames read off the transport and attached as a list of bytes
        under ``"_binary"``: concatenated they are a native columnar
        container (columnar/native.py), or an Arrow IPC stream when the
        request said ``wire=arrow``. ``Overloaded`` responses honor their
        Retry-After hint under ``self.policy``; ``batch`` and
        ``aggregate`` requests that lose the connection (or the shm
        stream) mid-read reconnect and resume from the frames already
        held (``resume_from``)."""
        self.release_frames()
        retries = self.policy.max_retries if self.policy is not None else 0
        # Frames survive across resume attempts: a mid-stream loss keeps
        # what arrived and asks only for the tail.
        progress: "list[bytes]" = (
            [] if op in ("batch", "aggregate") else None
        )
        for attempt in range(retries + 1):
            try:
                resp = self._request_once(op, fields, progress=progress)
                resp["_transport"] = self._transport
                return resp
            except ServeClientError as exc:
                if exc.error != "Overloaded" or attempt >= retries:
                    raise
                time.sleep(self._overload_delay(exc, attempt))
            except (ConnectionError, OSError, json.JSONDecodeError) as exc:
                # A death mid-JSON-line decodes as garbage; treat it the
                # same as a mid-frame cut — reconnect and resume. Shm
                # faults land here too (ShmError IS a ConnectionError);
                # repeated strikes downgrade the reconnect to sockets.
                if isinstance(exc, shm.ShmError):
                    self._shm_strikes += 1
                if progress is None or attempt >= retries:
                    raise
                self._reconnect()
        raise AssertionError("unreachable")

    def _overload_delay(self, exc: "ServeClientError", attempt: int) -> float:
        """Server hint floored by the policy's exponential schedule,
        capped at ``backoff_max``, jittered — so a fleet of rejected
        clients doesn't re-arrive in lockstep."""
        p = self.policy
        hint_s = float(exc.retry_after_ms or 0.0) / 1000.0
        d = min(p.backoff_max, max(hint_s, p.backoff_base * (2 ** attempt)))
        return d * (1 - p.jitter + p.jitter * random.random())

    def _request_once(self, op: str, fields: dict,
                      progress: "list | None" = None) -> dict:
        self._next_id += 1
        req = {"op": op, "id": self._next_id, **fields}
        # Frames held at ENTRY came from a prior severed attempt — only
        # then is this a resume (the list fills during a normal read too).
        resuming = bool(progress)
        if resuming:
            # Compose with any caller-supplied token: the server slices
            # its deterministic frame sequence at base + held frames.
            req["resume_from"] = (
                int(fields.get("resume_from") or 0) + len(progress)
            )
        self._sock.sendall((json.dumps(req) + "\n").encode())
        line = self._rfile.readline(MAX_LINE)
        if not line:
            raise ConnectionError("server closed the connection")
        resp = json.loads(line)
        if not resp.get("ok"):
            raise ServeClientError(resp)
        n_frames = int(resp.get("binary_frames") or 0)
        if n_frames:
            frames = progress if progress is not None else []
            if self._transport == "shm":
                self._read_records(n_frames, frames)
            else:
                for _ in range(n_frames):
                    (length,) = struct.unpack("<Q", self._read_exact(8))
                    frames.append(self._read_exact(length))
            resp["_binary"] = list(frames)
        elif resuming:
            # Resumed with zero frames left to serve (the loss hit after
            # the final frame): the held list IS the complete response.
            resp["_binary"] = list(progress)
        if resuming:
            # Present the reassembled response as the undisturbed one.
            resp["binary_frames"] = len(resp.get("_binary") or ())
            resp.pop("resume_from", None)
            resp.pop("total_frames", None)
        return resp

    def _read_records(self, n_frames: int, frames: list) -> None:
        """Drain ``n_frames`` transport records (serve/shm.py grammar).
        Segment announces (kind 2) may interleave and don't count."""
        got = 0
        while got < n_frames:
            kind = self._read_exact(1)[0]
            if kind == shm.REC_SEGMENT:
                seg_id, plen = shm.SEG.unpack(self._read_exact(shm.SEG.size))
                self._open_segment(seg_id, self._read_exact(plen).decode())
                continue
            if kind == shm.REC_INLINE:
                (length,) = struct.unpack("<Q", self._read_exact(8))
                frames.append(self._read_exact(length))
                got += 1
                continue
            if kind == shm.REC_SHM:
                seg_id, offset, length, crc = shm.DESC.unpack(
                    self._read_exact(shm.DESC.size)
                )
                reader = self._segments.get(seg_id)
                if reader is None:
                    raise shm.ShmError(
                        f"descriptor references unknown segment {seg_id}"
                    )
                view = reader.read(offset, length, crc)
                if self._map_frames:
                    frames.append(view)
                    self._deferred.append((reader, offset, length))
                else:
                    frames.append(bytes(view))
                    view.release()
                    reader.ack(offset, length)
                got += 1
                continue
            raise shm.ShmError(f"unknown transport record kind {kind}")

    def _read_exact(self, n: int) -> bytes:
        out = bytearray()
        while len(out) < n:
            piece = self._rfile.read(n - len(out))
            if not piece:
                raise ConnectionError(
                    "server closed the connection mid-frame"
                )
            out.extend(piece)
        return bytes(out)

    def close(self, keep_segments: bool = False) -> None:
        try:
            self._rfile.close()
        finally:
            self._sock.close()
        if not keep_segments:
            self.release_frames()
            for reader in (*self._segments.values(), *self._graveyard):
                reader.close()
            self._segments.clear()
            self._graveyard.clear()

    def __enter__(self) -> "ServeClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
