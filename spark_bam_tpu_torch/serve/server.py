"""Async accept loop: newline JSON over a unix socket or TCP (reference
``spark_bam_tpu/serve/server.py``).

The event loop only parses lines and shuttles futures; the real work runs
on the service's worker pool and the batcher thread, so a slow request
never stalls accepts. Each connection may pipeline requests; responses
carry the client's ``id`` and may complete out of order.

Transport negotiation lives here, not in the service: ``hello`` is
answered by the accept loop because transport is per-connection state. A
connection that negotiates ``transport=shm`` gets a ring segment
(``serve/shm.py``) and its binary frames leave as descriptor records;
every other connection keeps u64-length-prefixed frames on the socket.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import socket as _socket
import struct
import threading

from spark_bam_tpu_torch import obs
from spark_bam_tpu_torch.serve import shm
from spark_bam_tpu_torch.serve.admission import Overloaded
from spark_bam_tpu_torch.serve.protocol import (
    ProtocolError,
    decode_request,
    encode,
    error_response,
    ok_response,
)
from spark_bam_tpu_torch.serve.service import SplitService

#: Longest accepted request line; beyond this the connection is dropped.
MAX_LINE = 4 << 20


class _Conn:
    """Per-connection transport state (hello-negotiated). Touched only
    on the event loop — no locks."""

    __slots__ = ("transport", "ring", "wait_s", "chaos", "_next_seg_id")

    def __init__(self):
        self.transport = "socket"
        self.ring: "shm.SegmentWriter | None" = None
        self.wait_s = 0.2
        self.chaos = None
        self._next_seg_id = 0

    def alloc_seg_id(self) -> int:
        """Connection-unique segment ids: the router's descriptor relay
        announces upstream segments on the same id space, so its own ring
        and the remapped worker segments draw from one counter."""
        self._next_seg_id += 1
        return self._next_seg_id

    def close_ring(self) -> None:
        ring, self.ring = self.ring, None
        if ring is not None:
            ring.close()

    def detach_ring(self) -> "shm.SegmentWriter | None":
        ring, self.ring = self.ring, None
        return ring


#: How long a closing connection's ring may wait for the consumer's ack
#: cursor before it is unlinked regardless (leak bound, not correctness:
#: a consumer that mapped the segment keeps its pages either way).
_RING_LINGER_S = 10.0


async def _drain_then_close(ring: "shm.SegmentWriter", loop) -> None:
    deadline = loop.time() + _RING_LINGER_S
    try:
        while not ring.drained() and loop.time() < deadline:
            await asyncio.sleep(0.02)
    finally:
        ring.close()


def _local_peer(writer) -> bool:
    """shm segments only work same-host: unix sockets always qualify,
    TCP only from loopback."""
    sock = writer.get_extra_info("socket")
    if sock is not None and sock.family == _socket.AF_UNIX:
        return True
    peer = writer.get_extra_info("peername")
    host = peer[0] if isinstance(peer, (tuple, list)) and peer else None
    if host is None:
        return False
    host = str(host)
    return host.startswith("127.") or host == "::1"


def _hello_response(service, conn: _Conn, req: dict, writer) -> dict:
    """Negotiate the connection's transport (protocol.py ``hello``).
    Every refusal is a DOWNGRADE to sockets, never an error — the
    fallback path must always be reachable."""
    want = str(req.get("transport") or "socket")
    conn.close_ring()           # re-negotiation tears down any prior ring
    conn.transport = "socket"
    if want != "shm":
        return ok_response(req, transport="socket")
    if not getattr(service, "shm_enabled", False):
        obs.count("transport.downgrades")
        return ok_response(req, transport="socket",
                           reason="server does not offer transport=shm")
    if not _local_peer(writer):
        obs.count("transport.downgrades")
        return ok_response(req, transport="socket",
                           reason="shm transport is same-host only")
    capacity = int(getattr(service, "shm_bytes", 64 << 20))
    asked = int(req.get("segment_bytes") or 0)
    if asked:
        capacity = min(capacity, asked)
    try:
        ring = shm.SegmentWriter(capacity, seg_id=conn.alloc_seg_id())
    except OSError as exc:
        obs.count("transport.downgrades")
        return ok_response(req, transport="socket",
                           reason=f"segment allocation failed: {exc}")
    conn.ring = ring
    conn.transport = "shm"
    conn.wait_s = float(getattr(service, "shm_wait_ms", 200.0)) / 1000.0
    conn.chaos = getattr(service, "shm_chaos", None)
    obs.count("transport.shm_connections")
    return ok_response(req, transport="shm", segment=ring.path,
                       segment_id=ring.seg_id, segment_bytes=ring.capacity)


async def _handle_connection(service, reader, writer) -> None:
    """One client connection; ``service`` is anything with ``submit``: a
    ``SplitService``, or the fabric's ``Router``."""
    obs.count("serve.connections")
    wlock = asyncio.Lock()
    conn = _Conn()
    loop = asyncio.get_running_loop()

    async def record_for(frame) -> bytes:
        """One frame → one transport record (shm connections only). Ring
        writes are memcpy-speed and bounded; a full ring waits briefly for
        the consumer's ack cursor, then goes inline: the transport
        degrades, it never deadlocks. A service with shm chaos rolls its
        three seams here."""
        ring = conn.ring
        chaos = conn.chaos
        if ring is not None and ring.alive:
            if chaos is not None and chaos.roll("shm_unlink"):
                obs.count("fabric.chaos.shm_unlinks")
                ring.sever()    # frames after this point go inline
            else:
                desc = ring.try_write(frame)
                if desc is None and len(frame) <= ring.capacity:
                    obs.count("transport.ring_full_waits")
                    deadline = loop.time() + conn.wait_s
                    while desc is None and loop.time() < deadline:
                        await asyncio.sleep(0.001)
                        desc = ring.try_write(frame)
                if desc is not None:
                    rec = shm.pack_desc(*desc)
                    if chaos is not None and chaos.roll("shm_crc"):
                        obs.count("fabric.chaos.shm_crcs")
                        # A stale crc: the client must detect the mismatch
                        # and resume, never trust the frame.
                        rec = rec[:-1] + bytes([rec[-1] ^ 0xFF])
                    if chaos is not None and chaos.roll("shm_trunc"):
                        obs.count("fabric.chaos.shm_truncs")
                        raise shm.ChaosTruncation(rec[:len(rec) // 2])
                    obs.count("transport.shm_frames")
                    obs.count("transport.shm_bytes", len(frame))
                    return rec
        obs.count("transport.inline_frames")
        return shm.pack_inline(frame)

    async def write(resp: dict) -> None:
        # Binary frames (batch, aggregate) ride after the JSON line:
        # socket connections get u64-length-prefixed bytes, shm
        # connections transport records. ``_binary`` is a list: the line
        # and every frame leave in one buffered write. ``_binary_iter``
        # (the router's streaming relay) is an async iterator drained
        # under the write lock, the head and the first frame coalesced;
        # ``_records_iter`` carries encoded transport records (the
        # router's descriptor relay), forwarded as they are.
        chunks = resp.pop("_binary", None)
        frames_iter = resp.pop("_binary_iter", None)
        records_iter = resp.pop("_records_iter", None)
        head = encode(resp)
        poison = False
        if chunks:
            if conn.transport == "shm":
                parts = [head]
                try:
                    for c in chunks:
                        parts.append(await record_for(c))
                except shm.ChaosTruncation as exc:
                    parts.append(exc.partial)
                    poison = True
                data = b"".join(parts)
            else:
                data = b"".join(
                    [head, *(struct.pack("<Q", len(c)) + bytes(c)
                             for c in chunks)]
                )
        else:
            data = head
        if frames_iter is None and records_iter is None:
            async with wlock:
                writer.write(data)
                await writer.drain()
                if poison:
                    obs.count("serve.stream_aborts")
                    try:
                        writer.transport.abort()
                    except Exception:
                        pass
            return

        async def as_records(it):
            async for c in it:
                if conn.transport == "shm":
                    yield await record_for(c)
                else:
                    yield struct.pack("<Q", len(c)) + bytes(c)

        stream = records_iter if records_iter is not None \
            else as_records(frames_iter)
        async with wlock:
            # The head is held until the first frame record is ready, then
            # both leave in one buffered write (the same byte sequence as
            # separate writes).
            pending = data
            try:
                async for rec in stream:
                    if pending is not None:
                        writer.write(pending + rec)
                        pending = None
                    else:
                        writer.write(rec)
                    await writer.drain()
                if pending is not None:
                    writer.write(pending)
                    await writer.drain()
            except asyncio.CancelledError:
                raise
            except Exception as exc:
                # The head promised binary_frames the stream can no longer
                # deliver (resume exhausted, a chaos truncation): put what
                # must precede the cut on the wire, then abort the
                # transport, so the client sees a hard connection error,
                # never a silently short response.
                obs.count("serve.stream_aborts")
                tail = exc.partial if isinstance(exc, shm.ChaosTruncation) \
                    else b""
                if pending is not None or tail:
                    try:
                        writer.write((pending or b"") + tail)
                        await writer.drain()
                    except Exception:
                        pass
                try:
                    writer.transport.abort()
                except Exception:
                    pass

    async def one(req: dict) -> None:
        try:
            fut = service.submit(req, conn=conn)
        except Overloaded as exc:
            await write(error_response(
                req, "Overloaded", str(exc),
                retry_after_ms=exc.retry_after_ms,
            ))
            return
        # SplitService hands back thread-pool futures; the fabric Router
        # (which reuses this accept loop) hands back awaitables.
        if isinstance(fut, concurrent.futures.Future):
            await write(await asyncio.wrap_future(fut))
        else:
            await write(await fut)

    pending: "set[asyncio.Task]" = set()
    try:
        while True:
            try:
                line = await reader.readline()
            except (asyncio.LimitOverrunError, ValueError):
                await write(error_response(
                    {}, "ProtocolError", f"request line exceeds {MAX_LINE} bytes"
                ))
                break
            if not line:
                break
            if not line.strip():
                continue
            try:
                req = decode_request(line)
            except ProtocolError as exc:
                await write(error_response({}, "ProtocolError", str(exc)))
                continue
            if req.get("op") == "hello":
                # Answered inline on the loop: transport is connection
                # state and must be settled before later responses.
                await write(_hello_response(service, conn, req, writer))
                continue
            task = asyncio.ensure_future(one(req))
            pending.add(task)
            task.add_done_callback(pending.discard)
        if pending:
            await asyncio.gather(*pending, return_exceptions=True)
    finally:
        for task in pending:
            task.cancel()
        ring = conn.detach_ring()
        if ring is not None:
            if ring.drained() or not ring.alive:
                ring.close()
            else:
                # The peer may close before it has read every descriptor (a
                # relay closes its upstream connection once the last one
                # is forwarded, possibly before the end client mapped the
                # segment): hold the unlink until the ack cursor catches
                # up (bounded); mapped pages survive the eventual unlink.
                asyncio.ensure_future(_drain_then_close(ring, loop))
        writer.close()
        try:
            await writer.wait_closed()
        except Exception:
            pass


class ServeAddress:
    """Where a server listens: ``unix:<path>`` or ``tcp:<host>:<port>``."""

    def __init__(self, spec: str):
        self.spec = spec
        if spec.startswith("unix:"):
            self.kind = "unix"
            self.path = spec[len("unix:"):]
            if not self.path:
                raise ValueError(f"empty unix socket path in {spec!r}")
        else:
            body = spec[len("tcp:"):] if spec.startswith("tcp:") else spec
            host, _, port = body.rpartition(":")
            self.kind = "tcp"
            self.host = host or "127.0.0.1"
            try:
                self.port = int(port)
            except ValueError:
                raise ValueError(
                    f"bad serve address {spec!r}: expected unix:<path> or "
                    "tcp:<host>:<port>"
                ) from None


async def start_server(service: SplitService, address: ServeAddress):
    """Start listening; returns the ``asyncio.AbstractServer``."""
    handler = lambda r, w: _handle_connection(service, r, w)
    if address.kind == "unix":
        return await asyncio.start_unix_server(
            handler, path=address.path, limit=MAX_LINE
        )
    return await asyncio.start_server(
        handler, host=address.host, port=address.port, limit=MAX_LINE
    )


class ServerThread:
    """In-process server with its own event loop (tests, the smoke script,
    embedders).

    ``with ServerThread(service, "tcp:127.0.0.1:0") as srv:`` exposes
    ``srv.address`` (``(host, port)`` or unix path) while the calling
    thread stays free to act as a client.
    """

    def __init__(self, service: SplitService, spec: str = "tcp:127.0.0.1:0"):
        self.service = service
        self.addr = ServeAddress(spec)
        self.loop = asyncio.new_event_loop()
        self._server = None
        self._started = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name="serve-loop", daemon=True
        )

    def _run(self) -> None:
        asyncio.set_event_loop(self.loop)

        async def boot():
            self._server = await start_server(self.service, self.addr)
            self._started.set()

        self.loop.run_until_complete(boot())
        self.loop.run_forever()
        leftovers = asyncio.all_tasks(self.loop)
        for task in leftovers:
            task.cancel()
        if leftovers:
            self.loop.run_until_complete(
                asyncio.gather(*leftovers, return_exceptions=True)
            )
        self.loop.run_until_complete(self.loop.shutdown_asyncgens())
        self.loop.close()

    def start(self) -> "ServerThread":
        self._thread.start()
        if not self._started.wait(timeout=30):
            raise RuntimeError("serve loop failed to start")
        return self

    @property
    def address(self):
        if self.addr.kind == "unix":
            return self.addr.path
        return self._server.sockets[0].getsockname()[:2]

    def stop(self) -> None:
        def _shutdown():
            if self._server is not None:
                self._server.close()
            self.loop.stop()

        self.loop.call_soon_threadsafe(_shutdown)
        self._thread.join(timeout=10)

    def __enter__(self) -> "ServerThread":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


def serve_forever(service: SplitService, spec: str) -> None:
    """Blocking accept loop for the CLI ``serve`` subcommand."""

    async def main():
        server = await start_server(service, ServeAddress(spec))
        async with server:
            await server.serve_forever()

    asyncio.run(main())
