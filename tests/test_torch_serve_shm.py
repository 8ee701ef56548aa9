"""The port's shared-memory frame transport against the JAX package's.

Ring segment mechanics (write, read, consumer-ack reclaim, a full ring,
oversized frames, the guard crc, stale descriptors, orphan sweeping), the
segment header and descriptor bytes equal to the JAX package's, the hello
exchange and its downgrades to sockets, frames byte-identical over shm
and over the socket (and to the JAX server's), the socket framing on the
wire, ``map_frames``, the Arrow wire and the encoded-frame cache.
"""

import contextlib
import json
import os
import socket
import struct

import numpy as np
import pytest

from spark_bam_tpu.benchmarks.synth import synthetic_fixture
from spark_bam_tpu.core.config import Config as JConfig
from spark_bam_tpu.serve import ServerThread as JServerThread
from spark_bam_tpu.serve import SplitService as JSplitService
from spark_bam_tpu.serve import shm as jshm
from spark_bam_tpu_torch import obs
from spark_bam_tpu_torch.core.config import Config
from spark_bam_tpu_torch.parallel.mesh import local_mesh
from spark_bam_tpu_torch.serve import (
    ServeClient,
    ServeClientError,
    ServerThread,
    SplitService,
    shm,
)
from spark_bam_tpu_torch.serve import server as serve_server
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

pytestmark = [pytest.mark.serve]

SERVE_SPEC = "window=64KB,halo=8KB,batch=8,tick=5,workers=4"
COLS = ["pos", "mapq", "name"]


@pytest.fixture(scope="module")
def bam_path(tmp_path_factory):
    return str(synthetic_fixture(tmp_path_factory.mktemp("torch_shm")))


@contextlib.contextmanager
def _server(serve_spec=SERVE_SPEC, spec="tcp:127.0.0.1:0"):
    svc = SplitService(Config(serve=serve_spec), mesh=local_mesh(["cpu"]))
    try:
        with ServerThread(svc, spec) as srv:
            yield srv, svc
    finally:
        svc.close()


def _batch(client, bam_path, **fields):
    resp = client.request("batch", path=bam_path, columns=COLS, **fields)
    return [bytes(f) for f in resp["_binary"]], resp


# ------------------------------------------------------------ ring segment
def test_ring_write_read_ack_reclaim():
    w = shm.SegmentWriter(1 << 16, seg_id=7)
    try:
        r = shm.SegmentReader(w.path, 7)
        payload = os.urandom(9000)
        seg_id, off, length, crc = w.try_write(payload)
        assert (seg_id, length) == (7, len(payload))
        view = r.read(off, length, crc)
        assert bytes(view) == payload
        view.release()
        r.ack(off, length)
        # With the first frame acked the ring takes frame after frame past
        # its capacity, at monotone offsets.
        last_off = off
        for _ in range(20):
            desc = w.try_write(payload)
            assert desc is not None, "acked space was not reclaimed"
            _, off2, ln2, crc2 = desc
            assert off2 > last_off
            last_off = off2
            assert bytes(r.read(off2, ln2, crc2)) == payload
            r.ack(off2, ln2)
        r.close()
    finally:
        w.close()


def test_ring_full_without_acks_and_oversize():
    w = shm.SegmentWriter(1 << 16, seg_id=1)
    try:
        wrote = 0
        while w.try_write(b"x" * 8192) is not None:
            wrote += 1
            assert wrote < 64
        assert wrote == 8
        assert w.try_write(b"y" * (1 << 20)) is None
        assert w.free_bytes() == 0
    finally:
        w.close()


def test_reader_rejects_stale_descriptor_and_bad_crc():
    w = shm.SegmentWriter(1 << 16, seg_id=3)
    try:
        r = shm.SegmentReader(w.path, 3)
        _, off, ln, crc = w.try_write(b"z" * 100)
        with pytest.raises(shm.ShmError):
            r.read(off, ln, crc ^ 0xDEAD)
        r.ack(off, ln)
        with pytest.raises(shm.ShmError):
            r.read(off, ln, crc)
        with pytest.raises(shm.ShmError):
            r.read(off + 100, 1 << 20, 0)          # longer than the ring
        r.close()
    finally:
        w.close()


def test_reader_refuses_a_file_that_is_no_segment(tmp_path):
    p = tmp_path / "plain"
    p.write_bytes(b"\0" * 8192)
    with pytest.raises(shm.ShmError):
        shm.SegmentReader(str(p), 1)


@pytest.mark.parametrize("size", [0, 1, 100, 8192, 8193, 50_000])
def test_guard_crc_and_records_equal_jax(size):
    frame = np.random.default_rng(size).integers(
        0, 256, size, dtype=np.uint8).tobytes()
    assert shm.guard_crc(frame) == jshm.guard_crc(frame)
    assert shm.pack_inline(frame) == jshm.pack_inline(frame)
    assert shm.pack_desc(3, len(frame), 7, 99) == jshm.pack_desc(
        3, len(frame), 7, 99)
    assert shm.pack_segment(2, "/dev/shm/x") == jshm.pack_segment(
        2, "/dev/shm/x")


def test_segments_interoperate_with_jax(tmp_path):
    """A port writer's segment reads through the JAX reader and the other
    way round: the header and the cursors are the same bytes."""
    for writer_mod, reader_mod in ((shm, jshm), (jshm, shm)):
        w = writer_mod.SegmentWriter(1 << 16, seg_id=5,
                                     directory=str(tmp_path))
        try:
            r = reader_mod.SegmentReader(w.path, 5)
            for n in (10, 40_000, 30_000):
                frame = os.urandom(n)
                _, off, ln, crc = w.try_write(frame)
                assert bytes(r.read(off, ln, crc)) == frame
                r.ack(off, ln)
            assert w.drained()
            r.close()
        finally:
            w.close()
        assert not os.path.exists(w.path)


def test_sweep_orphans_unlinks_dead_pids_only(tmp_path):
    d = str(tmp_path)
    live = os.path.join(d, f"sbt-shm-{os.getpid()}-77-deadbeef")
    dead = os.path.join(d, f"sbt-shm-{2 ** 22 + 1234}-1-deadbeef")
    other = os.path.join(d, "sbt-shm-notapid-1-x")
    for p in (live, dead, other):
        with open(p, "wb") as f:
            f.write(b"\0" * 64)
    assert shm.sweep_orphans(d) == 1
    assert os.path.exists(live) and os.path.exists(other)
    assert not os.path.exists(dead)
    assert shm.sweep_orphans(str(tmp_path / "missing")) == 0


def test_segment_dir_override(monkeypatch, tmp_path):
    monkeypatch.setenv("SPARK_BAM_SHM_DIR", str(tmp_path))
    w = shm.SegmentWriter(1 << 16)
    try:
        assert os.path.dirname(w.path) == str(tmp_path)
        assert os.path.basename(w.path).startswith(f"sbt-shm-{os.getpid()}-")
    finally:
        w.close()


# ----------------------------------------------------- handshake, identity
def test_shm_frames_byte_identical_to_socket(bam_path):
    with _server() as (srv, _svc):
        with ServeClient(srv.address) as c:
            assert c.transport == "shm"
            shm_frames, resp = _batch(c, bam_path)
            assert resp["_transport"] == "shm"
        with ServeClient(srv.address, transport="socket") as c:
            assert c.transport == "socket"
            sock_frames, resp = _batch(c, bam_path)
            assert resp["_transport"] == "socket"
    assert len(shm_frames) >= 3
    assert shm_frames == sock_frames


def test_shm_frames_equal_the_jax_servers(bam_path):
    jsvc = JSplitService(JConfig(serve=SERVE_SPEC))
    try:
        with JServerThread(jsvc) as srv:
            with ServeClient(srv.address) as c:
                assert c.transport == "shm"
                want, _ = _batch(c, bam_path)
    finally:
        jsvc.close()
    with _server() as (srv, _svc):
        with ServeClient(srv.address) as c:
            got, _ = _batch(c, bam_path)
    assert got == want


def test_shm_granted_over_unix_socket(bam_path, tmp_path):
    with _server(spec=f"unix:{tmp_path}/serve.sock") as (srv, _svc):
        with ServeClient(srv.address) as c:
            assert c.transport == "shm"
            frames, _ = _batch(c, bam_path)
            assert frames


def test_small_ring_goes_inline(bam_path):
    """Frames larger than the ring travel inline; the bytes are the
    same."""
    def every_column(c):
        resp = c.request("batch", path=bam_path, batch_rows=2500)
        return [bytes(f) for f in resp["_binary"]]

    with _server() as (srv, _svc):
        with ServeClient(srv.address, transport="socket") as c:
            ref = every_column(c)
    assert max(map(len, ref)) > 64 << 10
    obs.configure()
    try:
        with _server(SERVE_SPEC + ",shm_bytes=64KB,shm_wait=0") as (srv, _):
            with ServeClient(srv.address) as c:
                assert c.transport == "shm"
                frames = every_column(c)
        counters = {x["name"]: x["value"]
                    for x in obs.registry().snapshot()["counters"]}
    finally:
        obs.shutdown()
    assert frames == ref
    assert counters.get("transport.inline_frames", 0) >= 1
    assert counters.get("transport.shm_frames", 0) >= 1


def test_downgrade_server_without_shm(bam_path):
    with _server() as (srv, _svc):
        with ServeClient(srv.address) as c:
            ref, _ = _batch(c, bam_path)
    with _server(SERVE_SPEC + ",shm=0") as (srv, _svc):
        with ServeClient(srv.address) as c:
            assert c.transport == "socket"
            frames, resp = _batch(c, bam_path)
            assert resp["_transport"] == "socket"
    assert frames == ref


def test_downgrade_non_local_peer(bam_path, monkeypatch):
    with _server() as (srv, _svc):
        with ServeClient(srv.address) as c:
            ref, _ = _batch(c, bam_path)
        monkeypatch.setattr(serve_server, "_local_peer", lambda w: False)
        with ServeClient(srv.address) as c:
            assert c.transport == "socket"
            frames, resp = _batch(c, bam_path)
            assert resp["_transport"] == "socket"
    assert frames == ref


def test_downgrade_unmappable_segment(bam_path, monkeypatch):
    with _server() as (srv, _svc):
        with ServeClient(srv.address) as c:
            ref, _ = _batch(c, bam_path)

        def boom(path, seg_id):
            raise OSError("no such shared segment here")

        monkeypatch.setattr(shm, "SegmentReader", boom)
        with ServeClient(srv.address) as c:
            assert c.transport == "socket"
            frames, _ = _batch(c, bam_path)
    assert frames == ref


def test_rehello_renegotiates_and_tears_down_ring(bam_path):
    with _server() as (srv, _svc):
        with ServeClient(srv.address) as c:
            assert c.transport == "shm"
            seg_path = next(iter(c._segments.values())).path
            assert os.path.exists(seg_path)
            resp = c._roundtrip({"op": "hello", "transport": "socket"})
            assert resp["ok"] and resp["transport"] == "socket"
            assert not os.path.exists(seg_path)


def _raw_request(addr, req: dict):
    """One request over a bare socket: the head line, the u64-framed
    frames and any residue."""
    with socket.create_connection(addr, timeout=60) as s:
        s.sendall((json.dumps(req) + "\n").encode())
        head = b""
        while b"\n" not in head:
            piece = s.recv(65536)
            assert piece, "server closed before the head line"
            head += piece
        line, _, buf = head.partition(b"\n")
        resp = json.loads(line)
        frames = []
        for _ in range(int(resp.get("binary_frames") or 0)):
            while len(buf) < 8:
                buf += s.recv(65536)
            (ln,) = struct.unpack("<Q", buf[:8])
            buf = buf[8:]
            while len(buf) < ln:
                buf += s.recv(65536)
            frames.append(buf[:ln])
            buf = buf[ln:]
        s.settimeout(0.2)
        with contextlib.suppress(socket.timeout):
            buf += s.recv(65536)
        return resp, frames, buf


def test_socket_framing_on_the_wire(bam_path):
    with _server() as (srv, _svc):
        with ServeClient(srv.address, transport="socket") as c:
            ref, _ = _batch(c, bam_path)
        resp, frames, residue = _raw_request(
            srv.address,
            {"op": "batch", "id": 1, "path": bam_path, "columns": COLS},
        )
    assert resp["ok"] and resp["binary_frames"] == len(ref)
    assert frames == ref
    assert residue == b""


def test_raw_hello_downgrade_reasons(bam_path):
    with _server(SERVE_SPEC + ",shm=0") as (srv, _svc):
        resp, frames, residue = _raw_request(
            srv.address, {"op": "hello", "id": 1, "transport": "shm"})
        assert resp == {"id": 1, "ok": True, "transport": "socket",
                        "reason": "server does not offer transport=shm"}
        assert frames == [] and residue == b""


def test_map_frames_returns_views_and_defers_acks(bam_path):
    with _server() as (srv, _svc):
        with ServeClient(srv.address, transport="socket") as c:
            ref, _ = _batch(c, bam_path)
        with ServeClient(srv.address, map_frames=True) as c:
            frames, _ = _batch(c, bam_path)
            raw = c.request("batch", path=bam_path, columns=COLS)
            views = raw["_binary"]
            assert any(isinstance(v, memoryview) for v in views)
            assert [bytes(v) for v in views] == ref
            assert c._deferred
            for v in views:
                if isinstance(v, memoryview):
                    v.release()
            c.release_frames()
            assert not c._deferred
    assert frames == ref


def test_client_resumes_a_severed_batch(bam_path, monkeypatch):
    """A connection lost mid-frames reconnects and asks for the rest with
    ``resume_from``; the reassembled frames equal an undisturbed read."""
    with _server() as (srv, _svc):
        with ServeClient(srv.address, transport="socket") as c:
            ref, _ = _batch(c, bam_path, batch_rows=400)
        assert len(ref) >= 5
        with ServeClient(srv.address, transport="socket") as c:
            real = c._read_exact
            calls = {"n": 0}

            def flaky(n):
                calls["n"] += 1
                if calls["n"] == 6:       # inside the third frame
                    raise ConnectionError("cut")
                return real(n)

            monkeypatch.setattr(c, "_read_exact", flaky)
            frames, resp = _batch(c, bam_path, batch_rows=400)
    assert frames == ref
    assert resp["binary_frames"] == len(ref)
    assert "resume_from" not in resp


# -------------------------------------------------------------- arrow wire
def test_wire_arrow_value_identical_to_sbcr(bam_path):
    pa = pytest.importorskip("pyarrow")
    from spark_bam_tpu_torch.columnar.arrow_ipc import open_stream
    from spark_bam_tpu_torch.columnar.native import read_container
    from spark_bam_tpu_torch.columnar.sink import to_arrow_batch

    with _server() as (srv, _svc):
        with ServeClient(srv.address) as c:
            sbcr, resp_s = _batch(c, bam_path)
            assert "wire" not in resp_s
            arrow, resp_a = _batch(c, bam_path, wire="arrow")
            assert resp_a["wire"] == "arrow"
    _, batches = read_container(b"".join(sbcr))
    want = pa.Table.from_batches([to_arrow_batch(rb) for rb in batches])
    got = open_stream(b"".join(arrow)).read_all()
    assert got.num_rows == resp_a["rows"] == resp_s["rows"]
    assert got.equals(want)


def test_wire_arrow_unsupported_without_pyarrow(bam_path, monkeypatch):
    import spark_bam_tpu_torch.columnar.arrow_ipc as aipc

    monkeypatch.setattr(aipc, "arrow_available", lambda: False)
    with _server() as (srv, _svc):
        with ServeClient(srv.address) as c:
            with pytest.raises(ServeClientError) as exc:
                c.request("batch", path=bam_path, columns=COLS, wire="arrow")
            assert exc.value.error == "Unsupported"
            assert "sbcr" in str(exc.value)
            frames, _ = _batch(c, bam_path)
            assert frames


def test_encoded_frame_cache_hits_on_repeat(bam_path):
    obs.configure()
    try:
        with _server() as (srv, _svc):
            with ServeClient(srv.address) as c:
                a, _ = _batch(c, bam_path)
                b, _ = _batch(c, bam_path)
                assert a == b
        counters = {x["name"]: x["value"]
                    for x in obs.registry().snapshot()["counters"]}
        assert counters.get("serve.frame_cache_misses", 0) == 1
        assert counters.get("serve.frame_cache_hits", 0) == 1
    finally:
        obs.shutdown()
