"""The port's write path against the JAX package's, on the CPU, exactly
(bytes and integers; no tolerance): the plain versions of the two lane
kernels against the JAX ``crc32_lanes`` / ``deflate_fixed_lanes`` over the
shared lane set (``benchmarks/write_cases.py``: lengths 0 to ``STRIDE``,
an overflowing lane), the member functions over ``tests/test_deflate.py``'s
``PAYLOADS``, the codec's members under every mode, ``write_bam_result``
(bytes, member table, record starts) at several block payloads and codecs,
and ``encode_zlib_stream``'s device branch with an overflowing window. A
payload past ``MAX_STORED_PAYLOAD`` raises the port's ``LimitExceeded``,
and a codec that resolves to CUDA raises without a card: nothing demotes
to the host."""

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_bam_tpu.bam.iterators import RecordStream as JaxRecordStream
from spark_bam_tpu.bam.writer import write_bam_result as jax_write_bam_result
from spark_bam_tpu.compress import codec as jcodec
from spark_bam_tpu.compress import huffman as jh
from spark_bam_tpu.compress import kernels as jk
from spark_bam_tpu.compress.config import DeflateConfig as JaxDeflateConfig
from spark_bam_tpu.core import guard as jguard
from spark_bam_tpu.core.channel import open_channel as jax_open_channel
from spark_bam_tpu_torch.bam.iterators import RecordStream
from spark_bam_tpu_torch.bam.writer import (
    BGZF_EOF,
    BgzfWriter,
    compress_block,
    write_bam_result,
)
from spark_bam_tpu_torch.benchmarks.write_cases import lane_batch, lane_cases
from spark_bam_tpu_torch.bgzf.index_blocks import scan_blocks
from spark_bam_tpu_torch.compress import codec, huffman
from spark_bam_tpu_torch.compress import kernels as pk
from spark_bam_tpu_torch.compress.config import DeflateConfig
from spark_bam_tpu_torch.core import guard
from spark_bam_tpu_torch.core.channel import open_channel
from spark_bam_tpu_torch.core.config import Config
from tests.bam_factories import random_bam
from tests.test_deflate import PAYLOADS
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

MAX = huffman.MAX_STORED_PAYLOAD


@pytest.fixture(autouse=True)
def clean_env(monkeypatch):
    monkeypatch.delenv("SPARK_BAM_DEFLATE", raising=False)


@pytest.fixture(scope="module")
def src_bam(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("torch_deflate") / "src.bam")
    random_bam(path, seed=77, n_records=(400, 401))
    return path


def _jax_lanes(payloads):
    data, lengths, b = jk.pack_lanes(payloads)
    return jnp.asarray(data), jnp.asarray(lengths), b


@pytest.mark.parametrize("b", [3, 12])
def test_lane_plain_versions_equal_jax(b):
    """``crc32_lanes`` / ``deflate_fixed_lanes`` on CPU tensors (their plain
    versions) against the JAX programs: every lane's CRC, total_bits and
    whole packed plane, zero-length and overflowing lanes included."""
    payloads = lane_batch(b, seed=1) if b < 12 else list(lane_cases(1).values())
    data, lengths, pb = pk.pack_lanes(payloads)
    jdata, jlengths, jb = _jax_lanes(payloads)
    assert pb == jb == b
    assert np.array_equal(data.numpy(), np.asarray(jdata)[:b])
    assert np.array_equal(lengths.numpy(), np.asarray(jlengths)[:b])
    crc = pk.crc32_lanes(data, lengths)
    assert crc.dtype == torch.uint32
    assert np.array_equal(crc.numpy(),
                          np.asarray(jk.crc32_lanes(jdata, jlengths))[:b])
    packed, bits, crc2 = pk.deflate_fixed_lanes(data, lengths)
    jpacked, jbits, jcrc = (np.asarray(x)[:b] for x in
                            jk.deflate_fixed_lanes(jdata, jlengths))
    assert packed.shape == (b, pk.OUT_BYTES) and packed.dtype == torch.uint8
    assert np.array_equal(packed.numpy(), jpacked)
    assert np.array_equal(bits.numpy(), jbits)
    assert np.array_equal(crc2.numpy(), jcrc)
    assert [int(c) for c in crc] == [zlib.crc32(p) for p in payloads]
    if b == 12:
        assert int(bits[0]) > pk.OUT_BYTES * 8   # the overflowing lane


def test_crc_consts_advance_over_zero_bytes():
    """The kernels' operator tables: Z_{2^k} applied to a register equals
    running the byte table over 2^k zero bytes."""
    consts = pk._crc_consts()
    table, nib = consts[:256], consts[256:].reshape(16, 8, 16)
    rng = np.random.default_rng(2)
    for k in (0, 1, 5, 6, 9):
        for v in rng.integers(0, 1 << 32, 4, dtype=np.uint64):
            v = int(v)
            want = v
            for _ in range(1 << k):
                want = (want >> 8) ^ int(table[want & 0xFF])
            got = 0
            for p in range(8):
                got ^= int(nib[k, p, (v >> (4 * p)) & 15])
            assert got == want


@pytest.mark.parametrize("name", list(PAYLOADS))
def test_member_functions_equal_jax(name):
    p = PAYLOADS[name]
    assert huffman.stored_body(p) == jh.stored_body(p)
    assert huffman.stored_member(p) == jh.stored_member(p)
    assert huffman.fixed_member(p) == jh.fixed_member(p)
    for level in (1, 6, 9):
        assert huffman.zlib_member(p, level) == jh.zlib_member(p, level)
    assert compress_block(p) == jh.zlib_member(p, 6)
    crc = zlib.crc32(p)
    assert (huffman.bgzf_member(b"\x03\x00", crc, len(p))
            == jh.bgzf_member(b"\x03\x00", crc, len(p)))
    d = zlib.decompressobj(31)
    assert d.decompress(huffman.fixed_member(p)) == p and d.eof


@pytest.mark.parametrize("mode", ["stored", "fixed", "auto"])
@pytest.mark.parametrize("dev", ["on", "off"])
def test_codec_members_equal_jax(mode, dev):
    """``DeviceDeflateCodec`` members (lanes on the CPU's plain versions,
    or the host functions under device=off) against the JAX codec's, two
    batches in flight; picks counted."""
    payloads = [PAYLOADS[k] for k in ("text", "binary", "boundary", "runs",
                                      "empty", "one")]
    cfg = DeflateConfig.parse(f"mode={mode},device={dev},lanes=4")
    port = codec.DeviceDeflateCodec(cfg, device="cpu")
    jax_codec = jcodec.DeviceDeflateCodec(
        JaxDeflateConfig.parse(f"mode={mode},device={dev},lanes=4"))
    first, second = port.dispatch(payloads[:4]), port.dispatch(payloads[4:])
    got = port.materialize(first) + port.materialize(second)
    assert got == jax_codec.encode_blocks(payloads)
    assert port.counts["members"] == len(payloads)
    if not (mode == "auto" and dev == "off"):
        stored = sum(m[18] == 1 for m in got)
        assert (port.counts["stored"], port.counts["fixed"]) == (
            stored, len(payloads) - stored)


def test_make_codec_selection():
    assert isinstance(codec.make_codec(None), codec.HostZlibCodec)
    assert isinstance(codec.make_codec("mode=off"), codec.HostZlibCodec)
    assert codec.make_codec("", level=3).level == 3
    c = codec.make_codec("mode=fixed,lanes=8", level=2, device="cpu")
    assert isinstance(c, codec.DeviceDeflateCodec)
    assert (c.lanes, c.cfg.level, c.device) == (8, 2, torch.device("cpu"))
    assert codec.make_codec("mode=stored,device=off").device is None


def _records(path, module):
    with (open_channel if module == "port" else jax_open_channel)(path) as ch:
        stream = (RecordStream if module == "port" else JaxRecordStream).open(ch)
        return stream.header, [r for _, r in stream]


@pytest.mark.parametrize("block_payload", [0xFF00, 8192, 1000])
@pytest.mark.parametrize("spec", ["", "mode=fixed", "mode=stored"])
def test_write_bam_result_equals_jax(src_bam, tmp_path, block_payload, spec):
    """``write_bam_result`` over the port's decoded records against JAX's
    over its own: the file, the member table, the record starts."""
    header, records = _records(src_bam, "port")
    jheader, jrecords = _records(src_bam, "jax")
    got = write_bam_result(tmp_path / "p.bam", header, records,
                           block_payload=block_payload, deflate=spec,
                           device="cpu")
    want = jax_write_bam_result(str(tmp_path / "j.bam"), jheader, jrecords,
                                block_payload=block_payload, deflate=spec)
    assert ((tmp_path / "p.bam").read_bytes()
            == (tmp_path / "j.bam").read_bytes())
    assert [(m.start, m.compressed_size, m.uncompressed_size)
            for m in got.blocks] == [
        (m.start, m.compressed_size, m.uncompressed_size) for m in want.blocks]
    assert got.record_flats == want.record_flats
    assert (got.count, got.header_len, got.bytes_out) == (
        want.count, want.header_len, want.bytes_out)
    assert scan_blocks(tmp_path / "p.bam") == got.blocks
    assert (tmp_path / "p.bam").read_bytes().endswith(BGZF_EOF)


def test_bgzf_writer_payloads_and_rows(tmp_path):
    """The writer cuts payloads at ``block_payload`` and its rows are the
    members it wrote; each member inflates back with host zlib."""
    raw = PAYLOADS["text"] * 30
    path = tmp_path / "w.bgzf"
    with open(path, "wb") as f, BgzfWriter(
            f, 40_000, codec=codec.make_codec("mode=fixed,lanes=2",
                                              device="cpu")) as w:
        w.write(raw[:7])
        w.write(raw[7:])
    blob = path.read_bytes()
    assert [m.uncompressed_size for m in w.blocks] == [40_000] * 3 + [30_000]
    out = b""
    for m in w.blocks:
        d = zlib.decompressobj(31)
        out += d.decompress(blob[m.start: m.start + m.compressed_size])
        assert d.eof
    assert out == raw and blob[w.blocks[-1].start
                               + w.blocks[-1].compressed_size:] == BGZF_EOF


def _stream_raw():
    rng = np.random.default_rng(9)
    return (rng.integers(32, 127, 100_000, dtype=np.uint8).tobytes()
            + rng.integers(144, 256, 70_000, dtype=np.uint8).tobytes()
            + b"ACGT" * 5_000)


def test_encode_zlib_stream_device_branch_equals_jax(monkeypatch):
    """The device branch on the CPU's plain lanes against the JAX device
    branch and the host stream; the overflowing window re-packed on the
    host and counted, through a spec from the environment too."""
    raw = _stream_raw()
    before = dict(codec.ZLIB_STREAM_COUNTS)
    got = codec.encode_zlib_stream(raw, "mode=fixed,device=on,lanes=2",
                                   device="cpu")
    assert got == jcodec.encode_zlib_stream(raw, "mode=fixed,device=on")
    assert got == huffman.zlib_stream(raw) and zlib.decompress(got) == raw
    over = sum(huffman.fixed_pack(raw[i: i + MAX])[1] > pk.OUT_BYTES * 8
               for i in range(0, len(raw), MAX))
    assert over >= 1
    assert codec.ZLIB_STREAM_COUNTS["repacks"] == before["repacks"] + over
    assert codec.ZLIB_STREAM_COUNTS["windows"] == before["windows"] + -(
        -len(raw) // MAX)
    monkeypatch.setenv("SPARK_BAM_DEFLATE", "mode=stored")
    assert codec.encode_zlib_stream(b"", device="cpu") == huffman.zlib_stream(b"")
    assert codec.encode_zlib_stream(raw[:5000], "mode=fixed,device=off") == (
        huffman.zlib_stream(raw[:5000]))


def test_payload_past_stored_limit_raises():
    big = bytes(MAX + 1)
    assert issubclass(guard.LimitExceeded, guard.MalformedInputError)
    for build in (huffman.stored_member, huffman.fixed_member):
        with pytest.raises(guard.LimitExceeded):
            build(big)
    with pytest.raises(guard.LimitExceeded):
        huffman.bgzf_member(bytes(0x10000), 0, 0)
    for c in (codec.HostZlibCodec(),
              codec.make_codec("mode=fixed", device="cpu"),
              codec.make_codec("mode=stored,device=off")):
        with pytest.raises(guard.LimitExceeded):
            c.dispatch([b"ok", big])


def test_cuda_codec_without_card_raises(monkeypatch, src_bam, tmp_path):
    """A spec that turns the lanes on resolves to CUDA and raises without
    a card; nothing demotes to the host, and no output is left."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for spec in ("mode=fixed", "mode=stored,device=on", "mode=auto"):
        with pytest.raises(RuntimeError, match="CUDA"):
            codec.make_codec(spec)
        with pytest.raises(RuntimeError, match="CUDA"):
            codec.encode_zlib_stream(b"abc", spec)
    header, records = _records(src_bam, "port")
    out = tmp_path / "x.bam"
    with pytest.raises(RuntimeError, match="CUDA"):
        write_bam_result(out, header, records, deflate="mode=stored")
    assert not out.exists() and not list(tmp_path.iterdir())
    # device=off is the host functions by the user's choice: no card needed.
    write_bam_result(out, header, records, deflate="mode=fixed,device=off")
    assert out.exists()


def test_config_deflate_and_guard_defaults():
    cfg = Config.from_env({"SPARK_BAM_DEFLATE": "mode=fixed,lanes=128"})
    assert cfg.deflate_config == DeflateConfig(mode="fixed", lanes=128)
    assert Config().deflate_config == DeflateConfig()
    assert guard.current_limits() == guard.DecodeLimits()
    assert (guard.DecodeLimits().__dict__
            == jguard.DecodeLimits().__dict__)
    assert issubclass(guard.TruncatedInput, EOFError)
    with pytest.raises(ValueError):
        guard.DecodeLimits(max_refs=0)
