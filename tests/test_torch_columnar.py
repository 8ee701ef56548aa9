"""The port's columnar schema, config and native container against the
JAX package's, on the CPU: the same seeded record batches give the same
container bytes for every codec and level, with and without columns
worth a dictionary; slicing, concatenation, re-batching, projection and
row iteration give the same results; each side's reader decodes the
other's bytes and rejects the same damage; the columnar and deflate
specs parse alike; the host fixed-Huffman zlib stream is the JAX
package's. Every comparison is exact."""

import struct
import zlib

import numpy as np
import pytest
import torch

from spark_bam_tpu.columnar import native as jn
from spark_bam_tpu.columnar import schema as js
from spark_bam_tpu.columnar.config import ColumnarConfig as JaxColumnarConfig
from spark_bam_tpu.compress import huffman as jh
from spark_bam_tpu.compress.config import DeflateConfig as JaxDeflateConfig
from spark_bam_tpu_torch.columnar import native as pn
from spark_bam_tpu_torch.columnar import schema as ps
from spark_bam_tpu_torch.columnar.config import ColumnarConfig
from spark_bam_tpu_torch.compress import huffman as ph
from spark_bam_tpu_torch.compress.codec import encode_zlib_stream
from spark_bam_tpu_torch.compress.config import DeflateConfig
from spark_bam_tpu_torch.core.config import Config

ROWS = (0, 1, 37, 300)
CONTIGS = [("chr1", 248_956_422), ("chr2", 242_193_529), ("chrM", 16_569)]


@pytest.fixture(autouse=True)
def host_deflate(monkeypatch):
    monkeypatch.delenv("SPARK_BAM_DEFLATE", raising=False)


def _var(rng, n: int, pool: "list[bytes] | None", hi: int = 40):
    """(offsets, values) of ``n`` values: drawn from ``pool`` when given
    (repeats: a dictionary pays), else random bytes of 0..hi bytes (some
    empty)."""
    if pool is not None:
        vals = [pool[int(i)] for i in rng.integers(0, len(pool), n)]
    else:
        vals = [rng.integers(33, 127, int(k), dtype=np.uint8).tobytes()
                for k in rng.integers(0, hi, n)]
    offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum([len(v) for v in vals], out=offsets[1:])
    return offsets, np.frombuffer(b"".join(vals), dtype=np.uint8).copy()


def _columns(seed: int, n: int, repeats: bool) -> dict:
    """Seeded column arrays of every schema column."""
    rng = np.random.default_rng(seed)
    cols = {c: rng.integers(-2**31, 2**31, n, dtype=np.int64).astype(np.int32)
            for c in ps.FIXED_COLUMNS}
    pools = {"name": [b"", b"SRR001", b"SRR002", b"x" * 30] if repeats else None,
             "cigar": [b"*", b"100M", b"5S95M"] if repeats else None}
    for c in ps.VAR_COLUMNS:
        cols[c] = _var(rng, n, pools.get(c), hi=200 if c == "seq" else 40)
    return cols


def _batches(cols: dict, n: int, columns=ps.COLUMNS):
    """The same columns as a port batch and a JAX batch."""
    def build(mod):
        return mod.RecordBatch({
            c: (mod.VarColumn(*cols[c]) if c in ps.VAR_COLUMNS
                else cols[c]) for c in columns}, n)
    return build(ps), build(js)


def _assert_batch_equal(got, want, label=""):
    assert got.num_rows == want.num_rows, label
    assert got.column_names == want.column_names, label
    for name in want.column_names:
        g, w = got.columns[name], want.columns[name]
        if hasattr(w, "offsets"):
            assert g.offsets.dtype == w.offsets.dtype == np.int64, (label, name)
            assert g.values.dtype == w.values.dtype == np.uint8, (label, name)
            np.testing.assert_array_equal(g.offsets, w.offsets, err_msg=name)
            np.testing.assert_array_equal(g.values, w.values, err_msg=name)
        else:
            assert g.dtype == w.dtype, (label, name)
            np.testing.assert_array_equal(g, w, err_msg=f"{label} {name}")


@pytest.mark.parametrize("repeats", [False, True], ids=["unique", "repeats"])
@pytest.mark.parametrize("level", [1, 6])
@pytest.mark.parametrize("codec", ["none", "zlib", "deflate"])
def test_container_bytes_equal_jax(codec, level, repeats):
    meta = pn.container_meta(ps.COLUMNS, codec, level, CONTIGS)
    assert meta == jn.container_meta(ps.COLUMNS, codec, level, CONTIGS)
    got, want = [pn.container_head(meta)], [jn.container_head(meta)]
    for i, n in enumerate(ROWS):
        pb, jb = _batches(_columns(10 * i + level, n, repeats), n)
        got.append(pn.batch_frame(pb, meta))
        want.append(jn.batch_frame(jb, meta))
        assert got[-1] == want[-1], (codec, level, n)
    got.append(pn.end_frame(sum(ROWS), len(ROWS)))
    want.append(jn.end_frame(sum(ROWS), len(ROWS)))
    assert b"".join(got) == b"".join(want)
    if repeats and codec == "none":
        # The dictionary section was taken for name and cigar.
        assert b"\x02" in got[-2]
    # Each side's reader decodes the other's bytes.
    blob = b"".join(got)
    for reader in (pn.NativeReader, jn.NativeReader):
        r = reader(blob)
        assert r.meta == meta
        decoded = list(r.iter_batches())
        assert [b.num_rows for b in decoded] == list(ROWS)
    for i, n in enumerate(ROWS):
        _, jb = _batches(_columns(10 * i + level, n, repeats), n)
        _assert_batch_equal(list(pn.NativeReader(blob).iter_batches())[i], jb)
        _assert_batch_equal(list(jn.NativeReader(blob).iter_batches())[i], jb)


@pytest.mark.parametrize("projection", [
    ("flag", "pos"), ("name", "cigar"), ps.COLUMNS, ("tags",)])
def test_projected_container_and_read_container(projection, tmp_path):
    cols = _columns(5, 64, True)
    meta = pn.container_meta(projection, "zlib", 6, CONTIGS)
    pb, jb = _batches(cols, 64, projection)
    blob = (pn.container_head(meta) + pn.batch_frame(pb, meta)
            + pn.end_frame(64, 1))
    assert blob == (jn.container_head(meta) + jn.batch_frame(jb, meta)
                    + jn.end_frame(64, 1))
    (tmp_path / "c.sbcr").write_bytes(blob)
    pm, pbs = pn.read_container(str(tmp_path / "c.sbcr"))
    jm, jbs = jn.read_container(blob)
    assert pm == jm
    _assert_batch_equal(pbs[0], jbs[0])


@pytest.mark.parametrize("n", ROWS)
def test_slice_concat_project_iter_equal_jax(n):
    cols = _columns(n, n, False)
    pb, jb = _batches(cols, n)
    for lo, hi in ((0, n), (0, n // 2), (n // 3, n), (n, n), (1, 1)):
        _assert_batch_equal(ps.slice_batch(pb, lo, hi),
                            js.slice_batch(jb, lo, hi), f"slice {lo}:{hi}")
    parts_p = [ps.slice_batch(pb, 0, n // 2), ps.slice_batch(pb, n // 2, n),
               pb]
    parts_j = [js.slice_batch(jb, 0, n // 2), js.slice_batch(jb, n // 2, n),
               jb]
    _assert_batch_equal(ps.concat_batches(parts_p),
                        js.concat_batches(parts_j), "concat")
    for proj in ("flag,pos", "name+cigar", None, ["tags", "flag"]):
        _assert_batch_equal(ps.project(pb, proj), js.project(jb, proj), proj)
    assert list(ps.iter_rows(pb)) == list(js.iter_rows(jb))


@pytest.mark.parametrize("target", [1, 7, 8192])
def test_rebatcher_equals_jax(target):
    sizes = (0, 5, 1, 13, 0, 40, 7, 3)
    pr, jr = ps.Rebatcher(target), js.Rebatcher(target)
    got, want = [], []
    for i, n in enumerate(sizes):
        pb, jb = _batches(_columns(100 + i, n, i % 2 == 0), n)
        got += list(pr.feed(pb))
        want += list(jr.feed(jb))
    got += list(pr.flush())
    want += list(jr.flush())
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        _assert_batch_equal(g, w, f"target {target}")


def test_take_rows_and_empty_batch():
    """``take_rows`` (the merge into file order) equals row slices
    concatenated in its order; ``empty_batch`` equals a zero-row slice."""
    pb, jb = _batches(_columns(3, 50, False), 50)
    order = np.random.default_rng(0).permutation(50)[:31]
    want = js.concat_batches([js.slice_batch(jb, int(i), int(i) + 1)
                              for i in order])
    _assert_batch_equal(ps.take_rows(pb, order), want)
    _assert_batch_equal(ps.take_rows(pb, np.zeros(0, np.int64)),
                        js.slice_batch(jb, 0, 0))
    _assert_batch_equal(ps.empty_batch(("flag", "name", "qual")),
                        js.BatchBuilder(("flag", "name", "qual")).build())


def _blob(codec="none"):
    meta = pn.container_meta(ps.COLUMNS, codec, 6, CONTIGS)
    pb, _ = _batches(_columns(9, 120, True), 120)
    qb, _ = _batches(_columns(19, 70, False), 70)
    return (pn.container_head(meta) + pn.batch_frame(pb, meta)
            + pn.batch_frame(qb, meta) + pn.end_frame(190, 2))


def _rows(native, blob):
    schema = ps if native is pn else js
    out = []
    for b in native.NativeReader(blob).iter_batches():
        out += list(schema.iter_rows(b))
    return out


def _damaged(blob: bytes) -> dict:
    """``tests/test_columnar.py::test_native_reader_rejects_corruption``'s
    damage cases, plus a flipped CRC and a bad version."""
    flipped = bytearray(blob)
    flipped[len(flipped) // 2] ^= 0xFF
    end_len = struct.calcsize("<BQ") + struct.calcsize("<QI") + 4
    bad_crc = bytearray(blob)
    bad_crc[-1] ^= 0x01
    return {
        "truncated_head": bytes(blob[:4]),
        "bad_magic": b"NOPE" + bytes(blob[4:]),
        "flipped_payload": bytes(flipped),
        "no_end_frame": bytes(blob[:-end_len]),
        "bad_end_crc": bytes(bad_crc),
        "bad_version": blob[:4] + struct.pack("<H", 9) + blob[6:],
    }


@pytest.mark.parametrize("case", ["truncated_head", "bad_magic",
                                  "flipped_payload", "no_end_frame",
                                  "bad_end_crc", "bad_version"])
@pytest.mark.parametrize("codec", ["none", "zlib"])
def test_readers_reject_the_same_damage(case, codec):
    bad = _damaged(_blob(codec))[case]
    for reader, err in ((pn.NativeReader, pn.ColumnarFormatError),
                        (jn.NativeReader, jn.ColumnarFormatError)):
        with pytest.raises(err):
            list(reader(bad).iter_batches())
    assert issubclass(pn.ColumnarFormatError, ValueError)


def test_readers_skip_unknown_frames():
    blob = _blob()
    head_len = struct.calcsize("<4sHH")
    fhdr = struct.unpack_from("<BQ", blob, head_len)
    schema_end = head_len + struct.calcsize("<BQ") + fhdr[1] + 4
    payload = struct.pack("<BQ", 200, 5) + b"hello"
    frame = payload + struct.pack("<I", zlib.crc32(payload))
    spliced = blob[:schema_end] + frame + blob[schema_end:]
    want = _rows(jn, blob)
    assert _rows(pn, spliced) == want
    assert _rows(jn, spliced) == want


SPECS = ["", "rows=1", "rows=100,codec=zlib,level=1", "codec=deflate",
         "columns=flag+pos+name", " rows = 7 , codec = none ",
         "batch_rows=9,columns=cigar", "rows=0", "rows=-3", "codec=lz4",
         "level=10", "level=x", "columns=bin", "bogus=1", "rows",
         "rows=5,,codec=zlib"]


@pytest.mark.parametrize("spec", SPECS)
def test_columnar_spec_parses_as_jax(spec):
    try:
        want = JaxColumnarConfig.parse(spec)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            ColumnarConfig.parse(spec)
        assert str(got.value) == str(e)
        return
    got = ColumnarConfig.parse(spec)
    assert (got.batch_rows, got.codec, got.level, got.columns) == (
        want.batch_rows, want.codec, want.level, want.columns)


DEFLATE_SPECS = ["", "fixed", "mode=stored,level=3", "mode=auto,device=off",
                 "lanes=4,device=on", "mode=bad", "level=11", "lanes=0",
                 "device=gpu", "what=1", "stored,oops"]


@pytest.mark.parametrize("spec", DEFLATE_SPECS)
def test_deflate_spec_parses_as_jax(spec):
    try:
        want = JaxDeflateConfig.parse(spec)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            DeflateConfig.parse(spec)
        assert str(got.value) == str(e)
        return
    got = DeflateConfig.parse(spec)
    assert (got.mode, got.level, got.lanes, got.device, got.enabled,
            got.deterministic) == (want.mode, want.level, want.lanes,
                                   want.device, want.enabled,
                                   want.deterministic)


def _payloads():
    rng = np.random.default_rng(4)
    return {
        "empty": b"",
        "one": b"\x90",
        "text": b"ACGT" * 5000,
        "random": rng.integers(0, 256, 70_000, dtype=np.uint8).tobytes(),
        "two_windows_exact": bytes(range(256)) * 512,
        "low_bytes": rng.integers(0, 144, 3000, dtype=np.uint8).tobytes(),
    }


@pytest.mark.parametrize("name", list(_payloads()))
def test_zlib_stream_equals_jax_and_round_trips(name):
    raw = _payloads()[name]
    assert ph.fixed_pack(raw) == jh.fixed_pack(raw)
    got = ph.zlib_stream(raw)
    assert got == jh.zlib_stream(raw)
    assert zlib.decompress(got) == raw
    assert ph.zlib_stream(raw, window=1000) == jh.zlib_stream(raw,
                                                              window=1000)
    np.testing.assert_array_equal(ph.fixed_stream_bits(raw, False),
                                  jh.fixed_stream_bits(raw, False))
    assert encode_zlib_stream(raw) == got
    assert encode_zlib_stream(raw, "mode=fixed,device=off") == got


@pytest.mark.parametrize("spec", ["fixed", "mode=auto", "mode=stored,device=on"])
def test_device_deflate_spec_raises(spec, monkeypatch):
    """A spec that turns the device lanes on resolves to CUDA and raises
    without a card: no host fallback. On the CPU's plain lanes it gives
    the host stream's bytes."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        encode_zlib_stream(b"abc", spec)
    monkeypatch.setenv("SPARK_BAM_DEFLATE", spec)
    with pytest.raises(RuntimeError, match="CUDA"):
        encode_zlib_stream(b"abc")
    assert encode_zlib_stream(b"abc", device="cpu") == ph.zlib_stream(b"abc")


def test_config_reads_spark_bam_columnar():
    cfg = Config.from_env({"SPARK_BAM_COLUMNAR": "rows=5,codec=zlib",
                           "SPARK_BAM_CACHE": "read"})
    assert cfg.columnar == "rows=5,codec=zlib" and cfg.cache == "read"
    assert cfg.columnar_config == ColumnarConfig(batch_rows=5, codec="zlib")
    assert Config.from_env({}).columnar_config == ColumnarConfig()
