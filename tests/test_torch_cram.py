"""The port's CRAM (``spark_bam_tpu_torch/cram/``, ``native/rans.cpp``, the
CRAM loaders of ``load/api.py``, ``count-reads -F``, ``fuzz-decode
--formats cram``) against the JAX package's, exactly: ITF8/LTF8 bytes,
rANS bytes and decodes (the native decoder, the Python one and the JAX
one, on valid and malformed streams), the block codecs, the writer's bytes
and its ``.crai``, records read across the two packages, the
reference-based decode, the loaders, ``aggregate``, ``export`` and the
CLI."""

import contextlib
import dataclasses
import gzip
import io
import struct
import types
import zlib
from pathlib import Path

import numpy as np
import pytest

from spark_bam_tpu.bam.bai import index_bam as jindex_bam
from spark_bam_tpu.bam.header import ContigLengths
from spark_bam_tpu.bam.record import BamRecord as JRecord
from spark_bam_tpu.cram import CramReader as JReader
from spark_bam_tpu.cram import CramWriter as JWriter
from spark_bam_tpu.cram import bam_bridge as jbridge
from spark_bam_tpu.cram import codecs as jcodecs
from spark_bam_tpu.cram import crai as jcrai
from spark_bam_tpu.cram import nums as jnums
from spark_bam_tpu.cram import rans as jrans
from spark_bam_tpu.cram import structure as jstructure
from spark_bam_tpu.cram.reader import contigs_from_sam_text as jcontigs
from spark_bam_tpu.cram.writer import synthesize_sam_text as jsynth
from spark_bam_tpu.load import api as japi
from spark_bam_tpu_torch.bam.record import BamRecord
from spark_bam_tpu_torch.benchmarks import agg_cases
from spark_bam_tpu_torch.benchmarks import text_cases as tc
from spark_bam_tpu_torch.cram import CramReader, CramWriter
from spark_bam_tpu_torch.cram import bam_bridge, codecs, crai, nums, rans
from spark_bam_tpu_torch.cram import structure
from spark_bam_tpu_torch.cram.container import eof_container
from spark_bam_tpu_torch.cram.reader import contigs_from_sam_text
from spark_bam_tpu_torch.cram.writer import synthesize_sam_text
from spark_bam_tpu_torch.load import api
from spark_bam_tpu_torch.native import build
from tests.bam_factories import random_bam

METHODS = ("gzip", "rans", "raw")


def _enc(recs):
    return [r.encode() for r in recs]


def _jcontigs(header) -> ContigLengths:
    return ContigLengths({i: (str(n), int(ln)) for i, (n, ln) in enumerate(
        zip(header.contig_names, header.contig_lengths))})


def _to_jax(recs):
    return [JRecord(**dataclasses.asdict(r)) for r in recs]


@pytest.fixture(scope="module")
def bams(tmp_path_factory):
    """Seeded BAMs: three random (mixed mapped and unmapped, duplicate
    flags, 1-5,000 bp), a sorted indexed one, and the tagged aggregate
    BAM (NM, RG and a B-array BC)."""
    d = tmp_path_factory.mktemp("torch_cram")
    out = {}
    for seed in (0, 1, 2):
        out[seed] = str(d / f"r{seed}.bam")
        random_bam(out[seed], seed, dup_rate=0.15, read_len=(1, 5000))
    out["sorted"] = str(d / "s.bam")
    random_bam(out["sorted"], 77, contigs=(("chr1", 2_000_000),
                                           ("chr2", 1_000_000)),
               n_records=(300, 301), pos_step=(1, 50), read_len=(10, 600),
               mapped_rate=0.9, sort=True)
    jindex_bam(out["sorted"])
    out["tagged"] = str(d / "tagged.bam")
    agg_cases.write_tagged_bam(out["tagged"])
    return out


def _seqless_records():
    """A mapped read with sequence '*' and a real cigar, an unmapped one
    with no sequence, an unmapped one with bases, and a mapped one with
    '=' and 'X' runs (which decode back as 'M')."""
    return [
        BamRecord(0, 99, 7, 4681, 0, -1, -1, 0, "noseq",
                  [(30, 0), (5, 2), (20, 0)], "", b"", b""),
        BamRecord(-1, -1, 0, 0, 4, -1, -1, 0, "unseq", [], "", b"", b""),
        BamRecord(-1, -1, 0, 4680, 4, -1, -1, 0, "un", [], "ACGTN",
                  b"\x01\x02\x03\x04\x05", b""),
        BamRecord(0, 500, 60, 4681, 0, 0, 700, 250, "eqx",
                  [(3, 7), (1, 8), (4, 0)], "ACGTACGT", b"\x1e" * 8,
                  b"NMi\x01\x00\x00\x00"),
    ]


# ------------------------------------------------------------- numbers
ITF8 = [0, 1, 127, 128, 0x3FFF, 0x4000, 0x1FFFFF, 0x200000, 0x0FFFFFFF,
        0x10000000, 2**31 - 1, -1, -2, -(2**31)]
LTF8 = [0, 127, 128, 0x3FFF, 0x200000 - 1, 0x10000000, 2**34, 2**41, 2**48,
        2**55, 2**62, -1, -(2**63)]


@pytest.mark.parametrize("value", ITF8)
def test_itf8_bytes_equal_jax(value):
    b = nums.itf8(value)
    assert b == jnums.itf8(value)
    cur = nums.Cursor(b)
    assert cur.itf8() == value and cur.at_end()


@pytest.mark.parametrize("value", LTF8)
def test_ltf8_bytes_equal_jax(value):
    b = nums.ltf8(value)
    assert b == jnums.ltf8(value)
    cur = nums.Cursor(b)
    assert cur.ltf8() == value and cur.at_end()


def test_cursor_truncation_raises_as_jax():
    for blob in (b"", b"\xff", b"\xff\xff\xff", b"\xe0\x01"):
        for name in ("itf8", "ltf8", "u32", "i32", "u8"):
            got = want = None
            try:
                getattr(nums.Cursor(blob), name)()
            except Exception as e:
                got = type(e).__name__
            try:
                getattr(jnums.Cursor(blob), name)()
            except Exception as e:
                want = type(e).__name__
            assert got == want, (blob, name)


# ---------------------------------------------------------------- rANS
def _rans_cases():
    rng = np.random.default_rng(11)
    return [
        b"",
        b"a",
        b"abc",
        b"q" * 5000,
        b"skewed " * 500,
        bytes(rng.integers(0, 256, 20_000, dtype=np.uint8)),
        bytes(rng.integers(33, 43, 50_000, dtype=np.uint8)),
        bytes(range(256)) * 9 + b"\x00",
    ]


@pytest.mark.parametrize("order", [0, 1])
def test_rans_bytes_and_decodes_equal_jax(order):
    """The encoder's bytes equal JAX's; the native decode equals the
    Python decode equals the JAX decode equals the input."""
    for data in _rans_cases():
        blob = rans.compress(data, order)
        assert blob == jrans.compress(data, order)
        assert (rans.decompress(blob) == rans.decompress_python(blob)
                == jrans.decompress(blob) == data)


def _outcome(fn, blob, *args):
    try:
        return ("ok", fn(blob, *args))
    except Exception as e:  # the class is what is compared
        return ("raised", type(e).__name__)


def _jax_python_decode(blob):
    """``jrans.decompress`` with its Python decoders in place of the
    native one."""
    from spark_bam_tpu.core.guard import StructurallyInvalid

    cur = jnums.Cursor(blob)
    order = cur.u8()
    cur.u32()
    out_sz = cur.u32()
    if out_sz == 0:
        return b""
    if order not in (0, 1):
        raise StructurallyInvalid(f"unknown rANS order {order}")
    return (jrans._decode_o0(cur, out_sz) if order == 0
            else jrans._decode_o1(cur, out_sz))


def _malformed_blobs():
    evil = bytes([0x00, 0xFF, 0xFF, 0x01, 0xFF, 0xFF, 0x00])
    run = bytes([250, 1, 251, 10]) + bytes([1] * 11) + bytes([0])
    blobs = [
        bytes([0]) + struct.pack("<II", len(evil), 100) + evil,
        bytes([0]) + struct.pack("<II", 1, 10) + b"\x00",
        bytes([0]) + struct.pack("<II", len(run), 10) + run,
        bytes([7]) + struct.pack("<II", 0, 10),
        b"\x00\x01",
    ]
    rng = np.random.default_rng(5)
    data = bytes(rng.integers(60, 70, 3000, dtype=np.uint8))
    for order in (0, 1):
        blob = rans.compress(data, order)
        blobs += [blob[:cut] for cut in range(9, len(blob), 23)]
        for _ in range(20):
            b = bytearray(blob)
            b[int(rng.integers(9, len(b)))] ^= int(rng.integers(1, 256))
            blobs.append(bytes(b))
    return blobs


def test_rans_malformed_raise_as_jax():
    """On malformed, truncated and bit-flipped streams the native decoder
    raises (or decodes) as the JAX package's does, and the Python decoder
    as the JAX Python decoder does."""
    for blob in _malformed_blobs():
        assert _outcome(rans.decompress, blob) == _outcome(
            jrans.decompress, blob)
        assert _outcome(rans.decompress_python, blob) == _outcome(
            _jax_python_decode, blob)
    assert _outcome(rans.decompress, _malformed_blobs()[0], 10) == (
        "raised", "StructurallyInvalid")


def test_rans_native_build_raises_without_gxx(tmp_path, monkeypatch):
    """No ``g++`` and no library built: the decode raises, and nothing
    falls back to the Python decoder."""
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(build, "_rans_lib", None)
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    blob = rans.compress(b"abcdabcd" * 10, 1)
    with pytest.raises(build.NativeBuildError, match="rans.cpp"):
        rans.decompress(blob)
    assert not (tmp_path / "_build").exists()


def test_rans_native_library_is_the_ports():
    path = build.build(build.RANS_SRC)
    assert path.parent == build.BUILD_DIR and path.name.startswith(
        "libsbt_rans-")
    assert path == build.library_path(build.RANS_SRC)


# -------------------------------------------------------------- codecs
def test_core_block_codecs_equal_jax():
    bits = [(0b0, 1), (0b10, 2), (0b11, 2), (0b0, 1), (37, 8), (5, 3)]
    w, jw = codecs.BitWriter(), jcodecs.BitWriter()
    for v, n in bits:
        w.write_bits(v, n)
        jw.write_bits(v, n)
    assert w.getvalue() == jw.getvalue()
    for mk in (lambda m: m.huffman([5, 6, 7], [1, 2, 2]),
               lambda m: m.beta(0, 8), lambda m: m.huffman([42], [0]),
               lambda m: m.external(9), lambda m: m.byte_array_stop(0, 7),
               lambda m: m.byte_array_len(m.external(3), m.external(4))):
        assert mk(codecs).serialize() == mk(jcodecs).serialize()
    dec = codecs.Decoders(codecs.BitReader(w.getvalue()), {})
    h = dec.int_reader(codecs.huffman([5, 6, 7], [1, 2, 2]))
    assert [h(), h(), h(), h()] == [5, 6, 7, 5]
    assert dec.int_reader(codecs.beta(0, 8))() == 37
    assert dec.int_reader(codecs.huffman([42], [0]))() == 42
    # External streams: ints, bytes, stop-byte and length-prefixed arrays.
    ext = {1: nums.Cursor(nums.itf8(300) + nums.itf8(-5)),
           2: nums.Cursor(b"xyz"), 3: nums.Cursor(b"ab\x00cd\x00"),
           4: nums.Cursor(nums.itf8(3)), 5: nums.Cursor(b"QRS")}
    dec = codecs.Decoders(codecs.BitReader(b""), ext)
    r = dec.int_reader(codecs.external(1))
    assert [r(), r()] == [300, -5]
    assert dec.byte_reader(codecs.external(2))() == ord("x")
    a = dec.array_reader(codecs.byte_array_stop(0, 3))
    assert [a(), a()] == [b"ab", b"cd"]
    la = dec.array_reader(codecs.byte_array_len(codecs.external(4),
                                                codecs.external(5)))
    assert la() == b"QRS"


def test_compression_header_and_structures_equal_jax():
    assert structure.DEFAULT_SUBST_MATRIX == jstructure.DEFAULT_SUBST_MATRIX
    assert bam_bridge.subst_tables(structure.DEFAULT_SUBST_MATRIX) == \
        jbridge.subst_tables(jstructure.DEFAULT_SUBST_MATRIX)
    for beg, end in ((0, 1), (99, 4000), (16383, 16385), (1 << 26, 1 << 27)):
        assert bam_bridge.reg2bin(beg, end) == jbridge.reg2bin(beg, end)
    tags = (b"NMi\x03\x00\x00\x00" + b"RGZgrp1\x00"
            + b"BCBi\x02\x00\x00\x00\x01\x00\x00\x00\x02\x00\x00\x00")
    assert bam_bridge.split_tags(tags) == jbridge.split_tags(tags)
    assert bam_bridge.join_tags(bam_bridge.split_tags(tags)) == tags
    for cigar, seq in (([(5, 0), (2, 1), (3, 4), (4, 2), (6, 0)],
                        "ACGTACGTACGTACGT"), ([(2, 5), (4, 0), (1, 6)],
                                              "AAAA")):
        assert bam_bridge.features_from_record(cigar, seq) == \
            jbridge.features_from_record(cigar, seq)


def test_sam_text_helpers_equal_jax():
    contigs = [("chr1", 1000), ("chrM", 16569), ("x", 0)]
    assert synthesize_sam_text(contigs) == jsynth(
        ContigLengths(dict(enumerate(contigs))))
    text = "@HD\tVN:1.6\n@SQ\tSN:a\tLN:5\n@SQ\tLN:7\n@SQ\tSN:b\n@PG\tID:x\n"
    h = contigs_from_sam_text(text)
    want = jcontigs(text)
    assert list(zip(h.contig_names, h.contig_lengths.tolist())) == [
        want[i] for i in range(len(want))]


def test_eof_container_is_canonical():
    assert eof_container().hex() == (
        "0f000000ffffffff0fe0454f4600000000010005bdd94f"
        "0001000606010001000100ee63014b")


# ------------------------------------------------------------- writer
def _write_both(tmp_path, header, recs, **kw):
    """The port's and the JAX writer's files of the same records, under
    the same base name in two directories (the ``.crai``'s gzip header
    names the file) and one fixed clock (it stamps the time)."""
    (tmp_path / "p").mkdir(exist_ok=True)
    (tmp_path / "j").mkdir(exist_ok=True)
    p, j = tmp_path / "p" / "x.cram", tmp_path / "j" / "x.cram"
    with CramWriter(p, tc.contig_pairs(header), header.text, **kw) as w:
        w.write_all(recs)
    with JWriter(j, _jcontigs(header), header.text, **kw) as w:
        w.write_all(_to_jax(recs))
    return p, j


@pytest.fixture
def fixed_clock(monkeypatch):
    monkeypatch.setattr(gzip, "time",
                        types.SimpleNamespace(time=lambda: 1_700_000_000))


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_writer_bytes_and_crai_equal_jax(bams, tmp_path, fixed_clock,
                                         method, seed):
    """Random BAMs (mixed mapped and unmapped) in several containers:
    the CRAM and its ``.crai`` byte for byte, and both readers give the
    BAM's records back."""
    header, recs = tc.bam_records(bams[seed])
    p, j = _write_both(tmp_path, header, recs, method=method,
                       records_per_container=100)
    assert p.read_bytes() == j.read_bytes()
    assert Path(str(p) + ".crai").read_bytes() == \
        Path(str(j) + ".crai").read_bytes()
    with CramReader(j) as r:
        assert len(r.container_infos()) == -(-len(recs) // 100)
        assert _enc(r) == _enc(recs)
    with JReader(p) as r:
        assert _enc(r) == _enc(recs)


@pytest.mark.parametrize("method", METHODS)
def test_writer_seqless_and_tagged_equal_jax(bams, tmp_path, fixed_clock,
                                             method):
    """Seqless mapped and unmapped records, '=' and 'X' runs, and tags
    of every kind (the tagged BAM): equal bytes, and records read back
    equal across the packages."""
    header, recs = tc.bam_records(bams["tagged"])
    recs = recs + _seqless_records()
    p, j = _write_both(tmp_path, header, recs, method=method,
                       records_per_container=64)
    assert p.read_bytes() == j.read_bytes()
    assert Path(str(p) + ".crai").read_bytes() == \
        Path(str(j) + ".crai").read_bytes()
    with CramReader(p) as r:
        got = list(r)
    with JReader(p) as r:
        want = list(r)
    assert _enc(got) == _enc(want)
    noseq, unseq, un, eqx = got[-4:]
    assert noseq.cigar == [(30, 0), (5, 2), (20, 0)] and noseq.seq == ""
    assert unseq.seq == "" and un.seq == "ACGTN"
    # '=' and 'X' runs come back as one 'M' run; the bases are kept.
    assert eqx.cigar == [(8, 0)] and eqx.seq == "ACGTACGT"


def test_crai_entries_equal_jax(bams, tmp_path):
    header, recs = tc.bam_records(bams["sorted"])
    p, j = _write_both(tmp_path, header, recs, records_per_container=40)
    got = crai.read_crai(str(p) + ".crai")
    assert [dataclasses.astuple(e) for e in got] == [
        dataclasses.astuple(e) for e in jcrai.read_crai(str(j) + ".crai")]
    e = crai.CraiEntry(0, 101, 500, 1000, 50, 4000)
    je = jcrai.CraiEntry(0, 101, 500, 1000, 50, 4000)
    for q in ((0, 100, 101), (0, 0, 100), (1, 100, 200), (0, 600, 601)):
        assert e.overlaps(*q) == je.overlaps(*q)


# ------------------------------------------------ reference-based decode
def _foreign_cram(tmp_path, with_embedded: bool, mods,
                  name: str = "foreign") -> Path:
    """One container shaped as real writers shape them (core bit-stream
    codecs, AP deltas, a single-reference slice, no read names, NF mate
    chaining, an optional embedded reference starting mid-contig), none
    of which the writer emits; assembled by ``mods`` (the port's or the
    JAX package's modules), as ``tests/test_cram.py`` assembles it."""
    cd, ct, st = mods
    ds = {
        "BF": cd.huffman([65, 129], [1, 1]),
        "CF": cd.huffman([0, 4], [1, 1]),
        "RL": cd.beta(0, 6),
        "AP": cd.beta(0, 4),
        "NF": cd.huffman([0], [0]),
        "TL": cd.huffman([0], [0]),
        "FN": cd.huffman([0, 1], [1, 1]),
        "FC": cd.huffman([ord("X")], [0]),
        "FP": cd.beta(0, 4),
        "BS": cd.huffman([1], [0]),
        "MQ": cd.beta(0, 7),
    }
    ch = st.CompressionHeader(read_names_included=False, ap_delta=True,
                              reference_required=True, tag_dict=[[]],
                              data_series=ds, tags={})
    w = cd.BitWriter()
    for v, n in ((0, 1), (1, 1), (8, 6), (0, 4), (1, 1), (3, 4), (30, 7),
                 (1, 1), (0, 1), (8, 6), (5, 4), (0, 1), (30, 7)):
        w.write_bits(v, n)
    ref_bytes = b"AACCGGTTAACCGGTT"  # contig "c", 0-based positions 10..25
    blocks = [ct.Block(ct.CORE, 0, w.getvalue()).serialize(ct.RAW)]
    content_ids, embedded_id = [], -1
    if with_embedded:
        blocks.append(ct.Block(ct.EXTERNAL, 100, ref_bytes).serialize(ct.RAW))
        content_ids, embedded_id = [100], 100
    sh = st.SliceHeader(ref_seq_id=0, start=11, span=13, n_records=2,
                        record_counter=0, n_blocks=len(blocks),
                        content_ids=content_ids,
                        embedded_ref_id=embedded_id)
    ch_block = ct.Block(ct.COMPRESSION_HEADER, 0, ch.serialize()).serialize(
        ct.RAW)
    sh_block = ct.Block(ct.MAPPED_SLICE, 0, sh.serialize()).serialize(ct.RAW)
    body = ch_block + sh_block + b"".join(blocks)
    hdr = ct.ContainerHeader(length=len(body), ref_seq_id=0, start=11,
                             span=13, n_records=2, record_counter=0,
                             bases=16, n_blocks=2 + len(blocks),
                             landmarks=[len(ch_block)])
    out = tmp_path / f"{name}{int(with_embedded)}.cram"
    with open(out, "wb") as f:
        f.write(ct.file_definition())
        f.write(ct.sam_header_container("@HD\tVN:1.6\n@SQ\tSN:c\tLN:100\n"))
        f.write(hdr.serialize() + body)
        f.write(ct.eof_container())
    return out


def _port_mods():
    from spark_bam_tpu_torch.cram import container
    return codecs, container, structure


def _jax_mods():
    from spark_bam_tpu.cram import container
    return jcodecs, container, jstructure


def _check_foreign(recs):
    a, b = recs
    assert (a.flag, a.pos, a.mapq, a.read_name) == (65, 10, 30, "q0")
    assert a.seq == "AAGCGGTT" and a.cigar == [(8, 0)]
    assert (b.flag, b.pos, b.seq) == (129, 15, "GTTAACCG")
    assert (a.next_ref_id, a.next_pos, a.tlen) == (0, 15, 13)
    assert (b.next_ref_id, b.next_pos, b.tlen) == (0, 10, -13)


@pytest.mark.parametrize("embedded", [True, False], ids=["embedded",
                                                          "fasta"])
def test_reference_based_decode_equals_jax(tmp_path, embedded):
    """The foreign shape: the port assembles the same bytes as the JAX
    package; the port's reader decodes them against the embedded
    reference or a FASTA file as the JAX reader does."""
    path = _foreign_cram(tmp_path, embedded, _port_mods())
    assert path.read_bytes() == _foreign_cram(
        tmp_path, embedded, _jax_mods(), "jax").read_bytes()
    fasta = tmp_path / "c.fa"
    fasta.write_text(">c desc\nNNNNNNNNNN\nAACCGGTTAACCGGTT\n")
    ref = None if embedded else str(fasta)
    with CramReader(path, reference=ref) as r:
        got = list(r)
    with JReader(path, reference=ref) as r:
        want = list(r)
    _check_foreign(got)
    assert _enc(got) == _enc(want)
    if not embedded:
        ds = api.load_cram(path, reference={"c": b"?" * 10 + b"AACCGGTT" * 2})
        assert _enc(ds.collect()) == _enc(got)


def test_reference_required_raises_as_jax(tmp_path):
    path = _foreign_cram(tmp_path, False, _port_mods())
    with CramReader(path) as r:
        with pytest.raises(ValueError, match="RR=true") as got:
            list(r)
    with JReader(path) as r:
        with pytest.raises(ValueError, match="RR=true") as want:
            list(r)
    assert type(got.value).__name__ == type(want.value).__name__


def test_decode_mapped_by_hand_equals_jax():
    """Match gaps pull bases from the reference, an X goes through the
    substitution matrix, a D consumes reference only."""
    sub = bam_bridge.subst_tables(structure.DEFAULT_SUBST_MATRIX)
    out = []
    for reader_cls in (CramReader, JReader):
        reader = reader_cls.__new__(reader_cls)
        if reader_cls is CramReader:
            reader.header = contigs_from_sam_text("@SQ\tSN:c\tLN:40\n")
        else:
            reader.contigs = ContigLengths({0: ("c", 40)})
        reader.reference = {"c": b"ACGTACGTACGTACGTACGT"}
        feats = iter([("X", 3, 0), ("D", 5, 2)])
        state = {"prev": 0}

        def r_fc():
            c, p, payload = next(feats)
            state.update(payload=payload, pos=p)
            return ord(c)

        def r_fp():
            d = state["pos"] - state["prev"]
            state["prev"] = state["pos"]
            return d

        payload = lambda: state["payload"]  # noqa: E731
        rec = reader._decode_mapped(
            0, 0, 0, 6, 0, sub, None, 0, False, lambda: 2, r_fc, r_fp,
            payload, payload, payload, payload, payload, payload, payload,
            payload, payload, lambda: 60, lambda: ord("N"), lambda: 0xFF,
            lambda n: b"#" * n)
        out.append(rec)
    assert out[0].seq == out[1].seq == "ACATGT"
    assert out[0].cigar == out[1].cigar == [(4, 0), (2, 2), (2, 0)]
    assert out[0].encode() == out[1].encode()


def test_nf_linked_mates_equal_jax():
    def recs(cls, names):
        return [cls(ref_id=0, pos=100 + i, mapq=60, bin=0, flag=0x1 | (
            0x10 if i == 1 else 0), next_ref_id=-1, next_pos=-1, tlen=0,
            read_name=n, cigar=[(4, 0)], seq="ACGT", qual=b"####")
            for i, n in enumerate(names)]

    for names_included in (False, True):
        a, b = recs(BamRecord, ["q0", "q1", "q2"]), recs(JRecord,
                                                         ["q0", "q1", "q2"])
        CramReader._resolve_mates(a, [0, None, None], names_included)
        JReader._resolve_mates(b, [0, None, None], names_included)
        assert _enc(a) == _enc(b)


# ------------------------------------------------------------- loaders
@pytest.fixture(scope="module")
def crams(bams, tmp_path_factory):
    """The sorted and the tagged BAMs as CRAMs of small containers, with
    their ``.crai``."""
    d = tmp_path_factory.mktemp("torch_cram_files")
    out = {}
    for key, per in (("sorted", 32), ("tagged", 50), (0, 64)):
        header, recs = tc.bam_records(bams[key])
        out[key] = str(d / f"{key}.cram")
        tc.write_cram(header, recs, out[key], "gzip", per)
    return out


@pytest.mark.parametrize("split", [None, 2000, 9000, "64KB"])
def test_load_cram_equals_jax(bams, crams, split):
    ds = api.load_cram(crams["sorted"], split)
    jds = japi.load_cram(crams["sorted"], split)
    assert len(ds.partitions) == len(jds.partitions)
    assert [[(i.offset, i.end) for i in g] for g in ds.partitions] == [
        [(i.offset, i.end) for i in g] for g in jds.partitions]
    assert _enc(ds.collect()) == _enc(jds.collect())
    assert _enc(ds.collect()) == _enc(tc.bam_records(bams["sorted"])[1])
    assert _enc(api.load_reads(crams["sorted"], split, device="cpu")
                .collect()) == _enc(japi.load_reads(crams["sorted"], split)
                                    .collect())


LOCI = ["chr1:2000-3000", "chr1:100-400,chr2:50-900", "chr2", "chr3"]


@pytest.mark.parametrize("loci", LOCI)
@pytest.mark.parametrize("with_crai", [True, False], ids=["crai", "scan"])
def test_load_cram_intervals_equals_jax(bams, crams, tmp_path, loci,
                                        with_crai):
    path = crams["sorted"]
    if not with_crai:
        path = str(tmp_path / "nocrai.cram")
        Path(path).write_bytes(Path(crams["sorted"]).read_bytes())
    got = api.load_cram_intervals(path, loci, "4KB")
    want = japi.load_cram_intervals(path, loci, "4KB")
    assert len(got.partitions) == len(want.partitions)
    assert _enc(got.collect()) == _enc(want.collect())
    # And the BAM's indexed interval load, through the .bai.
    assert _enc(got.collect()) == _enc(japi.load_bam_intervals(
        bams["sorted"], loci).collect())


def test_crai_narrows_the_containers(crams):
    """With the ``.crai`` a locus decodes only its containers."""
    with CramReader(crams["sorted"]) as r:
        total = len(r.container_infos())
    ds = api.load_cram_intervals(crams["sorted"], "chr1:2000-2500")
    picked = sum(len(g) for g in ds.partitions)
    assert 0 < picked < total


# ------------------------------------------------- aggregate and export
AGG_KW = [
    {},
    {"agg": "count;flagstat;mapq;tlen:max=50;coverage:bin=500,bins=16"},
    {"flags_required": 1024},
    {"flags_forbidden": 4, "agg": "count;mapq"},
    {"tags_required": ("NM",)},
    {"tags_required": ("BC", "RG"), "flags_forbidden": 16},
    {"loci": "chr1:100-5000", "agg": "count;coverage"},
    {"agg": "tlen"},
]


@pytest.mark.parametrize("kw", AGG_KW)
@pytest.mark.parametrize("key", ["tagged", "sorted"])
def test_aggregate_cram_equals_jax(crams, key, kw):
    """Every metric, flag and tag filters and loci: the int64 vectors,
    rows and contigs equal the JAX package's."""
    got = api.aggregate(crams[key], device="cpu", **kw)
    want = japi.aggregate(crams[key], **kw)
    assert got["agg"] == want["agg"] and got["rows"] == want["rows"]
    assert got["contigs"] == want["contigs"]
    assert list(got["metrics"]) == list(want["metrics"])
    for k, v in want["metrics"].items():
        assert got["metrics"][k].dtype == np.int64
        assert np.array_equal(got["metrics"][k], np.asarray(v)), k


def test_aggregate_cram_equals_the_bams_device_reduction(bams, crams):
    """The CRAM's host oracle equals the BAM's reduction (on the CPU
    device here; on the card in the smoke)."""
    for key in ("tagged", "sorted"):
        got = api.aggregate(crams[key], device="cpu")
        bam = api.aggregate(bams[key], device="cpu")
        assert got["rows"] == bam["rows"]
        for k in bam["metrics"]:
            assert np.array_equal(got["metrics"][k], bam["metrics"][k]), k


@pytest.mark.parametrize("kw", [{}, {"loci": "chr2"},
                                {"flags_forbidden": 16},
                                {"columns": "flag,pos,name,tags"}])
def test_export_cram_equals_jax(crams, tmp_path, kw):
    kw = dict(kw)
    columns = kw.pop("columns", None)
    got = api.export(crams["sorted"], str(tmp_path / "p.sbcr"),
                     columns=columns, device="cpu", **kw)
    want = japi.export(crams["sorted"], str(tmp_path / "j.sbcr"),
                       columns=columns, **kw)
    assert (tmp_path / "p.sbcr").read_bytes() == \
        (tmp_path / "j.sbcr").read_bytes()
    assert got["rows"] == want["rows"] > 0
    assert got["batches"] == want["batches"]


def test_entry_points_need_a_device_by_default(crams, tmp_path):
    with pytest.raises(RuntimeError, match="CUDA"):
        api.aggregate(crams["sorted"])
    with pytest.raises(RuntimeError, match="CUDA"):
        api.export(crams["sorted"], str(tmp_path / "x"))


# ------------------------------------------------------------------ CLI
def _run_port(argv):
    from spark_bam_tpu_torch import cli

    with contextlib.redirect_stdout(io.StringIO()) as out, \
            contextlib.redirect_stderr(io.StringIO()) as err:
        rc = cli.main(argv)
    return rc, out.getvalue(), err.getvalue()


def _run_jax(argv, out_path):
    from spark_bam_tpu.cli.main import main

    with contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(io.StringIO()):
        rc = main(argv + ["-o", str(out_path)])
    return rc, Path(out_path).read_text()


def _untimed(text):
    return [ln for ln in text.splitlines() if "time:" not in ln]


def test_count_reads_cli_with_reference_equals_jax(tmp_path, crams):
    path = _foreign_cram(tmp_path, False, _port_mods())
    fasta = tmp_path / "c.fa"
    fasta.write_text(">c\nNNNNNNNNNNAACCGGTTAACCGGTT\n")
    rc, out, _ = _run_port(["count-reads", "-F", str(fasta), "-n", "2",
                            "--device", "cpu", str(path)])
    jrc, jout = _run_jax(["count-reads", "-F", str(fasta), "-n", "2",
                          str(path)], tmp_path / "j.txt")
    assert rc == jrc == 0
    assert _untimed(out) == _untimed(jout)
    assert "Read count: 2" in out
    rc, out, _ = _run_port(["count-reads", "--device", "cpu", "-m", "3KB",
                            crams["sorted"]])
    jrc, jout = _run_jax(["count-reads", "-m", "3KB", crams["sorted"]],
                         tmp_path / "j2.txt")
    assert rc == jrc == 0 and _untimed(out) == _untimed(jout)


@pytest.mark.parametrize("flags", [["--resident"], ["--sharded"],
                                   ["--resident", "--sharded"]])
def test_count_reads_cram_modes_are_usage_errors_as_jax(crams, tmp_path,
                                                        flags):
    rc, _, err = _run_port(["count-reads", *flags, "--device", "cpu",
                            crams["sorted"]])
    from spark_bam_tpu.cli.main import main

    with contextlib.redirect_stderr(io.StringIO()) as jerr, \
            contextlib.redirect_stdout(io.StringIO()):
        jrc = main(["count-reads", *flags, crams["sorted"], "-o",
                    str(tmp_path / "o")])
    assert rc == jrc == 2
    assert err.strip().splitlines()[-1] == jerr.getvalue().strip(
        ).splitlines()[-1]


def test_aggregate_and_export_cli_with_reference(tmp_path, crams):
    """``-F`` on ``aggregate`` and ``export``: the report and the file
    equal the JAX CLI's; ``export --durable`` refuses ``--reference``."""
    path = _foreign_cram(tmp_path, False, _port_mods())
    fasta = tmp_path / "c.fa"
    fasta.write_text(">c\nNNNNNNNNNNAACCGGTTAACCGGTT\n")
    rc, out, _ = _run_port(["aggregate", "-F", str(fasta), "--format",
                            "json", "--device", "cpu", str(path)])
    jrc, jout = _run_jax(["aggregate", "-F", str(fasta), "--format", "json",
                          str(path)], tmp_path / "j.json")
    assert rc == jrc == 0 and out == jout
    rc, out, _ = _run_port(["export", "-F", str(fasta), "--device", "cpu",
                            "-o", str(tmp_path / "p.sbcr"), str(path)])
    from spark_bam_tpu.cli.main import main

    with contextlib.redirect_stdout(io.StringIO()):
        assert main(["export", "-F", str(fasta), "-o",
                     str(tmp_path / "j.sbcr"), str(path)]) == 0
    assert rc == 0
    assert (tmp_path / "p.sbcr").read_bytes() == \
        (tmp_path / "j.sbcr").read_bytes()
    rc, _, err = _run_port(["export", "--durable", "-F", str(fasta),
                            "--device", "cpu", "-o",
                            str(tmp_path / "d.sbcr"), str(path)])
    assert rc == 2 and "-i/--reference" in err


# ----------------------------------------------------------------- fuzz
@pytest.mark.parametrize("seed", [0, 3, 9])
def test_fuzz_decode_cram_counts_equal_jax(seed):
    from spark_bam_tpu.tools import fuzz_decode as J
    from spark_bam_tpu_torch.tools import fuzz_decode as P

    got = P.run_fuzz(seed, 40, ("cram",), device="cpu")
    want = J.run_fuzz(seed, 40, ("cram",))
    assert got["counts"] == want["counts"]
    assert got["violations"] == want["violations"] == []
    assert sum(got["counts"]["cram"].values()) == 40


def test_fuzz_cram_corpus_bytes_equal_jax(tmp_path):
    from spark_bam_tpu.tools import fuzz_decode as J
    from spark_bam_tpu_torch.tools import fuzz_decode as P

    (tmp_path / "p").mkdir()
    (tmp_path / "j").mkdir()
    assert P._cram_corpus(tmp_path / "p") == J._cram_corpus(tmp_path / "j")
    got = list(P.mutants_for("cram", tmp_path / "p", P.rng_for(4, "cram"),
                             30))
    want = list(J._mutants_for("cram", tmp_path / "j", J._Rng(
        (4 << 16) ^ zlib.crc32(b"cram")), 30))
    assert got == want
