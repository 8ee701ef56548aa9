"""Flat views of runs of BGZF blocks: raw payloads for the device
tokenizer, host inflation (the native table decoder of ``native/eager.cpp``)
for the classic loop, the demoted windows and the whole-file load
(``flatten_file``), and the block tables that map a flat offset to
``block:offset`` and back."""

from __future__ import annotations

import zlib
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np

from spark_bam_tpu_torch import obs
from spark_bam_tpu_torch.bgzf.block import (
    FOOTER_SIZE,
    MAX_COMPRESSED_PAYLOAD,
    BgzfError,
    Metadata,
    parse_header,
)
from spark_bam_tpu_torch.bgzf.index_blocks import blocks_metadata
from spark_bam_tpu_torch.core.channel import open_channel
from spark_bam_tpu_torch.native import build as native


@dataclass
class FlatView:
    """The uncompressed bytes of a run of blocks, flat-addressable through
    its block tables."""

    data: np.ndarray          # uint8, concatenated uncompressed payloads
    at_eof: bool = False      # the run ends at the file's uncompressed end
    block_starts: np.ndarray | None = None  # int64 compressed offset per block
    block_flat: np.ndarray | None = None    # int64 flat offset of its 1st byte
    file_total: int | None = None  # flat size of the whole file, if known

    @property
    def size(self) -> int:
        return int(self.data.shape[0])

    def flat_of_pos(self, block_pos: int, offset: int) -> int:
        i = int(np.searchsorted(self.block_starts, block_pos))
        if i >= len(self.block_starts) or self.block_starts[i] != block_pos:
            raise KeyError(f"block {block_pos} not in view")
        return int(self.block_flat[i]) + offset

    def pos_of_flat(self, flat: int) -> tuple[int, int]:
        return pos_of_flat_tables(self.block_starts, self.block_flat, flat)

    def pos_of_flat_many(self, flat: np.ndarray
                         ) -> tuple[np.ndarray, np.ndarray]:
        idx = np.searchsorted(self.block_flat, flat, side="right") - 1
        return self.block_starts[idx], flat - self.block_flat[idx]


def _next_pow2(n: int) -> int:
    return 1 << max(0, (max(n, 1) - 1).bit_length())


def read_run_payloads(ch, metas: list[Metadata]):
    """``(comp, offsets, lengths)`` for a contiguous run of blocks (what the
    window plan hands out): the run's bytes, read with one positioned read,
    and each block's raw-DEFLATE payload ``(offset, length)`` in them."""
    offsets = np.empty(len(metas), dtype=np.int64)
    lengths = np.empty(len(metas), dtype=np.int64)
    if not metas:
        return np.empty(0, dtype=np.uint8), offsets, lengths
    lo = metas[0].start
    hi = metas[-1].start + metas[-1].compressed_size
    if hi - lo != sum(m.compressed_size for m in metas):
        raise BgzfError(f"blocks at {lo}..{hi} are not one contiguous run")
    blob = ch.read_at(lo, hi - lo)
    if len(blob) != hi - lo:
        raise EOFError(f"short read of the blocks at {lo}..{hi}")
    for i, m in enumerate(metas):
        at = m.start - lo
        header_size, _ = parse_header(blob[at: at + 18])
        offsets[i] = at + header_size
        lengths[i] = m.compressed_size - header_size - FOOTER_SIZE
    return np.frombuffer(blob, dtype=np.uint8), offsets, lengths


def footer_crcs(comp: np.ndarray, offsets: np.ndarray,
                lengths: np.ndarray) -> np.ndarray:
    """``(B,) u32``: each block's stored CRC-32, the footer word that
    follows its payload in ``read_run_payloads``' bytes."""
    at = offsets + lengths
    word = np.zeros(len(at), dtype=np.uint32)
    for k in range(4):
        word |= comp[at + k].astype(np.uint32) << np.uint32(8 * k)
    return word


def crc_mismatch(start: int, stored: int, computed: int):
    """The strict block stream's ``BlockCorruptionError`` for a block
    whose inflated bytes do not match its footer CRC-32."""
    from spark_bam_tpu_torch.core.faults import BlockCorruptionError

    return BlockCorruptionError(
        f"BGZF block at {start}: CRC32 mismatch (stored {stored:#010x}, "
        f"computed {computed:#010x})")


def stage_run_payloads(ch, metas: list[Metadata]):
    """``(staged (B_pad, C_pad) u8, clens (B_pad,) i32)``: one zero-padded
    row per block for the device tokenizer. Both dims are powers of two;
    ``C_pad`` ≥ the longest payload + 8 so the kernel's 4-byte bit reads
    never leave a row, and ≥ 1024. Pad rows have ``clen == 0``."""
    return stage_rows(*read_run_payloads(ch, metas))


def stage_rows(comp: np.ndarray, offsets: np.ndarray, lengths: np.ndarray):
    """``stage_run_payloads`` from payloads already read."""
    b = len(offsets)
    longest = int(lengths.max()) if b else 0
    if longest > MAX_COMPRESSED_PAYLOAD:
        raise BgzfError(
            f"raw payload of {longest} bytes exceeds the BGZF "
            f"{MAX_COMPRESSED_PAYLOAD}-byte ceiling"
        )
    c_pad = max(_next_pow2(longest + 8), 1024)
    staged = np.zeros((_next_pow2(b), c_pad), dtype=np.uint8)
    for i in range(b):
        o, n = int(offsets[i]), int(lengths[i])
        staged[i, :n] = comp[o: o + n]
    clens = np.zeros(staged.shape[0], dtype=np.int32)
    clens[:b] = lengths
    return staged, clens


def _inflate_into(comp, off: int, clen: int, out: np.ndarray, usize: int,
                  crc_at: int | None = None):
    """Inflate one payload into ``out``; with ``crc_at`` (the block's
    compressed offset) its CRC-32 is checked against the footer word that
    follows the payload, as the strict block stream checks it."""
    if crc_at is None:
        data = zlib.decompress(bytes(comp[off: off + clen]), wbits=-15,
                               bufsize=max(usize, 1))
        if len(data) != usize:
            raise BgzfError(
                f"Expected {usize} decompressed bytes, found {len(data)}"
            )
    else:
        from spark_bam_tpu_torch.bgzf.stream import inflate_block_payload

        data = inflate_block_payload(comp[off: off + clen], usize)
        stored = int.from_bytes(bytes(comp[off + clen: off + clen + 4]),
                                "little")
        computed = zlib.crc32(data) & 0xFFFFFFFF
        if computed != stored:
            raise crc_mismatch(crc_at, stored, computed)
    out[:] = np.frombuffer(data, dtype=np.uint8)


#: Blocks a thread of the fast inflate takes at the least. The reference
#: cuts at 32, which leaves a run of under 64 blocks on one thread; at 8,
#: runs of 48-128 blocks inflated 1.2-2.2x faster on an H100's host, runs
#: of 1-16 blocks alike, and runs of 256 or more are cut as the
#: reference's (``benchmarks/profile_host_routes.py --legs short``).
SLICE_BLOCKS = 8


def slice_count(blocks: int, threads: int) -> int:
    """The threads a run of ``blocks`` is inflated on."""
    return max(1, min(threads, blocks // SLICE_BLOCKS))


def _inflate_fast(comp, offsets, lengths, out_alloc: np.ndarray,
                  block_flat: np.ndarray, usizes: np.ndarray, threads: int,
                  crcs: np.ndarray | None) -> int | None:
    """Inflate a run into ``out_alloc`` with the native table decoder, the
    run cut into ``slice_count(blocks, threads)`` slices of blocks,
    each on its own thread (the C call releases the GIL) and each writing
    a disjoint output range: only the last one holds the slack. With
    ``crcs`` (the footer words), each block's CRC-32 is checked too;
    returns the index of the first block whose check fails, or None."""
    n = len(offsets)
    n_slices = slice_count(n, threads)
    bounds = np.linspace(0, n, n_slices + 1, dtype=np.int64)

    def run_slice(k: int) -> int | None:
        lo, hi = int(bounds[k]), int(bounds[k + 1])
        flat_lo = int(block_flat[lo])
        flat_hi = len(out_alloc) if hi == n else int(block_flat[hi])
        native.inflate_blocks_fast_into(
            comp, offsets[lo:hi], lengths[lo:hi],
            out_alloc[flat_lo:flat_hi], block_flat[lo:hi] - flat_lo,
            usizes[lo:hi])
        if crcs is not None:
            for i in range(lo, hi):
                at = int(block_flat[i])
                got = zlib.crc32(out_alloc[at: at + int(usizes[i])])
                if got != int(crcs[i]):
                    return i
        return None

    if n_slices == 1:
        return run_slice(0)
    with ThreadPoolExecutor(max_workers=n_slices) as pool:
        # In slice order: the first damaged block in file order.
        return next((i for i in pool.map(run_slice, range(n_slices))
                     if i is not None), None)


def inflate_blocks(ch, metas: list[Metadata], threads: int = 8,
                   verify_crc: bool = False) -> FlatView:
    """Inflate a run of blocks with the native table decoder
    (``native/eager.cpp``; a block it refuses is decoded by zlib) into one
    flat buffer. ``verify_crc`` checks each block's CRC-32 and raises the
    strict stream's ``BlockCorruptionError`` on a damaged payload (the
    export's contract). A run the native call refuses (a payload neither
    decoder inflates to its footer's size) is inflated again block by
    block with zlib, which raises the first damaged block's error in file
    order; any other failure of the native call raises as it is."""
    comp, offsets, lengths = read_run_payloads(ch, metas)
    usizes = np.array([m.uncompressed_size for m in metas], dtype=np.int64)
    block_flat = np.zeros(len(metas), dtype=np.int64)
    if len(metas):
        np.cumsum(usizes[:-1], out=block_flat[1:])
    total = int(usizes.sum())
    # 8 bytes of slack keep the decoder's word copies fast up to the last
    # block's end; the view handed out is exact.
    out_alloc = np.empty(total + 8, dtype=np.uint8)
    out = out_alloc[:total]
    with obs.span("inflate.window", blocks=len(metas), bytes=total) as sp:
        engine = "zlib"   # the reference's label of an empty run
        if metas:
            # A library that does not build or load raises here.
            native.load_native()
            crcs = footer_crcs(comp, offsets, lengths) if verify_crc else None
            try:
                bad = _inflate_fast(comp, offsets, lengths, out_alloc,
                                    block_flat, usizes, threads, crcs)
            except (OSError, zlib.error):
                # A payload neither decoder inflates to its footer's size:
                # the per-block route raises the first damaged block's
                # error in file order (and checks every CRC on its way).
                # Where it finds none, the failure was not the data's.
                _inflate_each(comp, offsets, lengths, out, block_flat,
                              metas, verify_crc)
                raise
            if bad is not None:
                at = int(block_flat[bad])
                raise crc_mismatch(
                    metas[bad].start, int(crcs[bad]),
                    zlib.crc32(out[at: at + int(usizes[bad])]))
            engine = "native"
        sp.set(engine=engine)
    obs.count("inflate.windows")
    obs.count("inflate.blocks", len(metas))
    obs.count("inflate.bytes", total)
    block_starts, block_flat = metas_block_table(metas)
    return FlatView(out, block_starts=block_starts, block_flat=block_flat)


def _inflate_each(comp, offsets, lengths, out: np.ndarray,
                  block_flat: np.ndarray, metas, verify_crc: bool) -> None:
    """Inflate a run block by block with zlib, in file order: the first
    damaged block raises its error (``_inflate_into``'s)."""
    for i, m in enumerate(metas):
        at = int(block_flat[i])
        _inflate_into(comp, int(offsets[i]), int(lengths[i]),
                      out[at: at + m.uncompressed_size], m.uncompressed_size,
                      m.start if verify_crc else None)


def flatten_file(path, threads: int = 8) -> FlatView:
    """Inflate a whole BAM into one flat buffer with its block tables (the
    whole-file load; small files)."""
    with obs.span("bgzf.read", kind="metadata_scan", path=str(path)):
        metas = blocks_metadata(path)
    with open_channel(path) as ch:
        view = inflate_blocks(ch, metas, threads)
    view.file_total = view.size
    view.at_eof = True
    return view


def metas_block_table(metas) -> tuple[np.ndarray, np.ndarray]:
    """``(block_starts, block_flat)``: each block's compressed offset and
    the flat (uncompressed) offset of its first byte, without inflating."""
    block_starts = np.array([m.start for m in metas], dtype=np.int64)
    usizes = np.array([m.uncompressed_size for m in metas], dtype=np.int64)
    block_flat = np.zeros(len(metas), dtype=np.int64)
    if len(metas):
        np.cumsum(usizes[:-1], out=block_flat[1:])
    return block_starts, block_flat


def pos_of_flat_tables(block_starts: np.ndarray, block_flat: np.ndarray,
                       flat: int) -> tuple[int, int]:
    """Flat offset → ``(block_pos, offset in the block)``: a position at a
    block boundary belongs to the block that starts there."""
    i = int(np.searchsorted(block_flat, flat, side="right")) - 1
    return int(block_starts[i]), int(flat - block_flat[i])
