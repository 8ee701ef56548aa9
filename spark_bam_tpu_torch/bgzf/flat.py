"""Flat views of runs of BGZF blocks: raw payloads for the device
tokenizer, host-zlib inflation for the classic loop and the whole-file
load (``flatten_file``), and the block tables that map a flat offset to
``block:offset`` and back."""

from __future__ import annotations

import zlib
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np

from spark_bam_tpu_torch.bgzf.block import (
    FOOTER_SIZE,
    MAX_COMPRESSED_PAYLOAD,
    BgzfError,
    Metadata,
    parse_header,
)
from spark_bam_tpu_torch.bgzf.index_blocks import blocks_metadata
from spark_bam_tpu_torch.core.channel import open_channel


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


def stage_run_payloads(ch, metas: list[Metadata]):
    """``(staged (B_pad, C_pad) u8, clens (B_pad,) i32)``: one zero-padded
    row per block for the device tokenizer. Both dims are powers of two;
    ``C_pad`` ≥ the longest payload + 8 so the kernel's 4-byte bit reads
    never leave a row, and ≥ 1024. Pad rows have ``clen == 0``."""
    comp, offsets, lengths = read_run_payloads(ch, metas)
    b = len(metas)
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


def _inflate_into(comp, off: int, clen: int, out: np.ndarray, usize: int):
    data = zlib.decompress(bytes(comp[off: off + clen]), wbits=-15,
                           bufsize=max(usize, 1))
    if len(data) != usize:
        raise BgzfError(
            f"Expected {usize} decompressed bytes, found {len(data)}"
        )
    out[:] = np.frombuffer(data, dtype=np.uint8)


def inflate_blocks(ch, metas: list[Metadata], threads: int = 8) -> FlatView:
    """Inflate a run of blocks with host zlib (raw ``-15`` windows) across
    a thread pool; zlib releases the GIL."""
    comp, offsets, lengths = read_run_payloads(ch, metas)
    usizes = [m.uncompressed_size for m in metas]
    flat = np.concatenate([[0], np.cumsum(usizes)]).astype(np.int64)
    out = np.empty(int(flat[-1]), dtype=np.uint8)
    jobs = [
        (comp, int(offsets[i]), int(lengths[i]),
         out[flat[i]: flat[i + 1]], usizes[i])
        for i in range(len(metas))
    ]
    if threads > 1 and len(jobs) > 1:
        with ThreadPoolExecutor(max_workers=threads) as pool:
            list(pool.map(lambda j: _inflate_into(*j), jobs))
    else:
        for j in jobs:
            _inflate_into(*j)
    block_starts, block_flat = metas_block_table(metas)
    return FlatView(out, block_starts=block_starts, block_flat=block_flat)


def flatten_file(path, threads: int = 8) -> FlatView:
    """Inflate a whole BAM into one flat buffer with its block tables (the
    whole-file load; small files)."""
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
