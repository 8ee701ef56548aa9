"""The host ``eager`` checker (reference ``spark_bam_tpu/check/eager.py``,
eager/Checker.scala:18-177): the sequential oracle of the record-start
verdict. It short-circuits on the first failing check and chains
``reads_to_check`` consecutive records through a seekable stream.

Semantics kept from the reference:
- the name length is ``i32 & 0xff`` (its low byte only)           — ref :52
- zero bytes at the record edge after at least one success is a valid
  EOF                                                              — ref :36-39
- a reference position equal to the contig's length passes         — ref
  PosChecker.scala:59
- after a record with a negative sequence length the chain trusts
  ``nextOffset`` while reads go on from the physical cursor        — ref :116-125
"""

from __future__ import annotations

import struct

import numpy as np

from spark_bam_tpu_torch.bgzf.stream import (
    SeekableBlockStream,
    SeekableUncompressedBytes,
)
from spark_bam_tpu_torch.check.checker import (
    NoReadFoundException,
    name_char_allowed,
    register_checker,
)
from spark_bam_tpu_torch.core.channel import open_channel
from spark_bam_tpu_torch.core.pos import Pos


def _wrap32(x: int) -> int:
    x &= 0xFFFFFFFF
    return x - 0x100000000 if x >= 0x80000000 else x


def _trunc_div2(x: int) -> int:
    """Int division by 2 truncating toward zero, as on the JVM."""
    return -((-x) // 2) if x < 0 else x // 2


class EagerChecker:
    """``checker(pos)`` is the eager verdict at ``pos``; ``lengths`` are
    the contig lengths in index order."""

    def __init__(self, u: SeekableUncompressedBytes, lengths,
                 reads_to_check: int = 10):
        self.u = u
        self.lengths = [int(x) for x in np.asarray(lengths).tolist()]
        self.num_contigs = len(self.lengths)
        self.reads_to_check = reads_to_check

    @staticmethod
    def open(path, config=None, tolerant: bool = False) -> "EagerChecker":
        from spark_bam_tpu_torch.bam.header import read_header
        from spark_bam_tpu_torch.core.config import default_config

        config = config or default_config()
        return EagerChecker(
            SeekableUncompressedBytes(
                SeekableBlockStream(open_channel(path), tolerant=tolerant)),
            read_header(path).contig_lengths, config.reads_to_check)

    def __call__(self, pos: Pos) -> bool:
        self.u.seek(pos)
        return self._apply(self.u.tell(), 0)

    def _ref_pos_error(self, ref_idx: int, ref_pos: int) -> bool:
        return (ref_idx < -1 or ref_idx >= self.num_contigs or ref_pos < -1
                or (ref_idx >= 0 and ref_pos > self.lengths[ref_idx]))

    def _apply(self, start: int, successes: int) -> bool:
        u = self.u
        while successes < self.reads_to_check:
            fixed = u.read(36)
            if len(fixed) < 36:
                # Zero bytes exactly at the record edge, after at least
                # one chained success, is a valid EOF (ref :36-39).
                return (len(fixed) == 0 and u.tell() == start
                        and successes > 0)
            (remaining, ref_idx, ref_pos, name_len_i32, flags_n_cigar,
             seq_len, next_ref_idx, next_ref_pos, _tlen) = struct.unpack(
                "<9i", fixed)
            next_offset = start + 4 + remaining
            if self._ref_pos_error(ref_idx, ref_pos):
                return False
            name_len = name_len_i32 & 0xFF
            if name_len in (0, 1):
                return False
            flags = (flags_n_cigar >> 16) & 0xFFFF
            n_cigar = flags_n_cigar & 0xFFFF
            if (flags & 4) == 0 and (seq_len == 0 or n_cigar == 0):
                return False
            # int32-wrapping arithmetic with truncating division, as on
            # the JVM.
            n_seq_qual = _wrap32(_trunc_div2(_wrap32(seq_len + 1)) + seq_len)
            if remaining < _wrap32(32 + name_len + 4 * n_cigar + n_seq_qual):
                return False
            if self._ref_pos_error(next_ref_idx, next_ref_pos):
                return False
            name = u.read(name_len)
            if (len(name) < name_len or name[-1] != 0
                    or any(not name_char_allowed(b) for b in name[:-1])):
                return False
            cigar = u.read(4 * n_cigar)
            if len(cigar) < 4 * n_cigar or any(
                    cigar[4 * k] & 0xF > 8 for k in range(n_cigar)):
                return False
            if next_offset - u.tell() > 0:
                u.skip(next_offset - u.tell())
            start = next_offset
            successes += 1
        return True

    def next_read_start_with_delta(self, start: Pos,
                                   max_read_size: int = 10_000_000
                                   ) -> tuple[Pos, int] | None:
        """Advance byte by byte until a position passes (ref :128-162):
        ``(pos, bytes advanced)``, None at EOF without one; raises
        ``NoReadFoundException`` when the budget runs out mid-file."""
        u = self.u
        u.seek(start)
        for idx in range(max_read_size):
            pos = u.cur_pos()
            if pos is None:
                return None
            if self(pos):
                return pos, idx
            u.seek(pos)
            if not u.has_next():
                return None
            u.next_byte()
        raise NoReadFoundException("<stream>", start, max_read_size)

    def next_read_start(self, start: Pos, max_read_size: int = 10_000_000
                        ) -> Pos | None:
        found = self.next_read_start_with_delta(start, max_read_size)
        return found[0] if found else None

    def close(self) -> None:
        self.u.close()


@register_checker("eager")
def _make_eager(path, config, **kw):
    return EagerChecker.open(path, config)
