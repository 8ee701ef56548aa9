"""The host ``full`` checker (reference ``spark_bam_tpu/check/full.py``,
full/Checker.scala:17-198): every check of a record, returning the first
bad record's failing ``Flags`` (with the records chained before it) or
``Success``. Its verdict is the eager one; the flags are diagnostic.

Order quirks kept from the reference (they change flags, not verdicts):
- a name length of 0 or 1 flags noReadName / emptyReadName and consumes
  no name bytes, so the cigar is read from the fixed fields' end — ref
  :81-86, :111;
- a name read cut by EOF flags tooFewBytesForReadName and no cigar flag
  — ref :140-144;
- invalidCigarOp suppresses the emptyMapped flags — ref :113-132, whose
  (emptySeq, emptyCigar) pair lands swapped in EmptyMapped's fields.
"""

from __future__ import annotations

import struct
from typing import Union

import numpy as np

from spark_bam_tpu_torch.bgzf.stream import (
    SeekableBlockStream,
    SeekableUncompressedBytes,
)
from spark_bam_tpu_torch.check.checker import name_char_allowed, register_checker
from spark_bam_tpu_torch.check.eager import _trunc_div2, _wrap32
from spark_bam_tpu_torch.check.flags import Flags, Success
from spark_bam_tpu_torch.core.channel import open_channel
from spark_bam_tpu_torch.core.pos import Pos

Result = Union[Success, Flags]


class FullChecker:
    def __init__(self, u: SeekableUncompressedBytes, lengths,
                 reads_to_check: int = 10):
        self.u = u
        self.lengths = [int(x) for x in np.asarray(lengths).tolist()]
        self.num_contigs = len(self.lengths)
        self.reads_to_check = reads_to_check

    @staticmethod
    def open(path, config=None) -> "FullChecker":
        from spark_bam_tpu_torch.bam.header import read_header
        from spark_bam_tpu_torch.core.config import Config

        config = config or Config()
        return FullChecker(
            SeekableUncompressedBytes(SeekableBlockStream(open_channel(path))),
            read_header(path).contig_lengths, config.reads_to_check)

    def __call__(self, pos: Pos) -> Result:
        self.u.seek(pos)
        return self._apply(self.u.tell(), 0)

    def _ref_pos_flags(self, ref_idx: int, ref_pos: int, next_: bool) -> dict:
        neg_idx = too_large_idx = neg_pos = too_large_pos = False
        if ref_idx < -1:
            neg_idx = True
            neg_pos = ref_pos < -1
        elif ref_idx >= self.num_contigs:
            too_large_idx = True
            neg_pos = ref_pos < -1
        elif ref_pos < -1:
            neg_pos = True
        elif ref_idx >= 0 and ref_pos > self.lengths[ref_idx]:
            too_large_pos = True
        prefix = "negativeNextRead" if next_ else "negativeRead"
        tprefix = "tooLargeNextRead" if next_ else "tooLargeRead"
        return {
            f"{prefix}Idx": neg_idx,
            f"{tprefix}Idx": too_large_idx,
            f"{prefix}Pos": neg_pos,
            f"{tprefix}Pos": too_large_pos,
        }

    def _apply(self, start: int, successes: int) -> Result:
        u = self.u
        while successes < self.reads_to_check:
            fixed = u.read(36)
            if len(fixed) < 36:
                if len(fixed) == 0 and u.tell() == start and successes > 0:
                    return Success(successes)
                return Flags(tooFewFixedBlockBytes=True,
                             readsBeforeError=successes)
            (remaining, ref_idx, ref_pos, name_len_i32, flags_n_cigar,
             seq_len, next_ref_idx, next_ref_pos, _tlen) = struct.unpack(
                "<9i", fixed)
            next_offset = start + 4 + remaining
            kw = self._ref_pos_flags(ref_idx, ref_pos, next_=False)
            kw.update(self._ref_pos_flags(next_ref_idx, next_ref_pos,
                                          next_=True))
            name_len = name_len_i32 & 0xFF
            flags = (flags_n_cigar >> 16) & 0xFFFF
            n_cigar = flags_n_cigar & 0xFFFF
            n_cigar_bytes = 4 * n_cigar
            n_seq_qual = _wrap32(_trunc_div2(_wrap32(seq_len + 1)) + seq_len)
            kw["tooFewRemainingBytesImplied"] = remaining < _wrap32(
                32 + name_len + n_cigar_bytes + n_seq_qual)

            name_failed_eof = False
            if name_len == 0:
                kw["noReadName"] = True
            elif name_len == 1:
                kw["emptyReadName"] = True
            else:
                name = u.read(name_len)
                if len(name) < name_len:
                    kw["tooFewBytesForReadName"] = True
                    name_failed_eof = True
                elif name[-1] != 0:
                    kw["nonNullTerminatedReadName"] = True
                elif any(not name_char_allowed(b) for b in name[:-1]):
                    kw["nonASCIIReadName"] = True

            if not name_failed_eof:
                cigar = u.read(n_cigar_bytes)
                # A bad op among the readable words wins over the EOF a
                # later word would meet (ref :113-119).
                if any(cigar[4 * k] & 0xF > 8 for k in range(len(cigar) // 4)):
                    kw["invalidCigarOp"] = True
                elif len(cigar) < n_cigar_bytes:
                    kw["tooFewBytesForCigarOps"] = True
                elif (flags & 4) == 0 and (seq_len == 0 or n_cigar == 0):
                    kw["emptyMappedCigar"] = seq_len == 0
                    kw["emptyMappedSeq"] = n_cigar == 0

            if any(kw.values()):
                return Flags(**kw, readsBeforeError=successes)
            if next_offset - u.tell() > 0:
                u.skip(next_offset - u.tell())
            start = next_offset
            successes += 1
        return Success(self.reads_to_check)

    def close(self) -> None:
        self.u.close()


@register_checker("full")
def _make_full(path, config, **kw):
    return FullChecker.open(path, config)
