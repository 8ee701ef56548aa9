"""Split-boundary resolution on the device (reference ``load/api.py``:
``_resolve_split_start`` and ``_native_next_read_start``): the first record
start at or after a raw file split's first BGZF block.

``resolve_split_start`` takes the split that holds the header's end to
that end unchecked, finds the split's first block on the host
(``find_block_start``), and scans from there with ``next_read_start``:

- a run of blocks from that block is inflated with host zlib through
  ``SeekableBlockStream``, 128 KiB first, as the reference's scan reads;
- the run goes up to the device and ``check_window`` gives every offset
  its verdict, ``exact`` and ``escaped`` (``at_eof`` only when the run
  reached the file's end);
- from ``scan_from`` on, the first offset that passes exactly is the
  answer; an escaped offset before it (a chain the run's end cut) grows
  the run (at least doubling it) and resumes the scan exactly there, so a
  cut window never skips a true boundary;
- past ``SCAN_SLACK`` of lookahead behind an escaped offset, or at an
  offset that escapes at EOF (a chain cursor past the int32 range), the
  host engine (``check_flat``) resolves that one offset exactly over a
  run grown to its chain's reach or to EOF (counted in
  ``STATS.boundary_demotions``), where the reference hands the split to
  its Python checker; the scan then goes on past it on the device.

Offsets before ``max_read_size`` only are scanned: none that passes there
raises ``NoReadFoundException`` mid-file, and returns None at a clean EOF
(the trailing split owns no record start). There is no confirmation
pass: an offset ``check_window`` calls exact is exact by its contract.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from spark_bam_tpu_torch.bgzf.find_block_start import find_block_start
from spark_bam_tpu_torch.bgzf.stream import SeekableBlockStream
from spark_bam_tpu_torch.check.vectorized import check_flat
from spark_bam_tpu_torch.core.channel import open_channel
from spark_bam_tpu_torch.core.pos import Pos
from spark_bam_tpu_torch.device import resolve_device
from spark_bam_tpu_torch.tpu.checker import check_window
from spark_bam_tpu_torch.tpu.kernels import PAD
from spark_bam_tpu_torch.tpu.stream_check import pad_contig_lengths

#: Uncompressed bytes of the first run the scan checks.
FIRST_RUN = 128 << 10
#: Lookahead behind an escaped offset past which the host engine resolves
#: it (the reference's ``_NATIVE_SCAN_SLACK``).
SCAN_SLACK = 64 << 20


class NoReadFoundException(Exception):
    """The scan budget (``max_read_size``) ran out mid-file without a
    record start."""

    def __init__(self, path, start, max_read_size: int):
        super().__init__(
            f"Failed to find a valid read-start in {max_read_size} attempts"
            f" in {path} from {start}"
        )
        self.path = path
        self.start = start
        self.max_read_size = max_read_size


@dataclass
class BoundaryStats:
    """What the resolver did since the last ``reset``: boundaries scanned
    (``resolutions``, with each one's wall in ``ms``), ``check_window``
    calls (``windows``) and offsets the host engine resolved, past the
    growth bound or at EOF (``boundary_demotions``)."""

    resolutions: int = 0
    windows: int = 0
    boundary_demotions: int = 0
    ms: list = field(default_factory=list)

    def reset(self) -> None:
        self.resolutions = self.windows = self.boundary_demotions = 0
        self.ms = []


STATS = BoundaryStats()


class _Run:
    """Inflated blocks from one block start on, grown on demand."""

    def __init__(self, path, block_start: int):
        self.stream = SeekableBlockStream(open_channel(path))
        self.stream.seek(block_start)
        self.parts: list[np.ndarray] = []
        self.starts: list[int] = []
        self.flats: list[int] = []
        self.total = 0
        self.at_eof = False
        self._data = np.empty(0, dtype=np.uint8)

    def grow(self, upto: int) -> None:
        while self.total < upto and not self.at_eof:
            blk = self.stream.next_block()
            if blk is None:
                self.at_eof = True
                break
            data, start = blk
            self.starts.append(start)
            self.flats.append(self.total)
            self.parts.append(np.frombuffer(data, dtype=np.uint8))
            self.total += len(data)
        if len(self._data) != self.total:
            self._data = (np.concatenate(self.parts) if self.parts
                          else np.empty(0, dtype=np.uint8))

    @property
    def data(self) -> np.ndarray:
        return self._data

    def pos(self, off: int) -> Pos:
        i = int(np.searchsorted(self.flats, off, side="right")) - 1
        return Pos(self.starts[i], off - self.flats[i])

    def close(self) -> None:
        self.stream.close()


def _first_hit(run: _Run, lo: int, hi: int, lens, num_contigs: int,
               config, dev) -> tuple[int, bool] | None:
    """``(offset, escaped)`` of the first offset in [lo, hi) that passes
    exactly or escapes, by ``check_window`` over the whole run on ``dev``;
    None when every offset there certainly fails."""
    n = run.total
    w = max(FIRST_RUN, 1 << (n - 1).bit_length())
    padded = torch.zeros(w + PAD, dtype=torch.uint8, device=dev)
    padded[:n] = torch.from_numpy(run.data).to(dev)
    res = check_window(padded, lens, num_contigs, n, run.at_eof,
                       config.reads_to_check, funnel=config.funnel_enabled())
    STATS.windows += 1
    passed = (res["verdict"] & res["exact"])[lo:hi]
    escaped = res["escaped"][lo:hi]
    hit = (passed | escaped).to(torch.int32)
    j = torch.argmax(hit)
    found, first, esc = torch.stack(
        [hit[j].long(), j, escaped[j].long()]).tolist()
    return (lo + first, bool(esc)) if found else None


def _host_resolves(run: _Run, off: int, lengths: np.ndarray,
                   config) -> bool:
    """Exact verdict at ``off`` by the host engine, the run grown (at
    least doubled each time) until the chain no longer escapes or EOF."""
    while True:
        res = check_flat(run.data[off:], lengths,
                         candidates=np.zeros(1, dtype=np.int64),
                         at_eof=run.at_eof,
                         reads_to_check=config.reads_to_check)
        if run.at_eof or not res.escaped[0]:
            return bool(res.verdict[0])
        run.grow(2 * run.total)


def next_read_start(path, block_start: int, header, config,
                    device=None) -> Pos | None:
    """The first record start at or after ``Pos(block_start, 0)`` within
    ``config.max_read_size`` bytes, checked on ``device``; None at a clean
    EOF. Raises ``NoReadFoundException`` when the budget runs out
    mid-file."""
    dev = resolve_device(device)
    lengths = np.asarray(header.contig_lengths, dtype=np.int32)
    lens = torch.from_numpy(pad_contig_lengths(lengths)).to(dev)
    budget = config.max_read_size
    run = _Run(path, block_start)
    target = FIRST_RUN
    scan_from = 0   # every offset before it certainly fails
    try:
        while True:
            run.grow(target)
            if scan_from >= budget:
                raise NoReadFoundException(path, block_start, budget)
            hi = min(run.total, budget)
            hit = (_first_hit(run, scan_from, hi, lens, len(lengths), config,
                              dev) if hi > scan_from else None)
            if hit is not None:
                off, escaped = hit
                if not escaped:
                    return run.pos(off)
                scan_from = off
                if run.at_eof or run.total - off >= SCAN_SLACK:
                    # No more bytes to grow by (a chain whose cursor left
                    # the int32 range escapes even at EOF), or the growth
                    # bound: the host engine decides this offset.
                    STATS.boundary_demotions += 1
                    if _host_resolves(run, off, lengths, config):
                        return run.pos(off)
                    scan_from = off + 1
                    continue
                target = max(run.total * 2, off + (256 << 10))
                continue
            if run.at_eof:
                if budget >= run.total:
                    return None   # clean EOF: the split owns no start
                raise NoReadFoundException(path, block_start, budget)
            scan_from = max(scan_from, hi)
            target = max(run.total * 2, FIRST_RUN)
    finally:
        run.close()


def resolve_split_start(path, split, header, config, device=None
                        ) -> Pos | None:
    """find-block-start then find-record-start for one ``FileSplit``;
    None when the split owns no block (its first block lies at or past
    its end, or is the EOF sentinel) or no record start before EOF."""
    first = header.end_pos
    if split.start <= first.block_pos < split.end:
        # The first record begins exactly at the header's end.
        return first
    t0 = time.perf_counter()
    with open_channel(path) as ch:
        block_start = find_block_start(ch, split.start,
                                       config.bgzf_blocks_to_check,
                                       path=str(path))
    try:
        if block_start >= split.end:
            return None
        return next_read_start(path, block_start, header, config, device)
    finally:
        STATS.resolutions += 1
        STATS.ms.append((time.perf_counter() - t0) * 1e3)
