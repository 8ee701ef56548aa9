"""Whole-file streaming count (reference ``spark_bam_tpu/tpu/
stream_check.py``): the count-reads path.

Each kernel buffer is ``carry + window``, where the carry is the previous
buffer's trailing ``halo`` bytes, so every owned position has at least
``halo`` bytes of lookahead for its chain. A non-final buffer owns all but
its halo tail; the final one owns through EOF; ``lo`` keeps the BAM header
out of the owned span.

Two loops count, with the same pacing (``ring_depth`` windows un-synced),
flushes (``flush_every`` windows between device→host transfers) and escape
checkpoints (window 4, then every flush):

- ``_count_reads_fused`` (the default): worker threads stage each window
  group's raw BGZF payloads on the device, and ``checker.count_window_raw``
  tokenizes, resolves, assembles and counts there; the halo carry stays on
  the device. A window whose tokenizer verdict (``tok_ok``) is False demotes
  the whole count to the classic loop, counted in ``tokenize_demotions``.
- the classic loop in ``count_reads``: host zlib inflates, and each padded
  window goes to the device for ``checker.count_window``.

Escapes (chains longer than the halo) are resolved by the reference with a
deferral path that is not ported yet; here they raise ``CountEscaped``
rather than return a guessed count.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from spark_bam_tpu_torch.bam.header import read_header
from spark_bam_tpu_torch.bgzf.block import BgzfError
from spark_bam_tpu_torch.core.channel import open_channel
from spark_bam_tpu_torch.core.config import Config
from spark_bam_tpu_torch.device import resolve_device
from spark_bam_tpu_torch.tpu.checker import PAD, count_window, count_window_raw
from spark_bam_tpu_torch.tpu.inflate import InflatePipeline, stage_group_device


class CountEscaped(RuntimeError):
    """Owned positions escaped (their chains outran the halo); the exact
    deferral path that resolves them is not ported yet. ``base`` is the flat
    offset of the first window of the flush interval that counted them."""

    def __init__(self, base: int, esc_count: int):
        super().__init__(
            f"{esc_count} owned position(s) escaped in the flush interval "
            f"starting at flat offset {base}: chains outran the halo, and "
            "the deferral path that resolves them is not ported yet"
        )
        self.base = base
        self.esc_count = esc_count


def _next_pow2(n: int) -> int:
    return 1 << max(0, (max(n, 1) - 1).bit_length())


def _largest_window(groups, halo: int) -> int:
    """The most bytes any window holds: its carry (the previous window's
    unowned tail, at most ``halo``) plus its group's uncompressed bytes."""
    largest = carry = 0
    for g in groups:
        n = carry + sum(m.uncompressed_size for m in g)
        largest = max(largest, n)
        carry = min(halo, n)
    return largest


def pad_contig_lengths(lengths: np.ndarray, cmax: int = 1024) -> np.ndarray:
    """Contig lengths zero-padded to the kernels' static table width."""
    lens = np.zeros(max(cmax, len(lengths)), dtype=np.int32)
    lens[: len(lengths)] = lengths
    return lens


def halo_windows(pipeline, halo: int, header_end: int):
    """``(buf, base, own_end, lo, at_eof)`` rows with the halo-carry
    ownership discipline."""
    carry = np.empty(0, dtype=np.uint8)
    base_next = 0
    for view in pipeline:
        base = base_next
        buf = np.concatenate([carry, view.data]) if len(carry) else view.data
        n = len(buf)
        own_end = n if view.at_eof else max(n - halo, 0)
        lo = min(max(header_end - base, 0), own_end)
        yield buf, base, own_end, lo, view.at_eof
        carry = buf[own_end:]
        base_next = base + own_end


class _Ring:
    """Completion markers of queued windows: ``wait_oldest`` blocks until
    the oldest window's work is done, without a transfer."""

    def __init__(self, device: torch.device):
        self.device = device
        self.events: list = []

    def push(self) -> None:
        if self.device.type == "cuda":
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(self.device))
            self.events.append(ev)
        else:
            self.events.append(None)

    def __len__(self) -> int:
        return len(self.events)

    def wait_oldest(self) -> None:
        ev = self.events.pop(0)
        if ev is not None:
            ev.synchronize()


class StreamChecker:
    """Whole-file streaming count over a fixed kernel window.

    ``device=None`` runs on the current CUDA device and raises without one;
    ``device="cpu"`` runs every kernel's plain version."""

    def __init__(
        self,
        path,
        config: Config = Config(),
        window_uncompressed: int | None = None,
        halo: int | None = None,
        device=None,
    ):
        self.device = resolve_device(device)
        self.path = path
        self.config = config
        header = read_header(path)
        self.lengths = header.contig_lengths
        fresh = window_uncompressed or config.window_size
        halo = config.halo_size if halo is None else halo
        # The halo must leave room to advance; longer chains escape.
        self.halo = min(halo, fresh // 2)
        self.pipeline = InflatePipeline(path, fresh)
        self.total = self.pipeline.total
        # One power of two covering carry + window, clamped to the file so
        # small inputs run a small window, and never smaller than the
        # largest buffer a window assembles, so both loops serve every file.
        self.kernel_window = _next_pow2(max(
            min(fresh + self.halo, max(self.total, 1 << 16)),
            _largest_window(self.pipeline.groups, self.halo),
        ))
        # The header's uncompressed size is the flat offset of record 0.
        self.header_end_abs = header.uncompressed_size
        self.flush_every = config.flush_every_for(self.kernel_window)
        self.ring_depth = max(1, config.ring_depth)
        self.funnel_stats: dict | None = None
        self.tokenize_demotions = 0

    def _lengths_dev(self):
        lens = torch.from_numpy(pad_contig_lengths(self.lengths))
        return lens.to(self.device), len(self.lengths)

    def _funnel_add(self, screened: int, survivors: int) -> None:
        if self.funnel_stats is None:
            self.funnel_stats = {"screened": 0, "survivors": 0}
        self.funnel_stats["screened"] += screened
        self.funnel_stats["survivors"] += survivors

    def count_reads(self) -> int:
        """Record count: the fused device loop unless configured off or
        demoted, else the classic host-zlib loop. ``fused_count=None``
        follows ``device_inflate``, whose ``None`` means on."""
        fused = self.config.fused_count
        if fused is None:
            fused = self.config.device_inflate is not False
        if fused:
            res = self._count_reads_fused()
            if res is not None:
                return res
        return self._count_reads_classic()

    def _count_reads_classic(self) -> int:
        lens_dev, nc = self._lengths_dev()
        w = self.kernel_window
        acc = _Accumulator(self)
        ring = _Ring(self.device)
        for buf, base, own_end, lo, at_eof in halo_windows(
            self.pipeline, self.halo, self.header_end_abs
        ):
            padded = np.zeros(w + PAD, dtype=np.uint8)
            padded[: len(buf)] = buf
            out = count_window(
                torch.from_numpy(padded).to(self.device), lens_dev, nc,
                len(buf), at_eof, lo, own_end, self.config.reads_to_check,
            )
            ring.push()
            if len(ring) > self.ring_depth:
                ring.wait_oldest()
            if acc.add(out, base, len(buf)):
                break
        return acc.finish()

    def _count_reads_fused(self) -> int | None:
        """The device-resident loop; None demotes to the classic loop (a
        payload the staging refuses, or a tokenizer verdict of False), and
        every demotion is counted in ``tokenize_demotions``."""
        groups = self.pipeline.groups
        if not groups:
            return 0
        w, halo = self.kernel_window, self.halo
        lens_dev, nc = self._lengths_dev()
        acc = _Accumulator(self)
        ring = _Ring(self.device)
        ok_ring: list = []
        carry = torch.zeros(halo, dtype=torch.uint8, device=self.device)
        carry_len = 0
        base = 0
        demoted = False
        depth = self.pipeline.depth
        ch = open_channel(self.path)
        pool = ThreadPoolExecutor(max_workers=depth)
        try:
            pending = [pool.submit(stage_group_device, ch, g, self.device)
                       for g in groups[:depth]]
            for gi in range(len(groups)):
                try:
                    staged, clens, usizes = pending.pop(0).result()
                except (BgzfError, EOFError):
                    demoted = True
                    break
                if gi + depth < len(groups):
                    pending.append(pool.submit(
                        stage_group_device, ch, groups[gi + depth],
                        self.device))
                n = carry_len + int(usizes.sum())
                at_eof = gi == len(groups) - 1
                own_end = n if at_eof else max(n - halo, 0)
                lo = min(max(self.header_end_abs - base, 0), own_end)
                exp = np.zeros(staged.shape[0], dtype=np.int32)
                exp[: len(usizes)] = usizes
                out = count_window_raw(
                    staged, clens, torch.from_numpy(exp).to(self.device),
                    carry, lens_dev, nc, carry_len, n, at_eof, lo, own_end,
                    window=w, halo=halo,
                    reads_to_check=self.config.reads_to_check,
                )
                ok_ring.append(out["tok_ok"])
                carry = out["carry"]
                carry_len = n - own_end
                ring.push()
                if len(ring) > self.ring_depth:
                    ring.wait_oldest()
                    # A rejected row anywhere demotes the whole count; the
                    # classic loop restarts from the first window.
                    if not bool(ok_ring.pop(0)):
                        demoted = True
                        break
                stop = acc.add(out, base, n)
                base += own_end
                if stop:
                    break
        finally:
            pool.shutdown(wait=True, cancel_futures=True)
            ch.close()
        if not demoted and not all(bool(ok) for ok in ok_ring):
            demoted = True
        if demoted:
            self.tokenize_demotions += 1
            return None
        return acc.finish()


class _Accumulator:
    """Per-window device scalars summed on the device and flushed to host
    ints every ``flush_every`` windows, with the escape checkpoints."""

    def __init__(self, checker: StreamChecker):
        self.checker = checker
        self.total = 0
        self.dev_total = self.dev_esc = self.dev_surv = None
        self.windows = self.chunk = self.screened = 0
        self.chunk_base = 0
        self.escaped: CountEscaped | None = None

    def add(self, out: dict, base: int, screened: int) -> bool:
        """Fold one window in; True when an escape ends the count."""
        if self.dev_total is None:
            self.chunk_base = base
            self.dev_total, self.dev_esc, self.dev_surv = (
                out["count"], out["esc_count"], out["survivors"])
        else:
            self.dev_total = self.dev_total + out["count"]
            self.dev_esc = self.dev_esc + out["esc_count"]
            self.dev_surv = self.dev_surv + out["survivors"]
        self.screened += screened
        self.windows += 1
        self.chunk += 1
        # One early escape checkpoint at window 4, then one per flush.
        if self.windows == 4 and self._check_escape():
            return True
        if self.chunk >= self.checker.flush_every:
            if self._check_escape():
                return True
            self._flush()
        return False

    def _check_escape(self) -> bool:
        esc = int(self.dev_esc)
        if esc:
            self.escaped = CountEscaped(self.chunk_base, esc)
        return bool(esc)

    def _flush(self) -> None:
        self.total += int(self.dev_total)
        self.checker._funnel_add(self.screened, int(self.dev_surv))
        self.dev_total = self.dev_esc = self.dev_surv = None
        self.chunk = self.screened = 0

    def finish(self) -> int:
        if self.escaped is None and self.dev_total is not None:
            if not self._check_escape():
                self._flush()
        if self.escaped is not None:
            raise self.escaped
        return self.total
