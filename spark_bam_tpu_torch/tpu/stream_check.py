"""Whole-file streaming check (reference ``spark_bam_tpu/tpu/
stream_check.py``): the count-reads, full-check and load paths.

Each kernel buffer is ``carry + window``, where the carry is the previous
buffer's trailing ``halo`` bytes, so every owned position has at least
``halo`` bytes of lookahead for its chain. A non-final buffer owns all but
its halo tail; the final one owns through EOF; ``lo`` keeps the BAM header
out of the owned span.

Windows are inflated on the device unless ``Config.device_inflate`` is
False: worker threads stage each window group's raw BGZF payloads there,
and the ``tokenize`` and ``lz77_resolve`` kernels inflate it behind a halo
carry that stays on the device. Under ``Config.inflate`` ``tokenize=host``
the worker threads run the entropy phase instead (the host tokenizer,
packed planes in pinned buffers) and only ``lz77_resolve`` runs on the
device. With ``device_inflate=False`` host zlib inflates each window and
it is copied to the device.

Two loops count, with the same pacing (``ring_depth`` windows un-synced),
flushes (``flush_every`` windows between device→host transfers) and escape
checkpoints (window 4, then every flush):

- ``_count_reads_fused`` (the default): ``checker.count_window_raw``
  (``count_window_tokens`` under ``tokenize=host``) inflates and counts
  each window on the device. A window whose tokenizer verdict (``tok_ok``)
  is False, or a group the host tokenizer refuses, demotes the whole count
  to the classic loop, counted in ``tokenize_demotions``.
- the classic loop in ``count_reads``: host zlib inflates, and each padded
  window goes to the device for ``checker.count_window``.

``count_reads_resident`` (``Config.resident_scan``) packs host-zlib
windows into resident chunks and counts each chunk with one dispatch of
``checker.make_count_scan``'s counter: on a CUDA device one CUDA graph
replay of the chunk's window bodies.

``spans()`` and ``full_spans()`` run ``check_window`` on each window, one
window in flight; there a refused group or a tokenizer verdict of False
demotes that window alone to host zlib (also counted).

Positions whose chains outrun the halo *escape*. A count that saw an
escape re-runs the file through ``spans()``, which is exact: escaped owned
positions (and, for the flag projection ``full_spans()``, inexact ones) are
deferred into a side buffer of raw bytes that grows until their chains can
complete, then resolve with the host engine (``check/vectorized.py``).

The span contract: ``spans()`` yields ``(base, verdict)`` pairs whose True
positions are exactly the record starts of the file. Window spans tile
``[0, total)`` in order; a deferred position is False in its covering span
and is re-emitted later in a span whose ``base`` lies strictly behind the
tiling frontier. ``full_spans()`` yields ``(base, fail_mask,
reads_before)`` under the same contract, from the full pass.

``read_batches()`` turns the verdict spans into columnar ``ReadBatch``es:
each window's record starts parse on the device window the check ran on
(kept by the launcher, never written after it is assembled), and starts
whose records outrun the window, or whose verdicts came through the
deferral path, decode exactly from a seekable host stream.
``ordered_read_batches()`` gives the same records with each row's flat
offset and a floor below which no later row comes, for the export's
merge into file order.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from spark_bam_tpu_torch import obs
from spark_bam_tpu_torch.bam.header import read_header
from spark_bam_tpu_torch.bgzf.block import BgzfError
from spark_bam_tpu_torch.bgzf.flat import (
    inflate_blocks,
    metas_block_table,
    pos_of_flat_tables,
)
from spark_bam_tpu_torch.bgzf.stream import (
    SeekableBlockStream,
    SeekableUncompressedBytes,
)
from spark_bam_tpu_torch.check.flags import (
    FLAG_NAMES,
    bit_counts,
    considered_mask,
    num_failing_fields,
)
from spark_bam_tpu_torch.check.vectorized import check_flat
from spark_bam_tpu_torch.core.channel import open_channel
from spark_bam_tpu_torch.core.config import Config
from spark_bam_tpu_torch.core.pos import Pos
from spark_bam_tpu_torch.device import resolve_device
from spark_bam_tpu_torch.tpu.checker import (
    PAD,
    check_window,
    count_window,
    count_window_raw,
    count_window_tokens,
    inflate_window_raw,
    inflate_window_tokens,
    make_count_scan,
    next_carry,
)
from spark_bam_tpu_torch.tpu.inflate import (
    InflatePipeline,
    PackedGroup,
    PackedStaging,
    TokenizeError,
    stage_group_device,
    tokenize_group,
)
from spark_bam_tpu_torch.tpu.parser import parse_flat_records, parse_window


#: Spill positions ``read_batches`` gathers before it decodes them.
SPILL_FLUSH = 4096


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


class _Staging:
    """A host buffer of resident chunk rows at ``stride`` and their (4,
    rows) int32 table of ``n``, ``at_eof``, ``lo`` and ``own``: pinned on
    a CUDA device, where ``mark`` records an event after the copies out of
    it and ``pack`` waits for it before writing again. Bytes past each
    row's ``n`` are zeroed, as the check requires."""

    def __init__(self, rows: int, stride: int, device: torch.device):
        pin = device.type == "cuda"
        self.device = device
        self.stride = stride
        self.chunk = torch.zeros(rows * stride, dtype=torch.uint8,
                                 pin_memory=pin)
        self.table = torch.zeros((4, rows), dtype=torch.int32,
                                 pin_memory=pin)
        self.done = None

    def pack(self, rows) -> None:
        if self.done is not None:
            self.done.synchronize()
        data = self.chunk.numpy()
        table = self.table.numpy()
        for j, (buf, at_eof, lo, own) in enumerate(rows):
            at = j * self.stride
            n = len(buf)
            data[at: at + n] = buf
            data[at + n: at + self.stride] = 0
            table[:, j] = (n, at_eof, lo, own)

    def mark(self) -> None:
        if self.device.type == "cuda":
            self.done = torch.cuda.Event()
            self.done.record(torch.cuda.current_stream(self.device))


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
    """Whole-file streaming checker over a fixed kernel window.

    ``device=None`` runs on the current CUDA device and raises without one;
    ``device="cpu"`` runs every kernel's plain version. ``metas`` reuses a
    block scan (``blocks_metadata``) the caller already made."""

    def __init__(
        self,
        path,
        config: Config = Config(),
        window_uncompressed: int | None = None,
        halo: int | None = None,
        device=None,
        metas=None,
    ):
        self.device = resolve_device(device)
        self.path = path
        self.config = config
        self.header = header = read_header(path)
        self.lengths = header.contig_lengths
        fresh = window_uncompressed or config.window_size
        halo = config.halo_size if halo is None else halo
        # The halo must leave room to advance; longer chains escape.
        self.halo = min(halo, fresh // 2)
        self.pipeline = InflatePipeline(path, fresh, metas)
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
        #: The resident count's chunk counter, kept for later counts.
        self.scan_runner = None

    def _device_inflate(self) -> bool:
        """``Config.device_inflate``, whose ``None`` means on."""
        return self.config.device_inflate is not False

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
        follows ``device_inflate``, whose ``None`` means on. Either loop
        re-runs the file through the exact ``spans()`` path when an owned
        position escaped (chains longer than the halo)."""
        fused = self.config.fused_count
        if fused is None:
            fused = self._device_inflate()
        if fused:
            res = self._count_reads_fused()
            if res is not None:
                return res
        return self._count_reads_classic()

    def resident_chunk_rows(self) -> int:
        """The most window rows a resident chunk holds: its bytes at stride
        ``kernel_window + PAD`` are ``Config.resident_chunk_bytes`` clamped
        to at most 1 GiB (int32 row offsets and per-chunk sums) and at least
        one row, floored to a power of two of rows."""
        stride = self.kernel_window + PAD
        cap_bytes = min(1 << 30, max(self.config.resident_chunk_bytes,
                                     stride))
        return 1 << ((cap_bytes // stride).bit_length() - 1)

    def count_reads_resident(self, chunk_windows: int | None = None,
                             first_chunk_windows: int = 4) -> int:
        """Record count with one device dispatch per resident chunk
        (reference ``StreamChecker.count_reads_resident``).

        Host-zlib windows (``halo_windows``) are packed into chunks of rows
        at stride ``kernel_window + PAD`` (zeros past each row's bytes), and
        ``checker.make_count_scan``'s counter counts each chunk at once: on
        a CUDA device one CUDA graph replay of the chunk's window bodies
        (``CountScanGraphs``), on the CPU the plain loop. A chunk holds at
        most ``resident_chunk_rows()`` rows and at most ``chunk_windows``;
        the first holds ``first_chunk_windows`` (within the same bound) and
        is read back at once, so escape-prone inputs abort early, then
        results are read one chunk behind (at most two chunks in flight).
        On the device rows go through two pinned staging buffers, each
        reused once the copy out of it has run.

        Any escaped owned position re-runs the file through the exact
        ``spans()`` path; a window larger than the kernel window (which
        ``_largest_window`` rules out) goes to ``count_reads``."""
        w = self.kernel_window
        stride = w + PAD
        max_windows = self.resident_chunk_rows()
        chunk_windows = max_windows if chunk_windows is None else max(
            1, min(chunk_windows, max_windows))
        first = max(1, min(first_chunk_windows, max_windows))
        funnel = self.config.funnel_enabled()
        if self.scan_runner is None:
            self.scan_runner = make_count_scan(
                w, self.config.reads_to_check, funnel, self.device)
        runner = self.scan_runner
        lens_dev, nc = self._lengths_dev()
        rows_max = max(first, chunk_windows)
        slots = [_Staging(rows_max, stride, self.device)
                 for _ in range(2 if self.device.type == "cuda" else 1)]
        total = 0
        pend: list = []
        chunks = 0

        def flush(rows):
            st = slots[chunks % len(slots)]
            st.pack(rows)
            k = len(rows)
            m = st.table
            out = runner(st.chunk, lens_dev, nc, np.arange(k) * stride,
                         m[0, :k], m[1, :k], m[2, :k], m[3, :k])
            st.mark()
            return out, sum(len(r[0]) for r in rows)

        def fold(p) -> bool:
            """Add one chunk's sums; True when it escaped."""
            nonlocal total
            out, screened = p
            if int(out["esc_count"]):
                return True
            total += int(out["count"])
            if funnel:
                self._funnel_add(screened, int(out["survivors"]))
            return False

        escaped = False
        rows: list = []
        cap = first
        gen = halo_windows(self.pipeline, self.halo, self.header_end_abs)
        try:
            for buf, _base, own_end, lo, at_eof in gen:
                if len(buf) > w:
                    return self.count_reads()
                rows.append((buf, at_eof, lo, own_end))
                if len(rows) >= cap:
                    pend.append(flush(rows))
                    rows = []
                    chunks += 1
                    cap = chunk_windows
                    # The first chunk at once, then one chunk behind.
                    if chunks == 1 or len(pend) > 1:
                        if fold(pend.pop(0)):
                            escaped = True
                            break
        finally:
            gen.close()
        if not escaped:
            if rows:
                pend.append(flush(rows))
            escaped = any(fold(p) for p in pend)
        return self._count_via_spans() if escaped else total

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
                self.config.funnel_enabled(),
            )
            ring.push()
            if len(ring) > self.ring_depth:
                ring.wait_oldest()
            if acc.add(out, len(buf)):
                break
        return self._finish(acc)

    def _finish(self, acc: "_Accumulator") -> int:
        total = acc.finish()
        return self._count_via_spans() if total is None else total

    def _producer(self, ch):
        """The worker-thread half of the device inflate of one group and
        the errors that refuse a group: ``tokenize_group`` into pinned
        staging slots under ``Config.inflate`` ``tokenize=host``, else
        ``stage_group_device``."""
        if self.config.inflate_config.resolve_tokenize() == "host":
            staging = (PackedStaging(self.device, self.pipeline.depth + 1)
                       if self.device.type == "cuda" else None)
            threads = self.pipeline.threads

            def produce(group):
                return tokenize_group(ch, group, staging, threads)

            return produce, (BgzfError, EOFError, TokenizeError)

        def stage(group):
            return stage_group_device(ch, group, self.device)

        return stage, (BgzfError, EOFError)

    def _count_reads_fused(self) -> int | None:
        """The device-resident loop; None demotes to the classic loop (a
        payload the staging or the host tokenizer refuses, or a device
        tokenizer verdict of False), and every demotion is counted in
        ``tokenize_demotions``. Under ``tokenize=host`` worker threads
        tokenize and pack ``pipeline.depth`` groups ahead and each window
        is one packed copy and ``count_window_tokens``."""
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
        produce, refusals = self._producer(ch)
        kw = dict(window=w, halo=halo,
                  reads_to_check=self.config.reads_to_check,
                  funnel=self.config.funnel_enabled())
        pool = ThreadPoolExecutor(max_workers=depth)
        try:
            pending = [pool.submit(produce, g) for g in groups[:depth]]
            for gi in range(len(groups)):
                try:
                    item = pending.pop(0).result()
                except refusals:
                    demoted = True
                    break
                if gi + depth < len(groups):
                    pending.append(pool.submit(produce, groups[gi + depth]))
                n = carry_len + sum(m.uncompressed_size for m in groups[gi])
                at_eof = gi == len(groups) - 1
                own_end = n if at_eof else max(n - halo, 0)
                lo = min(max(self.header_end_abs - base, 0), own_end)
                if isinstance(item, PackedGroup):
                    out = count_window_tokens(
                        item.to_device(self.device),
                        torch.from_numpy(item.out_lens).to(self.device),
                        carry, lens_dev, nc, carry_len, n, at_eof, lo,
                        own_end, **kw)
                else:
                    staged, clens, usizes = item
                    exp = np.zeros(staged.shape[0], dtype=np.int32)
                    exp[: len(usizes)] = usizes
                    out = count_window_raw(
                        staged, clens, torch.from_numpy(exp).to(self.device),
                        carry, lens_dev, nc, carry_len, n, at_eof, lo,
                        own_end, **kw)
                    ok_ring.append(out["tok_ok"])
                carry = out["carry"]
                carry_len = n - own_end
                ring.push()
                if len(ring) > self.ring_depth:
                    ring.wait_oldest()
                    # A rejected row anywhere demotes the whole count; the
                    # classic loop restarts from the first window.
                    if ok_ring and not bool(ok_ring.pop(0)):
                        demoted = True
                        break
                stop = acc.add(out, n)
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
            obs.count("inflate.tokenize_demotions")
            return None
        return self._finish(acc)

    # ---------------------------------------------------- the window loop
    def _host_windows(self):
        """``(padded, n, base, own_end, at_eof, buf)`` per window from the
        host-zlib pipeline (``device_inflate=False``): the window goes to
        the device, and ``buf`` keeps its bytes on the host."""
        w = self.kernel_window
        for buf, base, own_end, _lo, at_eof in halo_windows(
            self.pipeline, self.halo, self.header_end_abs
        ):
            padded = torch.zeros(w + PAD, dtype=torch.uint8,
                                 device=self.device)
            padded[: len(buf)] = torch.from_numpy(buf)
            yield padded, len(buf), base, own_end, at_eof, buf

    def _device_windows(self):
        """``(padded, n, base, own_end, at_eof, None)`` per window, inflated
        on the device behind the halo carry, which stays there: worker
        threads stage each group's raw payloads on the device and
        ``inflate_window_raw`` tokenizes, resolves and assembles it, or,
        under ``tokenize=host``, tokenize and pack it on the host and
        ``inflate_window_tokens`` resolves and assembles the packed planes.
        A group the staging or the host tokenizer refuses, or whose device
        tokenizer verdict is False, demotes that window alone to host zlib
        (as the reference's pipeline does), counted in
        ``tokenize_demotions``."""
        groups = self.pipeline.groups
        w, halo = self.kernel_window, self.halo
        carry = torch.zeros(halo, dtype=torch.uint8, device=self.device)
        carry_len = base = 0
        depth = self.pipeline.depth
        ch = open_channel(self.path)
        produce, refusals = self._producer(ch)
        pool = ThreadPoolExecutor(max_workers=depth)

        def stage(group):
            try:
                return produce(group)
            except refusals:
                return None

        try:
            pending = [pool.submit(stage, g) for g in groups[:depth]]
            for gi, group in enumerate(groups):
                staged = pending.pop(0).result()
                if gi + depth < len(groups):
                    pending.append(pool.submit(stage, groups[gi + depth]))
                n = carry_len + sum(m.uncompressed_size for m in group)
                padded = None
                if isinstance(staged, PackedGroup):
                    padded, _ = inflate_window_tokens(
                        staged.to_device(self.device),
                        torch.from_numpy(staged.out_lens).to(self.device),
                        carry, carry_len, n, window=w, halo=halo)
                elif staged is not None:
                    rows, clens, usizes = staged
                    exp = np.zeros(rows.shape[0], dtype=np.int32)
                    exp[: len(usizes)] = usizes
                    padded, _, tok_ok = inflate_window_raw(
                        rows, clens, torch.from_numpy(exp).to(self.device),
                        carry, carry_len, n, window=w, halo=halo)
                    if not bool(tok_ok):
                        padded = None
                if padded is None:
                    self.tokenize_demotions += 1
                    obs.count("inflate.tokenize_demotions")
                    data = inflate_blocks(ch, group,
                                          self.pipeline.threads).data
                    padded = torch.zeros(w + PAD, dtype=torch.uint8,
                                         device=self.device)
                    padded[:carry_len] = carry[:carry_len]
                    padded[carry_len:n] = torch.from_numpy(data).to(
                        self.device)
                at_eof = gi == len(groups) - 1
                own_end = n if at_eof else max(n - halo, 0)
                yield padded, n, base, own_end, at_eof, None
                carry = next_carry(padded, own_end, halo)
                carry_len = n - own_end
                base += own_end
        finally:
            pool.shutdown(wait=True, cancel_futures=True)
            ch.close()

    def _windows(self, launch):
        """``(base, own_end, at_eof, launched)`` one window behind the
        device: window k + 1 is launched before window k is yielded, so the
        consumer's host work overlaps the device's. Windows are inflated on
        the device unless ``device_inflate`` is False."""
        source = (self._device_windows() if self._device_inflate()
                  else self._host_windows())
        prev = None
        for padded, n, base, own_end, at_eof, buf in source:
            out = launch(padded, n, at_eof, buf)
            if prev is not None:
                yield prev
            prev = (base, own_end, at_eof, out)
        if prev is not None:
            yield prev

    def _launcher(self, keys: tuple[str, ...], full_masks: bool = False):
        """One window's launch: ``check_window`` on the device window (the
        full pass when ``full_masks``, else as configured), and the outputs
        named in ``keys``, plus the window's bytes when the host does not
        hold them, copied to pinned host memory without waiting, behind a
        CUDA event. The device window itself stays in the output, for work
        that reads it after the check (the load's parse)."""
        lens_dev, nc = self._lengths_dev()
        funnel = self.config.funnel_enabled(full_masks)
        cuda = self.device.type == "cuda"

        def launch(padded, n, at_eof, buf):
            res = check_window(padded, lens_dev, nc, n, at_eof,
                               self.config.reads_to_check, funnel)
            res = {k: res[k] for k in keys}
            if buf is None:
                res["window"] = padded[:n]
            if not cuda:
                return res, buf, None, padded
            host = {}
            for k, v in res.items():
                host[k] = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
                host[k].copy_(v, non_blocking=True)
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(self.device))
            return host, buf, done, padded

        return launch

    @staticmethod
    def _materialize(out) -> dict:
        """One launched window's outputs, and its bytes as ``window``, as
        host arrays; the device window stays a tensor (``padded``), whose
        bytes are complete once this returns."""
        host, buf, done, padded = out
        if done is not None:
            done.synchronize()
        res = {k: v.numpy() for k, v in host.items()}
        if buf is not None:
            res["window"] = buf
        res["padded"] = padded
        return res

    # ------------------------------------------------ deferred candidates
    class _Deferred:
        """Escaped (or inexact) owned positions and the byte stream that
        will resolve them. ``buf`` holds the raw bytes from ``base`` (the
        earliest pending position) through the newest window's end; it
        grows as windows arrive and is trimmed as pendings resolve. Every
        operation is vectorized over the pending set."""

        def __init__(self, lengths: np.ndarray, reads_to_check: int):
            self.lengths = lengths
            self.rtc = reads_to_check
            self.pending = np.empty(0, dtype=np.int64)
            self.base = 0
            self.buf = np.empty(0, dtype=np.uint8)
            # Stream tip at the last attempt: a re-check reruns the flag
            # pass over the whole retained span, so attempts wait for real
            # growth.
            self._gate_tip = 0
            # The first run ``resolve`` retired but has not yielded yet.
            self._unemitted: int | None = None

        def __len__(self):
            return len(self.pending)

        def low(self) -> int | None:
            """The lowest position still to come out of ``resolve``:
            pending, or resolved in a run not yet yielded."""
            lows = [int(self.pending.min())] if len(self.pending) else []
            if self._unemitted is not None:
                lows.append(self._unemitted)
            return min(lows) if lows else None

        def extend(self, win_buf: np.ndarray, win_base: int):
            """Grow the byte stream with a window's newly seen bytes."""
            if not len(self.pending):
                return
            tip = self.base + len(self.buf)
            if win_base + len(win_buf) > tip:
                self.buf = np.concatenate(
                    [self.buf, win_buf[max(tip - win_base, 0):]]
                )

        def add(self, positions: np.ndarray, win_buf: np.ndarray,
                win_base: int):
            if not len(positions):
                return
            if not len(self.pending):
                self.base = int(positions.min())
                self.buf = win_buf[self.base - win_base:].copy()
            self.pending = np.concatenate([self.pending, positions])

        def _retire(self, done: np.ndarray) -> np.ndarray:
            """Drop resolved pendings and trim the buffer to the earliest
            survivor; returns the retired positions."""
            positions = self.pending[done]
            self.pending = self.pending[~done]
            if not len(self.pending):
                self.buf = np.empty(0, dtype=np.uint8)
            else:
                lo = int(self.pending.min())
                self.buf = self.buf[lo - self.base:]
                self.base = lo
            return positions

        @staticmethod
        def _emit_runs(positions: np.ndarray, rows: tuple):
            """Ascending resolved positions grouped into contiguous runs:
            one ``(run_start, per-field arrays)`` per run."""
            if not len(positions):
                return
            breaks = np.flatnonzero(np.diff(positions) != 1) + 1
            for seg in np.split(np.arange(len(positions)), breaks):
                yield int(positions[seg[0]]), tuple(r[seg] for r in rows)

        def resolve(self, at_eof: bool, fields: tuple[str, ...]):
            """Re-check pendings against the grown stream; yield ``(pos,
            row)`` for each run of pendings now resolved with certainty
            (``row`` holds one array per field). A lane retires only when
            exact: an inexact lane's flags may still change as the buffer
            grows past its chain, and at EOF everything is definitive.
            Attempts run at EOF or once the stream grew by a quarter of the
            retained span since the last one; ungated, windows shorter than
            a record would redo the span every window (quadratic)."""
            if not len(self.pending):
                return
            tip = self.base + len(self.buf)
            if not at_eof and tip - self._gate_tip < (tip - self.base) // 4:
                return
            self._gate_tip = tip
            res = check_flat(
                self.buf, self.lengths, candidates=self.pending - self.base,
                at_eof=at_eof, reads_to_check=self.rtc,
            )
            done = (~res.escaped) & res.exact
            positions = self._retire(done)
            rows = tuple(np.asarray(getattr(res, f))[done] for f in fields)
            runs = list(self._emit_runs(positions, rows))
            for k, run in enumerate(runs):
                self._unemitted = runs[k + 1][0] if k + 1 < len(runs) else None
                yield run
            self._unemitted = None

    # ------------------------------------------------------- consumers
    def _stream(self, fields: tuple[str, ...], defer_inexact: bool,
                with_buf: bool = False, deferred=None):
        """The window loop behind ``spans``, ``full_spans`` and
        ``read_batches``: project ``fields`` from each window, defer
        unresolved owned lanes (escaped, plus inexact ones when the
        projection is the flag masks), and re-emit them as contiguous-run
        spans once exact. ``with_buf`` appends the window's host bytes and
        its device tensor to each window tuple (``None, None`` on deferred
        re-emissions). ``deferred`` is the caller's ``_Deferred`` (it
        reads the pending positions between items)."""
        if deferred is None:
            deferred = self._Deferred(self.lengths, self.config.reads_to_check)
        funnel = self.config.funnel_enabled(defer_inexact)
        keys = (*fields, "escaped")
        if defer_inexact:
            keys += ("exact",)
        if funnel:
            keys += ("survivors",)
        for base, own_end, at_eof, out in self._windows(
            self._launcher(keys, full_masks=defer_inexact)
        ):
            res = self._materialize(out)
            buf = res["window"]
            if funnel:
                self._funnel_add(len(buf), int(res["survivors"]))
            spans = [res[f][:own_end].copy() for f in fields]
            bad = res["escaped"][:own_end]
            if defer_inexact:
                bad = bad | ~res["exact"][:own_end]
            deferred.extend(buf, base)
            bad_idx = np.flatnonzero(bad)
            if len(bad_idx):
                for s in spans:
                    s[bad_idx] = 0  # re-emitted by the deferral path
                deferred.add(base + bad_idx, buf, base)
            if with_buf:
                yield (base, *spans, buf, res["padded"])
            else:
                yield (base, *spans)
            for pos, row in deferred.resolve(at_eof, fields):
                yield (pos, *row, None, None) if with_buf else (pos, *row)
        if len(deferred):
            raise RuntimeError(
                f"{len(deferred)} deferred position(s) unresolved at EOF")

    def spans(self):
        """Yield ``(base, verdict)`` spans; see the module contract."""
        yield from self._stream(("verdict",), defer_inexact=False)

    def full_spans(self):
        """Yield ``(base, fail_mask, reads_before)`` spans tiling the file:
        the full checker's 19-bit mask at every position (reference
        full/Checker.scala) in O(window) memory. Lanes whose masks may be
        incomplete (escaped chains, failures that touch the buffer end)
        defer until a re-check is exact; their slots in the covering span
        hold mask 0 and reads_before 0."""
        yield from self._stream(("fail_mask", "reads_before"),
                                defer_inexact=True)

    def read_batches(self):
        """Columnar ``ReadBatch``es per streaming window: the load path in
        O(window) host memory (reference CanLoadBam.scala:173-243 loads per
        split, here per window).

        Yields ``(abs_base, batch)``; batch ``starts`` are window-relative
        (int64). Each window's records parse on the device tensor the check
        already holds: only the starts go up, only the columns come back.
        Records that start in an owned span but run past the window's bytes
        (longer than the halo), and record starts that resolved through the
        deferral path, are decoded exactly from a seekable stream and
        yielded as batches with ``abs_base = -1`` (their ``starts`` index
        their own buffer): whenever ``SPILL_FLUSH`` such positions are
        pending, and the rest at the end."""
        for base, batch, _abs, _floor in self._read_pieces(ordered=False):
            yield base, batch

    def ordered_read_batches(self):
        """The record batches of ``read_batches`` with each row's absolute
        flat offset, for consumers that put rows back in file order.

        Yields ``(abs_starts, batch, floor)``: ``abs_starts[i]`` is row
        ``i``'s offset, and no row below ``floor`` comes after this item.
        Each window's spills decode with the window, so what a consumer
        holds back stays O(window) on long reads; the record at the
        header's end always decodes from the stream, verdict or not, as
        the record path reads it (the first record of the file)."""
        for _base, batch, abs_starts, floor in self._read_pieces(ordered=True):
            yield abs_starts, batch, floor

    def _read_pieces(self, ordered: bool):
        """The loop behind ``read_batches`` and ``ordered_read_batches``:
        ``(abs_base, batch, abs_starts, floor)`` items (``abs_base`` -1
        on spill batches). ``ordered`` decodes the pending spills at every
        window and forces the header-end record through the stream."""
        he = self.header_end_abs
        first = he if ordered and he < self.total else None
        deferred = self._Deferred(self.lengths, self.config.reads_to_check)
        spill_abs: list[int] = []
        frontier = 0

        def floor() -> int:
            """The lowest offset a later item can still hold."""
            low = frontier
            if spill_abs:
                low = min(low, min(spill_abs))
            pending = deferred.low()
            return low if pending is None else min(low, pending)

        def flush():
            positions = sorted(spill_abs)
            spill_abs.clear()
            at = 0
            for batch in self._decode_spills(positions):
                lo, at = at, at + len(batch.starts)
                low = floor()
                if at < len(positions):   # later chunks of this flush
                    low = min(low, positions[at])
                yield -1, batch, np.asarray(positions[lo:at]), low

        for base, verdict, buf, padded in self._stream(
            ("verdict",), defer_inexact=False, with_buf=True,
            deferred=deferred,
        ):
            if buf is None:  # a deferred contiguous-run re-emission
                idx = base + np.flatnonzero(verdict)
                keep = idx >= he if first is None else idx > he
                spill_abs.extend(idx[keep].tolist())
            else:
                frontier = base + len(verdict)
                if first is not None and base <= first < frontier:
                    spill_abs.append(first)
                starts = np.flatnonzero(verdict)
                if first is None:
                    starts = starts[base + starts >= he]
                else:
                    starts = starts[base + starts > he]
                if len(starts):
                    # A record must fit the buffer to parse in the window;
                    # the others decode exactly from the stream.
                    sizes = (
                        buf[starts].astype(np.int64)
                        | (buf[starts + 1].astype(np.int64) << 8)
                        | (buf[starts + 2].astype(np.int64) << 16)
                        | (buf[starts + 3].astype(np.int64) << 24)
                    )
                    fits = starts + 4 + sizes <= len(buf)
                    spill_abs.extend((base + starts[~fits]).tolist())
                    starts = starts[fits]
                    if len(starts):
                        yield (base, parse_window(padded, buf, starts),
                               base + starts, floor())
                if ordered and spill_abs:
                    yield from flush()
            # Bound spill memory: flush in chunks during the stream.
            if len(spill_abs) >= SPILL_FLUSH:
                yield from flush()
        frontier = self.total
        if spill_abs:
            yield from flush()

    def _decode_spills(self, positions: list[int],
                       chunk_bytes: int = 64 << 20):
        """Exact decode of records whose bytes outran their window: each
        record is read through the seekable stream, and the records parse
        in buffers of at most about ``chunk_bytes`` (bounded memory;
        offsets stay far inside the parser's int32 range)."""
        block_starts, block_flat = metas_block_table(self.pipeline.metas)
        stream = SeekableUncompressedBytes(
            SeekableBlockStream(open_channel(self.path)))
        try:
            parts: list[bytes] = []
            starts: list[int] = []
            off = 0
            for pos in positions:
                stream.seek(Pos(*pos_of_flat_tables(block_starts, block_flat,
                                                    pos)))
                size_bytes = stream.read(4)
                size = int.from_bytes(size_bytes, "little")
                parts.append(size_bytes + stream.read(size))
                starts.append(off)
                off += 4 + size
                if off >= chunk_bytes:
                    yield self._parse_spills(parts, starts)
                    parts, starts, off = [], [], 0
            if parts:
                yield self._parse_spills(parts, starts)
        finally:
            stream.close()

    def _parse_spills(self, parts: list[bytes], starts: list[int]):
        buf = np.frombuffer(b"".join(parts), dtype=np.uint8)
        return parse_flat_records(buf, np.array(starts, dtype=np.int64),
                                  device=self.device)

    def record_starts(self):
        """Absolute flat offsets of record starts, one array per span, in
        stream order (deferred resolutions may come out of order)."""
        he = self.header_end_abs
        for base, verdict in self.spans():
            idx = base + np.flatnonzero(verdict)
            idx = idx[idx >= he]
            if len(idx):
                yield idx

    def _count_via_spans(self) -> int:
        he = self.header_end_abs
        return sum(int(v[max(he - b, 0):].sum()) for b, v in self.spans())


class _Accumulator:
    """Per-window device scalars summed on the device and flushed to host
    ints every ``flush_every`` windows, with the escape checkpoints."""

    def __init__(self, checker: StreamChecker):
        self.checker = checker
        self.funnel = checker.config.funnel_enabled()
        self.total = 0
        self.dev_total = self.dev_esc = self.dev_surv = None
        self.windows = self.chunk = self.screened = 0
        self.escaped = False

    def add(self, out: dict, screened: int) -> bool:
        """Fold one window in; True when an escape ends the count."""
        if self.dev_total is None:
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
        self.escaped = bool(int(self.dev_esc))
        return self.escaped

    def _flush(self) -> None:
        self.total += int(self.dev_total)
        if self.funnel:
            self.checker._funnel_add(self.screened, int(self.dev_surv))
        self.dev_total = self.dev_esc = self.dev_surv = None
        self.chunk = self.screened = 0

    def finish(self) -> int | None:
        """The count, or None when an owned position escaped."""
        if not self.escaped and self.dev_total is not None:
            if not self._check_escape():
                self._flush()
        return None if self.escaped else self.total


def full_check_summary_streaming(
    path,
    config: Config = Config(),
    window_uncompressed: int | None = None,
    halo: int | None = None,
    device=None,
    metas=None,
) -> dict:
    """The full-check aggregations over a whole file from ``full_spans``
    in O(window) memory (reference FullCheck.scala): per-flag totals over
    the considered positions, their count, and the critical (exactly one
    failing field) and two-check positions with their masks, in ascending
    position order. ``metas`` reuses the caller's block scan."""
    checker = StreamChecker(path, config, window_uncompressed, halo, device,
                            metas)
    per_flag = np.zeros(len(FLAG_NAMES), dtype=np.int64)
    considered_total = 0
    crit_pos: list[np.ndarray] = []
    crit_mask: list[np.ndarray] = []
    two_pos: list[np.ndarray] = []
    two_mask: list[np.ndarray] = []
    for base, fm, rb in checker.full_spans():
        cidx = np.flatnonzero(considered_mask(fm, rb))
        considered_total += len(cidx)
        masked = fm[cidx]
        per_flag += bit_counts(masked)
        nf = num_failing_fields(masked, rb[cidx])
        ones = cidx[nf == 1]
        twos = cidx[nf == 2]
        if len(ones):
            crit_pos.append(base + ones)
            crit_mask.append(fm[ones])
        if len(twos):
            two_pos.append(base + twos)
            two_mask.append(fm[twos])

    def cat_sorted(pos_parts, mask_parts):
        """Site arrays concatenated and put back in ascending position
        order: deferred re-emissions land behind the tiling frontier."""
        pos = (np.concatenate(pos_parts) if pos_parts
               else np.empty(0, dtype=np.int64))
        mask = (np.concatenate(mask_parts) if mask_parts
                else np.empty(0, dtype=np.int32))
        if len(pos) > 1 and np.any(np.diff(pos) < 0):
            order = np.argsort(pos, kind="stable")
            pos, mask = pos[order], mask[order]
        return pos, mask

    crit_pos_a, crit_mask_a = cat_sorted(crit_pos, crit_mask)
    two_pos_a, two_mask_a = cat_sorted(two_pos, two_mask)
    return {
        "per_flag": {name: int(per_flag[i])
                     for i, name in enumerate(FLAG_NAMES)},
        "considered": considered_total,
        "critical_positions": crit_pos_a,
        "critical_masks": crit_mask_a,
        "two_check_positions": two_pos_a,
        "two_check_masks": two_mask_a,
        "positions": checker.total,
    }
