"""BGZF inflate feeding the device (reference ``spark_bam_tpu/tpu/
inflate.py``): the window plan, the host-inflate pipeline of the
classic count loop (``bgzf/flat.py::inflate_blocks``), and the two routes
of the two-phase device inflate.

The device side of inflate is an entropy phase (bitstream → per-output-byte
literal/distance tokens) and a copy phase, the ``lz77_resolve`` kernel
(every byte takes the literal at the root of its back-reference chain).
``Config.inflate``'s ``tokenize`` says where the entropy phase runs:

- ``device`` (and ``auto``): worker threads stage each window group's raw
  payloads on the device (``stage_group_device``) and the ``tokenize``
  kernel decodes them; ``checker.count_window_raw`` chains it with the
  resolve and the count.
- ``host``: the host DEFLATE tokenizer (``native/tokenize.cpp``, C++ built
  by ``native/build.py``) decodes the group on worker threads, each block
  range on its own thread (ctypes releases the GIL), into one u8 buffer
  (``pack_tokens``' layout: the lit plane, then the dist plane's
  little-endian bytes), pinned on a CUDA device and reused behind an event
  (``PackedStaging``), so the 3-bytes-per-output-byte copy is one async
  transfer. On the device ``_unpack_tokens`` views the halves as the two
  planes and ``lz77_resolve`` resolves them in place
  (``checker.count_window_tokens``, ``inflate_group_device``). A stream
  the tokenizer refuses, or a size that disagrees with its block footer,
  raises ``TokenizeError``; callers demote that work to the host inflate
  and count it.

Both kernels live in ``tpu/kernels.py`` beside their plain versions.

Under a live obs registry (and only then) the work is split by phase as
the reference splits it: ``attribute_ms`` lands the host, H2D, device and
tokenizer times of each window as gauges and ms histograms (what ``top``
shows as host/h2d/dev), ``inflate.h2d`` times the staging copy, and
``inflate.device_kernel`` waits for the kernels' completion (a stream
synchronisation that runs only while the registry is live). With obs off
nothing here synchronises. ``maybe_profile_window`` captures one window
under ``torch.profiler`` when ``SPARK_BAM_PROFILE`` names a directory.
"""

from __future__ import annotations

import contextlib
import logging
import os
import queue
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator

import numpy as np
import torch

from spark_bam_tpu_torch import obs
from spark_bam_tpu_torch.bgzf.block import Metadata
from spark_bam_tpu_torch.bgzf.flat import (
    FlatView,
    _next_pow2,
    footer_crcs,
    inflate_blocks,
    metas_block_table,
    read_run_payloads,
    stage_rows,
)
from spark_bam_tpu_torch.bgzf.index_blocks import blocks_metadata
from spark_bam_tpu_torch.core.channel import open_channel
from spark_bam_tpu_torch.core.config import InflateConfig
from spark_bam_tpu_torch.device import resolve_device
from spark_bam_tpu_torch.native.build import tokenize_deflate
from spark_bam_tpu_torch.tpu.kernels import _resolve_body, lz77_resolve, tokenize
from spark_bam_tpu_torch.tpu.tokenize_device import STRIDE

__all__ = [
    "STRIDE", "InflatePipeline", "PackedGroup", "PackedStaging",
    "TokenizeError", "_resolve_body", "_unpack_tokens", "dispatch_group_device",
    "inflate_blocks_device", "inflate_file_device", "inflate_group_device",
    "lz77_resolve", "pack_tokens", "stage_group_device",
    "tokenize_group",
    "tokenize_pack", "window_plan",
]


log = logging.getLogger(__name__)


def sync_stream(device: torch.device) -> None:
    """Wait for the work queued on ``device``'s current stream (a no-op on
    the CPU, whose work is already done). Callers run it only under a
    live registry, to time completion rather than enqueue."""
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


def attribute_ms(host_ms=None, h2d_ms=None, device_ms=None,
                 tokenize_host_ms=None, tokenize_device_ms=None) -> None:
    """Per-window host/H2D/device attribution (reference
    ``tpu/inflate.py::attribute_ms``): each phase lands as a gauge (the
    last window and its peak, ``top``'s view) and an ms-unit histogram.
    No-op without a live registry. ``host_ms`` is the residual host work
    every route shares (bulk read, staging); the entropy phase reports
    under the ``tokenize_*`` names."""
    r = obs.registry()
    if r is None:
        return
    for name, v in (("inflate.host_ms", host_ms),
                    ("inflate.h2d_ms", h2d_ms),
                    ("inflate.device_ms", device_ms),
                    ("inflate.tokenize_host_ms", tokenize_host_ms),
                    ("inflate.tokenize_device_ms", tokenize_device_ms)):
        if v is not None:
            r.gauge(name).set(round(v, 3))
            r.histogram(name, unit="ms").observe(v)


def record_rounds(rounds) -> None:
    """Feed the LZ77 rounds-to-convergence histogram: one scalar read from
    the device, so only under a live registry."""
    if obs.enabled():
        obs.observe("inflate.rounds", int(rounds), unit="rounds")


PROFILE_ENV = "SPARK_BAM_PROFILE"
#: Directories already given their one window in this process.
_profiled: set = set()


@contextlib.contextmanager
def maybe_profile_window(label: str = "inflate_window",
                         device: torch.device | None = None):
    """One ``torch.profiler`` capture around one window when
    ``SPARK_BAM_PROFILE`` names a directory (the CLI's ``--profile``):
    CPU and, on a CUDA device, CUDA activities, written as a Chrome trace
    ``profile-<pid>-<label>.json`` there (the port's counterpart of the
    reference's one ``jax.profiler.trace`` window). Exactly one window a
    directory and process: the profiler's own cost would skew every later
    window. The dump's path lands in the flight ring. Never raises: a
    profiler that fails to start leaves a plain window."""
    out = os.environ.get(PROFILE_ENV)
    if not out or out in _profiled:
        yield None
        return
    _profiled.add(out)
    from torch.profiler import ProfilerActivity, profile

    cuda = device is not None and device.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    path = os.path.join(out, f"profile-{os.getpid()}-{label}.json")
    try:
        os.makedirs(out, exist_ok=True)
        prof = profile(activities=acts)
        prof.__enter__()
    except Exception:
        log.warning("torch.profiler unavailable; --profile window skipped",
                    exc_info=True)
        yield None
        return
    try:
        yield path
    finally:
        try:
            if cuda:
                sync_stream(device)
            prof.__exit__(None, None, None)
            prof.export_chrome_trace(path)
        except Exception:
            log.warning("profiler dump failed", exc_info=True)
        else:
            from spark_bam_tpu_torch.obs import flight

            flight.record("profile_dump", path=path, label=label)
            log.info("profiler trace of one %s written to %s", label, path)


class TokenizeError(IOError):
    """The host tokenizer refused a payload, or a payload's produced size
    disagrees with its block footer."""


def packed_nbytes(b: int) -> int:
    """Bytes of the packed token planes of ``b`` blocks, the batch padded
    to a power of two."""
    return 3 * _next_pow2(b) * STRIDE


def pack_tokens(lit: np.ndarray, dist: np.ndarray) -> np.ndarray:
    """(B, STRIDE) u8/u16 token rows as one contiguous u8 buffer: the lit
    plane, then the dist plane's little-endian bytes (the reference's
    layout; ``tokenize_pack`` writes it in place)."""
    return np.concatenate([
        np.ascontiguousarray(lit, dtype=np.uint8).reshape(-1),
        np.ascontiguousarray(dist, dtype="<u2").view(np.uint8).reshape(-1),
    ])


def _planes(packed: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Writable (B, STRIDE) lit and dist views of a packed host buffer."""
    plane = len(packed) // 3
    b = plane // STRIDE
    return (packed[:plane].reshape(b, STRIDE),
            packed[plane:].view(np.uint16).reshape(b, STRIDE))


def _unpack_tokens(packed: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The (B, STRIDE) lit and dist planes of a packed buffer on its device,
    as views (the dist half reinterpreted as uint16): no copy."""
    plane = packed.numel() // 3
    b = plane // STRIDE
    lit = packed[:plane].view(b, STRIDE)
    dist = packed[plane:].view(torch.uint16).view(b, STRIDE)
    return lit, dist


def _resolve_packed(packed: torch.Tensor):
    """Unpack and resolve LZ77 in place over the lit plane: ``(resolved
    (B, STRIDE) u8, rounds () i32)``."""
    lit, dist = _unpack_tokens(packed)
    return lz77_resolve(lit, dist, out=lit)


def tokenize_pack(comp: np.ndarray, offsets: np.ndarray,
                  lengths: np.ndarray, out_lengths: np.ndarray,
                  out: np.ndarray | None = None, threads: int = 8):
    """The host entropy phase of a batch of raw-DEFLATE payloads: tokenize
    into packed planes, check each produced size against its block footer,
    and zero the rows that pad the batch to a power of two. ``out`` is a
    u8 buffer of at least ``packed_nbytes(B)`` bytes to write into (a
    pinned staging slot); blocks are split over ``threads`` threads.

    Returns ``(packed u8, out_lens i64 (B,), b)`` with ``b`` the real block
    count. Raises ``TokenizeError`` when the tokenizer refuses a payload
    (naming the first, as the reference does) or a size disagrees with its
    footer. The time lands in the ``inflate.tokenize_host_ms`` series."""
    t0 = time.perf_counter()
    b = len(offsets)
    n = packed_nbytes(b)
    packed = np.empty(n, dtype=np.uint8) if out is None else out[:n]
    lit, dist = _planes(packed)
    out_lens = np.zeros(b, dtype=np.int64)
    comp = np.ascontiguousarray(comp, dtype=np.uint8)
    offsets = np.asarray(offsets, dtype=np.int64)
    lengths = np.asarray(lengths, dtype=np.int64)

    def run(lo: int, hi: int) -> int:
        rc = tokenize_deflate(comp, offsets[lo:hi], lengths[lo:hi],
                              lit[lo:hi], dist[lo:hi], out_lens[lo:hi])
        return lo + rc if rc else 0

    cuts = np.linspace(0, b, min(threads, b) + 1).astype(int) if b else [0]
    spans = [(int(lo), int(hi)) for lo, hi in zip(cuts[:-1], cuts[1:])]
    # The tokenizer writes the packed planes directly: the reference's
    # separate ``inflate.pack`` step has no counterpart here.
    with obs.span("inflate.tokenize", blocks=b):
        if len(spans) > 1:
            with ThreadPoolExecutor(max_workers=len(spans)) as pool:
                rcs = list(pool.map(lambda s: run(*s), spans))
        else:
            rcs = [run(*s) for s in spans]
    bad = [rc for rc in rcs if rc]
    if bad:
        raise TokenizeError(f"deflate tokenize failed at block {min(bad) - 1}")
    if not np.array_equal(out_lens, np.asarray(out_lengths, dtype=np.int64)):
        raise TokenizeError(
            "tokenized output sizes disagree with block footers")
    # dist = 0 rows are identity chains: the pad resolves to itself.
    lit[b:] = 0
    dist[b:] = 0
    attribute_ms(tokenize_host_ms=(time.perf_counter() - t0) * 1e3)
    obs.count("inflate.tokenize_blocks", b)
    return packed, out_lens, b


class _Slot:
    """One pinned packed buffer and the event of the last copy out of it."""

    __slots__ = ("buf", "done")

    def __init__(self):
        self.buf: torch.Tensor | None = None
        self.done = None


class PackedStaging:
    """Pinned host buffers for a stream of packed groups on a CUDA device.
    A worker takes a free buffer (waiting for the event of the last copy
    out of it) and tokenizes into it; ``to_device`` enqueues the copy on
    the current stream, records its event and hands the buffer back, so a
    buffer is written again only once its copy has run. ``slots`` must
    exceed the groups tokenized ahead of the consumer."""

    def __init__(self, device: torch.device, slots: int):
        self.device = device
        self._free: queue.Queue = queue.Queue()
        for _ in range(slots):
            self._free.put(_Slot())

    def acquire(self, nbytes: int) -> _Slot:
        slot = self._free.get()
        if slot.done is not None:
            slot.done.synchronize()
            slot.done = None
        if slot.buf is None or slot.buf.numel() < nbytes:
            slot.buf = None
            slot.buf = torch.empty(nbytes, dtype=torch.uint8,
                                   pin_memory=True)
        return slot

    def release(self, slot: _Slot) -> None:
        self._free.put(slot)


class PackedGroup:
    """A window group's packed token planes on the host: ``packed`` (u8),
    ``out_lens`` (B,) int64, ``b`` blocks, and the staging slot that holds
    ``packed``, if any."""

    __slots__ = ("packed", "out_lens", "b", "slot", "staging", "crcs")

    def __init__(self, packed, out_lens, b, slot=None, staging=None,
                 crcs=None):
        self.packed = packed
        self.out_lens = out_lens
        self.b = b
        self.slot = slot
        self.staging = staging
        #: (b,) u32 stored footer CRCs (``tokenize_group`` reads them).
        self.crcs = crcs

    def to_device(self, device: torch.device) -> torch.Tensor:
        """The packed buffer on ``device``: from the pinned slot, one async
        copy on the current stream (the slot goes back once its event
        has passed); on the CPU, the host buffer itself."""
        obs.count("inflate.h2d_bytes", int(self.packed.nbytes))
        host = torch.from_numpy(self.packed)
        if device.type != "cuda":
            return host
        dev = torch.empty(host.numel(), dtype=torch.uint8, device=device)
        dev.copy_(host, non_blocking=self.slot is not None)
        if self.slot is not None:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(device))
            self.slot.done = ev
            self.staging.release(self.slot)
            self.slot = None
        return dev


def tokenize_group(ch, metas: list[Metadata],
                   staging: PackedStaging | None = None,
                   threads: int = 8) -> PackedGroup:
    """Read, tokenize and pack one window group (the host half of the
    ``tokenize=host`` route), into a slot of ``staging`` when given. Raises
    ``TokenizeError`` as ``tokenize_pack`` does. ``crcs`` keeps the
    blocks' stored footer CRCs."""
    t0 = time.perf_counter()
    comp, offs, lens = read_run_payloads(ch, metas)
    attribute_ms(host_ms=(time.perf_counter() - t0) * 1e3)
    crcs = footer_crcs(comp, offs, lens)
    usizes = np.array([m.uncompressed_size for m in metas], dtype=np.int64)
    slot = None
    if staging is not None:
        slot = staging.acquire(packed_nbytes(len(metas)))
    try:
        packed, out_lens, b = tokenize_pack(
            comp, offs, lens, usizes,
            out=None if slot is None else slot.buf.numpy(), threads=threads)
    except BaseException:
        if slot is not None:
            staging.release(slot)
        raise
    return PackedGroup(packed, out_lens, b, slot, staging, crcs)


def stage_group_device(ch, metas: list[Metadata], device: torch.device):
    """Read and stage one window group's raw payloads and copy them to the
    device: ``(staged (B_pad, C_pad) u8, clens (B_pad,) i32, usizes (B,)
    i64 ndarray, crcs (B,) u32 ndarray)``, ``crcs`` the blocks' stored
    footer CRCs from the same one read. Runs on the pipeline's worker
    threads, ahead of the window that consumes it.

    The read and staging land in ``inflate.host_ms``; the copy to the
    device in the ``inflate.h2d`` span and ``inflate.h2d_ms``. The copy
    from pageable memory returns once it has run on the current stream,
    so the span holds any work queued there ahead of it too. It runs on a
    worker thread, whose spans are roots, as the reference's are."""
    t0 = time.perf_counter()
    comp, offs, lens = read_run_payloads(ch, metas)
    staged, clens = stage_rows(comp, offs, lens)
    attribute_ms(host_ms=(time.perf_counter() - t0) * 1e3)
    usizes = np.array([m.uncompressed_size for m in metas], dtype=np.int64)
    t0 = time.perf_counter()
    with obs.span("inflate.h2d", blocks=len(metas), bytes=staged.nbytes):
        staged_dev = torch.from_numpy(staged).to(device)
        clens_dev = torch.from_numpy(clens).to(device)
    attribute_ms(h2d_ms=(time.perf_counter() - t0) * 1e3)
    obs.count("inflate.h2d_bytes", int(staged.nbytes))
    return staged_dev, clens_dev, usizes, footer_crcs(comp, offs, lens)


def open_planned(path, metas):
    """``open_channel(path)``, with the block table handed to a remote
    channel as its exact fetch plan (``PlannedChannel.set_plan``): its
    ranged GETs coalesce over the blocks and prefetch in plan order, as
    the reference's ``InflatePipeline`` hands it over. A local channel
    takes no plan."""
    ch = open_channel(path)
    if hasattr(ch, "set_plan"):
        ch.set_plan((m.start, m.start + m.compressed_size) for m in metas)
    return ch


def window_plan(metas: list[Metadata], window_uncompressed: int
                ) -> list[list[Metadata]]:
    """Group consecutive blocks into ≈window-sized uncompressed runs."""
    groups: list[list[Metadata]] = []
    cur: list[Metadata] = []
    size = 0
    for m in metas:
        if cur and size + m.uncompressed_size > window_uncompressed:
            groups.append(cur)
            cur, size = [], 0
        cur.append(m)
        size += m.uncompressed_size
    if cur:
        groups.append(cur)
    return groups


def wait_stall(fut):
    """``fut.result()``, its wait in ``inflate.stall_ms`` and, past 1 ms,
    one ``inflate.stalls``: the consumer blocked on a producer thread,
    the stall the pipeline's ``depth`` exists to hide."""
    t0 = time.perf_counter()
    out = fut.result()
    wait_ms = (time.perf_counter() - t0) * 1e3
    obs.observe("inflate.stall_ms", wait_ms, unit="ms")
    if wait_ms > 1.0:
        obs.count("inflate.stalls")
    return out


class InflatePipeline:
    """Window groups of a BGZF file and their host inflation
    (``inflate_blocks``), ``depth`` groups in flight on worker threads while
    the consumer takes the oldest.
    The fused device count reads only ``groups``, ``depth`` and ``total``;
    iterating yields ``FlatView`` windows for the classic count loop.
    ``metas`` reuses a block scan the caller already made; ``verify_crc``
    checks every block's CRC-32 as it inflates (the export's contract)."""

    threads = 8   # inflate threads per group (the C call releases the GIL)
    depth = 2     # groups prepared ahead of the consumer
    verify_crc = False

    def __init__(self, path, window_uncompressed: int, metas=None):
        self.path = path
        if metas is None:
            with obs.span("bgzf.read", kind="metadata_scan", path=str(path)):
                metas = blocks_metadata(path)
        self.metas = list(metas)
        self.total = sum(m.uncompressed_size for m in self.metas)
        self.groups = window_plan(self.metas, window_uncompressed)

    def __iter__(self) -> Iterator[FlatView]:
        ch = open_planned(self.path, self.metas)
        pool = ThreadPoolExecutor(max_workers=self.depth)
        try:
            pending = [
                pool.submit(inflate_blocks, ch, g, self.threads,
                            self.verify_crc)
                for g in self.groups[: self.depth]
            ]
            for i in range(len(self.groups)):
                with contextlib.ExitStack() as stack:
                    if i == 0:
                        # --profile: the first window's inflate, closed
                        # before the window is yielded.
                        stack.enter_context(maybe_profile_window())
                    view = wait_stall(pending.pop(0))
                nxt = i + self.depth
                if nxt < len(self.groups):
                    pending.append(pool.submit(
                        inflate_blocks, ch, self.groups[nxt], self.threads,
                        self.verify_crc))
                view.at_eof = i == len(self.groups) - 1
                yield view
        finally:
            pool.shutdown(wait=True, cancel_futures=True)
            ch.close()


# ------------------------------------------------- whole-group device inflate
def _inflate_cfg(spec: str | None) -> InflateConfig:
    """``Config.inflate``'s spec, or ``SPARK_BAM_INFLATE`` when None."""
    if spec is None:
        spec = os.environ.get("SPARK_BAM_INFLATE", "")
    return InflateConfig.parse(spec)


def _concat_rows(resolved: np.ndarray, out_lens) -> np.ndarray:
    lens = [int(n) for n in out_lens]
    if not lens:
        return np.empty(0, dtype=np.uint8)
    return np.concatenate([resolved[i, :n] for i, n in enumerate(lens)])


def inflate_blocks_device(comp: np.ndarray, offsets: np.ndarray,
                          lengths: np.ndarray, out_lengths: np.ndarray,
                          device=None, threads: int = 8) -> np.ndarray:
    """Two-phase inflate of raw-DEFLATE payloads: host tokenize, one packed
    copy, ``lz77_resolve`` over every block at once. Returns the blocks'
    bytes, concatenated. Raises ``TokenizeError`` as ``tokenize_pack``
    does."""
    dev = resolve_device(device)
    packed, out_lens, b = tokenize_pack(comp, offsets, lengths, out_lengths,
                                        threads=threads)
    group = PackedGroup(packed, out_lens, b)
    if not obs.enabled():
        resolved, _ = _resolve_packed(group.to_device(dev))
        return _concat_rows(resolved[:b].cpu().numpy(), out_lens)
    # The phase split: the copy alone, then the kernel and the read back.
    # The waits between them run only under a live registry.
    t0 = time.perf_counter()
    with obs.span("inflate.h2d", blocks=b, bytes=packed.nbytes):
        packed_dev = group.to_device(dev)
        sync_stream(dev)
    t1 = time.perf_counter()
    with obs.span("inflate.device_kernel", blocks=b):
        resolved, rounds = _resolve_packed(packed_dev)
        host = resolved[:b].cpu().numpy()
    attribute_ms(h2d_ms=(t1 - t0) * 1e3,
                 device_ms=(time.perf_counter() - t1) * 1e3)
    record_rounds(rounds)
    obs.count("inflate.device_windows")
    return _concat_rows(host, out_lens)


class _PendingDeviceView:
    """A group whose resolve is queued on the device: ``materialize`` reads
    it back as a ``FlatView``. Under ``tokenize=device`` it also checks the
    tokenizer's verdicts against the footers and raises ``TokenizeError``
    (counted in ``inflate.tokenize_demotions``) on a disagreement."""

    def __init__(self, resolved, out_lens, b, metas, file_total, at_eof,
                 tok_ok=None, tok_lens=None, rounds=None):
        self.rounds = rounds
        self.resolved = resolved
        self.out_lens = out_lens
        self.b = b
        self.metas = metas
        self.file_total = file_total
        self.at_eof = at_eof
        self.tok_ok = tok_ok
        self.tok_lens = tok_lens

    def materialize(self) -> FlatView:
        t0 = time.perf_counter()
        # The read back is the first wait on the queued work: its wall is
        # the window's device phase (kernels and D2H).
        with obs.span("inflate.device_kernel", blocks=self.b):
            resolved = self.resolved[: self.b].cpu().numpy()
        if obs.enabled():
            attribute_ms(device_ms=(time.perf_counter() - t0) * 1e3)
            if self.rounds is not None:
                record_rounds(self.rounds)
        if self.tok_ok is not None:
            ok = self.tok_ok[: self.b].cpu().numpy()
            lens = self.tok_lens[: self.b].cpu().numpy().astype(np.int64)
            if not (ok.all() and np.array_equal(lens, self.out_lens)):
                obs.count("inflate.tokenize_demotions")
                raise TokenizeError(
                    "device tokenizer disagreed with block footers")
        obs.count("inflate.device_windows")
        data = _concat_rows(resolved, self.out_lens)
        block_starts, block_flat = metas_block_table(self.metas)
        at_eof = self.at_eof or (self.file_total is not None
                                 and len(data) == self.file_total)
        return FlatView(data, at_eof=at_eof, block_starts=block_starts,
                        block_flat=block_flat, file_total=self.file_total)


def dispatch_group_device(ch, metas: list[Metadata],
                          file_total: int | None = None,
                          at_eof: bool = False,
                          inflate_spec: str | None = None, device=None,
                          threads: int = 8) -> _PendingDeviceView:
    """The host phases and the queued device work of one group, with no
    wait. ``inflate_spec`` is ``Config.inflate`` (None reads
    ``SPARK_BAM_INFLATE``): ``tokenize=host`` tokenizes and packs on the
    host and ships the packed planes; otherwise the raw payloads ship and
    the ``tokenize`` kernel decodes them. ``lz77_resolve`` then resolves
    in place."""
    dev = resolve_device(device)
    usizes = np.array([m.uncompressed_size for m in metas], dtype=np.int64)
    if _inflate_cfg(inflate_spec).tokenize == "host":
        group = tokenize_group(ch, metas, threads=threads)
        if obs.enabled():
            t0 = time.perf_counter()
            with obs.span("inflate.h2d", blocks=group.b,
                          bytes=group.packed.nbytes):
                packed_dev = group.to_device(dev)
                sync_stream(dev)
            attribute_ms(h2d_ms=(time.perf_counter() - t0) * 1e3)
        else:
            packed_dev = group.to_device(dev)
        resolved, rounds = _resolve_packed(packed_dev)
        return _PendingDeviceView(resolved, group.out_lens, group.b, metas,
                                  file_total, at_eof, rounds=rounds)
    staged, clens, usizes, _crcs = stage_group_device(ch, metas, dev)
    b = len(metas)
    if obs.enabled():
        t0 = time.perf_counter()
        with obs.span("inflate.tokenize_device", blocks=b):
            lit, dist, lens, ok = tokenize(staged, clens)
            sync_stream(dev)
        attribute_ms(tokenize_device_ms=(time.perf_counter() - t0) * 1e3)
    else:
        lit, dist, lens, ok = tokenize(staged, clens)
    obs.count("inflate.tokenize_blocks", b)
    resolved, rounds = lz77_resolve(lit, dist, out=lit)
    return _PendingDeviceView(resolved, usizes, b, metas, file_total, at_eof,
                              tok_ok=ok, tok_lens=lens, rounds=rounds)


def inflate_group_device(ch, metas: list[Metadata],
                         file_total: int | None = None, at_eof: bool = False,
                         inflate_spec: str | None = None, device=None,
                         threads: int = 8) -> FlatView:
    """Two-phase device inflate of a run of blocks → ``FlatView`` (the
    device counterpart of ``bgzf/flat.py::inflate_blocks``)."""
    return dispatch_group_device(ch, metas, file_total, at_eof, inflate_spec,
                                 device, threads).materialize()


def inflate_file_device(path, inflate_spec: str | None = None, device=None,
                        threads: int = 8) -> FlatView:
    """Whole-file two-phase device inflate → ``FlatView`` (the device
    counterpart of ``bgzf/flat.py::flatten_file``). Every block goes
    through one resolve: the planes of the whole file are on the device at
    once (three bytes an output byte)."""
    metas = list(blocks_metadata(path))
    with open_planned(path, metas) as ch:
        return inflate_group_device(
            ch, metas, file_total=sum(m.uncompressed_size for m in metas),
            at_eof=True, inflate_spec=inflate_spec, device=device,
            threads=threads)
