"""Block codecs, the compressor behind ``bam.writer.BgzfWriter``, and the
zlib-stream encoder of the columnar container's ``codec=deflate`` buffers
(reference ``spark_bam_tpu/compress/codec.py``).

A codec turns uncompressed payloads into complete BGZF members through a
two-phase ``dispatch``/``materialize`` split: ``dispatch`` stages a batch
in pinned memory, copies it to the card and launches the lanes without
waiting; ``materialize`` copies the results back and frames the members.
The writer keeps two batches in flight, so the card packs batch N while
the host frames batch N - 1.

Unlike the reference, nothing demotes to the host on a device error:
``device=on`` and ``device=auto`` both mean the card and raise without
one, or on a failed build or launch; ``device=off`` is the host functions
of ``huffman.py`` by the user's choice (the same bytes under ``stored``
and ``fixed``; host zlib under ``auto``, as in the reference); on the card
``mode=auto`` is ``fixed``. The one host step
is data-driven: in ``encode_zlib_stream`` a window whose fixed stream
outgrows the lane's ``OUT_BYTES`` is re-packed on the host, and counted
in ``ZLIB_STREAM_COUNTS["repacks"]``. Each codec counts its members and
its stored and fixed picks in ``counts``.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np
import torch

from spark_bam_tpu_torch.compress import kernels as lanes
from spark_bam_tpu_torch.compress.config import DeflateConfig
from spark_bam_tpu_torch.compress.huffman import (
    MAX_STORED_PAYLOAD,
    bgzf_member,
    fixed_member,
    fixed_stream_bits,
    stored_body,
    stored_member,
    zlib_member,
    zlib_stream,
)
from spark_bam_tpu_torch.core.guard import LimitExceeded
from spark_bam_tpu_torch.device import resolve_device
from spark_bam_tpu_torch.kernels.build import load

#: ``encode_zlib_stream``'s device windows and host re-packs of windows
#: that outgrew a lane's output plane.
ZLIB_STREAM_COUNTS = {"windows": 0, "repacks": 0}


def _check_payloads(payloads) -> None:
    for p in payloads:
        if len(p) > MAX_STORED_PAYLOAD:
            raise LimitExceeded(
                f"{len(p)}-byte payload cannot fit any BGZF member "
                f"(max {MAX_STORED_PAYLOAD})"
            )


def _lane_device(cfg: DeflateConfig, device) -> "torch.device | None":
    """Where the lanes run: None for the host functions (``device=off``),
    else ``device`` resolved (``None`` → the current CUDA device, raising
    without one)."""
    if cfg.device == "off":
        return None
    return resolve_device(device)


class HostZlibCodec:
    """mode=off: host zlib per block at ``level``, stored where zlib's
    output would overflow BSIZE."""

    lanes = 1

    def __init__(self, level: int = 6):
        self.level = level
        self.counts = {"members": 0}

    def dispatch(self, payloads: "list[bytes]") -> "list[bytes]":
        _check_payloads(payloads)
        self.counts["members"] += len(payloads)
        return [zlib_member(p, self.level) for p in payloads]

    def materialize(self, pending: "list[bytes]") -> "list[bytes]":
        return pending

    def encode_blocks(self, payloads: "list[bytes]") -> "list[bytes]":
        return self.dispatch(payloads)


class _Pending:
    """One batch in flight: its payloads and the un-synced device results
    (None for a host batch)."""

    __slots__ = ("payloads", "dev")

    def __init__(self, payloads, dev):
        self.payloads = payloads
        self.dev = dev


class DeviceDeflateCodec:
    """mode=stored|fixed|auto: CRC-32 (and the fixed-Huffman pack) of
    ``lanes`` payloads a dispatch on the card, members framed on the host;
    under ``device=off`` the host functions, byte for byte the same."""

    def __init__(self, cfg: DeflateConfig, device=None):
        if cfg.mode not in ("stored", "fixed", "auto"):
            raise ValueError(f"DeviceDeflateCodec cannot serve mode={cfg.mode!r}")
        self.cfg = cfg
        self.mode = cfg.mode
        self.lanes = cfg.lanes
        self.device = _lane_device(cfg, device)
        self.counts = {"members": 0, "stored": 0, "fixed": 0, "batches": 0}
        if self.device is not None and self.device.type == "cuda":
            load()  # build now: a missing nvcc fails here, not mid-write

    def dispatch(self, payloads: "list[bytes]") -> _Pending:
        _check_payloads(payloads)
        if not payloads or self.device is None:
            return _Pending(payloads, None)
        dev = self.device
        data, lengths, _ = lanes.pack_lanes(payloads, pin=dev.type == "cuda")
        data = data.to(dev, non_blocking=True)
        lengths = lengths.to(dev, non_blocking=True)
        if self.mode == "stored":
            out = (lanes.crc32_lanes(data, lengths),)
        else:
            out = lanes.deflate_fixed_lanes(data, lengths)
        return _Pending(payloads, out)

    def materialize(self, pending: _Pending) -> "list[bytes]":
        payloads = pending.payloads
        if not payloads:
            return []
        if pending.dev is not None:
            return self._assemble(payloads,
                                  [t.cpu().numpy() for t in pending.dev])
        # device=off: the host functions; mode=auto is host zlib there, as
        # in the reference.
        if self.mode == "stored":
            members = [stored_member(p) for p in payloads]
            self._count(len(payloads), len(payloads))
        elif self.mode == "fixed":
            members = [fixed_member(p) for p in payloads]
            # A stored body starts 0x01; a fixed one has its low bits 11.
            self._count(len(payloads), sum(m[18] == 1 for m in members))
        else:
            members = [zlib_member(p, self.cfg.level) for p in payloads]
            self.counts["members"] += len(payloads)
            self.counts["batches"] += 1
        return members

    def _count(self, n: int, nstored: int) -> None:
        self.counts["members"] += n
        self.counts["batches"] += 1
        self.counts["stored"] += nstored
        self.counts["fixed"] += n - nstored

    def _assemble(self, payloads, host) -> "list[bytes]":
        """Device results → members; under fixed, stored wherever it is no
        larger (``huffman.fixed_member``'s rule), so a clipped lane is
        never read."""
        if self.mode == "stored":
            (crc,) = host
            members = [stored_member(p, crc=int(crc[i]))
                       for i, p in enumerate(payloads)]
            self._count(len(payloads), len(payloads))
            return members
        packed, total_bits, crc = host
        members = []
        nstored = 0
        for i, p in enumerate(payloads):
            nbytes = (int(total_bits[i]) + 7) // 8
            if nbytes >= len(p) + 5:
                members.append(bgzf_member(stored_body(p), int(crc[i]), len(p)))
                nstored += 1
            else:
                members.append(bgzf_member(packed[i, :nbytes].tobytes(),
                                           int(crc[i]), len(p)))
        self._count(len(payloads), nstored)
        return members

    def encode_blocks(self, payloads: "list[bytes]") -> "list[bytes]":
        return self.materialize(self.dispatch(payloads))


def encode_zlib_stream(raw: bytes, spec: "str | None" = None,
                       device=None) -> bytes:
    """A zlib stream of literal-only fixed-Huffman blocks over ``raw``, one
    block per ``MAX_STORED_PAYLOAD`` window. ``spec`` is a deflate spec
    (``None`` reads ``SPARK_BAM_DEFLATE``): with the device lanes off it is
    ``huffman.zlib_stream``; on, the windows are packed on ``device``
    (``None``: the current CUDA device, raising without one), ``lanes``
    windows a launch, and stitched into the same bytes."""
    if spec is None:
        spec = os.environ.get("SPARK_BAM_DEFLATE", "")
    cfg = DeflateConfig.parse(spec)
    if not cfg.enabled or cfg.device == "off":
        return zlib_stream(raw)
    dev = resolve_device(device)
    window = MAX_STORED_PAYLOAD
    mv = memoryview(raw)
    nwin = max(1, (len(mv) + window - 1) // window)
    chunks = [bytes(mv[i * window:(i + 1) * window]) for i in range(nwin)]
    bit_arrays = []
    for lo in range(0, nwin, cfg.lanes):
        group = chunks[lo: lo + cfg.lanes]
        data, lengths, _ = lanes.pack_lanes(group, pin=dev.type == "cuda")
        packed, total_bits, _crc = lanes.deflate_fixed_lanes(
            data.to(dev, non_blocking=True),
            lengths.to(dev, non_blocking=True))
        packed, total_bits = packed.cpu().numpy(), total_bits.cpu().numpy()
        ZLIB_STREAM_COUNTS["windows"] += len(group)
        for j, chunk in enumerate(group):
            i = lo + j
            tb = int(total_bits[j])
            if tb > lanes.OUT_BYTES * 8:
                # The window outgrew the lane's plane: re-pack on the host,
                # the same bytes by construction.
                ZLIB_STREAM_COUNTS["repacks"] += 1
                bit_arrays.append(fixed_stream_bits(chunk, final=i == nwin - 1))
            else:
                bit_arrays.append(fixed_stream_bits(
                    chunk, final=i == nwin - 1,
                    packed=packed[j, :(tb + 7) // 8].tobytes(), total_bits=tb,
                ))
    body = np.packbits(np.concatenate(bit_arrays), bitorder="little").tobytes()
    return (
        b"\x78\x01" + body
        + struct.pack(">I", zlib.adler32(raw) & 0xFFFFFFFF)
    )


def make_codec(cfg: "DeflateConfig | str | None", level: "int | None" = None,
               device=None):
    """The codec for a deflate spec or config: ``None``, "" or mode=off
    give host zlib at ``level``; the others a ``DeviceDeflateCodec`` on
    ``device``."""
    if cfg is None:
        cfg = DeflateConfig()
    elif isinstance(cfg, str):
        cfg = DeflateConfig.parse(cfg)
    if level is not None and level != cfg.level:
        cfg = DeflateConfig(cfg.mode, level, cfg.lanes, cfg.device)
    if not cfg.enabled:
        return HostZlibCodec(cfg.level)
    return DeviceDeflateCodec(cfg, device=device)
