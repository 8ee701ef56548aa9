"""Where the time of the BGZF writer goes on the GPU: the write path's
step-0 profile.

    python -m spark_bam_tpu_torch.benchmarks.profile_write [--mib 1024]
        [--spec mode=off --spec mode=stored --spec mode=fixed
         --spec mode=stored,lanes=128 --spec mode=fixed,lanes=128]

Writes a synthetic BAM (``--mib`` MiB uncompressed, seed 7) under the
package's ``_build/`` directory, inflates its uncompressed stream with
host zlib, and writes that stream again through ``bam.writer.BgzfWriter``
once per deflate spec (``lanes=16`` is the default), timing:

- host staging: ``pack_lanes`` into pinned memory (host clock);
- the H2D copy and each kernel: CUDA events around them, per dispatch
  (the card's time between the events, host gaps included: a dispatch
  is launch-bound; ``graph_ms`` gives a kernel's device time alone);
- the wait for the kernel at ``materialize`` and the D2H copy (host
  clock);
- member assembly: framing the members (host clock; under ``mode=off``
  this is host zlib itself);
- the file write (host clock);
- what is left: the writer cutting the stream into payloads.

and counts the dispatches, the kernel launches a dispatch and the stored
and fixed picks; first, each kernel's device time a launch (``graph_ms``)
on the stream's first 16 and 128 payloads. Prints the card's name and power limit and, last, one
JSON line. ``timed_write`` is the same measurement over any stream, for
the smoke.
"""

from __future__ import annotations

import argparse
import json
import time
from collections import deque
from pathlib import Path

import numpy as np
import torch

from spark_bam_tpu_torch.bam.writer import DEFAULT_BLOCK_PAYLOAD, BgzfWriter
from spark_bam_tpu_torch.compress import kernels as CK
from spark_bam_tpu_torch.compress.codec import (
    DeviceDeflateCodec,
    _check_payloads,
    _Pending,
    make_codec,
)
from spark_bam_tpu_torch.compress.config import DeflateConfig
from spark_bam_tpu_torch.tpu import kernels as K

PHASES = ("stage", "h2d", "kernel", "wait", "d2h", "assemble", "write")
SPECS = ("mode=off", "mode=stored", "mode=fixed", "mode=stored,lanes=128",
         "mode=fixed,lanes=128")


class TimedCodec(DeviceDeflateCodec):
    """``DeviceDeflateCodec`` with its dispatch split by phase: the same
    staging, copies, launch and assembly, with events and clocks between
    them (seconds in ``spent``)."""

    def __init__(self, cfg: DeflateConfig, device, spent: dict):
        super().__init__(cfg, device=device)
        self.spent = spent
        self.dispatches = 0
        self._events: deque = deque()

    def dispatch(self, payloads):
        _check_payloads(payloads)
        dev = self.device
        t0 = time.perf_counter()
        data, lengths, _ = CK.pack_lanes(payloads, pin=True)
        self.spent["stage"] += time.perf_counter() - t0
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        data = data.to(dev, non_blocking=True)
        lengths = lengths.to(dev, non_blocking=True)
        ev[1].record()
        if self.mode == "stored":
            out = (CK.crc32_lanes(data, lengths),)
        else:
            out = CK.deflate_fixed_lanes(data, lengths)
        ev[2].record()
        self.dispatches += 1
        self._events.append(ev)
        return _Pending(payloads, out)

    def materialize(self, pending):
        ev = self._events.popleft()
        t0 = time.perf_counter()
        ev[2].synchronize()
        t1 = time.perf_counter()
        host = [t.cpu().numpy() for t in pending.dev]
        t2 = time.perf_counter()
        members = self._assemble(pending.payloads, host)
        t3 = time.perf_counter()
        self.spent["wait"] += t1 - t0
        self.spent["d2h"] += t2 - t1
        self.spent["assemble"] += t3 - t2
        self.spent["h2d"] += ev[0].elapsed_time(ev[1]) / 1e3
        self.spent["kernel"] += ev[1].elapsed_time(ev[2]) / 1e3
        return members


class _TimedHost:
    """Host zlib with its time counted as member assembly."""

    def __init__(self, codec, spent: dict):
        self.codec, self.spent, self.lanes = codec, spent, codec.lanes
        self.counts = codec.counts
        self.dispatches = 0

    def dispatch(self, payloads):
        t0 = time.perf_counter()
        out = self.codec.dispatch(payloads)
        self.spent["assemble"] += time.perf_counter() - t0
        self.dispatches += 1
        return out

    def materialize(self, pending):
        return pending


class _TimedFile:
    def __init__(self, f, spent: dict):
        self.f, self.spent = f, spent

    def write(self, b) -> None:
        t0 = time.perf_counter()
        self.f.write(b)
        self.spent["write"] += time.perf_counter() - t0

    def flush(self) -> None:
        self.f.flush()


def graph_ms(fn, launches: int = 20, reps: int = 5) -> float:
    """Device time of one ``fn()`` with no host gap between launches:
    ``launches`` calls captured in one CUDA graph, the graph replayed
    between CUDA events (median of ``reps``), divided by ``launches``.
    A tiny kernel timed by events around one call measures the host's
    launch overhead as well; this measures the card alone."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(launches):
            fn()
    g.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        g.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / launches)
    return sorted(times)[len(times) // 2]


def timed_write(stream, spec: str, out_path, device=None,
                block_payload: int = DEFAULT_BLOCK_PAYLOAD,
                chunk: int = 4 << 20) -> dict:
    """Write ``stream`` (bytes-like, the uncompressed stream) to
    ``out_path`` through ``BgzfWriter`` under the deflate ``spec``, fed
    ``chunk`` bytes at a time; returns the wall and its split (seconds),
    the launches, dispatches and picks, and the writer's member table
    (``blocks``)."""
    spent = dict.fromkeys(PHASES, 0.0)
    cfg = DeflateConfig.parse(spec)
    if cfg.enabled:
        codec = TimedCodec(cfg, device, spent)
    else:
        codec = _TimedHost(make_codec(cfg), spent)
    mv = memoryview(stream)
    before = dict(K.LAUNCHES)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with open(out_path, "wb") as f:
        w = BgzfWriter(_TimedFile(f, spent), block_payload, codec=codec)
        for lo in range(0, len(mv), chunk):
            w.write(mv[lo: lo + chunk])
        w.close()
    wall = time.perf_counter() - t0
    launches = {k: K.LAUNCHES[k] - before[k]
                for k in ("crc32_lanes", "deflate_fixed_lanes")}
    split = {k: round(v, 6) for k, v in spent.items()}
    split["writer"] = round(wall - sum(v for k, v in spent.items()
                                       if k not in ("h2d", "kernel")), 6)
    return {
        "spec": spec, "lanes": codec.lanes, "wall_s": round(wall, 6),
        "gb_per_s": round(len(mv) / wall / 1e9, 6), "bytes_in": len(mv),
        "bytes_out": w.bytes_out, "members": len(w.blocks),
        "dispatches": codec.dispatches, "launches": launches,
        "launches_per_dispatch": (round(sum(launches.values())
                                        / codec.dispatches, 6)
                                  if codec.dispatches else 0),
        "picks": {k: codec.counts.get(k, 0) for k in ("stored", "fixed")},
        "split_s": split, "blocks": w.blocks,
    }


def main(argv=None) -> int:
    from spark_bam_tpu_torch.benchmarks.profile_count import _card
    from spark_bam_tpu_torch.benchmarks.synth import synth_bam
    from spark_bam_tpu_torch.bgzf.flat import inflate_blocks
    from spark_bam_tpu_torch.bgzf.index_blocks import blocks_metadata
    from spark_bam_tpu_torch.core.channel import open_channel

    ap = argparse.ArgumentParser(prog="profile_write")
    ap.add_argument("--mib", type=int, default=1024)
    ap.add_argument("--spec", action="append", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_write: needs a CUDA device")
    card = _card()
    print(card, flush=True)
    work = Path(__file__).resolve().parents[1] / "_build" / "profile_write"
    work.mkdir(parents=True, exist_ok=True)
    bam = work / "w.bam"
    synth_bam(bam, args.mib << 20, seed=7)
    with open_channel(bam) as ch:
        stream = inflate_blocks(ch, blocks_metadata(bam)).data
    kernels = {}
    for b in (16, 128):
        payloads = [bytes(stream[i * DEFAULT_BLOCK_PAYLOAD:
                                 (i + 1) * DEFAULT_BLOCK_PAYLOAD])
                    for i in range(b)]
        data, lengths, _ = CK.pack_lanes(payloads, pin=True)
        data, lengths = data.cuda(), lengths.cuda()
        kernels[f"lanes_{b}"] = {
            "crc32_lanes_ms": graph_ms(lambda: CK.crc32_lanes(data, lengths)),
            "deflate_fixed_lanes_ms": graph_ms(
                lambda: CK.deflate_fixed_lanes(data, lengths)),
        }
    print(json.dumps({"kernel_device_ms": kernels}), flush=True)
    runs = []
    try:
        for spec in args.spec or SPECS:
            r = timed_write(stream, spec, work / "out.bgzf")
            r.pop("blocks")
            print(json.dumps(r), flush=True)
            runs.append(r)
    finally:
        for p in work.iterdir():
            p.unlink()
    print(json.dumps({"card": card, "bytes_in": int(np.asarray(stream).size),
                      "kernel_device_ms": kernels, "runs": runs}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
