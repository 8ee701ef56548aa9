"""The streaming count of a BAM served over HTTP, beside the local count,
on the GPU host.

    python -m spark_bam_tpu_torch.benchmarks.profile_remote
        [--mib 1024] [--latency-ms 20] [--depths 0,4,16]
        [--bandwidth 1e9]

Writes a synthetic BAM (``--mib`` MiB uncompressed, seed 7) under the
package's ``_build/`` directory and serves it from the in-process fake
object store (``benchmarks/fakestore.py``, loopback only) at
``--latency-ms`` a request. For each ``--remote depth=D`` (0: adaptive)
and each bandwidth (unset, then ``--bandwidth`` bytes/s shared by every
response), a fresh store and one count with device inflate
(``StreamChecker(url).count_reads()``), split into its block-table scan
over the URL (``blocks_metadata``) and the count given that table; with
the wall, the requests, the planned GETs and their bytes, the stalls and
the depth reached. The local count runs before and after the remote ones
(the same process, the same card). Prints the card's name and power limit
and, last, one JSON line.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import torch

from spark_bam_tpu_torch import obs
from spark_bam_tpu_torch.benchmarks.fakestore import FakeObjectStore
from spark_bam_tpu_torch.benchmarks.profile_count import _card
from spark_bam_tpu_torch.benchmarks.synth import synth_bam
from spark_bam_tpu_torch.bgzf.index_blocks import blocks_metadata
from spark_bam_tpu_torch.core.config import Config
from spark_bam_tpu_torch.core.remote_plan import set_remote_config
from spark_bam_tpu_torch.kernels import build
from spark_bam_tpu_torch.tpu.stream_check import StreamChecker


def _count(path, metas=None) -> tuple[int, float]:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n = StreamChecker(path, Config(), metas=metas).count_reads()
    torch.cuda.synchronize()
    return n, time.perf_counter() - t0


def _remote(data: bytes, latency_s: float, depth: int,
            bandwidth: float | None) -> dict:
    set_remote_config(f"depth={depth}")
    reg = obs.configure()
    try:
        with FakeObjectStore(data, key="remote.bam", latency_s=latency_s,
                             bandwidth_Bps=bandwidth) as store:
            url = f"{store.url_base}/bucket/remote.bam"
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            metas = blocks_metadata(url)
            scan_s = time.perf_counter() - t0
            n, count_s = _count(url, metas)
            requests = store.stats["requests"]
        return {
            "depth_spec": depth, "bandwidth_Bps": bandwidth, "reads": n,
            "wall_s": scan_s + count_s, "scan_s": scan_s, "count_s": count_s,
            "requests": requests,
            "gets": reg.counter("remote.gets").value,
            "bytes": reg.counter("remote.bytes").value,
            "stalls": reg.counter("remote.stalls").value,
            "depth_reached": reg.gauge("remote.depth").max or depth or 8,
        }
    finally:
        obs.shutdown()
        set_remote_config(None)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mib", type=int, default=1024)
    ap.add_argument("--latency-ms", type=float, default=20.0)
    ap.add_argument("--depths", default="0,4,16")
    ap.add_argument("--bandwidth", type=float, default=1e9)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_remote needs an NVIDIA GPU")
    card = _card()
    print(card, flush=True)
    build.load()
    work = Path(__file__).resolve().parents[1] / "_build" / "profile_remote"
    work.mkdir(parents=True, exist_ok=True)
    path = work / "remote.bam"
    manifest = synth_bam(path, args.mib << 20, seed=7)
    data = path.read_bytes()
    _count(path)   # warm: the first launches build and load the kernels
    n, local0 = _count(path)
    runs = []
    for bandwidth in (None, args.bandwidth):
        for depth in (int(d) for d in args.depths.split(",")):
            run = _remote(data, args.latency_ms / 1e3, depth, bandwidth)
            if run["reads"] != manifest["reads"]:
                raise AssertionError((run, manifest["reads"]))
            print(json.dumps(run), flush=True)
            runs.append(run)
    n2, local1 = _count(path)
    if not n == n2 == manifest["reads"]:
        raise AssertionError((n, n2, manifest["reads"]))
    print(json.dumps({
        "card": card, "device": torch.cuda.get_device_name(0),
        "file_bytes": len(data), "reads": n, "latency_ms": args.latency_ms,
        "local_s": [local0, local1], "runs": runs,
    }), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
