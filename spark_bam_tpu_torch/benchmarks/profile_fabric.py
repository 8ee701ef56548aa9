"""What the fabric router adds to a count's latency under load on the GPU.

    python -m spark_bam_tpu_torch.benchmarks.profile_fabric [--rounds 8]
        [--mib 40]

Writes a synthetic BAM (``--mib`` MiB uncompressed, seed 8) under the
package's ``_build/`` directory and serves it with ``chip_smoke.py``'s
service A spec from two workers on the card: one in this process
(``SplitService`` behind a ``ServerThread``) and one ``WorkerPool`` process.
The file's rendezvous winner is the in-process worker. Four ways in, each
warmed with one count:

- ``direct``: the in-process worker's own accept loop;
- ``router_inproc``: a ``Router`` in this process over both workers;
- ``router_proc``: the ``fabric`` command in a process of its own,
  attached to both workers;
- ``direct_pool``: the pool worker's accept loop (cold on its first count).

Each round drives 8 clients x 3 counts through every way, in an order
that rotates each round. Prints each turn's wall, then per way the mean
turn, p50, p90, p99 and max latency (client clock, nearest rank) and the
8 slowest counts; then both routers' counters and the count requests each
worker served; the card's name and power limit first and, last, one JSON
line.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import signal
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

from spark_bam_tpu_torch.benchmarks.profile_count import _card
from spark_bam_tpu_torch.benchmarks.synth import synth_bam
from spark_bam_tpu_torch.core.config import Config

SPEC_A = "window=24MB,halo=4MB,batch=4,tick=2,workers=4,cache=2GB"
FABRIC = ("probe=200,probe_timeout=2000,eject=100,eject_max=400,"
          "holddown=400,autoscale=600000,budget=64,budget_rate=1")
PKG_PARENT = Path(__file__).resolve().parents[2]


def _pct(samples: list, q: float) -> float:
    s = sorted(samples)
    return s[min(len(s) - 1, round(q * (len(s) - 1)))]


def _turn(address: str, path: Path, want: int) -> "tuple[list, float]":
    """8 clients x 3 counts of ``path``: every latency (ms) and the wall."""
    from spark_bam_tpu_torch.serve import ServeClient

    def client(_):
        lat = []
        with ServeClient(address) as c:
            for _ in range(3):
                t0 = time.perf_counter()
                n = c.request("count", path=str(path))["count"]
                lat.append((time.perf_counter() - t0) * 1e3)
                if n != want:
                    raise RuntimeError(f"count {n} != {want}")
        return lat

    t0 = time.perf_counter()
    with ThreadPoolExecutor(8) as ex:
        lat = [x for r in ex.map(client, range(8)) for x in r]
    return lat, time.perf_counter() - t0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--mib", type=int, default=40)
    a = ap.parse_args(argv)

    from spark_bam_tpu_torch.fabric import (
        Router,
        WorkerPool,
        rendezvous_weight,
    )
    from spark_bam_tpu_torch.fabric.worker import PipeReader
    from spark_bam_tpu_torch.kernels import build
    from spark_bam_tpu_torch.serve import (
        ServeClient,
        ServerThread,
        SplitService,
    )

    card = _card()
    print(card, flush=True)
    build.load()
    work = PKG_PARENT / "spark_bam_tpu_torch" / "_build" / "profile_fabric"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    bam = work / "small.bam"
    want = synth_bam(bam, a.mib << 20, seed=8)["reads"]
    env = dict(os.environ, PYTHONPATH=str(PKG_PARENT))

    svc = SplitService(Config(serve=SPEC_A))
    srv = ServerThread(svc, "tcp:127.0.0.1:0").start()
    pool = WorkerPool(workers=1, serve=SPEC_A, env=env)
    rsrv = proc = None
    try:
        pool_addr = pool.start(timeout_s=300)[0]
        in_addr = "tcp:%s:%d" % srv.address
        in_wid = max(("w0", "w1"),
                     key=lambda w: rendezvous_weight(w, str(bam)))
        addrs = ([in_addr, pool_addr] if in_wid == "w0"
                 else [pool_addr, in_addr])
        router = Router(addrs, config=Config(fabric=FABRIC))
        rsrv = ServerThread(
            router, f"unix:{os.path.relpath(work / 'r.sock')}").start()
        sock = os.path.relpath(work / "p.sock")
        proc = subprocess.Popen(
            [sys.executable, "-m", "spark_bam_tpu_torch", "fabric",
             "--attach", addrs[0], "--attach", addrs[1], "--fabric", FABRIC,
             "--listen", f"unix:{sock}"],
            env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
            text=True)
        err = PipeReader(proc.stderr)
        if err.wait(lambda x: "routing on" in x,
                    time.monotonic() + 120) is None:
            raise RuntimeError("".join(err.lines)[-4000:])
        while not os.path.exists(sock):
            time.sleep(0.05)
        ways = {"direct": in_addr, "router_inproc": rsrv.address,
                "router_proc": f"unix:{sock}", "direct_pool": pool_addr}
        for address in ways.values():
            with ServeClient(address) as c:
                c.request("count", path=str(bam))
        lat = {w: [] for w in ways}
        walls = {w: [] for w in ways}
        order = list(ways)
        for k in range(a.rounds):
            r = k % len(order)
            for w in order[r:] + order[:r]:
                got, wall = _turn(ways[w], bam, want)
                lat[w].extend(got)
                walls[w].append(wall)
                print(f"round {k} {w}: {wall:.3f} s, max {max(got):.1f} ms",
                      flush=True)
        rows = {}
        for w in ways:
            rows[w] = {
                "turn_s": round(statistics.mean(walls[w]), 3),
                "p50_ms": round(_pct(lat[w], 0.5), 1),
                "p90_ms": round(_pct(lat[w], 0.9), 1),
                "p99_ms": round(_pct(lat[w], 0.99), 1),
                "max_ms": round(max(lat[w]), 1),
                "slowest_ms": [round(x, 1) for x in sorted(lat[w])[-8:]],
                "samples": len(lat[w]),
            }
            print(f"{w}: {rows[w]}", flush=True)
        with ServeClient(f"unix:{sock}") as c:
            st = c.request("stats")
        served = {w: v["stats"]["ops"].get("count", {}).get("requests")
                  for w, v in st["workers"].items()}
        counters = {"router_inproc": dict(sorted(router.counters.items())),
                    "router_proc": st["counters"]}
        print(f"router counters {counters}; count requests a worker "
              f"{served} (in-process worker {in_wid})", flush=True)
        proc.send_signal(signal.SIGTERM)
        proc.wait(timeout=60)
    finally:
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        if rsrv is not None:
            rsrv.stop()
        pool.terminate()
        srv.stop()
        svc.close()
        shutil.rmtree(work, ignore_errors=True)
    print(json.dumps({"card": card, "reads": want, "rounds": a.rounds,
                      "ways": rows, "counters": counters,
                      "served": served}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
