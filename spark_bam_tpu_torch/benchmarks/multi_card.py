"""The sharded workloads across every card of one host, against one card.

    python -m spark_bam_tpu_torch.benchmarks.multi_card [--mib 1024]

Needs two or more cards. Writes a synthetic BAM (``--mib`` MiB
uncompressed, seed 7) and its ``.records`` sidecar, then:

1. In this process, over ``make_mesh()`` (every card) and over card 0
   alone: ``count_reads_sharded``, ``full_check_summary_sharded`` (K =
   2^17) and ``check_bam_sharded``, each once to warm up (kernel build,
   graph capture) and once timed; the results must be equal (the count
   the generator's, check-bam without a false call) and the walls are
   printed side by side.
2. One worker process per card (``parallel/multihost.py``), joined by
   NCCL through a file rendezvous, counting the BAM in several
   all-reduced steps: every process must hold the generator's count.

Prints each card's name and power limit and, last, one JSON line.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import torch

from spark_bam_tpu_torch import (
    Config,
    check_bam_sharded,
    count_reads_sharded,
    full_check_summary_sharded,
    make_mesh,
)
from spark_bam_tpu_torch.bam.index_records import index_records
from spark_bam_tpu_torch.benchmarks.synth import synth_bam

K_SITES = 1 << 17


def _timed(fn):
    fn()   # warm-up: kernel build, allocator, graph capture
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _same(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if hasattr(a, "shape"):
        return a.shape == b.shape and bool((a == b).all())
    return a == b


def _workers(bam: Path, work: Path, cards: int) -> list[dict]:
    """One NCCL worker per card counting ``bam``; their JSON lines."""
    init = work / "rendezvous"
    argv = [sys.executable, "-m", "spark_bam_tpu_torch.parallel.multihost",
            "--init-file", str(init), "--num-processes", str(cards),
            "--backend", "nccl", "--bam", str(bam),
            "--chunk-bytes", str(32 << 20)]
    root = Path(__file__).resolve().parent.parent.parent
    procs = [subprocess.Popen([*argv, "--process-id", str(pid)], cwd=root,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for pid in range(cards)]
    try:
        outs = [p.communicate(timeout=900)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for p, out in zip(procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"NCCL worker failed:\n{out[-3000:]}")
    return [json.loads(out.strip().splitlines()[-1]) for out in outs]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mib", type=int, default=1024)
    args = ap.parse_args(argv)
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < 2:
        raise SystemExit(f"multi_card needs two or more cards, found {cards}")
    names = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(names, flush=True)
    work = Path(__file__).resolve().parent.parent / "_build" / "multi_card"
    work.mkdir(parents=True, exist_ok=True)
    try:
        bam = work / "multi.bam"
        manifest = synth_bam(bam, args.mib << 20, seed=7)
        index_records(bam)
        reads = manifest["reads"]
        meshes = {"all": make_mesh(), "one": make_mesh(["cuda:0"])}
        result = {"cards": names.splitlines(), "mib": args.mib,
                  "reads": reads}
        got = {}
        for label, mesh in meshes.items():
            walls = {}
            got[label] = {}
            for name, fn in (
                ("count", lambda: count_reads_sharded(bam, Config(),
                                                      mesh=mesh)),
                ("full_check", lambda: full_check_summary_sharded(
                    bam, Config(), mesh=mesh, k_positions=K_SITES)),
                ("check_bam", lambda: check_bam_sharded(bam, Config(),
                                                        mesh=mesh)),
            ):
                got[label][name], walls[name] = _timed(fn)
            result[f"{label}_s"] = walls
            print(f"{label} ({mesh.n_local} card(s)): {walls}", flush=True)
        a, b = got["all"], got["one"]
        if a["count"] != reads or b["count"] != reads:
            raise AssertionError((a["count"], b["count"], reads))
        if a["full_check"].pop("devices") != cards or b["full_check"].pop(
                "devices") != 1 or not _same(a["full_check"],
                                             b["full_check"]):
            raise AssertionError("full-check across the cards differs")
        if a["check_bam"].pop("devices") != cards or b["check_bam"].pop(
                "devices") != 1 or a["check_bam"] != b["check_bam"] or (
                a["check_bam"]["false_positives"]
                or a["check_bam"]["false_negatives"]):
            raise AssertionError((a["check_bam"], b["check_bam"]))
        t0 = time.perf_counter()
        outs = _workers(bam, work, cards)
        for pid, o in enumerate(outs):
            if not (o["process_id"] == pid and o["backend"] == "nccl"
                    and o["count"] == reads and o["chunks"] >= 2):
                raise AssertionError(o)
        result["nccl_workers"] = {"processes": cards,
                                  "steps": outs[0]["chunks"],
                                  "rows": outs[0]["rows"],
                                  "wall_s": time.perf_counter() - t0}
        print(f"NCCL: {cards} processes counted {reads} in "
              f"{outs[0]['chunks']} steps each", flush=True)
        print(json.dumps(result))
    finally:
        shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    main()
