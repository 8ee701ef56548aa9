"""Multi-process sharded checking over ``torch.distributed``: bring-up and
a runnable worker (reference ``spark_bam_tpu/parallel/multihost.py``).

One process per host (or per card), joined through ``torch.distributed``;
each feeds its own rows and the step totals ride ``dist.all_reduce``. Run
one of these per process, with the same command and a distinct
``--process-id`` (process 0's host is the coordinator):

    python -m spark_bam_tpu_torch.parallel.multihost \\
        --coordinator HOST0:29500 --num-processes N --process-id K [--bam PATH]

A multi-process CUDA worker drives the card ``process_id % cards`` (NCCL by
default, one card per process; ``--backend gloo`` lets two processes
share a card). ``--local-devices N`` drives N CPU devices instead (gloo),
and ``--init-file PATH`` rendezvouses through a shared file instead of
TCP: ``--init-file /tmp/rdv --num-processes 2 --local-devices 2`` on one
machine is the CPU rehearsal the tests run.

Without ``--bam`` the worker checks a deterministic synthetic batch (one
window per global device, its content varying per window) and prints the
reduced confusion matrix as one JSON line; with ``--bam`` it counts the
file's reads (``count_reads_sharded``), each process inflating only its
own block range. Every process prints its line.

With ``--serve LISTEN`` the process is a fabric worker instead: after the
``torch.distributed`` bring-up it runs one serving loop
(``fabric/worker.py`` ``serve_worker``) over this process's local devices,
never the global mesh, listening on LISTEN until SIGTERM drains it; it
announces its address as one JSON line. Point a fabric router at every
process's address (``fabric --attach ADDR ...``). ``--serve-spec`` is the
loop's ServeConfig spec.
"""

from __future__ import annotations

import argparse
import gc
import json
import struct

import numpy as np
import torch
import torch.distributed as dist

from spark_bam_tpu_torch.core.config import Config
from spark_bam_tpu_torch.parallel.mesh import (
    init_distributed,
    make_mesh,
    mesh_steps,
    release_mesh_steps,
)
from spark_bam_tpu_torch.parallel.stream_mesh import count_reads_sharded
from spark_bam_tpu_torch.tpu.checker import PAD

RECORD_NOISE = 1024


def example_window(w: int, n_records: int = 50, seed: int = 7):
    """A small synthetic BAM-record stream in a flat window buffer.

    Returns (padded, n, record_starts): ``n`` counts the records plus a
    trailing burst of noise bytes (which breaks the final records' chains:
    they become false negatives against the raw record starts), and
    ``record_starts`` is the ground truth."""
    rng = np.random.default_rng(seed)
    buf = bytearray()
    starts = []
    for i in range(n_records):
        starts.append(len(buf))
        name = f"read{i}".encode() + b"\x00"
        seq_len = 8
        body = (
            struct.pack(
                "<iiBBHHHiiii",
                0,                        # refID
                1000 + i,                 # pos
                len(name), 30, 0,         # l_read_name, mapq, bin
                1, 0,                     # n_cigar, flag
                seq_len, 0, 1000 + i, 0,  # l_seq, next_refID, next_pos, tlen
            )
            + name
            + struct.pack("<I", (seq_len << 4) | 0)
            + bytes((seq_len + 1) // 2)
            + bytes([30] * seq_len)
        )
        buf += struct.pack("<i", len(body)) + body
    n = len(buf)
    padded = np.zeros(w + PAD, dtype=np.uint8)
    padded[:n] = np.frombuffer(bytes(buf), dtype=np.uint8)
    padded[n: n + RECORD_NOISE] = rng.integers(0, 256, RECORD_NOISE,
                                               dtype=np.uint8)
    return padded, np.int32(n + RECORD_NOISE), np.array(starts,
                                                        dtype=np.int64)


def _join(coordinator, num_processes: int, process_id: int,
          local_devices: int, init_file, backend):
    """This process's devices, after joining the group (when there is more
    than one process), and the mesh over them."""
    if local_devices:
        devices = ["cpu"] * local_devices
    elif num_processes > 1:
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass --local-devices N "
                               "for a CPU rehearsal")
        card = process_id % torch.cuda.device_count()
        torch.cuda.set_device(card)
        devices = [torch.device("cuda", card)]
    else:
        devices = None
    if num_processes > 1:
        init_distributed(coordinator, num_processes, process_id,
                         backend=backend, init_file=init_file,
                         device_type="cpu" if local_devices else "cuda")
    return make_mesh(devices)


def _leave(together: bool = True) -> None:
    """Leave the group and tear it down while the interpreter is whole.
    After a clean run (``together``) a barrier keeps one process from
    closing its gloo pairs while the other is still in the last
    collective. Dropping the cached steps' hold on the group frees it
    (and joins its threads) once the caller's mesh goes, before the
    process exits: held by the process-wide step cache, it was torn down
    at interpreter exit, racing the peer's teardown, and that aborted the
    process now and then ("terminate called without an active
    exception")."""
    if not dist.is_initialized():
        return
    group = dist.group.WORLD
    if together:
        dist.barrier()
    release_mesh_steps(group)
    del group
    dist.destroy_process_group()
    gc.collect()


def run_worker(coordinator: str | None, num_processes: int, process_id: int,
               local_devices: int = 0, window: int = 1 << 16,
               init_file=None, backend: str | None = None) -> dict:
    """Join the group, run one check step over a global batch (one window
    per global device), return the reduced stats."""
    ok = False
    try:
        mesh = _join(coordinator, num_processes, process_id, local_devices,
                     init_file, backend)
        n_global, n_local = mesh.n_global, mesh.n_local
        # Window contents vary per global row (40 + row records), so the
        # reduction provably mixes every process's distinct rows.
        row0 = mesh.process_id * n_local
        windows = np.zeros((n_local, window + PAD), dtype=np.uint8)
        ns = np.zeros(n_local, dtype=np.int32)
        truth = np.zeros((n_local, window), dtype=bool)
        for j in range(n_local):
            padded, n, starts = example_window(window, 40 + row0 + j)
            windows[j] = padded
            ns[j] = n
            truth[j, starts] = True
        lengths = np.zeros(1024, dtype=np.int32)
        lengths[0] = 249_250_621
        step = mesh_steps(mesh).check_step()
        _, _, totals = step(mesh.shard(windows), ns, np.ones(n_local, bool),
                            mesh.shard(truth), lengths, 1)
        ok = True
    finally:
        _leave(together=ok)
    # Every row counts its records but the 9 chains the trailing noise
    # breaks (a boundary needs 10 consecutive records).
    exp_tp = sum(40 + r - 9 for r in range(n_global))
    exp_fn = 9 * n_global
    return {
        "processes": mesh.num_processes,
        "process_id": mesh.process_id,
        "global_devices": n_global,
        "local_devices": n_local,
        "true_positives": int(totals[0]),
        "false_positives": int(totals[1]),
        "false_negatives": int(totals[2]),
        "true_negatives": int(totals[3]),
        "positions": int(totals[4]),
        "expected_tp": exp_tp,
        "expected_fn": exp_fn,
        "ok": int(totals[0]) == exp_tp and int(totals[2]) == exp_fn
        and int(totals[1]) == 0,
    }


def run_worker_bam(path: str, coordinator: str | None, num_processes: int,
                   process_id: int, local_devices: int = 0,
                   row_bytes: int = 8 << 20, halo: int = 4 << 20,
                   chunk_bytes: int = 192 << 20, init_file=None,
                   backend: str | None = None) -> dict:
    """Real-data multi-process count-reads: each process inflates only its
    own block range of ``path`` (seam halos read from the following
    blocks), checks its rows on its devices, and the count is all-reduced:
    ``count_reads_sharded`` with this process's mesh."""
    stats: dict = {}
    ok = False
    try:
        mesh = _join(coordinator, num_processes, process_id, local_devices,
                     init_file, backend)
        count = count_reads_sharded(
            path, Config(), mesh=mesh, window_uncompressed=row_bytes,
            halo=halo, chunk_bytes=chunk_bytes, stats_out=stats)
        ok = True
    finally:
        _leave(together=ok)
    return {
        "mode": "bam",
        "path": str(path),
        "processes": mesh.num_processes,
        "process_id": mesh.process_id,
        "backend": mesh.backend,
        "global_devices": mesh.n_global,
        "local_devices": mesh.n_local,
        "rows": stats.get("rows", 0),
        "chunks": stats.get("steps", 0),
        "count": int(count),
        "escaped": int(stats.get("escapes", 0)),
        "fallback": bool(stats.get("fallback", False)),
        "tokenize_demotions": int(stats.get("tokenize_demotions", 0)),
        "ok": True,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m spark_bam_tpu_torch.parallel.multihost",
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                    help="TCP rendezvous of process 0")
    ap.add_argument("--init-file", default=None,
                    help="rendezvous through this shared file instead")
    ap.add_argument("--num-processes", type=int, default=1)
    ap.add_argument("--process-id", type=int, default=0)
    ap.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                    help="default: nccl on CUDA, gloo on CPU devices")
    ap.add_argument("--local-devices", type=int, default=0,
                    help="drive N CPU devices (rehearsal); 0 = CUDA")
    ap.add_argument("--bam", default=None,
                    help="shard this BAM by block ranges and count reads")
    ap.add_argument("--row-bytes", type=int, default=8 << 20,
                    help="uncompressed bytes owned per row (--bam)")
    ap.add_argument("--halo", type=int, default=4 << 20,
                    help="lookahead bytes per row (--bam)")
    ap.add_argument("--chunk-bytes", type=int, default=192 << 20,
                    help="row bytes per step and process (--bam)")
    ap.add_argument(
        "--serve", default=None, metavar="LISTEN",
        help="fabric-worker mode: after the bring-up, serve this process's "
             "local devices on LISTEN (tcp:host:port or unix:path) until "
             "SIGTERM drains it; point the fabric router at every "
             "process's announced address")
    ap.add_argument("--serve-spec", default="",
                    help="ServeConfig spec of the serving loop (--serve)")
    a = ap.parse_args(argv)
    if a.serve:
        from spark_bam_tpu_torch.fabric.worker import serve_worker

        return serve_worker(
            listen=a.serve, serve=a.serve_spec,
            device="cpu" if a.local_devices else None,
            devices=a.local_devices, coordinator=a.coordinator,
            num_processes=a.num_processes, process_id=a.process_id,
            init_file=a.init_file, backend=a.backend)
    common = dict(local_devices=a.local_devices, init_file=a.init_file,
                  backend=a.backend)
    if a.bam:
        stats = run_worker_bam(a.bam, a.coordinator, a.num_processes,
                               a.process_id, row_bytes=a.row_bytes,
                               halo=a.halo, chunk_bytes=a.chunk_bytes,
                               **common)
    else:
        stats = run_worker(a.coordinator, a.num_processes, a.process_id,
                           **common)
    print(json.dumps(stats), flush=True)
    return 0 if stats["ok"] else 1

if __name__ == "__main__":
    raise SystemExit(main())
