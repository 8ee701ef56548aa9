"""Runnable serve worker and local pool supervisor for the fabric
(reference ``spark_bam_tpu/fabric/worker.py``).

One worker is one ``SplitService`` accept loop over this process's own
devices. Run it directly (one per host, with the ``torch.distributed``
bring-up of ``parallel/multihost.py``) or let :class:`WorkerPool` launch N
local processes:

    python -m spark_bam_tpu_torch.fabric.worker \\
        --listen tcp:127.0.0.1:0 [--serve SPEC] [--device cpu --devices N] \\
        [--coordinator HOST0:port --num-processes N --process-id K]

The worker serves every visible CUDA device by default and raises without
one; ``--device cpu`` (with ``--devices N`` for an N-entry CPU mesh) serves
from the CPU instead. On CUDA it loads the kernel library before it
announces, so a missing ``nvcc`` or a failed build ends the process before
the announce line. Once listening it prints ONE JSON line on stdout,
``{"fabric_worker": true, "address": "tcp:host:port", ...}``, which is how
the pool (and operators scripting attach mode) learn the bound address
when the listen spec asked for port 0. SIGTERM and SIGINT drain: new work
is refused with a typed ``Draining`` error, in-flight requests and queued
batcher ticks finish unshed, then the process exits. ``SPARK_BAM_JOBS``
sets the worker's job plane (workers that share its ``dir`` resume each
other's jobs), and ``SPARK_BAM_DISK_CHAOS`` installs the disk-fault seam
before the announce.

The mesh is ``local_mesh()`` over this process's devices, never the
global process group: a serving worker answers only its own requests, and
a collective over every process would wait for dispatches the other hosts
never make. A multi-host fabric is one local serving loop per host, with
the router doing the fan-out.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

#: The directory holding the ``spark_bam_tpu_torch`` package: put on a
#: launched worker's ``PYTHONPATH`` so it imports this package from any
#: working directory.
_PKG_PARENT = str(Path(__file__).resolve().parent.parent.parent)

#: How long a drained worker waits for its in-flight requests to finish.
_DRAIN_WAIT_S = 30.0


class PipeReader:
    """Every line of a child's text pipe, read to its end on a daemon
    thread: the child never blocks on a full pipe, and :meth:`wait` looks
    for a line under the caller's deadline even while the child says
    nothing."""

    def __init__(self, stream):
        self.lines: "list[str]" = []
        self.ended = False
        self._cond = threading.Condition()
        threading.Thread(target=self._read, args=(stream,),
                         daemon=True).start()

    def _read(self, stream) -> None:
        try:
            for line in stream:
                with self._cond:
                    self.lines.append(line)
                    self._cond.notify_all()
        except (OSError, ValueError):
            pass                # the owner closed the pipe
        finally:
            with self._cond:
                self.ended = True
                self._cond.notify_all()

    def wait(self, pred, deadline: float) -> "str | None":
        """The first line that ``pred`` holds for, or None once the pipe
        has ended or ``time.monotonic()`` has passed ``deadline``."""
        seen = 0
        with self._cond:
            while True:
                for line in self.lines[seen:]:
                    if pred(line):
                        return line
                seen = len(self.lines)
                left = deadline - time.monotonic()
                if self.ended or left <= 0:
                    return None
                self._cond.wait(left)


def _is_announce(line: str) -> bool:
    try:
        obj = json.loads(line)
    except ValueError:
        return False
    return isinstance(obj, dict) and bool(obj.get("fabric_worker"))


def _worker_devices(device: "str | None", devices: int):
    """The worker's mesh entries: ``devices`` copies of ``device``, the
    first ``devices`` CUDA devices, or (both unset) every CUDA device."""
    import torch

    if device is None:
        if not devices:
            return None
        return [torch.device("cuda", i) for i in range(devices)]
    return [device] * max(1, devices)


def serve_worker(
    listen: str = "tcp:127.0.0.1:0",
    devices: int = 0,
    serve: str = "",
    columnar: str = "",
    device: "str | None" = None,
    coordinator: "str | None" = None,
    num_processes: int = 1,
    process_id: int = 0,
    init_file: "str | None" = None,
    backend: "str | None" = None,
) -> int:
    """Bring up one serve worker and block until SIGTERM-drained."""
    import dataclasses

    import torch

    from spark_bam_tpu_torch import obs
    from spark_bam_tpu_torch.core.config import Config
    from spark_bam_tpu_torch.core.faults import maybe_install_disk_chaos_from_env
    from spark_bam_tpu_torch.obs import flight
    from spark_bam_tpu_torch.parallel.mesh import init_distributed, local_mesh
    from spark_bam_tpu_torch.serve.server import ServerThread
    from spark_bam_tpu_torch.serve.service import SplitService
    from spark_bam_tpu_torch.serve.shm import sweep_orphans

    mesh_devices = _worker_devices(device, devices)
    on_cpu = device is not None and torch.device(device).type == "cpu"
    if num_processes > 1 and not on_cpu and torch.cuda.is_available():
        # One card a process unless the devices were named.
        if mesh_devices is None:
            card = process_id % torch.cuda.device_count()
            torch.cuda.set_device(card)
            mesh_devices = [torch.device("cuda", card)]
    # Resolved before anything else: without CUDA (and without --device
    # cpu) this raises, and the process ends before it announces.
    mesh = local_mesh(mesh_devices)
    if mesh.devices[0].type == "cuda":
        from spark_bam_tpu_torch.kernels import build

        build.load()   # a missing nvcc or a failed build raises here
    if num_processes > 1:
        init_distributed(coordinator, num_processes, process_id,
                         backend=backend, init_file=init_file,
                         device_type=mesh.devices[0].type)
    # A live registry: the stats op's split_resolutions (the per-worker
    # warm-tier proof) reads it.
    if obs.registry() is None:
        obs.configure()
    # Disk-fault chaos rides the environment into pool workers as fabric
    # chaos rides SPARK_BAM_FABRIC: every worker injects the same seeded
    # schedule, and the flight context names it.
    maybe_install_disk_chaos_from_env()

    config = Config.from_env()
    if serve:
        config = dataclasses.replace(config, serve=serve)
    if columnar:
        config = dataclasses.replace(config, columnar=columnar)
    chaos_spec = config.fabric_config.chaos
    if chaos_spec:
        # Under a chaos run (SPARK_BAM_FABRIC carries chaos=SEED:SPEC) the
        # worker's own dumps name the seed too.
        flight.set_context(chaos=chaos_spec)
    # A SIGKILLed predecessor cannot unlink its ring segments; sweep those
    # whose creating pid is dead.
    sweep_orphans()
    service = SplitService(config, mesh=mesh)

    stop = threading.Event()

    def _drain_and_stop(signum, frame):
        flight.record("sigterm", signum=int(signum))
        service.drain()
        stop.set()

    signal.signal(signal.SIGTERM, _drain_and_stop)
    signal.signal(signal.SIGINT, _drain_and_stop)

    srv = ServerThread(service, listen).start()
    addr = srv.address
    spec = (f"unix:{addr}" if isinstance(addr, str)
            else f"tcp:{addr[0]}:{addr[1]}")
    flight.record("worker_start", address=spec, devices=int(mesh.n_local))
    print(json.dumps({
        "fabric_worker": True,
        "address": spec,
        "pid": os.getpid(),
        "process_id": int(process_id),
        "devices": int(mesh.n_local),
    }), flush=True)
    try:
        # A timed wait: the main thread runs the signal handler even when
        # the signal reached another of the process's threads.
        while not stop.wait(0.5):
            pass
        # Drained: let in-flight ticks finish unshed before detaching.
        deadline = time.monotonic() + _DRAIN_WAIT_S
        while (sum(service.gate.inflight().values()) > 0
               and time.monotonic() < deadline):
            time.sleep(0.05)
    except BaseException as exc:
        # The one crash the worker can narrate: dump the ring first.
        flight.dump_auto("crash", extra={"address": spec,
                                         "error": repr(exc)})
        raise
    finally:
        srv.stop()
        service.close()
        flight.dump_auto("drain", extra={"address": spec})
        if num_processes > 1:
            import torch.distributed as dist

            if dist.is_initialized():
                dist.destroy_process_group()
    return 0


class WorkerPool:
    """Launch (or attach to) the fabric's serve workers.

    Launch mode spawns N ``fabric.worker`` subprocesses on this host and
    reads each one's announce line for its bound address; attach mode takes
    the addresses of running workers (other hosts' loops) and supervises
    nothing. ``kill(i, hard=True)`` serves failover runs; ``terminate()``
    SIGTERMs for graceful drains. The chaos layer (``fabric/chaos.py``
    ``ChaosStorm``) adds ``respawn(i)`` (relaunch a killed worker on its
    original port: the router's link re-probes the same address and
    reinstates it) and ``wedge(i)`` / ``unwedge(i)`` (SIGSTOP / SIGCONT: the
    wedged worker keeps every socket open while answering nothing, which
    only a probe timeout can detect).

    ``device`` and ``devices`` are the workers' ``--device`` and
    ``--devices`` (default: every visible CUDA device, and a worker
    without CUDA exits before announcing).
    """

    def __init__(self, workers: int = 3, devices: int = 0, serve: str = "",
                 columnar: str = "", attach: "list[str] | None" = None,
                 env: "dict | None" = None, stderr=None,
                 device: "str | None" = None):
        self.workers = int(workers)
        self.devices = int(devices)
        self.device = device
        self.serve = serve
        self.columnar = columnar
        self.attach = list(attach or [])
        self.env = env
        self.stderr = stderr
        self.procs: list = []
        self.addresses: "list[str]" = []

    def _spawn(self, listen: str):
        env = dict(os.environ if self.env is None else self.env)
        # The child finds this package from any working directory.
        env["PYTHONPATH"] = os.pathsep.join(
            [_PKG_PARENT] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH")
                             else []))
        # -c (not -m): runpy would import the fabric package first and
        # warn about the worker module being re-executed as __main__.
        cmd = [sys.executable, "-c",
               "import sys; from spark_bam_tpu_torch.fabric.worker import "
               "main; sys.exit(main(sys.argv[1:]))",
               "--listen", listen]
        if self.device is not None:
            cmd += ["--device", str(self.device)]
        if self.devices:
            cmd += ["--devices", str(self.devices)]
        if self.serve:
            cmd += ["--serve", self.serve]
        if self.columnar:
            cmd += ["--columnar", self.columnar]
        return subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=self.stderr,
            env=env, text=True,
        )

    def start(self, timeout_s: float = 120.0) -> "list[str]":
        if self.attach:
            self.addresses = list(self.attach)
            return self.addresses
        for _ in range(self.workers):
            self.procs.append(self._spawn("tcp:127.0.0.1:0"))
        deadline = time.monotonic() + timeout_s
        try:
            for p in self.procs:
                line = self._read_announce(p, deadline)
                self.addresses.append(line["address"])
        except BaseException:
            self.terminate(timeout_s=10.0)
            raise
        return self.addresses

    @staticmethod
    def _read_announce(proc, deadline: float) -> dict:
        # The worker prints exactly one JSON line once it is listening;
        # anything else on stdout before it (warnings) is skipped.
        line = PipeReader(proc.stdout).wait(_is_announce, deadline)
        if line is not None:
            return json.loads(line)
        try:
            proc.wait(timeout=max(0.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            raise TimeoutError(
                "fabric worker did not announce in time") from None
        raise RuntimeError(
            f"fabric worker exited rc={proc.returncode} before announcing "
            "its address"
        )

    def kill(self, i: int, hard: bool = False) -> None:
        p = self.procs[i]
        if p.poll() is None:
            p.send_signal(signal.SIGKILL if hard else signal.SIGTERM)

    def respawn(self, i: int, timeout_s: float = 120.0) -> str:
        """Relaunch worker ``i`` on its original port. The router's link for
        that address stays in place; its health monitor reinstates the
        worker on the first successful re-probe."""
        old = self.procs[i]
        if old.poll() is None:
            old.kill()
        old.wait(timeout=timeout_s)
        if old.stdout is not None:
            old.stdout.close()
        addr = self.addresses[i]
        deadline = time.monotonic() + timeout_s
        while True:
            # The dying process may hold the port through TCP teardown;
            # retry the bind until the OS releases it.
            proc = self._spawn(addr)
            try:
                line = self._read_announce(proc, deadline)
                break
            except RuntimeError:
                proc.wait(timeout=10)
                if proc.stdout is not None:
                    proc.stdout.close()
                if time.monotonic() >= deadline:
                    raise
                time.sleep(0.2)
        self.procs[i] = proc
        if line["address"] != addr:
            raise RuntimeError(
                f"respawned worker bound {line['address']}, wanted {addr}"
            )
        return addr

    def wedge(self, i: int) -> None:
        """SIGSTOP worker ``i``: sockets stay open, nothing answers."""
        p = self.procs[i]
        if p.poll() is None:
            p.send_signal(signal.SIGSTOP)

    def unwedge(self, i: int) -> None:
        p = self.procs[i]
        if p.poll() is None:
            p.send_signal(signal.SIGCONT)

    def terminate(self, timeout_s: float = 30.0) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.send_signal(signal.SIGCONT)   # a wedged worker must drain
                p.terminate()
        deadline = time.monotonic() + timeout_s
        for p in self.procs:
            left = max(0.1, deadline - time.monotonic())
            try:
                p.wait(timeout=left)
            except Exception:
                p.kill()
                p.wait(timeout=10)
        for p in self.procs:
            if p.stdout is not None:
                p.stdout.close()

    def __enter__(self) -> "WorkerPool":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.terminate()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m spark_bam_tpu_torch.fabric.worker",
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--listen", default="tcp:127.0.0.1:0",
                    help="accept-loop address (tcp:host:port or unix:path; "
                         "port 0 binds an ephemeral port, announced on "
                         "stdout)")
    ap.add_argument("--device", default=None,
                    help="torch device to serve from (default: every "
                         "visible CUDA device; cpu for the plain versions)")
    ap.add_argument("--devices", type=int, default=0,
                    help="mesh entries: N copies of --device, or the first "
                         "N CUDA devices (0: every CUDA device, or one "
                         "entry of --device)")
    ap.add_argument("--serve", default="", help="ServeConfig spec override")
    ap.add_argument("--columnar", default="",
                    help="ColumnarConfig spec override")
    ap.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                    help="torch.distributed TCP rendezvous of process 0")
    ap.add_argument("--init-file", default=None,
                    help="rendezvous through this shared file instead")
    ap.add_argument("--num-processes", type=int, default=1)
    ap.add_argument("--process-id", type=int, default=0)
    a = ap.parse_args(argv)
    return serve_worker(
        listen=a.listen, devices=a.devices, serve=a.serve,
        columnar=a.columnar, device=a.device, coordinator=a.coordinator,
        num_processes=a.num_processes, process_id=a.process_id,
        init_file=a.init_file,
    )


if __name__ == "__main__":
    raise SystemExit(main())
