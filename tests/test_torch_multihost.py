"""Two processes of the port's multi-process worker joined through
``torch.distributed`` (gloo, a ``file://`` rendezvous in the test's
directory), two CPU devices each: the synthetic check step's reduced
confusion matrix, and a BAM counted over at least two all-reduced steps
with every process holding the generator's count. Every process must
drive the same number of devices, and an early stop on the
escape-everywhere guard is taken by both processes together. Each run
has its own time limit, so a hung collective fails the test instead of
stalling the suite.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from spark_bam_tpu_torch.benchmarks.synth import synth_bam

ROOT = Path(__file__).resolve().parent.parent
TIMEOUT = 240


def _env():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)   # the port alone, no JAX at start-up
    env["OMP_NUM_THREADS"] = "1"
    return env


def _run(argv: list[str], tmp_path, n: int = 2) -> list[dict]:
    """Run ``n`` processes of ``argv`` (each with its ``--process-id``) and
    return each one's JSON line."""
    init = tmp_path / "rendezvous"
    procs = []
    for pid in range(n):
        log = (tmp_path / f"p{pid}.log").open("w+")
        procs.append((log, subprocess.Popen(
            [sys.executable, *argv, "--init-file", str(init),
             "--num-processes", str(n), "--process-id", str(pid)],
            cwd=ROOT, env=_env(), stdout=log, stderr=subprocess.STDOUT)))
    outs = []
    try:
        for log, p in procs:
            rc = p.wait(timeout=TIMEOUT)
            log.seek(0)
            text = log.read()
            outs.append((rc, text))
    finally:
        for log, p in procs:
            p.kill()
            log.close()
    return outs


def _json(outs) -> list[dict]:
    stats = []
    for rc, text in outs:
        assert rc == 0, text[-3000:]
        stats.append(json.loads(text.strip().splitlines()[-1]))
    return stats


WORKER = ["-m", "spark_bam_tpu_torch.parallel.multihost"]


def test_two_process_check_step(tmp_path):
    stats = _json(_run([*WORKER, "--local-devices", "2"], tmp_path))
    for pid, s in enumerate(stats):
        assert s["ok"], s
        assert (s["processes"], s["process_id"]) == (2, pid)
        assert (s["global_devices"], s["local_devices"]) == (4, 2)
        # Row r holds 40 + r records; trailing noise breaks the last 9
        # chains of every row.
        assert s["true_positives"] == sum(40 + r - 9 for r in range(4))
        assert s["false_negatives"] == 36 and s["false_positives"] == 0
    drop = ("process_id",)
    assert ({k: v for k, v in stats[0].items() if k not in drop}
            == {k: v for k, v in stats[1].items() if k not in drop})


def test_two_process_check_step_exits_clean(tmp_path):
    """The group is torn down in ``_leave``, not at interpreter exit: 24
    exits of the check step (four pairs of processes at a time, each run
    with its own time limit), every one with rc 0 and no abort. Before the
    fix about one exit in 30 died of SIGABRT after printing a correct
    line ("terminate called without an active exception")."""
    rounds, pairs = 3, 4
    for r in range(rounds):
        dirs = [tmp_path / f"r{r}p{k}" for k in range(pairs)]
        procs = []
        for d in dirs:
            d.mkdir()
            for pid in range(2):
                log = (d / f"p{pid}.log").open("w+")
                procs.append((log, subprocess.Popen(
                    [sys.executable, *WORKER, "--local-devices", "2",
                     "--init-file", str(d / "rendezvous"),
                     "--num-processes", "2", "--process-id", str(pid)],
                    cwd=ROOT, env=_env(), stdout=log,
                    stderr=subprocess.STDOUT)))
        try:
            for log, p in procs:
                rc = p.wait(timeout=TIMEOUT)
                log.seek(0)
                text = log.read()
                assert rc == 0, text[-3000:]
                assert "terminate called" not in text
                assert json.loads(text.strip().splitlines()[-1])["ok"]
        finally:
            for log, p in procs:
                p.kill()
                log.close()


def test_two_process_bam_count(tmp_path):
    bam = tmp_path / "multi.bam"
    manifest = synth_bam(bam, 4 << 20)
    stats = _json(_run(
        [*WORKER, "--local-devices", "2", "--bam", str(bam),
         "--row-bytes", str(1 << 20), "--halo", str(256 << 10),
         # One row per device a step: several all-reduced steps.
         "--chunk-bytes", str(8 << 20)], tmp_path))
    for s in stats:
        assert s["ok"] and s["backend"] == "gloo"
        assert s["count"] == manifest["reads"]
        assert s["chunks"] >= 2 and s["escaped"] == 0 and not s["fallback"]
        assert s["tokenize_demotions"] == 0
    assert stats[0]["count"] == stats[1]["count"]
    assert stats[0]["chunks"] == stats[1]["chunks"]


def test_every_process_leaves_together_on_mostly_dirty(tmp_path):
    """Long reads in rows shorter than a 10-record chain escape in every
    step:
    the escape-everywhere guard stops both processes at the same step (it
    reads all-reduced totals) and both resolve the exact count through
    the whole-file path."""
    bam = tmp_path / "long.bam"
    manifest = synth_bam(bam, 2 << 20, seed=9, unit_reads=8,
                         read_len=(60_000, 110_000))
    stats = _json(_run(
        [*WORKER, "--local-devices", "1", "--bam", str(bam),
         "--row-bytes", str(256 << 10), "--halo", str(16 << 10),
         "--chunk-bytes", "1"], tmp_path))
    for s in stats:
        assert s["count"] == manifest["reads"]
        assert s["fallback"] and s["escaped"] > 0
    assert stats[0]["chunks"] == stats[1]["chunks"] == 4
    assert stats[0]["escaped"] == stats[1]["escaped"]


UNEVEN = r"""
import sys
from spark_bam_tpu_torch.parallel.mesh import init_distributed, make_mesh
pid = int(sys.argv[1])
init_distributed(init_file=sys.argv[2], num_processes=2, process_id=pid,
                 device_type="cpu", timeout_s=120)
try:
    make_mesh(["cpu"] * (pid + 1))
except ValueError as e:
    print("refused:", e)
"""


def test_uneven_process_layout_raises(tmp_path):
    init = tmp_path / "rendezvous"
    procs = [subprocess.Popen(
        [sys.executable, "-c", UNEVEN, str(pid), str(init)], cwd=ROOT,
        env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for pid in range(2)]
    try:
        outs = [p.communicate(timeout=TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
        assert "refused: every process must drive the same number" in out
        assert "[1, 2]" in out


@pytest.mark.parametrize("argv", [["--backend", "mpi"]])
def test_worker_refuses_a_bad_backend(argv, tmp_path):
    proc = subprocess.run(
        [sys.executable, *WORKER, "--local-devices", "1", *argv,
         "--init-file", str(tmp_path / "r"), "--num-processes", "2"],
        cwd=ROOT, env=_env(), capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and "invalid choice" in proc.stderr
