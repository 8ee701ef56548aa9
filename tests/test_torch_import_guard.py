"""The port and its smoke script import neither JAX nor the JAX package."""

import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

PROBE = r"""
import importlib, pkgutil, sys
import spark_bam_tpu_torch
names = ["spark_bam_tpu_torch"]
for m in pkgutil.walk_packages(spark_bam_tpu_torch.__path__,
                               "spark_bam_tpu_torch."):
    if not m.name.endswith("__main__"):
        importlib.import_module(m.name)
        names.append(m.name)
import chip_smoke
bad = sorted(n for n in sys.modules
             if n in ("jax", "jaxlib", "spark_bam_tpu")
             or n.startswith(("jax.", "jaxlib.", "spark_bam_tpu.")))
print(",".join(names))
print(len(names))
print(bad)
"""

#: Modules the guard must have imported by name: the job plane, the lint
#: suite, the dashboard and the stage-1 kernels' edge cases among them.
MUST_IMPORT = {"spark_bam_tpu_torch.jobs", "spark_bam_tpu_torch.jobs.journal",
               "spark_bam_tpu_torch.jobs.manager",
               "spark_bam_tpu_torch.jobs.runner",
               "spark_bam_tpu_torch.jobs.scrub",
               "spark_bam_tpu_torch.parallel.executor",
               "spark_bam_tpu_torch.cram", "spark_bam_tpu_torch.cram.reader",
               "spark_bam_tpu_torch.cram.writer",
               "spark_bam_tpu_torch.cram.rans",
               "spark_bam_tpu_torch.native.build",
               "spark_bam_tpu_torch.analysis",
               "spark_bam_tpu_torch.analysis.base",
               "spark_bam_tpu_torch.analysis.baseline",
               "spark_bam_tpu_torch.analysis.findings",
               "spark_bam_tpu_torch.analysis.runner",
               "spark_bam_tpu_torch.analysis.runtime_sync",
               "spark_bam_tpu_torch.analysis.rules",
               "spark_bam_tpu_torch.analysis.rules.blocking_async",
               "spark_bam_tpu_torch.analysis.rules.guard_boundary",
               "spark_bam_tpu_torch.analysis.rules.obs_contract",
               "spark_bam_tpu_torch.analysis.rules.shared_state",
               "spark_bam_tpu_torch.obs.dashboard",
               "spark_bam_tpu_torch.utils", "spark_bam_tpu_torch.utils.timer",
               "spark_bam_tpu_torch.benchmarks.harvest",
               "spark_bam_tpu_torch.benchmarks.lane_cases",
               "spark_bam_tpu_torch.benchmarks.lane_checks"}

NATIVE_PROBE = r"""
import sys
from spark_bam_tpu_torch.cram import rans
from spark_bam_tpu_torch.native import build
data = bytes(range(40)) * 50
assert rans.decompress(rans.compress(data, 1)) == data
build.load()
import numpy as np
assert build.eager_check_native(np.zeros(64, np.uint8), np.arange(4),
                                np.array([100], np.int32)).shape == (4,)
assert len(build.inflate_blocks_native(
    np.frombuffer(b"\x03\x00", np.uint8), np.zeros(1, np.int64),
    np.full(1, 2, np.int64), np.zeros(1, np.int64))) == 0
maps = open("/proc/self/maps").read()
print(all(build.library_path(src).name in maps
          for src in (build.RANS_SRC, build.EAGER_SRC, build.ZLIB_SRC)))
print("spark_bam_tpu/native" in maps or "_spark_bam_native" in maps)
print(sorted(n for n in sys.modules if n == "spark_bam_tpu"
             or n.startswith("spark_bam_tpu.")))
"""


def test_port_imports_no_jax():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    names, count, bad = proc.stdout.strip().splitlines()[-3:]
    assert bad == "[]", f"port pulled in {bad}"
    assert int(count) >= 181  # every submodule was imported
    assert MUST_IMPORT <= set(names.split(","))


def test_smoke_script_alone_fails(tmp_path):
    """In a directory holding only chip_smoke.py it must exit non-zero and
    print no result line."""
    (tmp_path / "chip_smoke.py").write_bytes((ROOT / "chip_smoke.py").read_bytes())
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_port_native_code_is_its_own():
    """The rANS decoder, the tokenizer and the host yardstick (the eager
    checker and both inflates) load the port's own libraries, built from
    ``native/*.cpp``, and never the reference's prebuilt one."""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "-c", NATIVE_PROBE], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    ours, theirs, modules = proc.stdout.strip().splitlines()[-3:]
    assert (ours, theirs, modules) == ("True", "False", "[]")
