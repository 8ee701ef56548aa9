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

#: Modules the guard must have imported by name: the job plane among them.
MUST_IMPORT = {"spark_bam_tpu_torch.jobs", "spark_bam_tpu_torch.jobs.journal",
               "spark_bam_tpu_torch.jobs.manager",
               "spark_bam_tpu_torch.jobs.runner",
               "spark_bam_tpu_torch.jobs.scrub",
               "spark_bam_tpu_torch.parallel.executor"}


def test_port_imports_no_jax():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    names, count, bad = proc.stdout.strip().splitlines()[-3:]
    assert bad == "[]", f"port pulled in {bad}"
    assert int(count) >= 50   # every submodule was imported
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
