"""The port's durable job plane against the JAX package's, exactly.

The pure functions first (``JobsConfig.parse``, the disk-chaos specs and
their roll sequences, ``job_id_of``, the journal's frames, which each
package's ``read_journal`` reads from the other, torn and flipped too, and
``scan_bgzf_members``). Then the runners on the reference tests' fixture
(seed 29, 380-420 records, a checkpoint every 60 records, 4,096-byte
payloads): the port's clean rewrite equals the JAX job's and the port's
plain ``rewrite_bam`` under host zlib and ``mode=fixed`` (the port's plain
lanes on the CPU, JAX's jnp lanes), interrupted at records 1, 59, 60, 61
and 150 it resumes to the same bytes, a job either package started the
other resumes, the transcode's sidecars equal JAX's, and the export
interrupted after frame 3 resumes to JAX's file. Then the manager
(deferrals, preflight, pause on ENOSPC, cancel), the counters against
JAX's for one scenario, the scrubber's summaries and command against
JAX's, the commands (``--durable``, the refusals, no card), and one
``rewrite --durable`` process stopped and killed mid-run. Every comparison
is exact: equal values, equal bytes.
"""

import json
import os
import shutil
import signal
import subprocess
import sys
import time
from dataclasses import asdict
from pathlib import Path

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from spark_bam_tpu import obs as jobs_obs
from spark_bam_tpu.cli.main import main as jax_main
from spark_bam_tpu.core import faults as jfaults
from spark_bam_tpu.core.config import Config as JConfig
from spark_bam_tpu.jobs import journal as jjournal
from spark_bam_tpu.jobs import manager as jmanager
from spark_bam_tpu.jobs import runner as jrunner
from spark_bam_tpu.jobs import scrub as jscrub
from spark_bam_tpu_torch import cli, obs
from spark_bam_tpu_torch.core import faults
from spark_bam_tpu_torch.core.atomic import ResourceExhausted
from spark_bam_tpu_torch.core.config import Config
from spark_bam_tpu_torch.jobs import journal, manager, runner, scrub
from spark_bam_tpu_torch.jobs.journal import (
    Journal,
    JournalError,
    SegmentedOutput,
    _frame,
    read_journal,
)
from spark_bam_tpu_torch.jobs.manager import JobManager, JobsConfig, job_id_of
from spark_bam_tpu_torch.jobs.runner import (
    RUNNERS,
    JobCancelled,
    run_export_job,
    run_rewrite_job,
    run_transcode_job,
)
from spark_bam_tpu_torch.jobs.scrub import scan_bgzf_members, scrub_paths
from spark_bam_tpu_torch.load.api import export as plain_export
from spark_bam_tpu_torch.rewrite import rewrite_bam
from spark_bam_tpu_torch.sbi.format import decode_sbi
from spark_bam_tpu_torch.sbi.store import reset_cache_events
from tests.bam_factories import random_bam
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.jobs

ROOT = Path(__file__).resolve().parent.parent
#: The reference tests' cadence and payload: ~400 records cross several
#: checkpoints.
CKPT = 60
BLOCK = 4096
DEFLATES = ["", "mode=fixed"]


@pytest.fixture(autouse=True)
def clean_env(monkeypatch):
    for var in ("SPARK_BAM_DEFLATE", "SPARK_BAM_CACHE", "SPARK_BAM_CACHE_DIR",
                "SPARK_BAM_SPLIT_SIZE", "SPARK_BAM_METRICS_OUT",
                "SPARK_BAM_JOBS", "SPARK_BAM_DISK_CHAOS",
                "SPARK_BAM_COLUMNAR"):
        monkeypatch.delenv(var, raising=False)


@pytest.fixture(scope="module")
def bam_path(tmp_path_factory):
    p = tmp_path_factory.mktemp("torch_jobs") / "in.bam"
    random_bam(p, seed=29, n_records=(380, 420), read_len=(20, 600))
    return str(p)


@pytest.fixture(scope="module")
def clean(bam_path, tmp_path_factory):
    """deflate spec → the JAX job's clean bytes and result: the oracle of
    every port run."""
    d = tmp_path_factory.mktemp("torch_jobs_clean")
    out = {}
    for i, dspec in enumerate(DEFLATES):
        o = d / f"jax{i}.bam"
        res = jrunner.run_rewrite_job(
            _spec(bam_path, o, dspec), str(d / f"job{i}"), checkpoint=CKPT)
        out[dspec] = {"bytes": o.read_bytes(), "result": res}
    return out


def _spec(bam, out, deflate=""):
    spec = {"op": "rewrite", "path": str(bam), "out": str(out),
            "block_payload": BLOCK, "level": 6}
    if deflate:
        spec["deflate"] = deflate
    return spec


class _TripAt:
    """A cancel flag that trips at its ``n``-th check (one a record or a
    frame): a deterministic stand-in for a kill at a chosen point."""

    def __init__(self, n: int):
        self.left = int(n)

    def is_set(self) -> bool:
        self.left -= 1
        return self.left <= 0


def _wait_state(mgr, jid, states, timeout=30.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        s = mgr.status(jid)
        if s is not None and s["state"] in states:
            return s
        time.sleep(0.02)
    pytest.fail(f"job {jid} never reached {states}: {mgr.status(jid)}")


# ------------------------------------------------------------ pure functions
_JOBS_SPECS = ["", "dir=/tmp/j,ckpt=100,frames=4,mem=0.5,max=3",
               "checkpoint=7, max_active=1", "mem_watermark=1.0",
               "dir=x,frames=1", "nope=1", "checkpoint=0", "mem=1.5",
               "frames", "max=0", "mem=0", "checkpoint=x"]
_CHAOS_SPECS = ["7:enospc=0.05+eio=0.02+short=0.02+torn=0.01+rename=0.1",
                "0:", "3:enospc=1.0", "9: torn = 0.25 ", "x:eio=0.1",
                "1:bogus=1", "1:eio", "2:eio=abc", "-4:rename=0.5"]


def _outcome(fn, arg):
    """("ok", the parsed fields) or ("error", the message)."""
    try:
        got = fn(arg)
    except ValueError as e:
        return ("error", str(e))
    if isinstance(got, tuple):          # parse_disk_chaos: (seed, spec)
        return ("ok", got[0], asdict(got[1]))
    return ("ok", asdict(got))


@pytest.mark.parametrize("kind,spec", [("jobs", s) for s in _JOBS_SPECS]
                         + [("disk", s) for s in _CHAOS_SPECS])
def test_specs_parse_as_jax_does(kind, spec):
    port, jax = ((JobsConfig.parse, jmanager.JobsConfig.parse)
                 if kind == "jobs"
                 else (faults.parse_disk_chaos, jfaults.parse_disk_chaos))
    assert _outcome(port, spec) == _outcome(jax, spec)


def test_config_carries_jobs_and_disk_chaos(monkeypatch):
    assert Config(jobs="checkpoint=123").jobs_config.checkpoint == 123
    assert Config().disk_chaos_config is None
    seed, spec = Config(disk_chaos="9:eio=0.5").disk_chaos_config
    assert (seed, spec.eio) == (9, 0.5)
    monkeypatch.setenv("SPARK_BAM_JOBS", "frames=9")
    monkeypatch.setenv("SPARK_BAM_DISK_CHAOS", "7:torn=0.25")
    cfg = Config.from_env()
    assert cfg.jobs_config.frames == 9
    jseed, jspec = JConfig.from_env().disk_chaos_config
    assert cfg.disk_chaos_config[0] == jseed
    assert asdict(cfg.disk_chaos_config[1]) == asdict(jspec)


def _random_spec(rng) -> dict:
    spec = {"op": str(rng.choice(["rewrite", "export", "transcode"])),
            "path": f"/data/{rng.integers(0, 1 << 40):x}.bam",
            "out": f"/out/{rng.integers(0, 1000)}/o ü.bam"}
    if rng.random() < 0.5:
        spec["block_payload"] = int(rng.integers(1, 0xFF01))
    if rng.random() < 0.5:
        spec["level"] = int(rng.integers(0, 10))
    if rng.random() < 0.3:
        spec["deflate"] = str(rng.choice(["mode=fixed", "mode=stored",
                                          "fixed,lanes=3"]))
    if rng.random() < 0.3:
        spec["index"] = bool(rng.random() < 0.5)
    if rng.random() < 0.3:
        spec["columns"] = (["flag", "pos"] if rng.random() < 0.5
                           else "flag,pos,name")
    if rng.random() < 0.3:
        spec["batch_rows"] = int(rng.integers(1, 100_000))
    return spec


def test_job_id_of_equals_jax():
    rng = np.random.default_rng(15)
    specs = [_random_spec(rng) for _ in range(300)]
    ids = [job_id_of(s) for s in specs]
    assert ids == [jmanager.job_id_of(s) for s in specs]
    assert len(set(ids)) == len({json.dumps(s, sort_keys=True)
                                 for s in specs})
    assert (job_id_of({"op": "rewrite", "path": "x", "out": "y"})
            == job_id_of({"out": "y", "path": "x", "op": "rewrite"}))


@pytest.mark.parametrize("seed", [0, 3, 11, 2**40 + 7])
def test_disk_chaos_rolls_equal_jax(seed):
    spec = "enospc=0.1+eio=0.05+short=0.2+torn=0.3+rename=0.5"
    port = faults.DiskChaosState(*faults.parse_disk_chaos(f"{seed}:{spec}"))
    jax = jfaults.DiskChaosState(*jfaults.parse_disk_chaos(f"{seed}:{spec}"))
    kinds = ["enospc", "eio", "short", "torn", "rename"]
    order = [kinds[i] for i in np.random.default_rng(seed % 1000).integers(
        0, len(kinds), 2000)]
    assert [port.roll(k) for k in order] == [jax.roll(k) for k in order]
    assert port.injected == jax.injected
    assert sum(port.injected.values()) > 0


def test_disk_chaos_file_faults_equal_jax(tmp_path):
    """One seed: the same writes fail, tear and succeed in both seams."""
    spec = "11:eio=0.15+short=0.15+torn=0.1+enospc=0.05"

    def run(mod, path):
        outcomes = []
        with mod.disk_chaos(spec) as state:
            f = mod.wrap_disk(open(path, "wb"))
            for i in range(300):
                try:
                    outcomes.append(f.write(bytes([i % 251]) * (i % 70 + 1)))
                except OSError as e:
                    outcomes.append((e.errno, str(e)))
            f.close()
            return outcomes, dict(state.injected), path.read_bytes()

    assert run(faults, tmp_path / "p.bin") == run(jfaults, tmp_path / "j.bin")
    assert faults.installed_disk_chaos() is None
    assert faults.wrap_disk(sys.stdout) is sys.stdout


def test_disk_replace_fails_by_seed(tmp_path):
    for i in range(4):
        (tmp_path / f"s{i}").write_bytes(b"x")
    got = []
    with faults.disk_chaos("5:rename=0.5"):
        for i in range(4):
            try:
                faults.disk_replace(tmp_path / f"s{i}", tmp_path / f"d{i}")
                got.append(True)
            except OSError:
                got.append(False)
    state = jfaults.DiskChaosState(*jfaults.parse_disk_chaos("5:rename=0.5"))
    assert got == [not state.roll("rename") for _ in range(4)]
    assert [(tmp_path / f"d{i}").exists() for i in range(4)] == got


def test_maybe_install_disk_chaos_from_env():
    try:
        assert faults.maybe_install_disk_chaos_from_env({}) is None
        state = faults.maybe_install_disk_chaos_from_env(
            {"SPARK_BAM_DISK_CHAOS": "4:enospc=0.5"})
        assert faults.installed_disk_chaos() is state
        assert (state.seed, state.spec.enospc) == (4, 0.5)
        from spark_bam_tpu_torch.obs import flight
        assert flight.context()["disk_chaos_spec"] == "4:enospc=0.5"
    finally:
        faults.uninstall_disk_chaos()
    from spark_bam_tpu_torch.obs import flight
    assert "disk_chaos_seed" not in flight.context()


# ------------------------------------------------------------------ journal
_RECORD = st.fixed_dictionaries(
    {"t": st.sampled_from(["spec", "ckpt", "seg", "done", "note", "v9"])},
    optional={"seq": st.integers(0, 1 << 40),
              "msg": st.text(max_size=12),
              "buf": st.binary(max_size=20).map(lambda b: b.hex()),
              "flats": st.lists(st.integers(-5, 1 << 33), max_size=4)})


@settings(max_examples=40, deadline=None, database=None)
@given(records=st.lists(_RECORD, min_size=1, max_size=6),
       cut=st.floats(0, 1), flip=st.floats(0, 1))
def test_journals_cross_read_torn_and_flipped(records, cut, flip, tmp_path_factory):
    d = tmp_path_factory.mktemp("jr")
    pj, jj = Journal.open(d / "p.sbj"), jjournal.Journal.open(d / "j.sbj")
    for r in records:
        pj.append(r)
        jj.append(r)
    pj.close()
    jj.close()
    raw = (d / "p.sbj").read_bytes()
    assert raw == (d / "j.sbj").read_bytes()
    assert raw == b"".join(jjournal._frame(r) for r in records)
    assert read_journal(d / "j.sbj") == jjournal.read_journal(d / "p.sbj")

    def both(path):
        out = []
        for reader in (read_journal, jjournal.read_journal):
            try:
                out.append(reader(path))
            except (JournalError, jjournal.JournalError) as e:
                out.append(("foreign", str(e)))
        return out

    torn = d / "torn.sbj"
    torn.write_bytes(raw[:int(cut * len(raw))])
    a, b = both(torn)
    assert a == b
    flipped = bytearray(raw)
    at = min(int(flip * len(raw)), len(raw) - 1)
    flipped[at] ^= 0xFF
    torn.write_bytes(bytes(flipped))
    a, b = both(torn)
    assert a == b
    # Recovery cuts both packages' files back to the same prefix.
    shutil.copy(torn, d / "torn_j.sbj")
    try:
        Journal.open(torn).close()
        jjournal.Journal.open(d / "torn_j.sbj").close()
        assert torn.read_bytes() == (d / "torn_j.sbj").read_bytes()
    except (JournalError, jjournal.JournalError):
        assert at < 5


def _recs(n=6):
    return [{"t": "spec", "spec": {"n": 0}}] + [
        {"t": "ckpt", "seq": i, "records": (i + 1) * 10} for i in range(n - 2)
    ] + [{"t": "note", "msg": "tail"}]


def test_journal_reopen_unknown_tags_torn_tail_foreign(tmp_path):
    path = tmp_path / "journal.sbj"
    j = Journal.open(path)
    for r in _recs():
        j.append(r)
    j.append({"t": "v99_hologram", "payload": 1})
    assert j.last("ckpt")["seq"] == 3 and j.last("done") is None
    j.close()
    size = path.stat().st_size
    j2 = Journal.open(path)
    assert j2.records == _recs()          # the unknown tag skipped, kept
    j2.close()
    assert path.stat().st_size == size
    with open(path, "ab") as f:
        f.write(b'SBJ1 deadbeef {"t":"ck')     # torn mid-frame
    j3 = Journal.open(path)
    assert path.stat().st_size == size
    j3.append({"t": "done", "result": {"count": 1}})
    j3.close()
    assert jjournal.read_journal(path)[-1] == {"t": "done",
                                               "result": {"count": 1}}
    foreign = tmp_path / "foreign.sbj"
    foreign.write_bytes(b"BAM\x01 somebody else's file\n")
    with pytest.raises(JournalError):
        Journal.open(foreign)
    assert foreign.read_bytes() == b"BAM\x01 somebody else's file\n"


def test_segmented_output(tmp_path, monkeypatch):
    d = tmp_path / "segs"
    segout = SegmentedOutput(d)
    synced = []
    monkeypatch.setattr(journal, "fsync_dir", lambda p: synced.append(p))
    segout.begin(0)
    segout.write(b"alpha-")
    assert segout.commit() == (str(d / "seg-00000"), 6)
    assert synced == [str(d / "seg-00000")]
    segout.begin(1)
    segout.write(b"zz")
    segout.abort()
    assert not any(n.endswith(".part") for n in os.listdir(d))
    segout.begin(1)
    segout.write(b"beta")
    segout.commit()
    (d / "seg-00003").write_bytes(b"cc")       # a gap: not committed work
    (d / "seg-00007.part").write_bytes(b"xxxx")
    assert [os.path.basename(p) for p in segout.committed()] == [
        "seg-00000", "seg-00001"]
    assert segout.discard_parts() == 4
    out = tmp_path / "artifact.bin"
    assert segout.assemble(out) == 10 and out.read_bytes() == b"alpha-beta"
    segout.remove()
    assert segout.committed() == [] and out.read_bytes() == b"alpha-beta"


@pytest.mark.parametrize("spec", ["5:torn=1.0", "6:short=1.0", "2:enospc=1.0",
                                  "8:rename=1.0"])
def test_segment_commit_maps_disk_faults(tmp_path, spec):
    """A torn write passes ``write`` and fails the commit's size check; the
    others fail where they land. Each is a ``ResourceExhausted`` (a pause,
    not a failure) and leaves no segment and no ``.part``."""
    segout = SegmentedOutput(tmp_path / "segs")
    with faults.disk_chaos(spec):
        with pytest.raises(ResourceExhausted):
            segout.begin(0)
            segout.write(b"x" * 100_000)
            segout.commit()
        segout.abort()
    assert segout.committed() == []
    assert not any(n.endswith(".part") for n in os.listdir(tmp_path / "segs"))


def test_journal_append_under_enospc_pauses_and_recovers(tmp_path):
    path = tmp_path / "journal.sbj"
    j = Journal.open(path)
    j.append({"t": "spec", "spec": {}})
    j.close()
    with faults.disk_chaos("1:torn=1.0"):
        j = Journal.open(path)
        j.append({"t": "ckpt", "seq": 0})      # "succeeds", half on disk
        j.close()
    assert read_journal(path) == [{"t": "spec", "spec": {}}]
    with faults.disk_chaos("1:enospc=1.0"):
        j = Journal.open(path)
        with pytest.raises(ResourceExhausted):
            j.append({"t": "ckpt", "seq": 0})
        j.close()
    assert Journal.open(path).records == [{"t": "spec", "spec": {}}]


def test_atomic_file_goes_through_the_seam(tmp_path):
    from spark_bam_tpu_torch.core.atomic import AtomicFile

    with faults.disk_chaos("3:rename=1.0"):
        af = AtomicFile(tmp_path / "a.bin")
        af.f.write(b"data")
        with pytest.raises(OSError):
            af.commit()
        af.abort()
    with faults.disk_chaos("3:enospc=1.0"):
        af = AtomicFile(tmp_path / "a.bin")
        with pytest.raises(OSError):
            af.f.write(b"data")
        af.abort()
    assert os.listdir(tmp_path) == []


def test_cache_enospc_degrades_to_read_only(tmp_path):
    """The ``.sbi`` store's write goes through the seam: ENOSPC latches the
    cache to read-only, as the reference's test shows."""
    from spark_bam_tpu_torch.bgzf.block import Metadata
    from spark_bam_tpu_torch.sbi.format import (
        Fingerprint,
        SbiIndex,
        config_digest,
    )
    from spark_bam_tpu_torch.sbi.store import (
        CacheStore,
        cache_writes_disabled,
        reset_cache_write_degrade,
    )

    idx = SbiIndex(Fingerprint(1000, 2000, 3000, config_digest(Config())),
                   blocks=[Metadata(0, 50, 120)],
                   record_starts=np.array([104], dtype=np.uint64))
    store = CacheStore(cache_dir=str(tmp_path / "cache"))
    reset_cache_write_degrade()
    reg = obs.configure()
    try:
        with faults.disk_chaos("4:enospc=1.0"):
            assert store.store("a.bam", idx) is None
            assert cache_writes_disabled()
            assert store.store("a.bam", idx) is None
        assert reg.counter("cache.write_errors").value == 1
        assert reg.counter("chaos.disk_enospc").value == 1
        reset_cache_write_degrade()
        path = store.store("a.bam", idx)
        assert path is not None and os.path.exists(path)
    finally:
        reset_cache_write_degrade()
        obs.shutdown()


def test_scan_bgzf_members_equals_jax(clean):
    data = clean[""]["bytes"]
    cases = {"clean": data, "truncated": data[:-40], "half": data[:len(data) // 2],
             "tail17": data + b"\x1f" * 17, "empty": b""}
    for at in (0, 3, 11, 17, 30, len(data) // 3, len(data) - 30):
        m = bytearray(data)
        m[at] ^= 0xFF
        cases[f"flip{at}"] = bytes(m)
    bad_bsize = bytearray(data)
    bad_bsize[16:18] = b"\xff\xff"
    cases["bsize"] = bytes(bad_bsize)
    for name, blob in cases.items():
        pm, pf = scan_bgzf_members(blob, name)
        jm, jf = jscrub.scan_bgzf_members(blob, name)
        assert [(m.start, m.compressed_size, m.uncompressed_size) for m in pm
                ] == [(m.start, m.compressed_size, m.uncompressed_size)
                      for m in jm], name
        assert [f.as_dict() for f in pf] == [f.as_dict() for f in jf], name
    assert not scan_bgzf_members(data, "x")[1]


# ----------------------------------------------------------------- runners
@pytest.mark.parametrize("dspec", DEFLATES, ids=["zlib", "fixed"])
def test_rewrite_clean_equals_jax_and_plain(tmp_path, bam_path, clean, dspec):
    out = tmp_path / "out.bam"
    res = run_rewrite_job(_spec(bam_path, out, dspec), str(tmp_path / "job"),
                          checkpoint=CKPT, device="cpu")
    assert out.read_bytes() == clean[dspec]["bytes"]
    assert res == clean[dspec]["result"] | {"path": bam_path,
                                            "out": str(out)}
    assert res["resumed"] is False and res["redone_bytes"] == 0
    plain = tmp_path / "plain.bam"
    rewrite_bam(bam_path, plain, block_payload=BLOCK, level=6,
                deflate=dspec, device="cpu")
    assert plain.read_bytes() == out.read_bytes()
    # The segments are gone and the journal ends with the result.
    assert os.listdir(tmp_path / "job" / "segments") == []
    assert read_journal(tmp_path / "job" / "journal.sbj")[-1] == {
        "t": "done", "result": res}


@pytest.mark.parametrize("kill_at,dspec", [
    (1, ""), (CKPT - 1, ""), (CKPT, ""), (CKPT + 1, ""), (150, ""),
    (CKPT + 1, "mode=fixed"), (150, "mode=fixed")])
def test_rewrite_interrupt_resume_byte_identical(tmp_path, bam_path, clean,
                                                 kill_at, dspec):
    jdir = str(tmp_path / "job")
    out = tmp_path / "out.bam"
    with pytest.raises(JobCancelled):
        run_rewrite_job(_spec(bam_path, out, dspec), jdir, checkpoint=CKPT,
                        cancel=_TripAt(kill_at), device="cpu")
    assert not out.exists()
    ckpts = [r for r in read_journal(Path(jdir) / "journal.sbj")
             if r["t"] == "ckpt"]
    # The journal's seg_bytes are the committed segments' sizes.
    assert [r["seg_bytes"] for r in ckpts] == [
        os.path.getsize(Path(jdir) / "segments" / f"seg-{i:05d}")
        for i in range(len(ckpts))]
    res = run_rewrite_job(_spec(bam_path, out, dspec), jdir, checkpoint=CKPT,
                          device="cpu")
    assert res["resumed"] is (kill_at >= CKPT)
    assert res["count"] == clean[dspec]["result"]["count"]
    assert out.read_bytes() == clean[dspec]["bytes"]


def test_rewrite_repeated_kills_until_done(tmp_path, bam_path, clean):
    jdir = str(tmp_path / "job")
    out = tmp_path / "out.bam"
    res = None
    for _ in range(30):
        try:
            res = run_rewrite_job(_spec(bam_path, out), jdir, checkpoint=CKPT,
                                  cancel=_TripAt(CKPT + 10), device="cpu")
            break
        except JobCancelled:
            continue
    assert res is not None and res["resumed"] is True
    assert out.read_bytes() == clean[""]["bytes"]
    again = run_rewrite_job(_spec(bam_path, out), jdir, checkpoint=CKPT,
                            device="cpu")
    assert again == dict(res, resumed=True, redone_bytes=0)


def test_rewrite_uncovered_segment_dropped(tmp_path, bam_path, clean):
    jdir = str(tmp_path / "job")
    out = tmp_path / "out.bam"
    with pytest.raises(JobCancelled):
        run_rewrite_job(_spec(bam_path, out), jdir, checkpoint=CKPT,
                        cancel=_TripAt(CKPT + 5), device="cpu")
    orphan = os.path.join(jdir, "segments", "seg-00001")
    with open(orphan, "wb") as f:
        f.write(b"\x00" * 1234)
    with open(orphan + ".part", "wb") as f:
        f.write(b"\x00" * 10)
    res = run_rewrite_job(_spec(bam_path, out), jdir, checkpoint=CKPT,
                          device="cpu")
    assert res["redone_bytes"] == 1244
    assert not os.path.exists(orphan)
    assert out.read_bytes() == clean[""]["bytes"]


@pytest.mark.parametrize("starter", ["jax", "port"])
@pytest.mark.parametrize("dspec", DEFLATES, ids=["zlib", "fixed"])
def test_resume_across_packages(tmp_path, bam_path, clean, starter, dspec):
    """A job one package started and the other resumes gives the clean
    run's bytes: the journal, the segment names and the checkpoint records
    are the reference's."""
    jdir = str(tmp_path / "job")
    out = tmp_path / "out.bam"
    spec = _spec(bam_path, out, dspec)
    first, second = ((jrunner.run_rewrite_job, run_rewrite_job)
                     if starter == "jax"
                     else (run_rewrite_job, jrunner.run_rewrite_job))
    kw = {} if starter == "jax" else {"device": "cpu"}
    with pytest.raises((JobCancelled, jrunner.JobCancelled)):
        first(spec, jdir, checkpoint=CKPT, cancel=_TripAt(2 * CKPT + 7), **kw)
    kw = {"device": "cpu"} if starter == "jax" else {}
    res = second(spec, jdir, checkpoint=CKPT, **kw)
    assert res["resumed"] is True
    assert out.read_bytes() == clean[dspec]["bytes"]


def test_transcode_sidecars_equal_jax_and_scrub_clean(tmp_path, bam_path,
                                                      clean):
    jout, pout = tmp_path / "j" / "out.bam", tmp_path / "p" / "out.bam"
    jout.parent.mkdir()
    pout.parent.mkdir()
    jres = jrunner.run_transcode_job(_spec(bam_path, jout),
                                     str(tmp_path / "jjob"), checkpoint=CKPT)
    with pytest.raises(JobCancelled):
        run_transcode_job(_spec(bam_path, pout), str(tmp_path / "pjob"),
                          checkpoint=CKPT, cancel=_TripAt(100), device="cpu")
    pres = run_transcode_job(_spec(bam_path, pout), str(tmp_path / "pjob"),
                             checkpoint=CKPT, device="cpu")
    assert sorted(pres["sidecars"]) == ["blocks", "records", "sbi"]
    assert pout.read_bytes() == jout.read_bytes() == clean[""]["bytes"]
    for ext in (".blocks", ".records"):
        assert (Path(str(pout) + ext).read_bytes()
                == Path(str(jout) + ext).read_bytes())
    # The .sbi differs only in its fingerprint (each file's own mtime).
    p_sbi = decode_sbi(Path(pres["sidecars"]["sbi"]).read_bytes())
    j_sbi = decode_sbi(Path(jres["sidecars"]["sbi"]).read_bytes())
    assert p_sbi.blocks == j_sbi.blocks
    assert p_sbi.split_plans == j_sbi.split_plans
    assert np.array_equal(p_sbi.record_starts, j_sbi.record_starts)
    report = scrub_paths([str(pout)], source=bam_path)
    assert report.clean, report.summary()
    assert report.records_checked == pres["count"]
    assert len(report.artifacts) == 4


def test_export_interrupt_resume_equals_jax_and_plain(tmp_path, bam_path):
    jcfg = JConfig(columnar="rows=64")
    jout = tmp_path / "jax.sbcr"
    jres = jrunner.run_export_job(
        {"op": "export", "path": bam_path, "out": str(jout)},
        str(tmp_path / "jjob"), config=jcfg, checkpoint=2)
    cfg = Config(columnar="rows=64")
    out = tmp_path / "out.sbcr"
    spec = {"op": "export", "path": bam_path, "out": str(out)}
    with pytest.raises(JobCancelled):
        run_export_job(spec, str(tmp_path / "job"), config=cfg,
                       checkpoint=2, cancel=_TripAt(3), device="cpu")
    assert not out.exists()
    res = run_export_job(spec, str(tmp_path / "job"), config=cfg,
                         checkpoint=2, device="cpu")
    assert res["resumed"] is True and jres["batches"] >= 4
    assert out.read_bytes() == jout.read_bytes()
    assert {k: v for k, v in res.items() if k not in ("out", "resumed",
                                                      "checkpoints")} == {
        k: v for k, v in jres.items() if k not in ("out", "resumed",
                                                   "checkpoints")}
    plain = tmp_path / "plain.sbcr"
    plain_export(bam_path, plain, config=cfg, device="cpu")
    assert plain.read_bytes() == out.read_bytes()
    report = scrub_paths([str(out)])
    assert report.clean and report.records_checked == res["rows"]


@pytest.mark.parametrize("columns,rows", [("flag,pos,name", 50),
                                          (["seq", "qual"], 128)])
def test_export_spec_columns_and_rows_equal_jax(tmp_path, bam_path, columns,
                                                rows):
    spec = {"op": "export", "path": bam_path, "columns": columns,
            "batch_rows": rows}
    jres = jrunner.run_export_job(dict(spec, out=str(tmp_path / "j.sbcr")),
                                  str(tmp_path / "jj"), checkpoint=3)
    res = run_export_job(dict(spec, out=str(tmp_path / "p.sbcr")),
                         str(tmp_path / "pj"), checkpoint=3, device="cpu")
    assert ((tmp_path / "p.sbcr").read_bytes()
            == (tmp_path / "j.sbcr").read_bytes())
    assert res["columns"] == jres["columns"] and res["rows"] == jres["rows"]


def test_export_job_reads_the_chain_past_a_refused_record(tmp_path):
    """The export job writes what JAX's does where the checker refuses a
    record mid-file: all 601 rows, byte for byte."""
    from spark_bam_tpu_torch.benchmarks.load_cases import (
        write_refused_mid_bam,
    )

    path = str(tmp_path / "refused_mid.bam")
    write_refused_mid_bam(path)
    spec = {"op": "export", "path": path}
    jres = jrunner.run_export_job(dict(spec, out=str(tmp_path / "j.sbcr")),
                                  str(tmp_path / "jj"), checkpoint=2)
    res = run_export_job(dict(spec, out=str(tmp_path / "p.sbcr")),
                         str(tmp_path / "pj"), checkpoint=2, device="cpu")
    assert ((tmp_path / "p.sbcr").read_bytes()
            == (tmp_path / "j.sbcr").read_bytes())
    assert res["rows"] == jres["rows"] == 601


def test_export_job_takes_no_cpu_fallback(tmp_path, bam_path, monkeypatch):
    """Without a card and without ``device="cpu"`` the export job raises
    before any frame is written (the journal keeps only its spec)."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        run_export_job({"op": "export", "path": bam_path,
                        "out": str(tmp_path / "o.sbcr")},
                       str(tmp_path / "job"))
    assert [r["t"] for r in read_journal(tmp_path / "job" / "journal.sbj")
            ] == ["spec"]
    assert os.listdir(tmp_path / "job" / "segments") == []


# ----------------------------------------------------------------- manager
def _mgr(tmp_path, **kw):
    kw.setdefault("mem_fn", lambda: None)
    return JobManager(jcfg=JobsConfig(dir=str(tmp_path / "jobs"),
                                      checkpoint=CKPT, **kw.pop("jcfg", {})),
                      device="cpu", **kw)


def test_enospc_pauses_job_then_resume_completes(tmp_path, bam_path, clean):
    alerts = []
    mgr = _mgr(tmp_path, alert_fn=lambda name, **kw: alerts.append((name, kw)))
    out = tmp_path / "out.bam"
    spec = _spec(bam_path, out)
    try:
        with faults.disk_chaos("3:enospc=1.0"):
            jid = mgr.submit(spec)["job_id"]
            s = _wait_state(mgr, jid, {"paused"}, timeout=15)
        assert "ENOSPC" in s["error"] and s["op"] == "rewrite"
        assert [a[0] for a in alerts] == ["jobs.paused"]
        assert alerts[0][1] == {"job_id": jid, "op": "rewrite",
                                "error": s["error"]}
        # Every write failed, the journal's first append too: the resume
        # starts from an empty journal. No artifact yet.
        assert read_journal(tmp_path / "jobs" / jid / "journal.sbj") == []
        assert not out.exists()
        assert mgr.submit(spec)["job_id"] == jid
        s = _wait_state(mgr, jid, {"done"}, timeout=30)
        assert s["result"]["count"] == clean[""]["result"]["count"]
        assert out.read_bytes() == clean[""]["bytes"]
        assert mgr.submit(spec)["state"] == "done"   # idempotent
    finally:
        mgr.close(timeout=2.0)


def test_enospc_mid_run_keeps_checkpoints(tmp_path, bam_path, clean):
    """ENOSPC after checkpoints landed: the pause keeps them, the resume
    redoes only the open segment."""
    mgr = _mgr(tmp_path)
    out = tmp_path / "out.bam"
    spec = _spec(bam_path, out)
    try:
        # At this seed the first injected ENOSPC lands after the fourth
        # checkpoint.
        with faults.disk_chaos("0:enospc=0.03"):
            jid = mgr.submit(spec)["job_id"]
            s = _wait_state(mgr, jid, {"paused", "done"}, timeout=15)
        assert s["state"] == "paused", s
        ckpts = [r for r in read_journal(tmp_path / "jobs" / jid /
                                         "journal.sbj") if r["t"] == "ckpt"]
        assert len(ckpts) == 4
        assert sorted(os.listdir(tmp_path / "jobs" / jid / "segments")) == [
            f"seg-{i:05d}" for i in range(4)]
        mgr.submit(spec)
        s = _wait_state(mgr, jid, {"done"}, timeout=30)
        assert s["result"]["resumed"] is True
        assert out.read_bytes() == clean[""]["bytes"]
    finally:
        mgr.close(timeout=2.0)


@pytest.mark.parametrize("why", ["memory", "max_active"])
def test_manager_defers_typed(tmp_path, bam_path, why):
    if why == "memory":
        pmgr, jmgr = (_mgr(tmp_path, mem_fn=lambda: 0.99),
                      jmanager.JobManager(jcfg=jmanager.JobsConfig(
                          dir=str(tmp_path)), mem_fn=lambda: 0.99))
    else:
        pmgr = _mgr(tmp_path, jcfg={"max_active": 1})
        jmgr = jmanager.JobManager(jcfg=jmanager.JobsConfig(
            dir=str(tmp_path), max_active=1), mem_fn=lambda: None)
        pmgr._jobs["f" * 16] = manager._Job("f" * 16, {"op": "rewrite"})
        jmgr._jobs["f" * 16] = jmanager._Job("f" * 16, {"op": "rewrite"})
    errs = []
    for mgr in (pmgr, jmgr):
        with pytest.raises(OSError) as ei:
            mgr.submit(_spec(bam_path, tmp_path / "o.bam"))
        errs.append((type(ei.value).__name__, str(ei.value),
                     ei.value.retry_after_ms, ei.value.extra))
    assert errs[0] == errs[1] and errs[0][2] == 1000.0
    assert isinstance(ei.value, jmanager.ResourceExhausted)


def test_manager_preflight_refusal_and_bad_specs(tmp_path, bam_path,
                                                 monkeypatch):
    def boom(path, need, margin=1.1):
        raise ResourceExhausted("preflight: no space")

    monkeypatch.setattr(manager, "preflight_space", boom)
    mgr = _mgr(tmp_path)
    with pytest.raises(ResourceExhausted, match="no space"):
        mgr.submit(_spec(bam_path, tmp_path / "o.bam"))
    assert mgr.jobs() == []
    for bad in ({"op": "mine_bitcoin", "path": "a", "out": "b"},
                {"op": "rewrite", "path": "a"}):
        with pytest.raises(ValueError) as pe:
            mgr.submit(bad)
        with pytest.raises(ValueError) as je:
            jmanager.JobManager(jcfg=jmanager.JobsConfig(
                dir=str(tmp_path)), mem_fn=lambda: None).submit(bad)
        assert str(pe.value) == str(je.value)


def test_preflight_space_refuses_what_cannot_fit(tmp_path):
    from spark_bam_tpu.core.guard import preflight_space as jpre
    from spark_bam_tpu_torch.core.guard import preflight_space

    preflight_space(tmp_path / "o", 0)
    preflight_space(tmp_path / "o", 1 << 10)
    huge = 1 << 62
    with pytest.raises(ResourceExhausted) as pe:
        preflight_space(tmp_path / "o", huge)
    with pytest.raises(OSError) as je:
        jpre(tmp_path / "o", huge)
    assert pe.value.errno == je.value.errno
    assert str(pe.value).split(" filesystem has")[0] == str(
        je.value).split(" filesystem has")[0]


def test_manager_cancel_and_unknown_ids(tmp_path, bam_path, monkeypatch):
    def fake_runner(spec, job_dir, cancel=None, **kw):
        if not cancel.wait(10):
            return {"late": True}
        raise JobCancelled("stopped on request")

    monkeypatch.setitem(RUNNERS, "rewrite", fake_runner)
    mgr = _mgr(tmp_path)
    try:
        jid = mgr.submit(_spec(bam_path, tmp_path / "o.bam"))["job_id"]
        assert mgr.cancel(jid)["job_id"] == jid
        s = _wait_state(mgr, jid, {"cancelled"})
        assert "stopped on request" in s["error"] and s["finished"] > 0
        assert mgr.cancel("nope") is None and mgr.status("nope") is None
        assert mgr.jobs() == [s]
    finally:
        mgr.close(timeout=2.0)


def test_manager_failed_job_records_error(tmp_path):
    mgr = _mgr(tmp_path)
    try:
        jid = mgr.submit({"op": "rewrite", "path": str(tmp_path / "none.bam"),
                          "out": str(tmp_path / "o.bam")})["job_id"]
        s = _wait_state(mgr, jid, {"failed"})
        assert s["error"].startswith("FileNotFoundError")
    finally:
        mgr.close(timeout=2.0)


def _counters(reg, prefixes=("jobs.", "scrub.", "chaos.disk_")):
    return {c["name"]: c["value"] for c in reg.snapshot()["counters"]
            if c["name"].startswith(prefixes)}


def _counter_scenario(pkg, tmp_path, bam_path):
    """The same job-plane story in one package: an interrupted rewrite and
    its resume over an orphan segment, a torn journal tail and an unknown
    tag, a torn segment, a paused then finished job, a deferral, and a
    scrub with a quarantine."""
    rj, jr, fl, mg, sc = ((jrunner, jjournal, jfaults, jmanager, jscrub)
                          if pkg == "jax"
                          else (runner, journal, faults, manager, scrub))
    kw = {} if pkg == "jax" else {"device": "cpu"}
    jdir = str(tmp_path / "job")
    out = tmp_path / "out.bam"
    spec = _spec(bam_path, out)
    with pytest.raises(Exception):
        rj.run_rewrite_job(spec, jdir, checkpoint=CKPT,
                           cancel=_TripAt(CKPT + 5), **kw)
    Path(jdir, "segments", "seg-00001").write_bytes(b"\0" * 99)
    with open(Path(jdir, "journal.sbj"), "ab") as f:
        f.write(jr._frame({"t": "v9"}) + b"SBJ1 0000")
    rj.run_rewrite_job(spec, jdir, checkpoint=CKPT, **kw)
    seg = jr.SegmentedOutput(tmp_path / "segs")
    with fl.disk_chaos("5:torn=1.0"):
        seg.begin(0)
        seg.write(b"x" * 1000)
        with pytest.raises(OSError):
            seg.commit()
    mgr = mg.JobManager(jcfg=mg.JobsConfig(dir=str(tmp_path / "jobs"),
                                           checkpoint=CKPT, max_active=1),
                        mem_fn=lambda: None, **kw)
    spec2 = _spec(bam_path, tmp_path / "o2.bam")
    try:
        with fl.disk_chaos("3:enospc=1.0"):
            jid = mgr.submit(spec2)["job_id"]
            _wait_state(mgr, jid, {"paused"})
        mgr.submit(spec2)
        with pytest.raises(OSError):
            mgr.submit(_spec(bam_path, tmp_path / "o3.bam"))
        _wait_state(mgr, jid, {"done"})
    finally:
        mgr.close(timeout=2.0)
    bad = bytearray(out.read_bytes())
    bad[len(bad) // 2] ^= 0xFF
    (tmp_path / "bad.bam").write_bytes(bytes(bad))
    sc.scrub_paths([str(out), str(tmp_path / "bad.bam")], source=bam_path,
                   quarantine=True)


def test_counters_equal_jax(tmp_path, bam_path):
    jobs_obs.shutdown()
    jreg = jobs_obs.configure()
    try:
        _counter_scenario("jax", tmp_path / "j", bam_path)
    finally:
        jobs_obs.shutdown()
    reg = obs.configure()
    try:
        _counter_scenario("port", tmp_path / "p", bam_path)
    finally:
        obs.shutdown()
    got, want = _counters(reg), _counters(jreg)
    assert got == want
    for name in ("jobs.checkpoints", "jobs.checkpoint_bytes", "jobs.resumed",
                 "jobs.redone_bytes", "jobs.journal_appends",
                 "jobs.journal_truncated", "jobs.journal_skipped",
                 "jobs.submitted", "jobs.paused", "jobs.completed",
                 "jobs.deferred", "chaos.disk_torn_writes",
                 "chaos.disk_enospc", "scrub.artifacts", "scrub.findings",
                 "scrub.quarantined", "scrub.records_checked"):
        assert got.get(name, 0) > 0, name


# ------------------------------------------------------------------ scrub
def _scrub_cases(d: Path, bam_path, clean_bytes):
    """name → (paths, source) of the scrub comparisons, built in ``d``."""
    d.mkdir(parents=True, exist_ok=True)
    good = d / "good.bam"
    good.write_bytes(clean_bytes)
    flip = bytearray(clean_bytes)
    flip[len(flip) // 2] ^= 0xFF
    (d / "flip.bam").write_bytes(bytes(flip))
    (d / "art.bam").write_bytes(clean_bytes)
    (d / "art.bam.sbi").write_bytes(b"garbage-sidecar")
    (d / "art.bam.blocks").write_text("0,1,2\n")
    (d / "trunc.bam").write_bytes(clean_bytes[:-40])
    (d / "mid.bam").write_bytes(clean_bytes[:len(clean_bytes) // 3])
    jrunner.run_export_job({"op": "export", "path": bam_path,
                            "out": str(d / "x.sbcr")}, str(d / "xj"),
                           config=JConfig(columnar="rows=64"), checkpoint=4)
    xb = (d / "x.sbcr").read_bytes()
    (d / "xbad.sbcr").write_bytes(xb[:100] + bytes([xb[100] ^ 1]) + xb[101:])
    (d / "xtrunc.sbcr").write_bytes(xb[:-20])
    return {
        "clean": ([good], None), "parity": ([good], bam_path),
        "flip": ([d / "flip.bam"], None), "sidecars": ([d / "art.bam"], None),
        "truncated": ([d / "trunc.bam"], None),
        "mid": ([d / "mid.bam"], bam_path),
        "native": ([d / "x.sbcr"], None),
        "native_bad": ([d / "xbad.sbcr", d / "xtrunc.sbcr"], None),
        "missing": ([d / "none.bam"], None),
    }


def test_scrub_summaries_equal_jax(tmp_path, bam_path, clean):
    cases = _scrub_cases(tmp_path, bam_path, clean[""]["bytes"])
    for name, (paths, source) in cases.items():
        got = scrub_paths(paths, source=source).summary()
        want = jscrub.scrub_paths(paths, source=source).summary()
        assert got == want, name
        assert got["clean"] is (name in ("clean", "parity", "native")), name
        pr = scrub_paths(paths, source=source).job_report()
        jr = jscrub.scrub_paths(paths, source=source).job_report()
        assert [(p.index, p.status, p.error) for p in pr.partitions] == [
            (p.index, p.status, p.error) for p in jr.partitions]
        assert pr.quarantined == jr.quarantined


def test_scrub_quarantine_renames(tmp_path, clean):
    data = bytearray(clean[""]["bytes"])
    data[len(data) // 2] ^= 0xFF
    bad = tmp_path / "damaged.bam"
    bad.write_bytes(bytes(data))
    good = tmp_path / "good.bam"
    good.write_bytes(clean[""]["bytes"])
    report = scrub_paths([str(bad), str(good)], quarantine=True)
    assert report.quarantined == [str(bad) + ".quarantined"]
    assert not bad.exists() and good.exists()
    assert (tmp_path / "damaged.bam.quarantined").read_bytes() == bytes(data)


def test_scrub_command_exit_codes_equal_jax(tmp_path, bam_path, clean,
                                            capsys):
    cases = _scrub_cases(tmp_path, bam_path, clean[""]["bytes"])
    for name, (paths, source) in cases.items():
        argv = ["scrub"] + (["--source", source] if source else []) + [
            str(p) for p in paths]
        rc = cli.main(argv)
        got = capsys.readouterr().out
        jrc = jax_main(argv)
        want = capsys.readouterr().out
        assert (rc, got) == (jrc, want), name
        assert rc == (0 if json.loads(got)["clean"] else cli.RC_FINDINGS)
    # -o writes the report there; a bad stride is a usage error (2).
    assert cli.main(["scrub", "-o", str(tmp_path / "r.json"),
                     str(cases["clean"][0][0])]) == 0
    assert json.loads((tmp_path / "r.json").read_text())["clean"] is True
    for argv in (["scrub", "--stride", "0", "x.bam"], ["scrub"]):
        with pytest.raises(SystemExit) as pe:
            cli.main(argv)
        with pytest.raises(SystemExit) as je:
            jax_main(argv)
        assert pe.value.code == je.value.code == 2
    capsys.readouterr()


# --------------------------------------------------------------- commands
def test_cli_durable_rewrite_matches_plain(tmp_path, bam_path, capsys):
    plain = tmp_path / "plain.bam"
    assert cli.main(["rewrite", "--device", "cpu", "-i", "--deflate",
                     "mode=fixed", bam_path, str(plain)]) == 0
    capsys.readouterr()
    out = tmp_path / "durable.bam"
    argv = ["rewrite", "--durable", "--checkpoint", "64", "--device", "cpu",
            "-i", "--deflate", "mode=fixed",
            "--jobs", f"dir={tmp_path / 'jobsroot'}", bam_path, str(out)]
    assert cli.main(argv) == 0
    res = json.loads(capsys.readouterr().out)
    jout = tmp_path / "jdurable.bam"
    assert jax_main(["htsjdk-rewrite", "--durable", "--checkpoint", "64", "-i",
                     "--deflate", "mode=fixed",
                     "--jobs", f"dir={tmp_path / 'jroot'}", bam_path,
                     str(jout)]) == 0
    jres = json.loads(capsys.readouterr().out)
    assert out.read_bytes() == plain.read_bytes() == jout.read_bytes()
    for ext in (".blocks", ".records"):
        assert (Path(str(out) + ext).read_bytes()
                == Path(str(plain) + ext).read_bytes())
    norm = ("out", "sidecars")
    assert ({k: v for k, v in res.items() if k not in norm}
            == {k: v for k, v in jres.items() if k not in norm})
    # The job directory is the spec's id under the jobs root, as JAX's.
    spec = {"op": "rewrite", "path": bam_path, "out": str(out),
            "block_payload": 65280, "level": 6, "index": True}
    assert os.listdir(tmp_path / "jobsroot") == [job_id_of(spec)]


def test_cli_durable_export_matches_plain(tmp_path, bam_path, capsys):
    plain = tmp_path / "plain.sbcr"
    env_cols = "rows=100"
    assert cli.main(["export", "--device", "cpu", "--columnar", env_cols,
                     "--columns", "flag,pos,name", "-o", str(plain),
                     bam_path]) == 0
    capsys.readouterr()
    out = tmp_path / "durable.sbcr"
    assert cli.main(["export", "--durable", "--device", "cpu", "--checkpoint",
                     "2", "--columnar", env_cols, "--columns",
                     "flag,pos,name", "--jobs", f"dir={tmp_path / 'j'}",
                     "-o", str(out), bam_path]) == 0
    res = json.loads(capsys.readouterr().out)
    assert out.read_bytes() == plain.read_bytes()
    assert res["columns"] == ["flag", "pos", "name"] and res["checkpoints"] >= 2


@pytest.mark.parametrize("argv,msg", [
    (["export", "--durable", "--format", "arrow"], "native only"),
    (["export", "--durable", "-i", "chr1"], "-i/--reference"),
    (["export", "--durable", "--jobs", "bogus"], "Bad jobs entry"),
    (["export", "--durable", "--columns", "nope"], "unknown column"),
    (["rewrite", "--durable", "--jobs", "checkpoint=0"], ">= 1"),
    (["rewrite", "--durable", "--disk-chaos", "x:bogus"], "disk-chaos seed"),
    (["rewrite", "--disk-chaos", "1:bogus=1"], "Unknown disk-chaos key"),
    (["serve", "--jobs", "mem=2"], "watermark"),
    (["fabric", "--disk-chaos", "3:eio"], "Bad disk-chaos entry"),
])
def test_cli_refuses_before_any_work(tmp_path, bam_path, capsys, argv, msg):
    out = tmp_path / "o"
    cmd, rest = argv[0], argv[1:]
    if cmd == "export":
        full = [cmd, *rest, "--device", "cpu", "-o", str(out), bam_path]
    elif cmd == "rewrite":
        full = [cmd, *rest, "--device", "cpu", bam_path, str(out)]
    else:
        full = [cmd, *rest, "--device", "cpu", "--listen",
                f"unix:{tmp_path / 's.sock'}"]
    assert cli.main(full) == 2
    assert msg in capsys.readouterr().err
    assert os.listdir(tmp_path) == []
    assert faults.installed_disk_chaos() is None


def _env():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)    # the port alone, no JAX at start-up
    env["OMP_NUM_THREADS"] = "1"
    env["CUDA_VISIBLE_DEVICES"] = ""
    return env


@pytest.mark.parametrize("argv", [
    ["rewrite", "--durable", "IN", "OUT"],
    ["export", "--durable", "-o", "OUT", "IN"],
    ["serve", "--listen", "unix:SOCK"],
    ["fabric", "--fabric", "workers=1", "--listen", "unix:SOCK"],
])
def test_commands_refuse_without_a_card(tmp_path, bam_path, argv):
    """Without a card and without ``--device cpu`` the job plane's
    commands exit non-zero before any work: no output, no job dir."""
    argv = [a.replace("IN", bam_path).replace("OUT", str(tmp_path / "o"))
            .replace("SOCK", str(tmp_path / "s.sock")) for a in argv]
    argv += ["--jobs", f"dir={tmp_path / 'jobs'}"]
    proc = subprocess.run(
        [sys.executable, "-m", "spark_bam_tpu_torch", *argv], cwd=ROOT,
        env=_env(), capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "CUDA" in proc.stderr
    assert sorted(os.listdir(tmp_path)) == []


def _wait_ckpt(journal_path, deadline):
    """Wait until the journal holds a checkpoint and no ``done``."""
    while time.monotonic() < deadline:
        try:
            recs = read_journal(journal_path)
        except OSError:
            recs = []
        tags = [r["t"] for r in recs]
        if "done" in tags:
            return False
        if "ckpt" in tags:
            return True
        time.sleep(0.005)
    pytest.fail("no checkpoint in time")


def test_durable_rewrite_sigkilled_mid_run_resumes(tmp_path, capsys):
    """``rewrite --durable`` in its own process, stopped (SIGSTOP) as soon
    as its journal holds a checkpoint and no ``done``, then SIGKILLed; the
    same command again resumes and writes the plain rewrite's bytes."""
    bam = tmp_path / "in.bam"
    random_bam(bam, seed=31, n_records=(2400, 2401), read_len=(50, 500))
    plain = tmp_path / "plain.bam"
    rewrite_bam(bam, plain, block_payload=BLOCK, deflate="mode=fixed",
                device="cpu")
    out = tmp_path / "out.bam"
    root = tmp_path / "jobs"
    argv = ["rewrite", "--durable", "--device", "cpu", "--checkpoint", "150",
            "-b", str(BLOCK), "--deflate", "mode=fixed", "--jobs",
            f"dir={root}", str(bam), str(out)]
    spec = {"op": "rewrite", "path": str(bam), "out": str(out),
            "block_payload": BLOCK, "level": 6}
    jpath = root / job_id_of(spec) / "journal.sbj"
    proc = subprocess.Popen([sys.executable, "-m", "spark_bam_tpu_torch",
                             *argv], cwd=ROOT, env=_env(),
                            stdout=subprocess.DEVNULL,
                            stderr=subprocess.DEVNULL)
    try:
        assert _wait_ckpt(jpath, time.monotonic() + 90), "finished too soon"
        proc.send_signal(signal.SIGSTOP)
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=30)
    finally:
        proc.kill()
    assert proc.returncode == -signal.SIGKILL
    assert not out.exists()
    seg_bytes = [r["seg_bytes"] for r in read_journal(jpath)
                 if r["t"] == "ckpt"]
    reset_cache_events()
    assert cli.main(argv) == 0
    res = json.loads(capsys.readouterr().out)
    assert res["resumed"] is True
    assert res["redone_bytes"] <= 2 * max(seg_bytes)
    assert out.read_bytes() == plain.read_bytes()
    assert scrub_paths([str(out)], source=str(bam)).clean
