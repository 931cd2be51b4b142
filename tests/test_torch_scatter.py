"""Whale scatter/gather (``balance --scatter N``, ``serve/scatter.py``) on
the CPU, against the JAX package's planner and WAL and against the port's
own standalone runs.

- ``plan_scatter``'s ``to_wire()`` equals the JAX planner's on the same
  argv (the one departure: a whale's ``--stats-json`` becomes one file a
  shard), and a WAL written by either package folds to the same whales
  in both, torn tail included;
- a whale (``simplex``, ``duplex``, ``pipeline``; N = 2, 3 and 5; axes
  ``umi`` and ``coord``) submitted to a port balancer over two port
  daemons (``--device cpu``) gathers into the bytes of the port's
  standalone run of the same argv, and ``jobs --scatter`` shows every
  shard ``done``;
- with one backend SIGKILLed mid-whale (fleet daemons in child
  processes) the survivor adopts the shard under its original id and the
  whale still gathers into the standalone bytes;
- a shard that fails fails the whale with the shard's diagnostic and exit
  status, and no gather or host rerun follows.

Every daemon and balancer is stopped in a ``finally``; every wait is
bounded.
"""

import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time

import pytest
import torch

import fgumi_tpu.native as jax_native
import fgumi_tpu.native.batch as jax_native_batch
from fgumi_tpu.serve import scatter as jax_scatter
from fgumi_tpu_torch.cli import PROGRAM_ID
from fgumi_tpu_torch.cli import main as port_main
from fgumi_tpu_torch.serve import scatter
from fgumi_tpu_torch.serve.balancer import Balancer
from fgumi_tpu_torch.serve.client import ServeClient
from fgumi_tpu_torch.serve.daemon import JobService

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAIT_S = 120
PIPELINE_OPTS = ["-r", "8M+T", "+T", "--sample", "s", "--library", "l"]


@pytest.fixture(autouse=True)
def _reset_port_governor():
    """The daemons' admission and the shard runs move the port's
    process-wide resource governor; later tests in this worker expect it
    quiet."""
    yield
    from fgumi_tpu_torch.utils.governor import GOVERNOR

    GOVERNOR.reset_for_tests()


@pytest.fixture(autouse=True)
def no_jax_native(monkeypatch):
    """The JAX package's native library is never loaded here."""
    monkeypatch.setattr(jax_native, "get_lib", lambda: None)
    monkeypatch.setattr(jax_native_batch, "get_lib", lambda: None)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_scatter")
    grouped, duplex = str(d / "grouped.bam"), str(d / "duplex.bam")
    assert port_main(["simulate", "grouped-reads", "-o", grouped,
                      "--num-families", "150", "--family-size", "3",
                      "--seed", "5"]) == 0
    assert port_main(["simulate", "duplex-reads", "-o", duplex,
                      "--num-molecules", "100", "--seed", "4"]) == 0
    r1, r2 = str(d / "r1.fq.gz"), str(d / "r2.fq.gz")
    assert port_main(["simulate", "fastq-reads", "-1", r1, "-2", r2,
                      "--num-families", "80", "--family-size", "3",
                      "--seed", "7"]) == 0
    big = str(d / "big.bam")
    assert port_main(["simulate", "grouped-reads", "-o", big,
                      "--num-families", "1500", "--family-size", "3",
                      "--seed", "9"]) == 0
    return {"simplex": grouped, "duplex": duplex, "fastq": (r1, r2),
            "big": big}


@pytest.fixture(scope="module")
def fleet():
    """Two port daemons in this process (one worker each) with fleet ids,
    so their job ids differ: a balancer maps each id to one backend, and
    daemons without fleet ids both mint ``j-<n>``."""
    d = tempfile.mkdtemp(prefix="fts")
    svcs = []
    try:
        for name in ("a", "b"):
            svc = JobService(os.path.join(d, f"{name}.sock"), workers=1,
                             queue_limit=16,
                             journal_dir=os.path.join(d, "j"),
                             fleet_id=name)
            svc.start()
            svcs.append(svc)
        yield d, svcs
    finally:
        for s in svcs:
            s.close()
        shutil.rmtree(d, ignore_errors=True)


def _argv(command, inputs, out):
    if command == "pipeline":
        return ["pipeline", "-i", *inputs["fastq"], *PIPELINE_OPTS, "-o",
                out, "--device", "cpu"]
    return [command, "-i", inputs[command], "-o", out, "--device", "cpu"]


def _standalone(argv):
    """The bytes of the port's standalone run of ``argv`` (its output
    removed again)."""
    out = argv[argv.index("-o") + 1]
    assert port_main(argv) == 0
    with open(out, "rb") as f:
        data = f.read()
    os.unlink(out)
    return data


# ---------------------------------------------------------------------------
# the planner and the WAL against the JAX package's


_PLAN_ARGVS = [
    (["simplex", "-i", "in.bam", "-o", "out.bam", "--min-reads", "2"], 3,
     "umi"),
    (["duplex", "-i", "in.bam", "--output=o.bam", "--compression-level",
      "5"], 2, "coord"),
    (["pipeline", "-i", "a.fq", "b.fq", "-o=x y.bam", "--sample", "s"], 5,
     "umi"),
    (["simplex", "-i", "in.bam", "-o", "out.bam",
      "--compression-level=bad"], 2, "umi"),
    (["simplex", "-i", "in.bam", "-o", "-"], 2, "umi"),
    (["simplex", "-i", "in.bam", "-o", "o.bam", "--shard", "0/2"], 2,
     "umi"),
    (["codec", "-i", "in.bam", "-o", "o.bam"], 2, "umi"),
    (["sort", "-i", "in.bam", "-o", "o.bam"], 3, "umi"),
    (["simplex", "-i", "in.bam", "-o", "o.bam"], 1, "umi"),
    ([], 2, "umi"),
]


@pytest.mark.parametrize("argv,shards,axis", _PLAN_ARGVS)
def test_plan_scatter_equals_jax(argv, shards, axis):
    got = scatter.plan_scatter(argv, "prog", shards, axis)
    want = jax_scatter.plan_scatter(argv, "prog", shards, axis)
    assert (got is None) == (want is None)
    if got is not None:
        assert got.to_wire() == want.to_wire()
        assert scatter.ScatterPlan.from_wire(got.to_wire()).to_wire() \
            == got.to_wire()


def test_plan_scatter_pins_pg_and_splits_stats_json():
    argv = ["simplex", "-i", "in.bam", "-o", "out.bam", "--stats-json",
            "s.json"]
    plan = scatter.plan_scatter(argv, None, 3, "coord")
    want = jax_scatter.plan_scatter(argv, PROGRAM_ID, 3, "coord")
    for k, (got_argv, jax_argv) in enumerate(zip(plan.shard_argvs,
                                                 want.shard_argvs)):
        i = got_argv.index("--stats-json") + 1
        assert got_argv[i] == f"s.json.s{k}of3" and jax_argv[i] == "s.json"
        assert got_argv[:i] + got_argv[i + 1:] \
            == jax_argv[:i] + jax_argv[i + 1:]
        pg = got_argv[got_argv.index("--pg-argv") + 1]
        assert pg == f"{PROGRAM_ID} " + " ".join(argv)
    with pytest.raises(ValueError, match="unknown scatter axis"):
        scatter.plan_scatter(argv, None, 2, "pos")


def _wal_events(wal, plan):
    wal.append({"ev": "whale", "id": "w-ab-1", "argv": ["simplex"],
                "argv0": "p", "priority": "high", "tag": "t",
                "client": "c", "dedupe": "d1", "plan": plan.to_wire()})
    wal.append({"ev": "whale", "id": "w-ab-2", "argv": ["duplex"],
                "plan": plan.to_wire()})
    wal.append({"ev": "whale", "id": "w-ab-1", "argv": ["ignored"]})
    for k, state in ((0, "submitted"), (1, "done"), (0, "requeued")):
        wal.append({"ev": "shard", "whale": "w-ab-1", "k": k,
                    "attempt": k, "dedupe": f"w-ab-1-s{k}",
                    "job_id": f"a-j-{k}", "state": state})
    wal.append({"ev": "shard", "whale": "w-none", "k": 0})
    wal.append({"ev": "whale_state", "id": "w-ab-2", "state": "failed",
                "error": "shard 1/2 failed: command exited 2"})


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_wal_replay_folds_as_jax(tmp_path, writer):
    mod = scatter if writer == "port" else jax_scatter
    path = str(tmp_path / "scatter.wal")
    plan = scatter.plan_scatter(["simplex", "-i", "i.bam", "-o", "o.bam"],
                                "p", 2, "umi")
    wal = mod.ScatterWal(path)
    _wal_events(wal, plan)
    wal.close()
    with open(path, "ab") as f:
        f.write(b'{"v": 1, "ev": "shard", "whale": "w-ab-1"')  # torn tail
    size = os.path.getsize(path)
    shutil.copy(path, path + ".jax")
    got = scatter.ScatterWal.replay(path)
    want = jax_scatter.ScatterWal.replay(path + ".jax")
    assert got == want
    whales, max_num = got
    assert max_num == 2 and sorted(whales) == ["w-ab-1", "w-ab-2"]
    assert whales["w-ab-1"]["shards"][0]["state"] == "requeued"
    assert whales["w-ab-2"]["state"] == "failed"
    assert os.path.getsize(path) == os.path.getsize(path + ".jax") < size


# ---------------------------------------------------------------------------
# whales through the port's balancer


def _whale(fleet, argv, shards, axis, label):
    d, svcs = fleet
    front = os.path.join(d, f"{label}.sock")
    bal = Balancer(f"unix:{front}",
                   [f"unix:{s.socket_path}" for s in svcs],
                   poll_period_s=0.1, scatter_shards=shards,
                   scatter_axis=axis)
    bal.bind()
    bal.start()
    try:
        client = ServeClient(front, timeout=30)
        job = client.submit(argv)
        assert job["id"].startswith("w-")
        done = client.wait(job["id"], timeout=WAIT_S)
        scatter_op = client._checked({"v": 1, "op": "scatter",
                                      "id": job["id"]})["scatter"]
        return done, scatter_op
    finally:
        bal.close()


@pytest.mark.parametrize("axis", ["umi", "coord"])
@pytest.mark.parametrize("shards", [2, 3, 5])
@pytest.mark.parametrize("command", ["simplex", "duplex", "pipeline"])
def test_whale_gathers_into_the_standalone_bytes(inputs, fleet, tmp_path,
                                                 command, shards, axis):
    out = str(tmp_path / "whale.bam")
    argv = _argv(command, inputs, out)
    want = _standalone(argv)
    done, shown = _whale(fleet, argv, shards, axis,
                         f"f{command[0]}{shards}{axis[0]}")
    assert done["state"] == "done" and done["exit_status"] == 0, done
    with open(out, "rb") as f:
        assert f.read() == want
    assert [s["state"] for s in shown["scatter"]["shards"]] \
        == ["done"] * shards
    assert all(s["job_id"] and s["attempt"] == 0
               for s in shown["scatter"]["shards"])
    # the shard outputs and manifests are cleaned up after the gather
    assert sorted(os.listdir(tmp_path)) == ["whale.bam"]


def test_failed_shard_fails_the_whale_with_its_exit_status(inputs, fleet,
                                                           tmp_path):
    out = str(tmp_path / "whale.bam")
    argv = _argv("simplex", inputs, out) + ["--min-reads", "0"]
    done, shown = _whale(fleet, argv, 2, "umi", "ffail")
    assert done["state"] == "failed" and done["exit_status"] == 2
    assert "failed: command exited 2" in done["error"]
    assert not os.path.exists(out)
    if not torch.cuda.is_available():
        # a shard on the card that cannot run fails the whale the same
        # way: nothing reruns on the host
        argv = [a for a in _argv("simplex", inputs, out) if a != "cpu"]
        argv[argv.index("--device") + 1:argv.index("--device") + 1] = \
            ["cuda"]
        done, _ = _whale(fleet, argv, 2, "coord", "fcuda")
        assert done["state"] == "failed" and done["exit_status"] == 2
        assert not os.path.exists(out)


def test_jobs_scatter_and_submit_cli_against_a_balancer(inputs, fleet,
                                                        tmp_path, capsys):
    d, svcs = fleet
    front = os.path.join(d, "cli.sock")
    bal = Balancer(f"unix:{front}", [f"unix:{s.socket_path}" for s in svcs],
                   poll_period_s=0.1, scatter_shards=3)
    bal.bind()
    bal.start()
    try:
        out = str(tmp_path / "whale.bam")
        argv = _argv("simplex", inputs, out)
        want = _standalone(argv)
        capsys.readouterr()
        assert port_main(["submit", "--socket", front, "--timeout", "120",
                          *argv]) == 0
        with open(out, "rb") as f:
            assert f.read() == want
        capsys.readouterr()
        assert port_main(["jobs", "--socket", front, "--scatter"]) == 0
        section = json.loads(capsys.readouterr().out)
        assert section["enabled"] and section["shards"] == 3
        (whale,) = section["jobs"]
        assert whale["state"] == "done" and whale["shards"] == {"done": 3}
        assert port_main(["jobs", "--socket", front, "--scatter",
                          whale["id"]]) == 0
        one = json.loads(capsys.readouterr().out)
        assert [s["state"] for s in one["scatter"]["shards"]] \
            == ["done"] * 3
    finally:
        bal.close()


# ---------------------------------------------------------------------------
# a backend killed mid-whale


def _spawn(d, fleet_id):
    sock = os.path.join(d, f"{fleet_id}.sock")
    proc = subprocess.Popen(
        [sys.executable, "-m", "fgumi_tpu_torch", "serve", "--socket", sock,
         "--journal-dir", os.path.join(d, "j"), "--fleet-id", fleet_id,
         "--lease-scan-period", "0.3", "--workers", "1", "--no-warmup"],
        env=dict(os.environ, PYTHONPATH=REPO), stdout=subprocess.DEVNULL,
        stderr=subprocess.DEVNULL)
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline:
        try:
            ServeClient(sock, timeout=2).ping()
            return sock, proc
        except Exception:  # noqa: BLE001 - not up yet
            time.sleep(0.1)
    proc.kill()
    proc.wait(timeout=30)
    raise AssertionError(f"daemon {fleet_id} did not start")


def test_whale_survives_a_backend_killed_mid_whale(inputs, tmp_path):
    d = tempfile.mkdtemp(prefix="ftk")
    os.makedirs(os.path.join(d, "j"))
    procs = []
    bal = None
    try:
        sa, pa = _spawn(d, "a")
        sb, pb = _spawn(d, "b")
        procs += [pa, pb]
        out = str(tmp_path / "whale.bam")
        argv = ["simplex", "-i", inputs["big"], "-o", out, "--device",
                "cpu"]
        want = _standalone(argv)
        front = os.path.join(d, "front.sock")
        # the grace outlasts the lease scan: the takeover wins the race
        bal = Balancer(f"unix:{front}", [f"unix:{sa}", f"unix:{sb}"],
                       poll_period_s=0.2, eject_failures=1,
                       scatter_shards=3, scatter_grace_s=5,
                       scatter_wal=os.path.join(d, "scatter.wal"))
        bal.bind()
        bal.start()
        # both depths known before the whale arrives: a backend not yet
        # polled routes last, so every shard could land on the other one
        bal.poll_backends_once()
        client = ServeClient(front, timeout=30)
        wid = client.submit(argv)["id"]
        cb = ServeClient(sb, timeout=10)
        deadline = time.monotonic() + WAIT_S
        while not any(j["state"] == "running"
                      for j in cb.status()["jobs"]):
            assert time.monotonic() < deadline
            time.sleep(0.02)
        b_jobs = {j["id"] for j in cb.status()["jobs"]}
        pb.send_signal(signal.SIGKILL)
        pb.wait(timeout=30)
        done = client.wait(wid, timeout=WAIT_S)
        assert done["state"] == "done", done
        with open(out, "rb") as f:
            assert f.read() == want
        shard_ids = {s["job_id"] for s in done["scatter"]["shards"]}
        assert b_jobs & shard_ids  # a shard kept its id through takeover
        fleet_a = ServeClient(sa, timeout=10).stats()["fleet"]
        assert fleet_a["takeovers"] == 1
        assert {s["attempt"] for s in done["scatter"]["shards"]} == {0}
        assert os.path.exists(os.path.join(d, "j", "b.journal.claimed"))
    finally:
        if bal is not None:
            bal.close()
        for p in procs:
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
                try:
                    p.wait(timeout=60)
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait(timeout=30)
        shutil.rmtree(d, ignore_errors=True)
