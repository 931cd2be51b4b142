"""The port's job-service daemon end to end on the CPU, against the JAX
package's and against the port's own standalone runs.

- a ``simplex`` job and a ``pipeline`` job (``--device cpu``) on ``simulate
  grouped-reads`` and ``fastq-reads`` inputs write bytes identical to the
  port's standalone run with the same argv (``@PG`` included) and records
  identical to ``fgumi_tpu.cli.main`` standalone; so do the two run at
  once, and two concurrent jobs keep their run reports' counters apart
  (the kernel launch counters add up under one lock and each command's
  tally stays its own);
- the per-job trace and run report, cancel, drain and shutdown, the
  socket claim (a live daemon refused, a dead one's socket replaced), the
  TCP listener (handshake token, connection cap, io deadline, per-listener
  caps), crash recovery from ``--journal`` (requeue under the original id,
  dedupe keys, report-dir sweep), and ``serve.dispatch:raise`` failing one
  job while the daemon serves on;
- the port's client against a JAX ``JobService`` and the JAX client
  against a port one;
- the CLI: ``serve``'s refusals and exit codes (a deferred option "not
  yet ported", fleet misuse, ``--compile-cache`` JAX-only, a busy socket or port, a warm-up
  without CUDA), ``submit``, ``stats`` and ``jobs`` (``--scatter`` gets the
  reference daemon's refusal), and a ``--device cuda`` job under
  ``--no-warmup`` failing as it does standalone.

Every daemon is stopped in a fixture finalizer or a ``finally``; every
wait is bounded.
"""

import contextlib
import json
import logging
import os
import shutil
import socket
import sys
import tempfile
import threading
import time

import pytest

import fgumi_tpu.native as jax_native
import fgumi_tpu.native.batch as jax_native_batch
from fgumi_tpu.cli import main as jax_main
from fgumi_tpu.serve.client import ServeClient as JaxClient
from fgumi_tpu.serve.daemon import JobService as JaxJobService
from fgumi_tpu_torch import cli as port_cli
from fgumi_tpu_torch.cli import main as port_main
from fgumi_tpu_torch.io.bam import BamReader
from fgumi_tpu_torch.observe.report import validate_report
from fgumi_tpu_torch.serve import journal as journal_mod
from fgumi_tpu_torch.serve import protocol, transport
from fgumi_tpu_torch.serve.client import (ServeClient, ServeError,
                                          TransportError)
from fgumi_tpu_torch.serve.daemon import JobService, SocketBusy
from fgumi_tpu_torch.serve.jobs import Job

WAIT_S = 120
PIPELINE_OPTS = ["-r", "8M+T", "+T", "--sample", "s", "--library", "l"]


@pytest.fixture(autouse=True)
def no_jax_native(monkeypatch):
    """The JAX package's native library is never loaded here (its build
    races between test workers); its CLI runs its per-record routes."""
    monkeypatch.setattr(jax_native, "get_lib", lambda: None)
    monkeypatch.setattr(jax_native_batch, "get_lib", lambda: None)


@pytest.fixture
def sock_dir():
    """A short directory for Unix sockets (paths are capped at 107
    bytes), removed afterwards."""
    d = tempfile.mkdtemp(prefix="fts")
    yield d
    shutil.rmtree(d, ignore_errors=True)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_serve")
    grouped = str(d / "grouped.bam")
    assert port_main(["simulate", "grouped-reads", "-o", grouped,
                      "--num-families", "30", "--family-size", "3",
                      "--seed", "11"]) == 0
    r1, r2 = str(d / "r1.fq.gz"), str(d / "r2.fq.gz")
    assert port_main(["simulate", "fastq-reads", "-1", r1, "-2", r2,
                      "--num-families", "60", "--family-size", "4",
                      "--seed", "7"]) == 0
    return {"grouped": grouped, "fastq": (r1, r2)}


def _argvs(inputs, out):
    """Each job's argv on the port and on the JAX package (same command,
    the reference's device selection)."""
    return {
        "simplex": (["simplex", "-i", inputs["grouped"], "-o", out,
                     "--min-reads", "1", "--device", "cpu"],
                    ["simplex", "-i", inputs["grouped"], "-o", out,
                     "--min-reads", "1", "--devices", "1"]),
        "pipeline": (["pipeline", "-i", *inputs["fastq"], *PIPELINE_OPTS,
                      "-o", out, "--device", "cpu"],
                     ["pipeline", "-i", *inputs["fastq"], *PIPELINE_OPTS,
                      "-o", out]),
    }


def _records(path):
    with BamReader(path) as r:
        return ([ln for ln in r.header.text.splitlines()
                 if not ln.startswith("@PG")], [rec.data for rec in r])


@contextlib.contextmanager
def running(svc):
    svc.start()
    try:
        yield svc
    finally:
        svc.close()


@pytest.fixture
def service(sock_dir, tmp_path):
    rpt = tmp_path / "reports"
    rpt.mkdir()
    svc = JobService(os.path.join(sock_dir, "serve.sock"), workers=2,
                     queue_limit=4, report_dir=str(rpt))
    with running(svc):
        yield svc


def _standalone(argv):
    """The port's standalone bytes of ``argv`` (its output removed)."""
    out = argv[argv.index("-o") + 1]
    assert port_main(argv) == 0
    data = open(out, "rb").read()
    os.unlink(out)
    return data


# ---------------------------------------------------------------------------
# parity


@pytest.mark.parametrize("command", ["simplex", "pipeline"])
def test_job_bytes_equal_standalone_records_equal_jax(service, inputs,
                                                      tmp_path, command):
    out = str(tmp_path / f"{command}.bam")
    port_argv, jax_argv = _argvs(inputs, out)[command]
    assert jax_main(jax_argv) == 0
    want = _records(out)
    os.unlink(out)
    standalone = _standalone(port_argv)
    client = ServeClient(service.socket_path, timeout=10)
    job = client.wait(client.submit(port_argv)["id"], timeout=WAIT_S)
    assert job["state"] == "done", job["error"]
    assert open(out, "rb").read() == standalone
    assert _records(out) == want and want[1]
    report = json.load(open(job["report_path"]))
    assert validate_report(report) == []
    assert report["exit_status"] == 0 and report["command"] == command


def test_two_jobs_at_once_equal_standalone(service, inputs, tmp_path):
    """A pipeline and a simplex job run together on the two workers; each
    output is byte-identical to its standalone run."""
    argvs = {c: _argvs(inputs, str(tmp_path / f"{c}.bam"))[c][0]
             for c in ("simplex", "pipeline")}
    standalone = {c: _standalone(a) for c, a in argvs.items()}
    client = ServeClient(service.socket_path, timeout=10)
    ids = {c: client.submit(a)["id"] for c, a in argvs.items()}
    for c, jid in ids.items():
        job = client.wait(jid, timeout=WAIT_S)
        assert job["state"] == "done", job["error"]
        out = argvs[c][argvs[c].index("-o") + 1]
        assert open(out, "rb").read() == standalone[c], c


def test_concurrent_jobs_isolated_counters(service, inputs, tmp_path):
    """Two jobs at once produce per-job run reports whose record counts
    equal a solo run's (30 families x 3 pairs = 180 reads each)."""
    client = ServeClient(service.socket_path, timeout=10)
    jobs = [client.submit(_argvs(inputs, str(tmp_path / f"c{i}.bam"))[
        "simplex"][0]) for i in range(2)]
    done = [client.wait(j["id"], timeout=WAIT_S) for j in jobs]
    reports = [json.load(open(j["report_path"])) for j in done]
    for r in reports:
        assert validate_report(r) == []
        assert r["records"]["simplex"] == 180
        assert r["metrics"]["io.bytes_read"] == \
            reports[0]["metrics"]["io.bytes_read"]
        assert r["device"]["dispatches"] == reports[0]["device"]["dispatches"]


def test_launch_counters_add_up_and_stay_per_command():
    """Every wrapper counts through ``cuda_kernel.count_launch``: one lock
    for all counters, so launches from many threads add up, and each
    command's telemetry scope keeps its own tally."""
    from fgumi_tpu_torch.observe.scope import scoped_telemetry, spawn_thread
    from fgumi_tpu_torch.ops import canary, combine, cuda_kernel, \
        umi_hamming
    from fgumi_tpu_torch.ops import wire as W

    counters = [(cuda_kernel, "LAUNCHES"), (cuda_kernel, "FILTER_LAUNCHES"),
                (cuda_kernel, "RESIDENT_LAUNCHES"),
                (cuda_kernel, "PACKED2_LAUNCHES"), (W, "PACKED2_LAUNCHES"),
                (combine, "DUPLEX_COMBINE_LAUNCHES"),
                (combine, "CODEC_COMBINE_LAUNCHES"),
                (umi_hamming, "HAMMING_LAUNCHES"),
                (canary, "CANARY_LAUNCHES")]
    before = [getattr(m, c) for m, c in counters]
    per_thread, threads_per_job = 300, 4
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    scopes, threads = [], []
    try:
        for job in range(2):
            with scoped_telemetry(f"job{job}") as scope:
                scopes.append(scope)
                for _ in range(threads_per_job):
                    threads.append(spawn_thread(
                        lambda: [cuda_kernel.count_launch(m, c)
                                 for _ in range(per_thread)
                                 for m, c in counters]))
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
        for (m, c), b in zip(counters, before):
            setattr(m, c, b)
    each = per_thread * threads_per_job
    for (m, c), b in zip(counters, before):
        for scope in scopes:
            assert scope.launches(f"{m.__name__}.{c}") == each
    with scoped_telemetry("job") as scope:
        assert not any(port_cli._kernel_counters().values())
        cuda_kernel.count_launch(umi_hamming, "HAMMING_LAUNCHES")
        assert port_cli._kernel_counters()["umi_hamming"] == 1
    umi_hamming.HAMMING_LAUNCHES -= 1


def test_per_job_trace_file(service, inputs, tmp_path):
    client = ServeClient(service.socket_path, timeout=10)
    job = client.submit(["sort", "-i", inputs["grouped"], "-o",
                         str(tmp_path / "traced.bam")], trace=True)
    job = client.wait(job["id"], timeout=WAIT_S)
    assert job["state"] == "done", job["error"]
    obj = json.load(open(job["trace_path"]))
    names = {e["name"] for e in obj["traceEvents"] if e["ph"] == "X"}
    assert "pipeline.read" in names or "bgzf.compress" in names
    job2 = client.wait(client.submit(
        ["sort", "-i", inputs["grouped"], "-o",
         str(tmp_path / "untraced.bam")])["id"], timeout=WAIT_S)
    assert job2["state"] == "done" and job2["trace_path"] is None


def test_cancel_and_status_listing(service, inputs, tmp_path):
    client = ServeClient(service.socket_path, timeout=10)
    assert client.status()["workers"] == 2
    job = client.submit(["sort", "-i", inputs["grouped"],
                         "-o", str(tmp_path / "s.bam")])
    try:
        assert client.cancel(job["id"])["state"] == "cancelled"
    except ServeError as e:  # it may already run on a fast machine
        assert "running" in str(e) or "already" in str(e) \
            or "starting" in str(e)
    assert job["id"] in {j["id"] for j in client.status()["jobs"]}
    client.wait(job["id"], timeout=WAIT_S)


def test_shutdown_finishes_queued_jobs(sock_dir, tmp_path, inputs):
    svc = JobService(os.path.join(sock_dir, "sd.sock"), workers=1,
                     queue_limit=4, report_dir=str(tmp_path))
    with running(svc):
        client = ServeClient(svc.socket_path, timeout=10)
        outs = [str(tmp_path / f"sd{i}.bam") for i in range(3)]
        ids = [client.submit(["sort", "-i", inputs["grouped"], "-o", o])[
            "id"] for o in outs]
        assert client.shutdown()["draining"] is True
        waiter = threading.Thread(target=svc.wait_until_shutdown)
        waiter.start()
        waiter.join(timeout=WAIT_S)
        assert not waiter.is_alive()
        assert all(os.path.exists(o) for o in outs)
        assert all(svc.registry.get(j).state == "done" for j in ids)
        with pytest.raises(ServeError, match="draining"):
            client.submit(["sort", "-i", inputs["grouped"], "-o", outs[0]])


def test_socket_claim_rejects_live_daemon_replaces_dead(sock_dir):
    sock = os.path.join(sock_dir, "claim.sock")
    with running(JobService(sock, workers=1)):
        with pytest.raises(SocketBusy):
            JobService(sock, workers=1).start()
    # a dead daemon's socket file: a bound socket nobody listens on
    dead = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    dead.bind(sock)
    dead.close()
    assert os.path.exists(sock)
    with running(JobService(sock, workers=1)) as svc2:
        assert ServeClient(sock, timeout=5).ping()["ok"]
        assert svc2.socket_path == sock
    assert not os.path.exists(sock)


# ---------------------------------------------------------------------------
# TCP


@pytest.fixture
def tcp_service():
    svc = JobService(None, workers=1, queue_limit=2, tcp=("127.0.0.1", 0))
    svc.start_transport()
    yield svc
    svc.close()


def test_tcp_serves_submit_and_status(tcp_service):
    client = ServeClient(f"tcp:127.0.0.1:{tcp_service.tcp_port}", timeout=10)
    job = client.submit(["sort", "-i", "a", "-o", "b"])
    assert job["state"] == "queued"
    assert client.job(job["id"])["id"] == job["id"]
    resp = tcp_service.handle_request({"v": 1, "op": "hello"})
    assert resp["ok"] is True and resp["auth"] == "open"


def test_tcp_token_handshake():
    svc = JobService(None, workers=1, tcp=("127.0.0.1", 0),
                     auth_token="s3cret")
    svc.start_transport()
    try:
        addr = f"tcp:127.0.0.1:{svc.tcp_port}"
        assert ServeClient(addr, timeout=10, token="s3cret").ping()[
            "tool"] == "fgumi-tpu-torch"
        with pytest.raises(ServeError, match="handshake rejected"):
            ServeClient(addr, timeout=10, token="nope").ping()
        with pytest.raises(ServeError, match="authentication required"):
            ServeClient(addr, timeout=10).ping()
    finally:
        svc.close()


def _wait_live(svc, n=1):
    deadline = time.monotonic() + 5
    while svc._frames.live_connections() < n \
            and time.monotonic() < deadline:
        time.sleep(0.01)
    assert svc._frames.live_connections() >= n


def test_tcp_connection_cap_rejected_with_reason():
    svc = JobService(None, workers=1, tcp=("127.0.0.1", 0), conn_cap=1)
    svc.start_transport()
    try:
        hold = socket.create_connection(("127.0.0.1", svc.tcp_port),
                                        timeout=10)
        _wait_live(svc)
        over = socket.create_connection(("127.0.0.1", svc.tcp_port),
                                        timeout=10)
        resp = protocol.read_frame(over.makefile("rb"))
        assert resp["ok"] is False
        assert "connection limit reached" in resp["error"]
        over.close()
        hold.close()
    finally:
        svc.close()


def test_tcp_io_deadline_closes_idle_connection():
    svc = JobService(None, workers=1, tcp=("127.0.0.1", 0),
                     io_timeout_s=0.3)
    svc.start_transport()
    try:
        conn = socket.create_connection(("127.0.0.1", svc.tcp_port),
                                        timeout=10)
        t0 = time.monotonic()
        assert conn.makefile("rb").readline() == b""
        assert time.monotonic() - t0 < 5.0
        conn.close()
    finally:
        svc.close()


def test_unix_connections_do_not_consume_tcp_cap(sock_dir):
    svc = JobService(os.path.join(sock_dir, "s.sock"), workers=1,
                     tcp=("127.0.0.1", 0), conn_cap=1)
    svc.start_transport()
    try:
        hold = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        hold.connect(svc.socket_path)
        _wait_live(svc)
        client = ServeClient(f"tcp:127.0.0.1:{svc.tcp_port}", timeout=10)
        assert client.ping()["tool"] == "fgumi-tpu-torch"
        hold.close()
    finally:
        svc.close()


@pytest.mark.parametrize("addr", [
    "unix:/tmp/a.sock", "/tmp/a.sock", "relative.sock", "tcp:127.0.0.1:7001",
    "tcp:my.host.example:80", "", "unix:", "tcp:9000", "tcp:host:",
    "tcp:host:notaport", "tcp:host:70000", "somehost:123"])
def test_parse_address_equal(addr):
    from fgumi_tpu.serve import transport as jax_transport

    def outcome(mod):
        try:
            return mod.parse_address(addr)
        except ValueError as e:
            return str(e)

    assert outcome(transport) == outcome(jax_transport)


def test_transport_units(tmp_path, monkeypatch):
    from fgumi_tpu.serve import transport as jax_transport

    for host in ("127.0.0.1", "localhost", "0.0.0.0", "192.168.1.10", ""):
        assert transport.is_loopback(host) == jax_transport.is_loopback(host)
    p = transport.RetryPolicy(attempts=5, base_s=0.25, cap_s=1.0, jitter=0.0)
    assert [p.delay_s(k) for k in (1, 2, 3, 4)] == [0.25, 0.5, 1.0, 1.0]
    q = transport.RetryPolicy(base_s=1.0, cap_s=1.0, jitter=0.5,
                              rng=__import__("random").Random(7).random)
    assert all(0.5 <= q.delay_s(k) <= 1.0 for k in range(1, 20))
    assert transport.RetryPolicy.none().attempts == 1
    for bad in ({"attempts": 0}, {"jitter": 2.0}):
        with pytest.raises(ValueError):
            transport.RetryPolicy(**bad)
    f = tmp_path / "tok"
    f.write_text("  s3cret\n")
    assert transport.load_token(str(f)) == "s3cret"
    (tmp_path / "empty").write_text("  \n")
    with pytest.raises(ValueError, match="empty"):
        transport.load_token(str(tmp_path / "empty"))
    monkeypatch.setenv(transport.TOKEN_ENV, "env-secret")
    assert transport.load_token(None) == "env-secret"
    monkeypatch.delenv(transport.TOKEN_ENV)
    assert transport.load_token(None) is None
    with pytest.raises(ValueError, match="without a handshake token"):
        transport.TcpListener("0.0.0.0", 0, token=None)
    assert transport.TcpListener("127.0.0.1", 0, token="s").require_auth
    assert not transport.TcpListener("127.0.0.1", 0).require_auth
    with pytest.raises(ValueError, match="conn_cap"):
        transport.TcpListener("127.0.0.1", 0, conn_cap=-1)


def test_client_retries_follow_policy(monkeypatch):
    """Idempotent requests retry on the policy's capped schedule; cancel,
    shutdown and a keyless submit never retry."""
    from fgumi_tpu_torch.serve import client as client_mod

    policy = transport.RetryPolicy(attempts=3, base_s=0.2, cap_s=1.0,
                                   jitter=0.0)
    c = ServeClient("/nonexistent.sock", retry_policy=policy)
    slept = []
    monkeypatch.setattr(client_mod.time, "sleep",
                        lambda s: slept.append(round(s, 3)))
    with pytest.raises(TransportError, match="cannot reach daemon"):
        c.ping()
    assert slept == [0.2, 0.4]
    calls = []

    def once(obj, timeout=None):
        calls.append(obj["op"])
        raise client_mod._Retryable(ServeError("connection reset"))

    monkeypatch.setattr(c, "_request_once", once)
    for op, n in ((lambda: c.cancel("j-1"), 1), (c.shutdown, 1),
                  (c.status, 3), (lambda: c.submit(["sort"]), 1),
                  (lambda: c.submit(["sort"], dedupe="k"), 3)):
        calls.clear()
        with pytest.raises(ServeError):
            op()
        assert len(calls) == n


# ---------------------------------------------------------------------------
# crash recovery


def _mk_job(jid, argv=("sort", "-i", "x")):
    return Job(jid, list(argv), "normal", argv0="fgumi-tpu-torch")


def test_recovery_requeues_under_original_id_and_dedupes(sock_dir, tmp_path,
                                                         inputs):
    """A journal left by a killed daemon (a job submitted and running, no
    end) drives the requeue on start: the job runs to its end under its
    original id, and its dedupe key answers a resubmit with that record."""
    jpath = str(tmp_path / "journal.jsonl")
    out = str(tmp_path / "out.bam")
    argv = ["sort", "-i", inputs["grouped"], "-o", out, "--order",
            "template-coordinate"]
    j = journal_mod.JobJournal(jpath)
    job = _mk_job("j-3", argv)
    j.record_submit(job, dedupe="run-42")
    job.state = "running"
    j.record_state(job)
    j.close()
    svc = JobService(os.path.join(sock_dir, "s.sock"), workers=1,
                     journal_path=jpath)
    try:
        svc.recover()
        svc.scheduler.start()
        deadline = time.monotonic() + WAIT_S
        while svc.registry.get("j-3").state not in ("done", "failed") \
                and time.monotonic() < deadline:
            time.sleep(0.05)
        assert svc.registry.get("j-3").state == "done"
        assert os.path.exists(out)
        resp = svc.handle_request({"v": 1, "op": "submit", "argv": argv,
                                   "dedupe": "run-42"})
        assert resp["ok"] and resp["deduped"] is True
        assert resp["job"]["id"] == "j-3"
        resp2 = svc.handle_request({"v": 1, "op": "submit", "argv": [
            "sort", "-i", inputs["grouped"], "-o",
            str(tmp_path / "o2.bam"), "--order", "template-coordinate"]})
        assert resp2["ok"] and resp2["job"]["id"] == "j-4"
        svc.scheduler.drain()
        assert svc.scheduler.join(timeout=WAIT_S)
        assert svc.journal_stats["requeued"] == 1
    finally:
        svc.close()
    rep = journal_mod.replay(jpath)
    assert rep.by_id["j-3"]["state"] == "done"
    assert rep.by_id["j-4"]["state"] == "done"
    assert rep.dedupe["run-42"] == "j-3"


def test_recovery_dedupe_keys(sock_dir, tmp_path):
    """Replay never rebinds a cancelled (admission-rejected) job's key, and
    a requeue refused by a smaller capacity releases its key."""
    jpath = str(tmp_path / "a.jsonl")
    j = journal_mod.JobJournal(jpath)
    rejected = _mk_job("j-1")
    j.record_submit(rejected, dedupe="key-r")
    rejected.state = "cancelled"
    j.record_state(rejected)
    done = _mk_job("j-2")
    j.record_submit(done, dedupe="key-d")
    done.state, done.exit_status = "done", 0
    j.record_state(done)
    j.close()
    svc = JobService(os.path.join(sock_dir, "a.sock"), journal_path=jpath)
    try:
        svc.recover()
        assert "key-r" not in svc._dedupe
        assert svc._dedupe.get("key-d") == "j-2"
    finally:
        svc.close()
    jpath = str(tmp_path / "b.jsonl")
    j = journal_mod.JobJournal(jpath)
    j.record_submit(_mk_job("j-1"), dedupe="key-1")
    j.record_submit(_mk_job("j-2"), dedupe="key-2")
    j.close()
    svc = JobService(os.path.join(sock_dir, "b.sock"), workers=1,
                     queue_limit=0, journal_path=jpath)
    try:
        svc.recover()
        assert svc._dedupe.get("key-1") == "j-1"
        assert "key-2" not in svc._dedupe
        assert svc.registry.get("j-2").state == "cancelled"
        assert svc.journal_stats == {"replayed": 2, "requeued": 1,
                                     "truncated_bytes": 0}
    finally:
        svc.close()


def test_recovery_sweeps_stale_report_temps(sock_dir, tmp_path):
    rpt = tmp_path / "reports"
    rpt.mkdir()
    jpath = str(tmp_path / "journal.jsonl")
    j = journal_mod.JobJournal(jpath)
    j.record_submit(_mk_job("j-1"))
    mark = _mk_job("j-1")
    mark.state, mark.exit_status = "done", 0
    j.record_state(mark)
    j.close()
    stale = rpt / ".j-1.report.json.tmp.999999.1"
    stale.write_bytes(b"{")
    os.utime(stale, (1, 1))
    live = rpt / f".j-2.report.json.tmp.{os.getpid()}.1"
    live.write_bytes(b"{")
    svc = JobService(os.path.join(sock_dir, "s.sock"), report_dir=str(rpt),
                     journal_path=jpath)
    try:
        svc.recover()
        assert not stale.exists() and live.exists()
    finally:
        svc.close()


# ---------------------------------------------------------------------------
# chaos


def test_serve_dispatch_fault_fails_job_daemon_survives(sock_dir, tmp_path,
                                                        monkeypatch):
    from fgumi_tpu_torch.utils import faults

    monkeypatch.setenv("FGUMI_TPU_FAULT", "serve.dispatch:raise:1.0:1")
    faults.reset()
    svc = JobService(os.path.join(sock_dir, "chaos.sock"), workers=1,
                     queue_limit=2, report_dir=str(tmp_path))
    try:
        with running(svc):
            client = ServeClient(svc.socket_path, timeout=10)
            argv = ["simulate", "grouped-reads", "--num-families", "2",
                    "--family-size", "2", "--seed", "1", "-o"]
            out1, out2 = str(tmp_path / "o1.bam"), str(tmp_path / "o2.bam")
            j1 = client.wait(client.submit(argv + [out1])["id"],
                             timeout=WAIT_S)
            assert j1["state"] == "failed"
            assert "injected fault at serve.dispatch" in j1["error"]
            assert not os.path.exists(out1)
            j2 = client.wait(client.submit(argv + [out2])["id"],
                             timeout=WAIT_S)
            assert j2["state"] == "done", j2["error"]
            assert os.path.exists(out2)
    finally:
        monkeypatch.delenv("FGUMI_TPU_FAULT")
        faults.reset()


# ---------------------------------------------------------------------------
# the two packages' clients and daemons


def test_port_client_talks_to_jax_daemon(sock_dir):
    svc = JaxJobService(os.path.join(sock_dir, "jax.sock"), workers=1,
                        queue_limit=2)
    svc.start_transport()
    try:
        client = ServeClient(svc.socket_path, timeout=10)
        assert client.ping()["tool"] == "fgumi-tpu"
        job = client.submit(["sort", "-i", "a", "-o", "b"])
        assert job["state"] == "queued" and job["id"] == "j-1"
        status = client.status()
        assert [j["id"] for j in status["jobs"]] == ["j-1"]
        assert client.job("j-1")["argv"] == ["sort", "-i", "a", "-o", "b"]
    finally:
        svc.close()


def test_jax_client_talks_to_port_daemon(sock_dir):
    svc = JobService(os.path.join(sock_dir, "port.sock"), workers=1,
                     queue_limit=2)
    svc.start_transport()
    try:
        client = JaxClient(svc.socket_path, timeout=10)
        assert client.ping()["tool"] == "fgumi-tpu-torch"
        job = client.submit(["sort", "-i", "a", "-o", "b"])
        assert job["state"] == "queued" and job["id"] == "j-1"
        assert [j["id"] for j in client.status()["jobs"]] == ["j-1"]
        assert client.stats()["scheduler"]["queued"] == 1
        assert svc.registry.get("j-1").argv0  # the JAX client's argv0
    finally:
        svc.close()


# ---------------------------------------------------------------------------
# the CLI


def _errors(caplog):
    return [r.getMessage() for r in caplog.records
            if r.levelno >= logging.ERROR]


@pytest.mark.parametrize("flags,reason", [
    # the fleet options are ported: their misuse exits 2 as the JAX CLI's
    # does (tests/test_torch_fleet_lease.py holds them to it)
    (["--journal-dir", "fleet", "--journal", "j.jsonl"],
     "--journal and --journal-dir are exclusive"),
    (["--journal-dir", "fleet", "--lease-scan-period", "1", "--fleet-id",
      "a/b"], "invalid fleet id 'a/b'"),
    (["--journal-dir", "fleet", "--fleet-id", ".a"], "invalid fleet id"),
    # the coalescer is ported: its window no longer refuses, so the next
    # misused option is the one reported
    (["--coalesce-window-ms", "2", "--health-period", "-1"],
     "--health-period must be >= 0"),
    (["--compile-cache", "cache"], "--compile-cache: JAX-only"),
    (["--coalesce-window-ms", "-1"], "--coalesce-window-ms must be >= 0"),
    ([], None),
    (["--workers", "0"], "--workers must be >= 1"),
    (["--queue-limit", "-1"], "--queue-limit must be >= 0"),
    (["--max-per-client", "-1"], "--max-per-client must be >= 0"),
    (["--max-frame-bytes", "100"], "--max-frame-bytes must be >= 1024"),
    (["--metrics-port", "70000"], "--metrics-port must be in 0..65535"),
    (["--conn-cap", "-1"], "--conn-cap must be >= 0"),
    (["--health-period", "-1"], "--health-period must be >= 0"),
    (["--tcp", "nohostport"], "--tcp: tcp address must be"),
    (["--tcp", "0.0.0.0:0"], "without a handshake token")])
def test_serve_refusals_exit_2_before_binding(sock_dir, caplog, flags,
                                              reason):
    sock = os.path.join(sock_dir, "r.sock")
    socket_flags = [] if reason is None else ["--socket", sock]
    with caplog.at_level(logging.ERROR, logger="fgumi_tpu_torch"):
        assert port_main(["serve", *socket_flags, "--no-warmup",
                          *flags]) == 2
    errors = _errors(caplog)
    assert len(errors) == 1 and "\n" not in errors[0]
    assert (reason or "serve needs --socket and/or --tcp") in errors[0]
    assert not os.path.exists(sock)


def test_serve_busy_socket_and_port_exit_2(sock_dir, caplog):
    sock = os.path.join(sock_dir, "dup.sock")
    svc = JobService(sock, workers=1)
    svc.start_transport()
    try:
        assert port_main(["serve", "--socket", sock, "--no-warmup"]) == 2
        assert os.path.exists(sock)
        assert ServeClient(sock, timeout=5).ping()["ok"]
    finally:
        svc.close()
    blocker = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    blocker.bind(("127.0.0.1", 0))
    blocker.listen(1)
    try:
        other = os.path.join(sock_dir, "s.sock")
        rc = port_main(["serve", "--tcp",
                        f"127.0.0.1:{blocker.getsockname()[1]}",
                        "--socket", other, "--no-warmup"])
        assert rc == 2 and not os.path.exists(other)
    finally:
        blocker.close()


def test_serve_warm_up_without_cuda_exits_2(sock_dir, caplog):
    """The warm-up needs the card: without CUDA it exits 2 with its line
    after the socket checks, and serves nothing cold."""
    sock = os.path.join(sock_dir, "w.sock")
    with caplog.at_level(logging.ERROR, logger="fgumi_tpu_torch"):
        assert port_main(["serve", "--socket", sock]) == 2
    errors = _errors(caplog)
    assert len(errors) == 1 and "serve: warm-up failed" in errors[0]
    assert not os.path.exists(sock)


@contextlib.contextmanager
def _serve_cli(sock, *flags):
    """``serve`` through the CLI on a thread; shut down on exit."""
    rc = {}
    t = threading.Thread(target=lambda: rc.setdefault(
        "rc", port_main(["serve", "--socket", sock, "--no-warmup",
                         *flags])))
    t.start()
    try:
        deadline = time.monotonic() + 30
        while not os.path.exists(sock) and time.monotonic() < deadline:
            time.sleep(0.02)
        client = ServeClient(sock, timeout=10)
        client.ping()
        yield client
    finally:
        with contextlib.suppress(ServeError):
            ServeClient(sock, timeout=10).shutdown()
        t.join(timeout=WAIT_S)
        assert not t.is_alive()
    assert rc["rc"] == 0


def test_serve_cli_submit_stats_jobs(sock_dir, tmp_path, inputs, capsys,
                                     caplog):
    """``serve`` (with the accepted ``--coalesce-window-ms 0``), then
    ``submit`` (bytes equal to standalone), ``stats --section``, ``jobs``
    listing and ``--id``, ``jobs --scatter`` refused as by the reference's
    daemon, and a ``--device cuda`` job failing on this CUDA-less host with
    the standalone exit 2 on its record."""
    sock = os.path.join(sock_dir, "cli.sock")
    out = str(tmp_path / "cli.bam")
    argv = _argvs(inputs, out)["simplex"][0]
    standalone = _standalone(argv)
    with _serve_cli(sock, "--coalesce-window-ms", "0") as client:
        assert port_main(["submit", "--socket", sock, *argv]) == 0
        assert open(out, "rb").read() == standalone
        capsys.readouterr()
        assert port_main(["stats", "--socket", sock, "--section",
                          "scheduler"]) == 0
        assert json.loads(capsys.readouterr().out)["scheduler"][
            "workers"] == 2
        assert port_main(["stats", "--socket", sock, "--section",
                          "nope"]) == 2
        assert port_main(["jobs", "--socket", sock]) == 0
        listing = capsys.readouterr().out
        assert "j-1" in listing and "done" in listing
        assert port_main(["jobs", "--socket", sock, "--id", "j-1"]) == 0
        assert json.loads(capsys.readouterr().out)["state"] == "done"
        with caplog.at_level(logging.ERROR, logger="fgumi_tpu_torch"):
            caplog.clear()
            assert port_main(["jobs", "--socket", sock, "--scatter"]) == 2
        want = JaxJobService(None).handle_request(
            {"v": 1, "op": "scatter"})["error"]
        assert _errors(caplog) == [f"jobs: {want}"]
        cuda_argv = argv[:-2] + ["--device", "cuda"]
        assert port_main(["submit", "--socket", sock, *cuda_argv]) == 2
        job = client.job("j-2")
        assert job["state"] == "failed" and job["exit_status"] == 2
        assert port_main(["jobs", "--socket", sock, "--drain"]) == 0
        assert client.status()["draining"] is True


def test_submit_without_command_and_unreachable_daemon(sock_dir):
    assert port_main(["submit", "--socket",
                      os.path.join(sock_dir, "x.sock")]) == 2
    assert port_main(["submit", "--socket", os.path.join(sock_dir, "x.sock"),
                      "sort", "-i", "a", "-o", "b"]) == 2
    assert port_main(["stats", "--socket",
                      os.path.join(sock_dir, "x.sock")]) == 2


def test_governor_pressure_sheds_submits_and_submit_waits(sock_dir,
                                                          monkeypatch):
    """Under a resource watermark the daemon sheds new submits with the
    reference's ``resource_pressure`` answer and retry hint (an idempotent
    resubmit of a known job still answers); ``submit`` sleeps exactly that
    hint and resubmits while it may wait."""
    from fgumi_tpu.serve.daemon import JobService as JaxService
    from fgumi_tpu.utils.governor import GOVERNOR as JAX_GOVERNOR
    from fgumi_tpu_torch.serve.client import ShedError
    from fgumi_tpu_torch.utils.governor import GOVERNOR

    svc = JobService(os.path.join(sock_dir, "shed.sock"), workers=1)
    ref = JaxService(None, workers=1)
    req = {"v": 1, "op": "submit", "argv": ["sort"], "dedupe": "k"}
    try:
        first = svc.handle_request(req)
        assert first["ok"]
        for gov in (GOVERNOR, JAX_GOVERNOR):
            gov.state, gov._soft_reason = "soft", "rss 9 MiB >= soft 8 MiB"
        fresh = {"v": 1, "op": "submit", "argv": ["sort"]}
        got, want = svc.handle_request(fresh), ref.handle_request(fresh)
        assert got == want == {
            "v": 1, "ok": False, "retry_after_s": 5.0,
            "error": "resource_pressure: rss 9 MiB >= soft 8 MiB"}
        assert svc.handle_request(req)["deduped"] is True
        assert GOVERNOR.snapshot()["shed"] == 1
    finally:
        GOVERNOR.reset_for_tests()
        JAX_GOVERNOR.reset_for_tests()

    class Shedding:
        def __init__(self):
            self.calls = 0

        def submit(self, **kw):
            self.calls += 1
            if self.calls < 3:
                raise ShedError("resource_pressure: x", 5.0)
            return {"id": "j-1"}

    slept = []
    client = Shedding()
    assert port_cli._submit_with_shed_retry(
        client, {}, wait=True, sleep=slept.append) == {"id": "j-1"}
    assert slept == [5.0, 5.0]
    with pytest.raises(ShedError):
        port_cli._submit_with_shed_retry(Shedding(), {}, wait=False,
                                         sleep=slept.append)
