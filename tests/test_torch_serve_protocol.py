"""The port's job-service wire layer against the JAX package's.

- frames: ``encode_frame``/``decode_frame`` byte- and value-equal over a
  seeded corpus of requests and responses, and ``read_frame``'s size cap,
  torn frames and clean EOF answered alike;
- ``validate_request``: the same verdict and reason on every frame of the
  corpus and on the reference's explicit cases;
- the job registry's state machine and the scheduler's admission,
  priority, quota, cancel and drain decisions equal on the same script;
- journals: one written by the JAX package's ``JobJournal`` replays to the
  same ``ReplayResult`` on the port's ``replay``, and the other way round
  (torn tails, garbage lines and version mismatches truncated alike);
- a live port daemon through the reference's golden conversations (Unix
  socket and an auth-required TCP listener): every response equal to the
  golden frame but the ``tool`` name and the ``stats`` sections of parts
  the port does not have.

Every daemon here is stopped in a fixture finalizer, and every wait is
bounded.
"""

import json
import os
import random
import shutil
import socket
import tempfile
import threading
import time

import pytest

from fgumi_tpu.serve import jobs as jax_jobs
from fgumi_tpu.serve import journal as jax_journal
from fgumi_tpu.serve import protocol as jax_protocol
from fgumi_tpu.serve import scheduler as jax_scheduler
from fgumi_tpu_torch.serve import jobs, journal, protocol, scheduler
from fgumi_tpu_torch.serve.daemon import JobService

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                      "serve_protocol_golden.json")

#: stats sections whose value depends on what else this process ran (the
#: router, the routing snapshot, the sentinel and the coalescer are
#: process-wide): compared by presence, their values normalized away as
#: the reference's golden file has them (None on a fresh daemon)
ABSENT_STATS = ("router", "routing_state", "audit", "coalesce")


@pytest.fixture
def sock_dir():
    """A short directory for Unix sockets (their paths are capped at 107
    bytes), removed afterwards."""
    d = tempfile.mkdtemp(prefix="fts")
    yield d
    shutil.rmtree(d, ignore_errors=True)


# ---------------------------------------------------------------------------
# frames


def _word(rng):
    alphabet = "abcXYZ019-_./:é€ \t\"\\"
    return "".join(rng.choice(alphabet) for _ in range(rng.randint(0, 12)))


def _value(rng, depth=0):
    kind = rng.randrange(8 if depth < 2 else 6)
    if kind == 0:
        return rng.randint(-2 ** 40, 2 ** 40)
    if kind == 1:
        return rng.random() * 10 ** rng.randint(-3, 9)
    if kind == 2:
        return _word(rng)
    if kind == 3:
        return rng.choice([None, True, False])
    if kind == 4:
        return [_word(rng) for _ in range(rng.randint(0, 5))]
    if kind == 5:
        return rng.choice(list(jax_protocol.PRIORITIES) + ["asap", ""])
    if kind == 6:
        return [_value(rng, depth + 1) for _ in range(rng.randint(0, 3))]
    return {_word(rng): _value(rng, depth + 1)
            for _ in range(rng.randint(0, 3))}


def corpus(seed: int, n: int = 150):
    """Seeded request-like frames: mostly well-formed ones of every op,
    with each field sometimes of the wrong type or missing."""
    rng = random.Random(seed)
    ops = sorted(jax_protocol.OPS) + ["gather", "explode", None, 3]
    out = []
    for _ in range(n):
        obj = {"v": rng.choice([1, 1, 1, 1, 2, "1", None]),
               "op": rng.choice(ops)}
        for key in ("argv", "priority", "argv0", "dedupe", "client",
                    "shard", "token", "id", "trace", "tag", "traceparent",
                    "sent_unix"):
            if rng.random() < 0.4:
                obj[key] = _value(rng)
        if obj["op"] == "submit" and rng.random() < 0.6:
            obj["argv"] = [_word(rng) or "sort"
                           for _ in range(rng.randint(1, 6))]
        if rng.random() < 0.3:
            obj[_word(rng)] = _value(rng)
        out.append(obj)
    return out


@pytest.mark.parametrize("seed", range(4))
def test_frames_byte_equal(seed):
    for obj in corpus(seed):
        for frame in (obj, protocol.ok_response(**{"job": obj}),
                      protocol.error_response("reason", job=obj)):
            got = protocol.encode_frame(frame)
            assert got == jax_protocol.encode_frame(frame)
            assert got.endswith(b"\n") and b"\n" not in got[:-1]
            assert protocol.decode_frame(got) == \
                jax_protocol.decode_frame(got) == json.loads(got)
    assert protocol.ok_response(a=1) == jax_protocol.ok_response(a=1)
    assert protocol.error_response("x", b=2) == \
        jax_protocol.error_response("x", b=2)


@pytest.mark.parametrize("name,data,limit", [
    ("eof", b"", 64),
    ("one", b'{"v":1,"op":"ping"}\n', 64),
    ("at_limit", b'{"k":"' + b"x" * 55 + b'"}\n', 64),
    ("over_limit", b'{"k":"' + b"x" * 56 + b'"}\n', 64),
    ("torn", b'{"v":1,"op":"pi', 64),
    ("not_json", b"this is not json\n", 64),
    ("not_object", b"[1, 2]\n", 64),
    ("two", b'{"a":1}\n{"b":2}\n', 64)])
def test_read_frame_equal(name, data, limit):
    import io

    def outcome(mod):
        stream = io.BytesIO(data)
        got = []
        for _ in range(3):
            try:
                got.append(mod.read_frame(stream, limit))
            except mod.ProtocolError as e:
                got.append(("error", str(e)))
                break
        return got

    assert outcome(protocol) == outcome(jax_protocol)
    assert protocol.MAX_FRAME_BYTES == jax_protocol.MAX_FRAME_BYTES
    assert protocol.PRIORITIES == jax_protocol.PRIORITIES
    assert protocol.OPS == jax_protocol.OPS


@pytest.mark.parametrize("seed", range(4))
def test_validate_request_equal(seed):
    verdicts = [protocol.validate_request(obj) for obj in corpus(seed)]
    assert verdicts == [jax_protocol.validate_request(obj)
                        for obj in corpus(seed)]
    # the corpus reaches both verdicts and several reasons
    assert None in verdicts and len(set(verdicts)) > 5


@pytest.mark.parametrize("req,reason", [
    ({"v": 1, "op": "ping"}, None),
    ({"v": 2, "op": "ping"}, "unsupported protocol version"),
    ({"v": 1, "op": "x"}, "unknown op"),
    ({"v": 1, "op": "submit", "argv": []}, "requires argv"),
    ({"v": 1, "op": "submit", "argv": ["sort", 3]}, "requires argv"),
    ({"v": 1, "op": "submit", "argv": ["sort"], "priority": "asap"},
     "unknown priority"),
    ({"v": 1, "op": "cancel"}, "requires id"),
    ({"v": 1, "op": "hello", "token": 5}, "hello token"),
    ({"v": 1, "op": "submit", "argv": ["sort"], "shard": "0/2"},
     "shard must be an object")])
def test_validate_request_reasons(req, reason):
    got = protocol.validate_request(req)
    assert got == jax_protocol.validate_request(req)
    assert (got is None) if reason is None else (reason in got)


# ---------------------------------------------------------------------------
# the registry and the scheduler


def _lifecycle(mod):
    """One script through a registry: the states, counts and wire records
    after each step, and the refused transitions."""
    trace = []
    reg = mod.JobRegistry(keep_finished=2)
    a = reg.create(["sort"], "high", tag="t1", client="c")
    b = reg.create(["dedup"], "low")
    c = reg.create(["simplex"], "normal")
    reg.mark_running(a)
    trace.append(reg.counts())
    reg.mark_done(a, 0)
    reg.mark_running(b)
    reg.mark_done(b, 2)
    for bad in (lambda: reg.mark_done(c, 0), lambda: reg.mark_running(a)):
        try:
            bad()
        except mod.InvalidTransition as e:
            trace.append(str(e))
    reg.mark_cancelled(c)
    trace.append(reg.counts())
    trace.append([j.id for j in reg.list()])  # keep_finished evicts a
    done = mod.Job("j-7", ["sort"], "normal", argv0="x")
    done.state = "done"
    reg.restore(done)
    trace.append(reg.create(["sort"], "normal").id)
    for job in (b, c):
        wire = job.to_wire()
        trace.append({k: v for k, v in wire.items()
                      if not k.endswith("_unix")})
    return trace


def test_registry_state_machine_equal():
    assert _lifecycle(jobs) == _lifecycle(jax_jobs)


class _GatedExecutor:
    """Executor whose jobs block until released (deterministic occupancy)."""

    def __init__(self):
        self.gate = threading.Event()
        self.order = []
        self.started = threading.Semaphore(0)

    def __call__(self, job):
        self.order.append(job.id)
        self.started.release()
        assert self.gate.wait(10)
        return 0


def _wait_until(pred, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.01)
    return False


#: submit scripts: (workers, queue_limit, max_per_client, steps); a step is
#: ("submit", priority, client), ("cancel", job index or id), "drain",
#: "release" (the gate opens) or "wait_start"
SCRIPTS = {
    "capacity": (1, 1, 0, [("submit", "normal", None), "wait_start",
                           ("submit", "normal", None),
                           ("submit", "normal", None),
                           ("submit", "high", None)]),
    "priority": (1, 10, 0, [("submit", "normal", None), "wait_start",
                            ("submit", "low", None),
                            ("submit", "high", None),
                            ("submit", "normal", None),
                            ("submit", "high", None), "release"]),
    "quota": (2, 4, 1, [("submit", "normal", "a"), ("submit", "normal", "a"),
                        ("submit", "normal", "b"), ("submit", "low", None),
                        ("submit", "normal", "b"), ("submit", "high", None),
                        ("submit", "normal", None)]),
    "cancel": (1, 5, 0, [("submit", "normal", None), "wait_start",
                         ("submit", "normal", None),
                         ("submit", "low", None), ("cancel", 1),
                         ("cancel", 0), ("cancel", "j-404"), ("cancel", 1),
                         "release"]),
    "drain": (1, 5, 0, [("submit", "normal", None), "wait_start",
                        ("submit", "normal", None), "drain",
                        ("submit", "high", None), "release"]),
}


def _run_script(sched_mod, jobs_mod, name):
    workers, limit, per_client, steps = SCRIPTS[name]
    reg = jobs_mod.JobRegistry()
    ex = _GatedExecutor()
    sched = sched_mod.Scheduler(ex, reg, workers=workers, queue_limit=limit,
                                max_per_client=per_client)
    sched.start()
    trace, made = [], []
    try:
        for step in steps:
            if step == "wait_start":
                assert ex.started.acquire(timeout=10)
            elif step == "release":
                ex.gate.set()
            elif step == "drain":
                sched.drain()
                trace.append(("drain", sched.draining))
            elif step[0] == "submit":
                job = reg.create(["x"], step[1], client=step[2])
                made.append(job)
                trace.append(("submit", job.id, sched.submit(job)))
                trace.append(("quota", sched.client_quota_state()))
            else:
                target = step[1] if isinstance(step[1], str) \
                    else made[step[1]].id
                trace.append(("cancel", target, sched.cancel(target)))
        ex.gate.set()
        sched.drain()
        assert sched.join(timeout=10)
        trace.append(("order", ex.order))
        trace.append(("states", [j.state for j in made]))
        trace.append(("depth", sched.depth()))
    finally:
        ex.gate.set()
        sched.drain()
        sched.join(timeout=10)
    return trace


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_scheduler_decisions_equal(name):
    got = _run_script(scheduler, jobs, name)
    assert got == _run_script(jax_scheduler, jax_jobs, name)
    decisions = [t[2] for t in got if t[0] == "submit"]
    if name in ("capacity", "quota", "drain"):
        assert any(not ok for ok, _ in decisions)  # a refusal was reached


def test_executor_exception_marks_job_failed_worker_survives():
    reg = jobs.JobRegistry()
    boom = {"left": 1}

    def execute(job):
        if boom["left"]:
            boom["left"] -= 1
            raise RuntimeError("executor exploded")
        return 0

    sched = scheduler.Scheduler(execute, reg, workers=1, queue_limit=5)
    sched.start()
    try:
        bad = reg.create(["bad"], "normal")
        good = reg.create(["good"], "normal")
        sched.submit(bad)
        sched.submit(good)
        assert _wait_until(sched.idle)
        assert bad.state == "failed" and "executor exploded" in bad.error
        assert good.state == "done"
    finally:
        sched.drain()
        assert sched.join(timeout=10)


# ---------------------------------------------------------------------------
# journals across the two packages


def _write_journal(mod_journal, mod_jobs, path, scenario):
    def job(jid, argv=("sort", "-i", "x")):
        return mod_jobs.Job(jid, list(argv), "normal", argv0="fgumi-tpu",
                            client="c" if jid == "j-2" else None,
                            hops={"client_sent_unix": 12.5},
                            shard={"whale": "w", "index": 0} if jid == "j-3"
                            else None)

    j = mod_journal.JobJournal(path)
    if scenario == "version_mismatch":
        j.close()
        with open(path, "wb") as f:
            f.write(json.dumps({"v": 99, "ev": "submit", "id": "j-1",
                                "argv": ["sort"]}).encode() + b"\n")
        return
    for i in range(1, 6):
        j.record_submit(job(f"j-{i}"), dedupe=f"key-{i}" if i % 2 else None)
    for jid, state, rc in (("j-2", "done", 0), ("j-4", "cancelled", None),
                           ("j-1", "running", None), ("j-5", "failed", 3)):
        x = job(jid)
        x.state, x.exit_status = state, rc
        x.error = "boom" if state == "failed" else None
        j.record_state(x)
    j.record_requeued("j-1")
    j.close()
    if scenario == "torn_tail":
        with open(path, "ab") as f:
            f.write(b'{"v": 1, "ev": "state", "id": "j-3", "sta')
    elif scenario == "garbage_line":
        with open(path, "ab") as f:
            f.write(b"\x00\xff garbage not json\n")
            f.write(json.dumps({"v": 1, "ev": "state", "id": "j-3",
                                "state": "done", "exit_status": 0,
                                "error": None}).encode() + b"\n")


@pytest.mark.parametrize("scenario", ["clean", "torn_tail", "garbage_line",
                                      "version_mismatch"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_journal_replays_equal_across_packages(tmp_path, writer, scenario):
    mods = {"jax": (jax_journal, jax_jobs), "port": (journal, jobs)}
    src = str(tmp_path / "w.journal")
    _write_journal(*mods[writer], src, scenario)
    results = {}
    for reader, (mod_journal, _) in mods.items():
        path = str(tmp_path / f"{reader}.journal")
        shutil.copy(src, path)
        rep = mod_journal.replay(path)
        results[reader] = (vars(rep), [r["id"] for r in rep.incomplete()],
                           open(path, "rb").read())
    assert results["port"] == results["jax"]
    rep, incomplete, _ = results["port"]
    if scenario == "version_mismatch":
        assert rep["records"] == 0 and rep["truncated_bytes"] > 0
    else:
        assert incomplete == ["j-1", "j-3"]
        assert rep["dedupe"] == {"key-1": "j-1", "key-3": "j-3",
                                 "key-5": "j-5"}
        assert (rep["truncated_bytes"] > 0) == (scenario != "clean")


def test_truncated_journal_stays_appendable(tmp_path):
    path = str(tmp_path / "j.journal")
    _write_journal(journal, jobs, path, "torn_tail")
    good = journal.replay(path)
    j = journal.JobJournal(path)
    j.record_requeued("j-3")
    j.close()
    again = journal.replay(path)
    assert again.records == good.records + 1 and again.truncated_bytes == 0
    assert jax_journal.replay(path).records == again.records


# ---------------------------------------------------------------------------
# the golden conversations on a live port daemon


def _normalize(obj):
    """Zero the volatile fields the golden file cannot pin down (the
    reference's rule), and map the port's own names onto the reference's:
    the ``tool`` and the stats payload's sections the port leaves out."""
    if isinstance(obj, dict):
        out = {}
        stats = "schema_version" in obj
        for k, v in obj.items():
            if k.endswith("_unix") and isinstance(v, (int, float)):
                out[k] = 0
            elif k in ("uptime_s", "pid"):
                out[k] = 0
            elif k in ("report_path", "trace_path"):
                out[k] = None
            elif k == "tool" and v == "fgumi-tpu-torch":
                out[k] = "fgumi-tpu"
            elif stats and k in ("metrics", "latency", "device",
                                 "device_memory", "breaker", "governor",
                                 "monitor"):
                out[k] = None
            else:
                out[k] = _normalize(v)
        if stats:
            out.update(dict.fromkeys(ABSENT_STATS))
        return out
    if isinstance(obj, list):
        return [_normalize(v) for v in obj]
    return obj


@pytest.fixture
def service(sock_dir):
    svc = JobService(os.path.join(sock_dir, "serve.sock"), workers=1,
                     queue_limit=1, report_dir=None)
    # no scheduler workers: queued jobs stay queued, so the conversation
    # is deterministic
    svc.start_transport()
    yield svc
    svc.close()


@pytest.fixture
def tcp_service():
    svc = JobService(None, workers=1, queue_limit=1, tcp=("127.0.0.1", 0),
                     auth_token="golden-secret")
    svc.start_transport()
    yield svc
    svc.close()


def test_golden_conversation(service):
    golden = json.load(open(GOLDEN))
    conn = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    conn.settimeout(10)
    conn.connect(service.socket_path)
    stream = conn.makefile("rb")
    try:
        for exchange in golden["exchanges"]:
            conn.sendall(protocol.encode_frame(exchange["request"]))
            resp = protocol.read_frame(stream)
            assert _normalize(resp) == exchange["response"], exchange["name"]
    finally:
        conn.close()


def test_tcp_golden_conversations(tcp_service):
    golden = json.load(open(GOLDEN))
    for convo in golden["tcp_conversations"]:
        conn = socket.create_connection(("127.0.0.1", tcp_service.tcp_port),
                                        timeout=10)
        stream = conn.makefile("rb")
        try:
            for exchange in convo["exchanges"]:
                conn.sendall(protocol.encode_frame(exchange["request"]))
                resp = protocol.read_frame(stream)
                assert _normalize(resp) == exchange["response"], \
                    f"{convo['name']}: {exchange['name']}"
            if convo["closed"]:
                try:
                    assert stream.readline() == b"", convo["name"]
                except ConnectionResetError:
                    pass
        finally:
            conn.close()


def test_stats_sections(service):
    stats = service.handle_request({"v": 1, "op": "stats"})["stats"]
    from fgumi_tpu.serve.introspect import \
        STATS_SCHEMA_VERSION as JAX_VERSION

    assert stats["schema_version"] == JAX_VERSION
    want = set(_normalize(json.load(open(GOLDEN))["exchanges"][-1][
        "response"]["stats"]))
    assert set(stats) == want
    assert stats["scheduler"]["workers"] == 1 and stats["monitor"] is None
