"""The port's fleet balancer (``fgumi_tpu_torch/serve/balancer.py``) on the
CPU, against the JAX package's.

- ``PeerBreaker`` walks the JAX breaker's states over the same event
  sequences (failures, successes, probes, cooldowns that double to 8x);
- ``render_fleet_prometheus`` and ``render_fleet_healthz`` give the JAX
  package's text and answer for the same health-poll snapshot (a backend
  with takeovers and latency, an ejected one, an SDC hold, draining);
- routing over live port daemons (workers never run): a submit goes to
  the least-loaded healthy backend, a dedupe key pins the resubmit,
  status and cancel follow the job, a dead backend is ejected and its
  keyed submit relocated, and the JAX balancer routes the same way;
- the SDC hold trips on a backend reporting audit divergences, as the JAX
  balancer's does; the port's daemons report no audit section, so
  against them it never trips;
- ``balance``'s exit codes equal the JAX CLI's on misuse; ``balance`` in
  a child process imports no torch (no CUDA context), answers ``submit``,
  ``jobs``, ``stats`` and ``jobs --scatter`` through the port's CLI, and
  exits 0 on SIGTERM.

Every daemon and balancer is stopped in a ``finally``; every wait is
bounded.
"""

import json
import logging
import os
import random
import shutil
import signal
import subprocess
import sys
import tempfile
import time

import pytest

import fgumi_tpu.native as jax_native
import fgumi_tpu.native.batch as jax_native_batch
from fgumi_tpu.cli import main as jax_main
from fgumi_tpu.observe.scope import scoped_telemetry as jax_scope
from fgumi_tpu.serve import balancer as jax_balancer
from fgumi_tpu_torch.cli import main as port_main
from fgumi_tpu_torch.observe.scope import scoped_telemetry
from fgumi_tpu_torch.serve import balancer
from fgumi_tpu_torch.serve.client import ServeClient
from fgumi_tpu_torch.serve.daemon import JobService

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def no_jax_native(monkeypatch):
    """The JAX package's native library is never loaded here."""
    monkeypatch.setattr(jax_native, "get_lib", lambda: None)
    monkeypatch.setattr(jax_native_batch, "get_lib", lambda: None)


@pytest.fixture
def sock_dir():
    d = tempfile.mkdtemp(prefix="ftb")
    yield d
    shutil.rmtree(d, ignore_errors=True)


# ---------------------------------------------------------------------------
# the peer breaker


def _walk(mod, events, clock):
    br = mod.PeerBreaker(eject_failures=2, cooldown_s=1.0, probe_successes=2,
                         now=lambda: clock[0])
    trace = []
    for ev in events:
        if ev == "tick":
            clock[0] += 0.75
        elif ev == "allow":
            trace.append(("allow", br.allow()))
        elif ev == "ok":
            br.record_success()
        else:
            br.record_failure("probe failed: refused")
        trace.append(br.snapshot())
    return trace


@pytest.mark.parametrize("seed", range(6))
def test_peer_breaker_walks_the_jax_states(seed):
    rng = random.Random(seed)
    events = [rng.choice(["tick", "allow", "ok", "fail", "fail", "tick"])
              for _ in range(300)]
    got = _walk(balancer, events, [100.0])
    want = _walk(jax_balancer, events, [100.0])
    assert got == want
    assert any(s.get("state") == "half-open" for s in got
               if isinstance(s, dict))


def test_peer_breaker_cooldown_doubles_to_eight_times():
    """Each failed half-open probe re-opens the breaker for twice the last
    cooldown, up to 8x; a clean probe closes it and resets the trips."""
    for mod in (balancer, jax_balancer):
        clock = [0.0]
        br = mod.PeerBreaker(eject_failures=1, cooldown_s=1.0,
                             probe_successes=1, now=lambda: clock[0])
        br.record_failure("down")
        cools = []
        for _ in range(6):
            opened = clock[0]
            while br.state == "open":
                clock[0] += 0.25
            cools.append(clock[0] - opened)
            assert br.allow() and not br.allow()  # one probe slot
            br.record_failure("still down")
        assert cools == [1.0, 2.0, 4.0, 8.0, 8.0, 8.0]
        while br.state == "open":
            clock[0] += 0.25
        assert br.allow()
        br.record_success()
        assert br.state == "closed" and br.snapshot()["trips"] == 0


# ---------------------------------------------------------------------------
# the fleet metrics and healthz renderers


_STATS = {
    "scheduler": {"queued": 2, "running": 1},
    "fleet": {"fleet_id": "a", "takeovers": 2, "takeover_jobs": 5},
    "metrics": {"serve.jobs.done": 7, "serve.transport.frames": 40,
                "flag": True, "name": "x"},
    "latency": {"serve.job.e2e.submit_to_done_s": {
        "p50": 1.5, "p90": 2.25, "p99": 3.0, "count": 7, "sum": 12.5}},
}


def _render(mod, scope, case, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1_000_000.0)
    with scope("balance"):
        bal = mod.Balancer("unix:/nonexistent/front.sock",
                           ["unix:/nonexistent/a.sock",
                            "tcp:127.0.0.1:9", "unix:/nonexistent/c.sock"],
                           scatter_shards=3 if case == "scatter" else 0)
        a, b, c = bal.backends
        a.note_stats(_STATS)
        a.note_depth(3)
        a.note_ok()
        b.breaker.record_failure("refused")
        b.breaker.record_failure("refused")
        if case == "sdc":
            c.note_stats({"scheduler": {}, "audit": {"divergent": 4}})
            c.note_audit(4)
        if case == "draining":
            bal.drain()
        text = mod.render_fleet_prometheus(bal)
        health = mod.render_fleet_healthz(bal)
        snap = bal.stats_snapshot()
        if case == "all_down":
            for x in (a, c):
                x.breaker.record_failure("refused")
                x.breaker.record_failure("refused")
            health = mod.render_fleet_healthz(bal)
        bal.close()
    return text, health, snap


@pytest.mark.parametrize("case", ["plain", "sdc", "draining", "all_down",
                                  "scatter"])
def test_fleet_metrics_and_healthz_equal_jax(case, monkeypatch):
    got = _render(balancer, scoped_telemetry, case, monkeypatch)
    want = _render(jax_balancer, jax_scope, case, monkeypatch)
    assert got[0] == want[0]
    assert got[1] == want[1]
    port_snap, jax_snap = got[2], want[2]
    assert port_snap["tool"] == "fgumi-tpu-torch-balance"
    for snap in (port_snap, jax_snap):
        snap.pop("tool")
        snap.pop("pid")
        if snap["scatter"] is not None:
            snap["scatter"].pop("wal")
        for b in snap["backends"]:  # monotonic-clock stamps
            for t in b["breaker"]["transitions"]:
                t.pop("t")
    assert port_snap == jax_snap
    assert 'fgumi_tpu_serve_job_e2e_submit_to_done_s{backend="unix:' \
        '/nonexistent/a.sock",quantile="0.99"} 3' in got[0]
    status = {"plain": 200, "sdc": 200, "draining": 503, "all_down": 503,
              "scatter": 200}[case]
    assert got[1][0] == status


# ---------------------------------------------------------------------------
# routing over live port daemons


@pytest.fixture
def daemons(sock_dir):
    svcs = []
    for name in ("a", "b"):
        svc = JobService(os.path.join(sock_dir, f"{name}.sock"), workers=1,
                         queue_limit=8)
        svc.start_transport()
        svcs.append(svc)
    yield svcs
    for s in svcs:
        s.close()


def _route_trace(mod, sock_dir, daemons, label):
    bal = mod.Balancer(f"unix:{sock_dir}/{label}.sock",
                       [f"unix:{s.socket_path}" for s in daemons],
                       poll_period_s=0.1, backend_timeout_s=10)
    trace = []
    try:
        bal.poll_backends_once()
        for i in range(5):
            resp = bal.handle_request({"v": 1, "op": "submit",
                                       "argv": ["sort", "-i", f"{label}{i}"],
                                       "dedupe": f"{label}-k{i % 3}"})
            assert resp["ok"], resp
            trace.append((resp["job"]["id"], bool(resp.get("deduped"))))
        jid = trace[0][0]
        st = bal.handle_request({"v": 1, "op": "status", "id": jid})
        trace.append(st["job"]["argv"])
        trace.append(bal.handle_request({"v": 1, "op": "cancel",
                                         "id": jid})["job"]["state"])
        trace.append(bal.handle_request({"v": 1, "op": "status",
                                         "id": "nope"})["ok"])
        bal.poll_backends_once()
        trace.append([b["depth"] for b in bal.stats_snapshot()["backends"]])
    finally:
        bal.close()
    return trace


def test_routing_equals_jax_balancer(sock_dir, daemons):
    got = _route_trace(balancer, sock_dir, daemons, "p")
    # fresh daemons for the JAX balancer: the same routing decisions
    for s in daemons:
        s.close()
    fresh = []
    try:
        for name in ("a", "b"):
            svc = JobService(os.path.join(sock_dir, f"{name}2.sock"),
                             workers=1, queue_limit=8)
            svc.start_transport()
            fresh.append(svc)
        want = _route_trace(jax_balancer, sock_dir, fresh, "p")
    finally:
        for s in fresh:
            s.close()
    assert got == want
    # a resubmitted key is answered with its first job
    assert [d for _, d in got[:5]] == [False, False, False, True, True]
    assert got[3][0] == got[0][0] and got[4][0] == got[1][0]
    assert got[6] == "cancelled" and got[7] is False


@pytest.mark.parametrize("fleet_ids", [False, True],
                         ids=["no_fleet_ids", "fleet_ids"])
def test_balancer_warns_when_two_backends_mint_one_id(sock_dir, caplog,
                                                      fleet_ids):
    """Daemons without fleet ids both mint ``j-1``: the balancer's id map
    keeps the newer, so it warns and names the remedy. With distinct fleet
    ids (as a whale's fleet runs) the ids differ, nothing is said, and each
    id's status reaches the daemon that holds it."""
    svcs = []
    bal = None
    try:
        for name in ("a", "b"):
            fleet = {"journal_dir": os.path.join(sock_dir, "j"),
                     "fleet_id": name} if fleet_ids else {}
            svc = JobService(os.path.join(sock_dir, f"{name}.sock"),
                             workers=1, queue_limit=8, **fleet)
            svc.start_transport()
            svcs.append(svc)
        bal = balancer.Balancer(f"unix:{sock_dir}/w.sock",
                                [f"unix:{s.socket_path}" for s in svcs],
                                poll_period_s=0.1, backend_timeout_s=10)
        bal.poll_backends_once()
        caplog.set_level(logging.WARNING)
        ids = []
        for i in range(2):
            resp = bal.handle_request({"v": 1, "op": "submit",
                                       "argv": ["sort", "-i", f"w{i}"]})
            assert resp["ok"], resp
            ids.append(resp["job"]["id"])
        # one job on each daemon
        assert [s.registry.get(j).argv for s, j in zip(svcs, ids)] \
            == [["sort", "-i", "w0"], ["sort", "-i", "w1"]]
        said = [r.getMessage() for r in caplog.records
                if "both minted job id" in r.getMessage()]
        if fleet_ids:
            assert ids == ["a-j-1", "b-j-1"] and said == []
            for i, j in enumerate(ids):
                st = bal.handle_request({"v": 1, "op": "status", "id": j})
                assert st["job"]["argv"] == ["sort", "-i", f"w{i}"]
        else:
            assert ids == ["j-1", "j-1"]
            assert len(said) == 1 and "--fleet-id" in said[0]
    finally:
        if bal is not None:
            bal.close()
        for s in svcs:
            s.close()


def test_dead_backend_ejected_and_keyed_submit_relocated(sock_dir, daemons):
    bal = balancer.Balancer(f"unix:{sock_dir}/f.sock",
                            [f"unix:{s.socket_path}" for s in daemons],
                            poll_period_s=0.1, eject_failures=1,
                            cooldown_s=30, backend_timeout_s=5)
    try:
        bal.poll_backends_once()
        daemons[0].close()
        resp = bal.handle_request({"v": 1, "op": "submit", "argv": ["sort"],
                                   "dedupe": "k"})
        assert resp["ok"]
        assert daemons[1].registry.get(resp["job"]["id"]) is not None
        bal.poll_backends_once()
        states = [b["state"] for b in bal.stats_snapshot()["backends"]]
        assert states == ["open", "closed"]
        assert balancer.render_fleet_healthz(bal)[0] == 200
        daemons[1].close()
        bal.poll_backends_once()
        assert balancer.render_fleet_healthz(bal)[0] == 503
        resp = bal.handle_request({"v": 1, "op": "submit", "argv": ["x"]})
        assert not resp["ok"] and "no healthy backends" in resp["error"]
    finally:
        bal.close()


@pytest.mark.parametrize("mod", [balancer, jax_balancer],
                         ids=["port", "jax"])
def test_sdc_hold_trips_only_on_reported_divergence(sock_dir, daemons,
                                                    monkeypatch, mod):
    bal = mod.Balancer(f"unix:{sock_dir}/s.sock",
                       [f"unix:{s.socket_path}" for s in daemons],
                       poll_period_s=0.1)
    try:
        bal.poll_backends_once()
        # the port's daemons report the sentinel's audit section; with
        # no divergence counted they are never held
        stats = daemons[0].handle_request({"v": 1, "op": "stats"})["stats"]
        assert "audit" in stats
        assert (stats["audit"] or {}).get("divergent", 0) == 0
        assert not any(b.get("sdc_hold")
                       for b in bal.stats_snapshot()["backends"])
        a = bal.backends[0]
        real = a.client.stats
        monkeypatch.setattr(a.client, "stats", lambda timeout=None: {
            **real(timeout=timeout), "audit": {"divergent": 3}})
        bal.poll_backends_once()
        snap = bal.stats_snapshot()["backends"][0]
        assert snap["sdc_hold"] and snap["audit_divergent"] == 3
        resp = bal.handle_request({"v": 1, "op": "submit", "argv": ["sort"]})
        assert resp["ok"]
        assert daemons[1].registry.get(resp["job"]["id"]) is not None
        monkeypatch.setattr(a.client, "stats", real)
        bal.poll_backends_once()
        assert not bal.stats_snapshot()["backends"][0].get("sdc_hold")
    finally:
        bal.close()


# ---------------------------------------------------------------------------
# the CLI


@pytest.mark.parametrize("flags", [
    ["--poll-period", "0"], ["--eject-failures", "0"], ["--probes", "0"],
    ["--max-frame-bytes", "100"], ["--metrics-port", "70000"],
    ["--scatter", "1"], ["--scatter-grace", "0"],
    ["--scatter", "2", "--scatter-axis", "pos"],
    ["--backend", "host:1234"], ["--listen-bad"]])
def test_balance_misuse_exits_2_as_jax(sock_dir, caplog, flags):
    listen = ["--listen", f"unix:{sock_dir}/f.sock"]
    backend = ["--backend", f"unix:{sock_dir}/a.sock"]
    if flags == ["--listen-bad"]:
        flags, listen = [], ["--listen", "host:99"]
    if flags[:1] == ["--backend"]:
        backend = []
    argv = ["balance", *listen, *backend, *flags]

    def rc(main):
        try:
            return main(argv)
        except SystemExit as e:  # argparse's own exit 2
            return e.code

    with caplog.at_level(logging.ERROR, logger="fgumi_tpu_torch"):
        got = rc(port_main)
    assert got == rc(jax_main) == 2
    assert not os.path.exists(f"{sock_dir}/f.sock")


def test_balance_busy_listen_socket_exits_2(sock_dir, daemons):
    busy = daemons[0].socket_path
    argv = ["balance", "--listen", f"unix:{busy}", "--backend",
            f"unix:{daemons[1].socket_path}"]
    assert port_main(argv) == 2
    assert ServeClient(busy, timeout=5).ping()["ok"]


_BALANCE_CHILD = """
import atexit, sys
sys.path.insert(0, {repo!r})
atexit.register(lambda: open({marker!r}, "w").write(
    "torch" if "torch" in sys.modules else "no-torch"))
from fgumi_tpu_torch.cli import main
sys.exit(main({argv!r}))
"""


def test_balance_child_serves_the_cli_without_torch(sock_dir, daemons,
                                                    capsys):
    front = os.path.join(sock_dir, "front.sock")
    marker = os.path.join(sock_dir, "marker")
    argv = ["balance", "--listen", f"unix:{front}", "--poll-period", "0.2",
            "--metrics-port", "0",
            *[a for s in daemons for a in ("--backend",
                                           f"unix:{s.socket_path}")]]
    proc = subprocess.Popen(
        [sys.executable, "-c", _BALANCE_CHILD.format(
            repo=REPO, marker=marker, argv=argv)],
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    try:
        deadline = time.monotonic() + 60
        while True:
            try:
                ping = ServeClient(front, timeout=2).ping()
                break
            except Exception:  # noqa: BLE001 - not up yet
                assert time.monotonic() < deadline and proc.poll() is None
                time.sleep(0.1)
        assert ping["tool"] == "fgumi-tpu-torch-balance"
        capsys.readouterr()
        assert port_main(["submit", "--socket", front, "--no-wait", "sort",
                          "-i", "a.bam", "-o", "b.bam"]) == 0
        submitted = capsys.readouterr().out
        assert "j-1" in submitted
        assert port_main(["jobs", "--socket", front]) == 0
        assert "j-1" in capsys.readouterr().out
        assert port_main(["stats", "--socket", front]) == 0
        stats = json.loads(capsys.readouterr().out)
        assert stats["fleet_metrics"]["backends_total"] == 2
        assert stats["scatter"] is None
        # --scatter is off: the balancer's own answer
        assert port_main(["jobs", "--socket", front, "--scatter"]) == 2
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
        assert open(marker).read() == "no-torch"
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
