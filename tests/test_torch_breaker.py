"""The port's device circuit breaker, health monitor and canary against the
JAX package's.

- the same event scripts (failures, overruns, canary failures, successes,
  probe claims, silent-corruption trips, audited probes, the clock moved
  on) through ``fgumi_tpu.ops.breaker.DeviceBreaker`` and the port's under
  one patched clock and the same knobs: equal snapshots (and ``allow``/
  ``blocked`` answers) after every step;
- ``device_retry_call`` feeding the breaker: a clean call a success, a
  spent retry budget a transient failure (nothing moves to the CPU: the
  call still raises);
- ``HealthMonitor`` with an injected canary (successes, failures and the
  breaker opening), its skips (no CUDA context; dispatches in flight);
- ``/healthz`` 200 and then 503 once the breaker opens, ``/metrics``, and
  the ``stats`` op's breaker and monitor sections on a live daemon;
- ``monitor_period_s`` equal to the reference's on every value;
- K7's plain version (``ops/canary.canary_sum_plain``, the wrapper on CPU
  tensors) equal to the JAX package's ``_canary_sum_jit`` on zero and
  seeded random payloads, exactly, and its input checks.
"""

import json
import os
import shutil
import tempfile
import time
import urllib.request

import numpy as np
import pytest
import torch

from fgumi_tpu.ops import breaker as jax_breaker
from fgumi_tpu_torch.ops import breaker as port_breaker
from fgumi_tpu_torch.ops import canary, kernel
from fgumi_tpu_torch.serve.client import ServeClient
from fgumi_tpu_torch.serve.daemon import JobService


@pytest.fixture(autouse=True)
def reset_port_breaker():
    """The port's breaker is process-wide: leave it as found."""
    port_breaker.BREAKER.reset()
    yield
    port_breaker.BREAKER.reset()


class FakeClock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


#: event scripts; a step is a breaker method name or ("advance", seconds)
SCRIPTS = {
    "transient_threshold": ["record_transient_failure"] * 2
    + ["allow", "record_transient_failure", "allow", "blocked"],
    "success_resets_score": ["record_transient_failure"] * 2
    + ["record_success"] + ["record_transient_failure"] * 2,
    "overrun_trips": ["record_deadline_overrun", "allow"],
    "canary_trips": ["record_canary_failure", ("advance", 9.9),
                     ("advance", 0.2)],
    "half_open_probes": ["record_deadline_overrun", ("advance", 10.1),
                         "allow", "allow", "blocked", "record_success",
                         "allow", "record_success", "allow"],
    "stale_probe_released": ["record_deadline_overrun", ("advance", 10.1),
                             "allow", "allow", ("advance", 361.0), "allow",
                             "record_success", "record_success"],
    "half_open_failure_reopens": ["record_deadline_overrun",
                                  ("advance", 10.1), "allow",
                                  "record_transient_failure"],
    "hysteresis_doubles": ["record_deadline_overrun", ("advance", 10.1),
                           "allow", "record_deadline_overrun",
                           ("advance", 10.1), ("advance", 10.0), "allow",
                           "record_canary_failure", ("advance", 30.0),
                           ("advance", 10.1), "allow", "record_success",
                           "allow", "record_success"],
    "cooldown_cap": ["record_canary_failure"]
    + [("advance", 200.0), "allow", "record_canary_failure"] * 6,
    "sdc_quarantine": ["record_sdc", ("advance", 10.1), "allow",
                       "audit_required", "record_success", "allow",
                       "record_audit_clean", "record_audit_clean",
                       "record_audit_clean", "record_audit_clean",
                       "audit_required", "sdc_quarantined"],
    "sdc_retrip": ["record_sdc", ("advance", 10.1), "allow",
                   "record_audit_clean", "record_sdc", ("advance", 10.1),
                   "allow", ("advance", 10.0), "allow"],
}

KNOBS = {"FGUMI_TPU_BREAKER_FAILURES": "3",
         "FGUMI_TPU_BREAKER_COOLDOWN_S": "10",
         "FGUMI_TPU_BREAKER_PROBES": "2",
         "FGUMI_TPU_AUDIT_READMIT": "4"}


def _run(mod, steps, monkeypatch):
    clock = FakeClock()
    # the probe slot's timeout is the deadline ceiling plus slack; the port
    # has no deadlines (300 + 60 s), so both run with that value
    monkeypatch.setattr(mod.DeviceBreaker, "_probe_timeout_s",
                        staticmethod(lambda: 360.0))
    b = mod.DeviceBreaker(now=clock)
    trace = []
    for step in steps:
        if isinstance(step, tuple):
            clock.t += step[1]
            got = None
        else:
            got = getattr(b, step)()
        trace.append((step, got, b.snapshot()))
    return trace


@pytest.mark.parametrize("knobs", [KNOBS, {"FGUMI_TPU_BREAKER": "0"},
                                   {"FGUMI_TPU_AUDIT_READMIT": "0"}],
                         ids=["default", "disabled", "no_readmit"])
@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_breaker_snapshots_equal_step_by_step(monkeypatch, name, knobs):
    for k in list(KNOBS) + ["FGUMI_TPU_BREAKER"]:
        monkeypatch.delenv(k, raising=False)
    for k, v in knobs.items():
        monkeypatch.setenv(k, v)
    got = _run(port_breaker, SCRIPTS[name], monkeypatch)
    want = _run(jax_breaker, SCRIPTS[name], monkeypatch)
    assert got == want
    assert port_breaker.CLOSED == jax_breaker.CLOSED
    assert port_breaker.MAX_COOLDOWN_FACTOR == jax_breaker.MAX_COOLDOWN_FACTOR


def test_breaker_metrics_and_dump_on_trip():
    from fgumi_tpu_torch.observe.metrics import METRICS

    before = METRICS.get("device.breaker.transitions", 0)
    port_breaker.BREAKER.record_deadline_overrun()
    assert METRICS.get("device.breaker.state") == port_breaker.OPEN
    assert METRICS.get("device.breaker.transitions", 0) == before + 1
    assert METRICS.get("device.breaker.opened", 0) >= 1


@pytest.mark.parametrize("value", [None, "12.5", "0", "-3", "junk", "1e3"])
def test_monitor_period_equal(monkeypatch, value):
    if value is None:
        monkeypatch.delenv("FGUMI_TPU_HEALTH_PERIOD_S", raising=False)
    else:
        monkeypatch.setenv("FGUMI_TPU_HEALTH_PERIOD_S", value)
    assert port_breaker.monitor_period_s() == jax_breaker.monitor_period_s()


# ---------------------------------------------------------------------------
# feeding from the dispatch path


def test_device_retry_call_feeds_breaker(monkeypatch):
    from fgumi_tpu_torch.utils.faults import InjectedFault

    monkeypatch.setenv("FGUMI_TPU_DEVICE_RETRIES", "1")
    monkeypatch.setenv("FGUMI_TPU_DEVICE_BACKOFF_S", "0")
    b = port_breaker.BREAKER
    assert kernel.device_retry_call(lambda: 7, "K1") == 7
    assert b.snapshot()["successes"] == 1

    def fail():
        raise InjectedFault("injected fault at device.dispatch")

    for i in range(3):
        with pytest.raises(InjectedFault):
            kernel.device_retry_call(fail, "K1")
        assert b.snapshot()["transient_failures"] == i + 1
    assert b.state == port_breaker.OPEN
    # an open breaker moves no work: the next dispatch still runs
    assert kernel.device_retry_call(lambda: 8, "K1") == 8


def test_live_dispatches_counted_process_wide():
    class Handle:
        __slots__ = ("__weakref__",)

    h = Handle()
    with kernel._LIVE_LOCK:
        kernel._LIVE_DISPATCHES.add(h)
    assert kernel.dispatches_in_flight() >= 1
    n = kernel.dispatches_in_flight()
    del h  # a dropped handle (a failed command) leaves the count
    assert kernel.dispatches_in_flight() == n - 1


# ---------------------------------------------------------------------------
# the health monitor


def test_monitor_feeds_breaker_from_injected_canary():
    from fgumi_tpu_torch.observe import metrics as metrics_mod

    reg = metrics_mod._GLOBAL_REGISTRY
    outcomes = [(True, 0.01, None), (False, 2.0, "deadline 2s exceeded")]
    b = port_breaker.DeviceBreaker()
    mon = port_breaker.HealthMonitor(b, period_s=30,
                                     canary=lambda t: outcomes.pop(0))
    ok0 = reg.get("device.canary.ok", 0)
    failed0 = reg.get("device.canary.failed", 0)
    mon._canary_once()
    assert b.snapshot()["successes"] == 1 and b.state == port_breaker.CLOSED
    mon._canary_once()
    snap = b.snapshot()
    assert snap["canary_failures"] == 1 and snap["state"] == port_breaker.OPEN
    assert mon.canaries == 2
    assert reg.get("device.canary.ok", 0) == ok0 + 1
    assert reg.get("device.canary.failed", 0) == failed0 + 1


def test_monitor_loop_runs_and_stops():
    calls = []
    b = port_breaker.DeviceBreaker()
    mon = port_breaker.HealthMonitor(
        b, period_s=0.01, canary=lambda t: calls.append(t) or (True, 0, None))
    mon.start()
    deadline = time.monotonic() + 10
    while len(calls) < 3 and time.monotonic() < deadline:
        time.sleep(0.01)
    mon.stop()
    assert len(calls) >= 3 and calls[0] == mon.canary_timeout_s
    assert not mon._thread.is_alive()


def test_monitor_never_initialises_cuda_and_skips_busy_card(monkeypatch):
    mon = port_breaker.HealthMonitor(port_breaker.DeviceBreaker())
    assert not torch.cuda.is_initialized()
    mon._canary_once()  # no context: nothing to check, nothing created
    assert mon.canaries == 0 and not torch.cuda.is_initialized()
    ran = []
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(kernel, "device_canary",
                        lambda t: ran.append(t) or (True, 0.0, None))
    monkeypatch.setattr(kernel, "dispatches_in_flight", lambda: 2)
    mon._canary_once()
    assert mon.canaries == 0 and not ran
    monkeypatch.setattr(kernel, "dispatches_in_flight", lambda: 0)
    mon._canary_once()
    assert mon.canaries == 1 and ran == [mon.canary_timeout_s]


# ---------------------------------------------------------------------------
# /healthz, /metrics and stats on a live daemon


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def test_healthz_200_then_503_and_stats(monkeypatch):
    d = tempfile.mkdtemp(prefix="ftb")
    monkeypatch.setattr(kernel, "device_canary",
                        lambda t: (True, 0.0, None))
    svc = JobService(os.path.join(d, "h.sock"), workers=1, metrics_port=0,
                     health_period_s=3600)
    try:
        svc.start()
        base = f"http://127.0.0.1:{svc._introspection.port}"
        status, body = _get(base + "/healthz")
        assert status == 200
        assert json.loads(body)["breaker"] == "closed"
        assert json.loads(body)["monitor"]["period_s"] == 3600
        port_breaker.BREAKER.record_canary_failure()
        status, body = _get(base + "/healthz")
        assert status == 503
        assert json.loads(body)["status"] == "degraded"
        status, text = _get(base + "/metrics")
        assert status == 200
        assert "fgumi_tpu_device_breaker_open 1" in text
        assert 'fgumi_tpu_serve_jobs{state="queued"} 0' in text
        assert _get(base + "/nope")[0] == 404
        stats = ServeClient(svc.socket_path, timeout=10).stats()
        assert stats["breaker"]["state"] == "open"
        assert stats["breaker"]["canary_failures"] == 1
        assert stats["monitor"] == {"period_s": 3600, "canaries": 0,
                                    "canary_launches": 0}
    finally:
        svc.close()
        shutil.rmtree(d, ignore_errors=True)


# ---------------------------------------------------------------------------
# K7's plain version


def _payloads():
    rng = np.random.default_rng(7)
    yield "zeros_1MiB", np.zeros(kernel.CANARY_BYTES, dtype=np.uint8)
    yield "ones_1MiB", np.full(kernel.CANARY_BYTES, 255, dtype=np.uint8)
    for n in (1, 15, 16, 17, 4095, kernel.CANARY_BYTES,
              kernel.CANARY_BYTES + 13):
        yield f"random_{n}", rng.integers(0, 256, n, dtype=np.uint8)


@pytest.mark.parametrize("name,x", list(_payloads()),
                         ids=[n for n, _ in _payloads()])
def test_canary_plain_equals_jax(name, x):
    from fgumi_tpu.ops.kernel import _canary_sum_jit

    want = np.asarray(_canary_sum_jit(x))
    launches = canary.CANARY_LAUNCHES
    got = canary.canary_sum(torch.from_numpy(x))
    assert got.dtype == torch.int32 and got.shape == ()
    assert want.dtype == np.int32 and int(got) == int(want) == int(
        x.astype(np.int64).sum())
    assert int(canary.canary_sum_plain(torch.from_numpy(x))) == int(want)
    assert canary.CANARY_LAUNCHES == launches  # CPU tensors: no launch


@pytest.mark.parametrize("bad,err", [
    (torch.zeros(0, dtype=torch.uint8), "outside 1.."),
    (torch.zeros(8, dtype=torch.int32), "expected torch.uint8"),
    (torch.zeros((2, 4), dtype=torch.uint8), "expected \\(n,\\)"),
    (torch.zeros(16, dtype=torch.uint8)[::2], "contiguous"),
    (torch.zeros(canary.MAX_BYTES + 1, dtype=torch.uint8), "outside 1..")])
def test_canary_wrapper_rejects(bad, err):
    with pytest.raises((TypeError, ValueError), match=err):
        canary.canary_sum(bad)
    # the cap keeps any payload's int32 sum exact
    assert 255 * canary.MAX_BYTES < 2 ** 31


def test_canary_round_trip_needs_cuda():
    """``device_canary`` is a card round trip: without CUDA it raises at
    the context (the monitor never calls it then)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present (tests/test_torch_cuda.py)")
    with pytest.raises((RuntimeError, AssertionError)):
        kernel.device_canary(1.0)
