"""Dispatch deadlines and the device feeder (``ops/kernel.py`` of the
port): ``FGUMI_TPU_DISPATCH_DEADLINE_S`` parsed as the JAX package parses
it, a launch that hangs abandoned at its deadline while the submitting
thread
watches (the feeder thread is the stuck one), a card that never signals
its results' event abandoned at the resolve, the feeder's gate (at most the
depth launched and unresolved, launches in submission order), and the
command's exit: 3 under an injected hang, 1 for a real one, nothing
published either way. Every hang here lasts at most 2 s."""

import gc
import logging
import os
import threading
import time

import numpy as np
import pytest

from fgumi_tpu.ops import kernel as jax_kernel
from fgumi_tpu_torch import cli as port_cli
from fgumi_tpu_torch.ops import cuda_kernel
from fgumi_tpu_torch.ops import kernel as K
from fgumi_tpu_torch.ops.breaker import BREAKER
from fgumi_tpu_torch.ops.tables import quality_tables
from fgumi_tpu_torch.utils import faults

LOGGER = "fgumi_tpu_torch"


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for k in ("FGUMI_TPU_FAULT", "FGUMI_TPU_DISPATCH_DEADLINE_S",
              "FGUMI_TPU_DEADLINE_FACTOR", "FGUMI_TPU_FEEDER_DEPTH",
              "FGUMI_TPU_FEEDER_BYTES"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("FGUMI_TPU_DEVICE_BACKOFF_S", "0.001")
    faults.reset()
    BREAKER.reset()
    K.DEVICE_STATS.reset()
    yield
    faults.reset()
    BREAKER.reset()


@pytest.mark.parametrize("spec", [None, "", "120", "5:60", "0.5:2", "0",
                                  "off", "inf", "none", "-3", "garbage",
                                  "1:x", "100:10"])
@pytest.mark.parametrize("pred", [None, 0.0, 0.001, 0.5, 30.0])
def test_deadline_equals_jax(monkeypatch, spec, pred):
    if spec is not None:
        monkeypatch.setenv("FGUMI_TPU_DISPATCH_DEADLINE_S", spec)
    assert K._deadline_bounds() == jax_kernel._deadline_bounds()
    assert K.dispatch_deadline_s(pred) == jax_kernel.dispatch_deadline_s(pred)


def test_deadline_factor(monkeypatch):
    monkeypatch.setenv("FGUMI_TPU_DEADLINE_FACTOR", "3")
    assert K.dispatch_deadline_s(20.0) == 60.0
    assert K.dispatch_deadline_s(0.001) == 30.0  # the floor
    monkeypatch.setenv("FGUMI_TPU_DEADLINE_FACTOR", "x")
    assert K.dispatch_deadline_s(1.0) == jax_kernel.dispatch_deadline_s(1.0)


def _batch(seed=0, n_fam=12, fam=3, L=16):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 5, size=(n_fam * fam, L), dtype=np.uint8)
    quals = rng.integers(2, 41, size=(n_fam * fam, L), dtype=np.uint8)
    return codes, quals, np.arange(n_fam + 1, dtype=np.int64) * fam


def test_hung_launch_abandoned_at_its_deadline(monkeypatch):
    """An injected hang inside the launch (on the feeder thread): the
    submitter raises at the deadline, the dispatch is counted abandoned
    and fed to the breaker, and once the hang ends the feeder's slot is
    free and the next dispatch runs."""
    monkeypatch.setenv("FGUMI_TPU_DISPATCH_DEADLINE_S", "0.1:0.3")
    monkeypatch.setenv("FGUMI_TPU_FAULT", "device.dispatch:hang:1.0:1")
    monkeypatch.setenv("FGUMI_TPU_FAULT_HANG_S", "1.0")
    kern = K.ConsensusKernel(quality_tables(45, 40), "cpu")
    codes, quals, starts = _batch()
    t0 = time.monotonic()
    with pytest.raises(K.DeadlineExceeded) as err:
        kern.device_call_segments_wire(codes, quals, starts)
    assert time.monotonic() - t0 < 0.9
    assert err.value.injected
    assert "did not complete within 0.3s" in str(err.value)
    assert K.DEVICE_STATS.snapshot()["deadline_fallbacks"] == 1
    assert BREAKER.snapshot()["deadline_overruns"] == 1
    assert K.DEVICE_STATS.in_flight == 0
    # the late launch returns, its result is dropped, its slot released
    deadline = time.monotonic() + 5
    while K.DEVICE_FEEDER._inflight and time.monotonic() < deadline:
        time.sleep(0.05)
    assert K.DEVICE_FEEDER._inflight == 0
    # the default deadline again: an ordinary dispatch on a loaded host
    # may take longer than the test's 0.3 s
    monkeypatch.delenv("FGUMI_TPU_DISPATCH_DEADLINE_S")
    want = K.ConsensusKernel(quality_tables(45, 40), "cpu")
    got = kern.resolve_segments_wire(
        kern.device_call_segments_wire(codes, quals, starts), codes, quals,
        starts)
    ref = want.resolve_segments_wire(
        want.device_call_segments_wire(codes, quals, starts), codes, quals,
        starts)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)


class _NeverSignals:
    """A CUDA event stand-in of a card that never finishes."""

    def query(self):
        return False

    def synchronize(self):
        raise AssertionError("the resolve must never block on the card")


def test_result_event_never_signals_abandoned_at_resolve(monkeypatch):
    """The launch returned but its results' event never completes: the
    resolve polls it until the deadline, then abandons the dispatch (the
    resolving thread never blocks in the driver)."""
    kern = K.ConsensusKernel(quality_tables(45, 40), "cpu")
    codes, quals, starts = _batch()
    handle = kern.device_call_segments_wire(codes, quals, starts)
    monkeypatch.setenv("FGUMI_TPU_DISPATCH_DEADLINE_S", "0.2:0.4")
    handle.event = _NeverSignals()
    t0 = time.monotonic()
    with pytest.raises(K.DeadlineExceeded) as err:
        kern.resolve_segments_wire(handle, codes, quals, starts)
    assert 0.35 < time.monotonic() - t0 < 2.0
    assert not err.value.injected
    assert handle.abandoned
    assert K.DEVICE_STATS.in_flight == 0
    assert K.DEVICE_STATS.snapshot()["deadline_fallbacks"] == 1
    assert K.DEVICE_FEEDER._inflight == 0


def test_feeder_gate_holds_past_its_depth_in_order(monkeypatch):
    """A feeder of depth 2: a third launch waits until one of the first
    two resolves; launches run in submission order."""
    monkeypatch.setenv("FGUMI_TPU_FEEDER_DEPTH", "2")
    feeder = K.DeviceFeeder()
    order = []

    def item(i):
        return lambda: order.append(i) or i

    tickets = [feeder.submit(item(i)) for i in range(3)]
    assert tickets[0].wait(1.0) == 0 and tickets[1].wait(1.0) == 1
    time.sleep(0.2)
    assert not tickets[2].done() and order == [0, 1]
    feeder.mark_resolved(tickets[1])
    assert tickets[2].wait(1.0) == 2
    assert order == [0, 1, 2]
    for t in tickets:
        feeder.mark_resolved(t)
    assert feeder._inflight == 0
    assert feeder.drain(timeout=2.0)


def test_feeder_byte_budget(monkeypatch):
    monkeypatch.setenv("FGUMI_TPU_FEEDER_BYTES", str(1 << 20))
    feeder = K.DeviceFeeder()
    a = feeder.submit(lambda: "a", upload_bytes=700_000)
    b = feeder.submit(lambda: "b", upload_bytes=700_000)
    assert a.wait(1.0) == "a"
    time.sleep(0.2)
    assert not b.done()  # 1.4 MB would pass the 1 MiB budget
    feeder.mark_resolved(a)
    assert b.wait(1.0) == "b"
    feeder.mark_resolved(b)
    assert feeder.drain(timeout=2.0)


@pytest.mark.parametrize("threads", [0, 2])
def test_dropped_dispatches_give_their_slots_back(threads):
    """More failed commands than the feeder's depth, each with dispatches
    pending when its sink fails: the runner drops them unresolved, and
    their slots and upload bytes go back with the handles, so the next
    dispatch starts at once instead of waiting at the gate."""
    from fgumi_tpu_torch import pipeline

    kern = K.ConsensusKernel(quality_tables(45, 40), "cpu")
    codes, quals, starts = _batch()
    assert K.DEVICE_FEEDER._inflight == 0

    def sink(out):
        raise OSError("sink failed")

    for i in range(K.DEVICE_FEEDER.depth + 2):
        with pytest.raises(OSError, match="sink failed"):
            pipeline.run_stages(
                iter(range(4)),
                lambda _: [kern.device_call_segments_wire(codes, quals,
                                                          starts)],
                sink, threads=threads,
                resolve_fn=lambda h: kern.resolve_segments_wire(
                    h, codes, quals, starts))
    t0 = time.monotonic()
    handle = kern.device_call_segments_wire(codes, quals, starts)
    assert time.monotonic() - t0 < 1.0
    kern.resolve_segments_wire(handle, codes, quals, starts)
    gc.collect()  # handles an error's traceback keeps in a cycle
    K.DEVICE_FEEDER.mark_resolved(handle.ticket)  # idempotent; reaps
    assert K.DEVICE_FEEDER._inflight == 0
    assert K.DEVICE_FEEDER._inflight_bytes == 0


def test_drain_returns_after_the_feeder_thread_ended():
    """``drain`` waits for the feeder's thread itself, not only for its
    queue: a serve daemon's shutdown then finalizes the interpreter with
    no thread of its launches left to wake inside the finalization (that
    aborted the daemon now and then: SIGABRT after a clean stop). The
    switch interval keeps this thread on the GIL after ``drain`` returns,
    so a thread left running would still be alive at the check."""
    import sys

    feeder = K.DeviceFeeder()
    ticket = feeder.submit(lambda: 7)
    assert ticket.wait(2.0) == 7
    feeder.mark_resolved(ticket)
    thread = feeder._thread
    assert thread is not None and thread.is_alive()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(5.0)
    try:
        assert feeder.drain(timeout=10.0)
        alive = thread.is_alive()
    finally:
        sys.setswitchinterval(interval)
    assert not alive and feeder._thread is None
    # a later submit starts a fresh thread
    ticket = feeder.submit(lambda: 8)
    assert ticket.wait(2.0) == 8
    feeder.mark_resolved(ticket)
    assert feeder.drain(timeout=10.0)


def test_dropped_ticket_still_queued_never_runs():
    """A handle collected before its launch started: the launch is
    skipped and no slot is taken."""
    feeder = K.DeviceFeeder()
    gate = threading.Event()
    ran = []
    first = feeder.submit(lambda: gate.wait(2.0))
    second = feeder.submit(lambda: ran.append(1), upload_bytes=100)
    feeder.release_dropped(second)  # reaped before the loop pops it
    gate.set()
    assert first.wait(2.0) is True
    with pytest.raises(K.DeadlineExceeded):
        second.wait(2.0)
    assert ran == []
    feeder.mark_resolved(first)
    assert feeder._inflight == 0 and feeder._inflight_bytes == 0


def test_abandoned_while_queued_never_runs():
    feeder = K.DeviceFeeder()
    gate = threading.Event()
    ran = []
    first = feeder.submit(lambda: gate.wait(2.0))
    second = feeder.submit(lambda: ran.append(1))
    feeder.abandon(second)
    gate.set()
    assert first.wait(2.0) is True
    with pytest.raises(K.DeadlineExceeded):
        second.wait(2.0)
    assert ran == []
    feeder.mark_resolved(first)
    assert feeder._inflight == 0


def test_ticket_wait_counts_from_the_launch_start():
    feeder = K.DeviceFeeder()
    t = feeder.submit(lambda: time.sleep(0.3) or "done")
    with pytest.raises(K.DeadlineExceeded):
        t.wait(0.1)
    assert t.wait(2.0) == "done"
    feeder.mark_resolved(t)


@pytest.fixture(scope="module")
def grouped(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_deadline")
    p = str(d / "g.bam")
    assert port_cli.main(["simulate", "grouped-reads", "-o", p,
                          "--num-families", "120"]) == 0
    return p


def _errors(caplog):
    return [r.getMessage() for r in caplog.records
            if r.levelno >= logging.ERROR and r.name == LOGGER]


@pytest.mark.parametrize("threads", ["0", "3"])
def test_injected_hang_exits_3_nothing_published(tmp_path, monkeypatch,
                                                 caplog, grouped, threads):
    monkeypatch.setenv("FGUMI_TPU_DISPATCH_DEADLINE_S", "0.2:0.5")
    monkeypatch.setenv("FGUMI_TPU_FAULT", "device.dispatch:hang:1.0:1")
    monkeypatch.setenv("FGUMI_TPU_FAULT_HANG_S", "2")
    out = tmp_path / "o.bam"
    with caplog.at_level(logging.WARNING, logger=LOGGER):
        rc = port_cli.main(["simplex", "-i", grouped, "-o", str(out),
                            "--device", "cpu", "--threads", threads])
    # the command ended while the launch still hangs on the feeder
    assert K.DEVICE_FEEDER._active
    assert rc == 3
    assert os.listdir(tmp_path) == []
    errors = _errors(caplog)
    assert len(errors) == 1 and "did not complete within 0.5s" in errors[0]
    _wait_feeder_idle()


def test_real_hang_exits_1(tmp_path, monkeypatch, caplog, grouped):
    """A launch that hangs with no fault armed (a wedged card) exits 1."""
    monkeypatch.setenv("FGUMI_TPU_DISPATCH_DEADLINE_S", "0.2:0.4")
    real = cuda_kernel.consensus_wire_full
    calls = []

    def wedged(*args):
        calls.append(1)
        if len(calls) == 1:
            time.sleep(2.0)
        return real(*args)

    monkeypatch.setattr(cuda_kernel, "consensus_wire_full", wedged)
    out = tmp_path / "o.bam"
    with caplog.at_level(logging.WARNING, logger=LOGGER):
        rc = port_cli.main(["simplex", "-i", grouped, "-o", str(out),
                            "--device", "cpu"])
    assert K.DEVICE_FEEDER._active and calls == [1]
    assert rc == 1
    assert os.listdir(tmp_path) == []
    errors = _errors(caplog)
    assert len(errors) == 1 and "abandoned" in errors[0]
    _wait_feeder_idle()


def _wait_feeder_idle():
    """Let a hung launch end before the next test uses the feeder."""
    deadline = time.monotonic() + 10
    while (K.DEVICE_FEEDER._active or K.DEVICE_FEEDER._inflight) \
            and time.monotonic() < deadline:
        time.sleep(0.05)
