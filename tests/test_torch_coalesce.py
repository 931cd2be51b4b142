"""The cross-job dispatch coalescer (``fgumi_tpu_torch/ops/coalesce.py``) on
the CPU plain versions.

Partners dispatched from several threads through the armed window merge
into one launch, and each partner's resolve equals its solo run exactly
(also where the union of the partners' quals takes the packed2 route);
the merge key keeps different tables and read lengths apart; the
fairness caps (an oversize batch goes solo, a row budget flushes in
arrival order); the window's arming (auto at two running jobs in a
serving daemon, ``FGUMI_TPU_COALESCE`` off and force, a 0 ms window, the
hold priced at the router's overhead, off with nothing configured);
``serve.coalesce`` fired inside the merged launch (a retried raise leaves
every partner equal to its solo run, an unbounded one fails every
partner: the port never finishes a merged batch on the host; an
out-of-memory halves each partner's own rows); proportional byte attribution per job scope; the scoreboard; and a
serve daemon running two ``simplex`` jobs at once whose outputs are
byte-identical to their standalone runs, with merged launches counted."""

import os
import shutil
import tempfile
import threading

import numpy as np
import pytest

from fgumi_tpu_torch import cli as port_cli
from fgumi_tpu_torch.observe.scope import TelemetryScope, scoped_telemetry
from fgumi_tpu_torch.ops import kernel as K
from fgumi_tpu_torch.ops.breaker import BREAKER
from fgumi_tpu_torch.ops.coalesce import COALESCER, CoalescedTicket, bypassed
from fgumi_tpu_torch.ops.router import ROUTER
from fgumi_tpu_torch.ops.tables import quality_tables
from fgumi_tpu_torch.utils import faults


@pytest.fixture(autouse=True)
def _coalesce_env(monkeypatch):
    monkeypatch.setenv("FGUMI_TPU_COALESCE", "1")
    monkeypatch.setenv("FGUMI_TPU_COALESCE_WINDOW_MS", "1000")
    monkeypatch.setenv("FGUMI_TPU_DEVICE_BACKOFF_S", "0.001")
    for k in ("FGUMI_TPU_FAULT", "FGUMI_TPU_COALESCE_PARTNER_ROWS",
              "FGUMI_TPU_COALESCE_MAX_ROWS", "FGUMI_TPU_COALESCE_PARTNERS"):
        monkeypatch.delenv(k, raising=False)
    faults.reset()
    COALESCER.reset()
    COALESCER.set_serving(False)
    COALESCER.set_active_jobs(0)
    yield
    faults.reset()
    COALESCER.reset()
    BREAKER.reset()
    ROUTER.reset()


@pytest.fixture
def kernel():
    return K.ConsensusKernel(quality_tables(45, 40), "cpu")


def _batch(n_fam, fam, L, seed, hi_q=40):
    rng = np.random.default_rng(seed)
    template = rng.integers(0, 4, size=(n_fam, 1, L), dtype=np.uint8)
    codes = np.repeat(template, fam, axis=1)
    err = rng.random((n_fam, fam, L)) < 0.02
    codes[err] = (codes[err] + 1) % 4
    quals = rng.integers(10, hi_q, size=(n_fam, fam, L), dtype=np.uint8)
    starts = np.arange(n_fam + 1, dtype=np.int64) * fam
    return codes.reshape(-1, L), quals.reshape(-1, L), starts


def _solo(kernel, batch):
    with bypassed():
        h = kernel.device_call_segments_wire(*batch)
        assert not isinstance(h, CoalescedTicket)
        return kernel.resolve_segments_wire(h, *batch)


def _concurrent(kernel, batches, scopes=None):
    """Every batch dispatched and resolved on its own thread."""
    results = [None] * len(batches)
    errors = [None] * len(batches)
    tickets = [None] * len(batches)

    def worker(i):
        try:
            if scopes is not None:
                with scoped_telemetry(scope=scopes[i]):
                    run(i)
            else:
                run(i)
        except BaseException as e:  # noqa: BLE001 - surfaced below
            errors[i] = e

    def run(i):
        kern = kernel[i] if isinstance(kernel, list) else kernel
        tickets[i] = kern.device_call_segments_wire(*batches[i])
        results[i] = kern.resolve_segments_wire(tickets[i], *batches[i])

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(len(batches))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return results, errors, tickets


def _equal(a, b):
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("quals", ["wire", "packed2_union"])
def test_merged_partners_equal_their_solo_runs(kernel, monkeypatch, quals):
    monkeypatch.setenv("FGUMI_TPU_COALESCE_PARTNERS", "3")
    batches = [_batch(40, 4, 64, 1), _batch(25, 3, 64, 2),
               _batch(60, 5, 64, 3, hi_q=94 if quals != "wire" else 40)]
    refs = [_solo(kernel, b) for b in batches]
    got, errors, tickets = _concurrent(kernel, batches)
    assert errors == [None] * 3
    for r, g in zip(refs, got):
        _equal(r, g)
    assert all(isinstance(t, CoalescedTicket) for t in tickets)
    snap = COALESCER.snapshot()
    assert snap["merged_batches"] == 1 and snap["partners"] == 3
    assert snap["max_partners"] == 3
    assert snap["rows_in"] == snap["rows_dispatched"] == sum(
        b[0].shape[0] for b in batches)


def test_key_keeps_tables_and_lengths_apart(monkeypatch):
    monkeypatch.setenv("FGUMI_TPU_COALESCE_WINDOW_MS", "100")
    kerns = [K.ConsensusKernel(quality_tables(45, 40), "cpu"),
             K.ConsensusKernel(quality_tables(30, 20), "cpu"),
             K.ConsensusKernel(quality_tables(45, 40), "cpu")]
    batches = [_batch(10, 3, 32, 4), _batch(10, 3, 32, 5),
               _batch(10, 3, 48, 6)]
    refs = [_solo(k, b) for k, b in zip(kerns, batches)]
    got, errors, _ = _concurrent(kerns, batches)
    assert errors == [None] * 3
    for r, g in zip(refs, got):
        _equal(r, g)
    snap = COALESCER.snapshot()
    assert snap["merged_batches"] == 0 and snap["solo_flushes"] == 3


def test_same_tables_merge_across_kernel_objects(monkeypatch):
    monkeypatch.setenv("FGUMI_TPU_COALESCE_PARTNERS", "2")
    kerns = [K.ConsensusKernel(quality_tables(45, 40), "cpu")
             for _ in range(2)]
    assert kerns[0]._coalesce_key() == kerns[1]._coalesce_key()
    batches = [_batch(10, 3, 32, 7), _batch(12, 2, 32, 8)]
    refs = [_solo(k, b) for k, b in zip(kerns, batches)]
    got, errors, _ = _concurrent(kerns, batches)
    assert errors == [None, None]
    for r, g in zip(refs, got):
        _equal(r, g)
    assert COALESCER.snapshot()["merged_batches"] == 1


def test_oversized_partner_dispatches_solo(kernel, monkeypatch):
    monkeypatch.setenv("FGUMI_TPU_COALESCE_PARTNER_ROWS", "50")
    big = _batch(30, 3, 32, 9)  # 90 rows: above the cap
    h = kernel.device_call_segments_wire(*big)
    assert not isinstance(h, CoalescedTicket)
    _equal(kernel.resolve_segments_wire(h, *big), _solo(kernel, big))
    assert COALESCER.snapshot()["oversize_solo"] == 1


def test_row_budget_flushes_in_arrival_order(kernel, monkeypatch):
    monkeypatch.setenv("FGUMI_TPU_COALESCE_MAX_ROWS", "100")
    monkeypatch.setenv("FGUMI_TPU_COALESCE_WINDOW_MS", "200")
    batches = [_batch(20, 3, 32, s) for s in (10, 11, 12)]  # 60 rows each
    t = [kernel.device_call_segments_wire(*b) for b in batches]
    # the second would overflow the first's group: the first flushes and
    # the second opens the next group, which the third overflows again
    assert [x.group.seq for x in t] == [t[0].group.seq, t[0].group.seq + 1,
                                        t[0].group.seq + 2]
    for ticket, b in zip(t, batches):
        _equal(kernel.resolve_segments_wire(ticket, *b), _solo(kernel, b))
    assert COALESCER.snapshot()["solo_flushes"] == 3


def test_window_auto_arms_at_two_running_jobs(monkeypatch):
    monkeypatch.delenv("FGUMI_TPU_COALESCE")
    assert not COALESCER.armed()
    COALESCER.set_active_jobs(3)
    assert not COALESCER.armed()  # not serving
    COALESCER.set_serving(True)
    assert COALESCER.armed()
    COALESCER.set_active_jobs(1)
    assert not COALESCER.armed()


@pytest.mark.parametrize("mode,window,armed", [
    (None, None, False), ("", None, False), ("auto", None, True),
    (None, "2", True), ("1", None, True), ("0", "2", False)])
def test_window_is_opt_in(monkeypatch, mode, window, armed):
    """Nothing configured, a serving daemon with two running jobs holds
    no batch; a configured window or ``FGUMI_TPU_COALESCE`` arms it."""
    for name, v in (("FGUMI_TPU_COALESCE", mode),
                    ("FGUMI_TPU_COALESCE_WINDOW_MS", window)):
        if v is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, v)
    COALESCER.set_serving(True)
    COALESCER.set_active_jobs(2)
    assert COALESCER.armed() == armed
    assert COALESCER.snapshot()["armed"] == armed


@pytest.mark.parametrize("mode,window,armed", [
    ("0", "300", False), ("off", "300", False), ("1", "0", False),
    ("force", "5", True), ("on", "300", True), ("", "300", False)])
def test_window_modes(monkeypatch, mode, window, armed):
    monkeypatch.setenv("FGUMI_TPU_COALESCE", mode)
    monkeypatch.setenv("FGUMI_TPU_COALESCE_WINDOW_MS", window)
    assert COALESCER.armed() == armed


def test_bypass_context(kernel):
    b = _batch(5, 2, 16, 13)
    with bypassed():
        assert not isinstance(kernel.device_call_segments_wire(*b),
                              CoalescedTicket)
    t = kernel.device_call_segments_wire(*b)
    assert isinstance(t, CoalescedTicket)
    kernel.resolve_segments_wire(t, *b)


def test_hold_priced_against_router_overhead(monkeypatch):
    monkeypatch.delenv("FGUMI_TPU_COALESCE")
    monkeypatch.setenv("FGUMI_TPU_COALESCE_WINDOW_MS", "50")
    ROUTER.reset()
    # unmeasured: the 50 ms prior overhead caps nothing below 50 ms
    assert COALESCER._effective_window_s() == pytest.approx(0.05)
    for _ in range(30):
        ROUTER.observe_device(0, 0, 0.0, 0.002, 0.002)
    assert COALESCER._effective_window_s() == pytest.approx(0.002, rel=0.05)
    assert COALESCER.snapshot()["priced_window_ms"] == pytest.approx(
        2.0, rel=0.05)


def test_retried_fault_in_merged_launch_leaves_partners_equal(kernel,
                                                              monkeypatch):
    monkeypatch.setenv("FGUMI_TPU_COALESCE_PARTNERS", "2")
    monkeypatch.setenv("FGUMI_TPU_FAULT", "serve.coalesce:raise:1.0:1")
    faults.reset()
    batches = [_batch(20, 3, 32, 14), _batch(15, 4, 32, 15)]
    with bypassed():
        refs = [kernel.resolve_segments_wire(
            kernel.device_call_segments_wire(*b), *b) for b in batches]
    got, errors, _ = _concurrent(kernel, batches)
    assert errors == [None, None]
    for r, g in zip(refs, got):
        _equal(r, g)
    assert faults.snapshot() == {"serve.coalesce": 1}
    assert COALESCER.snapshot()["merged_batches"] == 1


def test_unbounded_fault_fails_every_partner_no_host(kernel, monkeypatch):
    """A departure: the JAX package finishes each partner of a failed
    merged launch on its host engine; the port's partners fail (each
    job exits 3 and publishes nothing)."""
    monkeypatch.setenv("FGUMI_TPU_COALESCE_PARTNERS", "2")
    monkeypatch.setenv("FGUMI_TPU_FAULT", "serve.coalesce:raise:1.0")
    faults.reset()
    batches = [_batch(20, 3, 32, 16), _batch(15, 4, 32, 17)]
    got, errors, _ = _concurrent(kernel, batches)
    assert got == [None, None]
    assert all(isinstance(e, faults.InjectedFault) for e in errors)
    assert kernel.host_batches == 0


def test_oom_in_merged_launch_halves_each_partner(kernel, monkeypatch):
    monkeypatch.setenv("FGUMI_TPU_COALESCE_PARTNERS", "2")
    monkeypatch.setenv("FGUMI_TPU_FAULT", "serve.coalesce:oom:1.0:1")
    faults.reset()
    batches = [_batch(20, 3, 32, 18), _batch(16, 4, 32, 19)]
    with bypassed():
        refs = [kernel.resolve_segments_wire(
            kernel.device_call_segments_wire(*b), *b) for b in batches]
    K.DEVICE_STATS.reset()
    got, errors, _ = _concurrent(kernel, batches)
    assert errors == [None, None]
    for r, g in zip(refs, got):
        _equal(r, g)
    assert K.DEVICE_STATS.snapshot()["batch_splits"] == 2


def test_merged_fetch_attribution_proportional(kernel, monkeypatch):
    monkeypatch.setenv("FGUMI_TPU_COALESCE_PARTNERS", "2")
    batches = [_batch(30, 4, 32, 101), _batch(10, 4, 32, 102)]
    scopes = [TelemetryScope(f"job{i}") for i in range(2)]
    _, errors, _ = _concurrent(kernel, batches, scopes)
    assert errors == [None, None]
    assert COALESCER.snapshot()["merged_batches"] == 1
    s0, s1 = (s.device_stats(K.DeviceStats).snapshot() for s in scopes)
    assert s0["dispatches"] == 1 and s1["dispatches"] == 1
    b0, b1 = s0["bytes_fetched"], s1["bytes_fetched"]
    assert b1 > 0 and abs(b0 - 3 * b1) <= 4
    # the launch counts in the leader's scope only
    assert sum(s.launches("fgumi_tpu_torch.ops.cuda_kernel.LAUNCHES")
               for s in scopes) <= 1


def test_snapshot_surface(kernel, monkeypatch):
    from fgumi_tpu_torch.observe.metrics import METRICS

    monkeypatch.setenv("FGUMI_TPU_COALESCE_PARTNERS", "2")
    _concurrent(kernel, [_batch(16, 3, 32, s) for s in (81, 82)])
    snap = COALESCER.snapshot()
    for key in ("armed", "mode", "window_ms", "priced_window_ms",
                "active_jobs", "merged_batches", "solo_flushes", "partners",
                "oversize_solo", "rows_in", "rows_dispatched",
                "pending_groups"):
        assert key in snap, key
    assert METRICS.histogram("device.coalesce.window_wait_s").count >= 2
    assert METRICS.histogram("device.coalesce.fill_ratio").count >= 1
    assert (METRICS.get("device.coalesce.joined") or 0) >= 2


@pytest.fixture(scope="module")
def grouped(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_coalesce")
    p = str(d / "g.bam")
    assert port_cli.main(["simulate", "grouped-reads", "-o", p,
                          "--num-families", "400", "--seed", "9"]) == 0
    return p


def test_two_serve_jobs_byte_identical_to_standalone(grouped, monkeypatch):
    """Two ``simplex`` jobs at once on a serving daemon whose window is
    armed (auto: two running jobs): both outputs byte-identical to the
    standalone runs, merged launches counted, ``stats`` carrying the
    ``coalesce`` section."""
    from fgumi_tpu_torch.serve.client import ServeClient
    from fgumi_tpu_torch.serve.daemon import JobService

    monkeypatch.delenv("FGUMI_TPU_COALESCE")
    monkeypatch.setenv("FGUMI_TPU_COALESCE_WINDOW_MS", "400")
    # the hold is priced at the router's overhead: an unmeasured router
    # keeps the whole window
    monkeypatch.setattr(COALESCER, "_effective_window_s",
                        lambda: 0.4)
    d = tempfile.mkdtemp(prefix="ftc")
    svc = JobService(os.path.join(d, "s.sock"), workers=2)
    try:
        svc.start()
        argvs = {k: ["simplex", "-i", grouped, "-o",
                     os.path.join(d, f"{k}.bam"), "--device", "cpu",
                     "--batch-bytes", "4096"] for k in ("a", "b")}
        client = ServeClient(os.path.join(d, "s.sock"), timeout=30)
        ids = {k: client.submit(argv)["id"] for k, argv in argvs.items()}
        jobs = {k: client.wait(jid, timeout=120) for k, jid in ids.items()}
        assert all(j["state"] == "done" for j in jobs.values()), jobs
        coal = client.stats()["coalesce"]
        assert coal["merged_batches"] >= 1, coal
        for k, argv in argvs.items():
            # the standalone run of the same argv, after the daemon's
            out = argv[argv.index("-o") + 1]
            with open(out, "rb") as f:
                got = f.read()
            os.unlink(out)
            assert port_cli.main(argv) == 0
            with open(out, "rb") as f:
                assert f.read() == got, k
    finally:
        svc.request_shutdown()
        svc.close()
        shutil.rmtree(d, ignore_errors=True)
