"""The result sentinel (``fgumi_tpu_torch/ops/sentinel.py``), mirroring
``tests/test_sentinel.py`` where the semantics match and testing the
port's departures as departures.

Matching: ``FGUMI_TPU_AUDIT`` parsed as the JAX package's; deterministic
counter sampling; ``off`` a no-op; a clean audit keeps the breaker closed;
a ``device.fetch:corrupt-result`` under ``all`` is caught inline, trips the
breaker's SDC quarantine, is repaired with the oracle's result and lands in
the scoreboard with both digests; only forced (inline, quarantine-time)
audits count toward re-admission, a stale background one does not; a full
queue drops a sample before copying its inputs; the fused K1-f route's
stats rows are audited and repaired; ``--audit-output`` verdicts are
recorded; CLI runs audited and not are byte-identical to the JAX CLI's,
and a divergence lands in the run report.

Departures: unset, the default rate audits the card's dispatches only (the
plain versions of ``--device cpu`` are audited under an explicit value);
under the port's default route a quarantined device keeps running every
batch, audited inline (the JAX package routes them to its host engine)."""

import json
import logging
import time

import numpy as np
import pytest

from fgumi_tpu.io.bam import BamReader as JaxReader
from fgumi_tpu import cli as jax_cli
from fgumi_tpu.ops import sentinel as jax_sentinel
from fgumi_tpu_torch import cli as port_cli
from fgumi_tpu_torch.consensus.device_filter import DeviceFilterParams
from fgumi_tpu_torch.consensus.filter import FilterConfig
from fgumi_tpu_torch.ops import kernel as K
from fgumi_tpu_torch.ops.breaker import BREAKER
from fgumi_tpu_torch.ops.sentinel import SENTINEL, AuditSentinel, audit_rate
from fgumi_tpu_torch.ops.tables import quality_tables
from fgumi_tpu_torch.utils import faults


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for k in ("FGUMI_TPU_AUDIT", "FGUMI_TPU_FAULT", "FGUMI_TPU_AUDIT_QUEUE",
              "FGUMI_TPU_AUDIT_READMIT", "FGUMI_TPU_ROUTE",
              "FGUMI_TPU_HYBRID"):
        monkeypatch.delenv(k, raising=False)
    faults.reset()
    SENTINEL.reset()
    BREAKER.reset()
    yield
    SENTINEL.drain(timeout=10)
    SENTINEL.reset()
    BREAKER.reset()
    faults.reset()


def _kernel():
    return K.ConsensusKernel(quality_tables(45, 40), "cpu")


def _batch(seed=0, n_fam=4, fam=3, L=48):
    rng = np.random.default_rng(seed)
    counts = np.full(n_fam, fam, dtype=np.int64)
    codes = rng.integers(0, 4, size=(n_fam * fam, L)).astype(np.uint8)
    quals = rng.integers(2, 40, size=(n_fam * fam, L)).astype(np.uint8)
    return codes, quals, counts, np.concatenate(([0], np.cumsum(counts)))


def _resolve(kern, codes, quals, counts, starts):
    return K.route_and_call_segments(kern, codes, quals, counts, starts)


@pytest.mark.parametrize("value", ["off", "0", "false", "none", "all", "1",
                                   "always", "16", "3", "", "default",
                                   "bogus", "-2"])
def test_audit_rate_parse_equals_jax(monkeypatch, value):
    monkeypatch.setenv("FGUMI_TPU_AUDIT", value)
    assert audit_rate() == jax_sentinel.audit_rate() == audit_rate("cpu") \
        or value in ("", "default")
    if value in ("", "default"):
        # a departure: the default audits the card's dispatches only
        assert audit_rate("cuda") == jax_sentinel.audit_rate() == 64
        assert audit_rate("cpu") == 0


def test_sampling_is_deterministic(monkeypatch):
    monkeypatch.setenv("FGUMI_TPU_AUDIT", "3")
    kern = _kernel()
    batch = _batch(seed=1)
    runs = []
    for _ in range(2):
        SENTINEL.reset()
        for _i in range(7):
            _resolve(kern, *batch)
        SENTINEL.drain()
        runs.append((list(SENTINEL.sampled_ordinals), SENTINEL.sampled))
    assert runs[0] == runs[1]
    assert runs[0][0] == [3, 6] and runs[0][1] == 2
    assert SENTINEL.snapshot()["clean"] == 2


@pytest.mark.parametrize("value", ["off", None])
def test_audit_off_and_cpu_default_are_no_ops(monkeypatch, value):
    if value is not None:
        monkeypatch.setenv("FGUMI_TPU_AUDIT", value)
    kern = _kernel()
    for _ in range(70):
        out = _resolve(kern, *_batch(seed=2))
    assert out[0].shape[0] == 4
    snap = SENTINEL.snapshot()
    assert snap["sampled"] == 0 and not SENTINEL.has_activity()


def test_clean_audit_counts_and_keeps_breaker_closed(monkeypatch):
    monkeypatch.setenv("FGUMI_TPU_AUDIT", "all")
    kern = _kernel()
    for seed in range(3):
        _resolve(kern, *_batch(seed=seed))
    snap = SENTINEL.snapshot()
    assert snap["sampled"] == snap["clean"] == 3 and snap["divergent"] == 0
    assert SENTINEL.inline_audits == 3
    assert BREAKER.state == "closed"


def test_injected_divergence_trips_sdc_and_repairs(monkeypatch):
    monkeypatch.setenv("FGUMI_TPU_AUDIT", "all")
    kern = _kernel()
    batch = _batch(seed=4)
    want = _resolve(_kernel(), *batch)
    monkeypatch.setenv("FGUMI_TPU_FAULT", "device.fetch:corrupt-result:1.0:1")
    faults.reset()
    got = _resolve(kern, *batch)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    snap = SENTINEL.snapshot()
    assert snap["divergent"] == 1
    rec = snap["divergence"][0]
    assert rec["families"] >= 1 and rec["fields"]
    assert len(rec["device_digest"]) == len(rec["host_digest"]) == 64
    assert rec["device_digest"] != rec["host_digest"]
    b = BREAKER.snapshot()
    assert b["state"] == "open" and b["sdc_trips"] == 1
    assert BREAKER.audit_required()


def test_quarantine_keeps_the_device_and_audits_inline(monkeypatch):
    """A departure: under the port's default route a quarantined device
    keeps running every batch, each audited inline (the JAX package
    routes them to its host engine); audited clean probes lift it."""
    monkeypatch.setenv("FGUMI_TPU_AUDIT", "off")
    monkeypatch.setenv("FGUMI_TPU_AUDIT_READMIT", "2")
    monkeypatch.setenv("FGUMI_TPU_BREAKER_COOLDOWN_S", "2")
    kern = _kernel()
    kern._host()._build_tables()  # the audits below take milliseconds
    batch = _batch(seed=5)
    want = _resolve(_kernel(), *batch)
    BREAKER.record_sdc("test")
    K.DEVICE_STATS.reset()
    got = _resolve(kern, *batch)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert K.DEVICE_STATS.dispatches == 1
    assert K.DEVICE_STATS.snapshot().get("route_device") == 1
    assert SENTINEL.inline_audits == 1 and BREAKER.audit_required()
    time.sleep(2.1)  # the cooldown: half-open, audited probes count
    _resolve(kern, *batch)
    assert BREAKER.audit_required()
    _resolve(kern, *batch)
    assert not BREAKER.audit_required() and BREAKER.state == "closed"
    _resolve(kern, *batch)  # back to the rate: off
    assert SENTINEL.inline_audits == 3 and K.DEVICE_STATS.dispatches == 4


def test_stale_background_clean_audit_cannot_lift_quarantine(monkeypatch):
    monkeypatch.setenv("FGUMI_TPU_AUDIT_READMIT", "1")
    monkeypatch.setenv("FGUMI_TPU_BREAKER_COOLDOWN_S", "0.1")
    s = AuditSentinel()
    kern = _kernel()
    codes, quals, counts, starts = _batch(seed=12)
    w, q, d, e, _ = kern._host().call_segments_counted(codes, quals, starts)
    BREAKER.record_sdc("test")
    time.sleep(0.2)
    assert BREAKER.state == "half-open"
    item = s._retain(kern, codes, quals, starts, w, q, d, e, 1, None, None,
                     -1, 1)
    item["forced"] = False
    assert s._audit_one(item) is None
    assert BREAKER.audit_required()
    item = s._retain(kern, codes, quals, starts, w, q, d, e, 1, None, None,
                     -1, 2)
    item["forced"] = True
    assert s._audit_one(item) is None
    assert not BREAKER.audit_required()


def test_queue_overflow_drops_before_retaining(monkeypatch):
    monkeypatch.setenv("FGUMI_TPU_AUDIT", "2")
    monkeypatch.setenv("FGUMI_TPU_AUDIT_QUEUE", "1")
    s = AuditSentinel()
    kern = _kernel()
    codes, quals, counts, starts = _batch(seed=13)
    w, q, d, e, _ = kern._host().call_segments_counted(codes, quals, starts)
    retained = []
    real = s._retain
    monkeypatch.setattr(s, "_retain",
                        lambda *a, **k: retained.append(1) or real(*a, **k))
    with s._lock:
        s._q.append((None, None))  # a backlog the worker never sees
    assert s.maybe_audit(kern, codes, quals, starts, w, q, d, e) is None
    assert s.maybe_audit(kern, codes, quals, starts, w, q, d, e) is None
    snap = s.snapshot()
    assert snap["dropped"] == 1 and snap["sampled"] == 1
    assert retained == []
    with s._lock:
        s._q.clear()


def _filter_stage():
    cfg = FilterConfig.new([2], [0.2], [0.1], min_base_quality=10)
    return DeviceFilterParams(cfg, True)


@pytest.mark.parametrize("corrupt", [False, True])
def test_fused_filter_route_audited(monkeypatch, corrupt):
    """K1-f's stats rows (and, inline, the survivors' gather) against the
    host engine's through ``fused_stats_oracle``; a corrupted stats fetch
    is caught and the resolve hands back the oracle's full columns."""
    monkeypatch.setenv("FGUMI_TPU_AUDIT", "all")
    if corrupt:
        monkeypatch.setenv("FGUMI_TPU_FAULT",
                           "device.fetch:corrupt-result:1.0:1")
        faults.reset()
    kern = _kernel()
    codes, quals, counts, starts = _batch(seed=6, L=48)
    lens = np.full(len(counts), 48, dtype=np.int32)
    params = (1, 10, _filter_stage())
    ticket = kern.device_call_segments_wire_filtered(codes, quals, starts,
                                                     lens, params)
    out = kern.resolve_segments_wire_filtered(ticket, codes, quals, starts)
    snap = SENTINEL.snapshot()
    assert snap["sampled"] == 1
    if corrupt:
        assert out[0] == "columns" and snap["divergent"] == 1
        assert snap["divergence"][0]["route"] == "device-filter"
        want = kern._host().call_segments(codes, quals, starts)
        for a, b in zip(out[1:], want):
            np.testing.assert_array_equal(a, b)
    else:
        assert out[0] == "stats" and snap["clean"] == 1


@pytest.fixture(scope="module")
def grouped(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_sentinel")
    p = str(d / "g.bam")
    assert port_cli.main(["simulate", "grouped-reads", "-o", p,
                          "--num-families", "300", "--seed", "3"]) == 0
    return p


def _records(path):
    with JaxReader(path) as r:
        return [rec.data for rec in r]


@pytest.mark.parametrize("audit", ["all", "2", "off"])
def test_cli_audited_records_equal_jax(tmp_path, monkeypatch, grouped,
                                       audit):
    monkeypatch.setenv("FGUMI_TPU_AUDIT", audit)
    out = {}
    for name, main, extra in (("jax", jax_cli.main, []),
                              ("port", port_cli.main, ["--device", "cpu",
                                                       "--batch-bytes",
                                                       "8192"])):
        out[name] = str(tmp_path / f"{name}.bam")
        assert main(["simplex", "-i", grouped, "-o", out[name]]
                    + extra) == 0
    assert _records(out["port"]) == _records(out["jax"])
    snap = SENTINEL.snapshot()
    assert snap["divergent"] == 0
    assert (snap["sampled"] > 0) == (audit != "off")


def test_cli_divergence_lands_in_run_report(tmp_path, monkeypatch, grouped):
    monkeypatch.setenv("FGUMI_TPU_AUDIT", "all")
    monkeypatch.setenv("FGUMI_TPU_FAULT", "device.fetch:corrupt-result:1.0:1")
    faults.reset()
    rpt = tmp_path / "r.json"
    out = tmp_path / "o.bam"
    assert port_cli.main(["--run-report", str(rpt), "simplex", "-i", grouped,
                          "-o", str(out), "--device", "cpu"]) == 0
    report = json.load(open(rpt))
    audit = report["audit"]
    assert audit["divergent"] == 1 and audit["divergence"]
    assert report["device"]["breaker"]["sdc_trips"] == 1
    monkeypatch.delenv("FGUMI_TPU_FAULT")
    faults.reset()
    ref = tmp_path / "ref.bam"
    assert jax_cli.main(["simplex", "-i", grouped, "-o", str(ref)]) == 0
    assert _records(str(out)) == _records(str(ref))


def test_cli_audit_output_verdicts_recorded(tmp_path, grouped):
    rpt = tmp_path / "r.json"
    out = tmp_path / "o.bam"
    assert port_cli.main(["--audit-output", "--run-report", str(rpt),
                          "simplex", "-i", grouped, "-o", str(out),
                          "--device", "cpu"]) == 0
    rec = json.load(open(rpt))["audit"]["output"][-1]
    assert rec["ok"] and rec["records"] > 0 and rec["members"] > 0
    assert rec["path"] == str(out)


def test_cli_audit_output_refusal_recorded(tmp_path, monkeypatch, caplog,
                                          grouped):
    monkeypatch.setenv("FGUMI_TPU_FAULT",
                       "writer.compress:corrupt-bytes:1.0:1")
    faults.reset()
    out = tmp_path / "o.bam"
    with caplog.at_level(logging.ERROR, logger="fgumi_tpu_torch"):
        assert port_cli.main(["--audit-output", "simplex", "-i", grouped,
                              "-o", str(out), "--device", "cpu"]) == 5
    assert not out.exists()
    rec = SENTINEL.snapshot()["output"][-1]
    assert not rec["ok"] and rec["error"]


def test_background_audits_drained_before_exit(monkeypatch):
    monkeypatch.setenv("FGUMI_TPU_AUDIT", "2")
    kern = _kernel()
    for seed in range(6):
        _resolve(kern, *_batch(seed=seed))
    assert SENTINEL.drain(timeout=10)
    snap = SENTINEL.snapshot()
    assert snap["pending"] == 0 and snap["sampled"] == 3
    assert snap["clean"] + snap["dropped"] == 3
