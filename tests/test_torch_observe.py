"""The port's telemetry layer (``fgumi_tpu_torch/observe``) held against the
JAX package's (``fgumi_tpu/observe``).

- spans: the disabled path is one shared no-op, nesting, thread
  attribution, errors, the event cap and its truncation marker, valid
  Chrome JSON; ``run_stages`` records its stage spans on the stage threads
  and none with tracing off;
- the metrics registry and the latency histograms (buckets, quantiles and
  summaries equal to the JAX package's for the same observations);
- the heartbeat (gauges, a broken gauge, its thread, the rate EWMA and
  ETA, ``ProgressTracker(total=...)``'s goal);
- scopes: isolation, thread propagation, two concurrent in-process
  commands keeping separate reports;
- the flight recorder's ring, dumps and ``validate_dump``;
- the atomic commit (``--no-atomic-output`` writes to the final name,
  ``FGUMI_TPU_NO_ATOMIC``, stale temporaries);
- ``-v`` and ``FGUMI_TPU_LOG``;
- the run report of ``simplex`` and ``pipeline --device cpu``: accepted by
  both validators, with the JAX package's stage names, record counts,
  exit status and top-level sections;
- with no telemetry option, no span is recorded and no telemetry thread
  starts.
"""

import json
import logging
import os
import threading
import time

import pytest

import fgumi_tpu.native as jax_native
import fgumi_tpu.native.batch as jax_native_batch
from fgumi_tpu.cli import main as jax_main
from fgumi_tpu.observe import metrics as jax_metrics
from fgumi_tpu.observe import report as jax_report
from fgumi_tpu_torch.cli import main as port_main
from fgumi_tpu_torch.observe import flight, heartbeat as hb, trace
from fgumi_tpu_torch.observe import metrics as port_metrics
from fgumi_tpu_torch.observe import report as port_report
from fgumi_tpu_torch.observe.metrics import (METRICS, MetricsRegistry,
                                             record_stage_times)
from fgumi_tpu_torch.observe.scope import (command_argv, current_argv,
                                           current_scope, publish_to_global,
                                           scoped_telemetry, spawn_thread)
from fgumi_tpu_torch.pipeline import StageTimes, run_stages
from fgumi_tpu_torch.utils import atomic
from fgumi_tpu_torch.utils.progress import ProgressTracker

LOGGER = "fgumi_tpu_torch"


@pytest.fixture(autouse=True)
def _clean_tracer():
    trace.stop_trace()
    yield
    trace.stop_trace()


@pytest.fixture(scope="module")
def jax_lib(tmp_path_factory):
    """The JAX package's native library, built from its source into a
    private temporary directory (never the package's own build path, whose
    build races between xdist workers): the JAX CLI then runs the same
    batch engines (and ``run_stages``) as the port."""
    import ctypes
    import subprocess

    src = os.path.join(os.path.dirname(jax_native.__file__),
                       "fgumi_native.cc")
    so = str(tmp_path_factory.mktemp("jaxnative") / "libjax_native.so")
    subprocess.run(["g++", "-O1", "-shared", "-fPIC", "-pthread", "-o", so,
                    src, "-ldeflate"], check=True, capture_output=True)
    lib = ctypes.CDLL(so)
    jax_native._declare(lib)
    return lib


@pytest.fixture(autouse=True)
def with_jax_lib(monkeypatch, jax_lib):
    monkeypatch.setattr(jax_native, "get_lib", lambda: jax_lib)
    monkeypatch.setattr(jax_native_batch, "get_lib", lambda: jax_lib)


# ---------------------------------------------------------------------------
# spans


def test_span_disabled_is_shared_noop():
    assert not trace.tracing_enabled()
    s = trace.span("anything", key="value")
    assert s is trace.NULL_SPAN
    assert trace.span("other") is s
    with s:
        s.set(extra=1)
    trace.instant("marker")


def test_span_nesting_attrs_and_set():
    t = trace.start_trace()
    with trace.span("outer", batch=3):
        with trace.span("inner") as sp:
            sp.set(bytes=480)
    by_name = {e["name"]: e for e in t.snapshot() if e["ph"] == "X"}
    outer, inner = by_name["outer"], by_name["inner"]
    assert outer["args"] == {"batch": 3}
    assert inner["args"] == {"bytes": 480}
    assert outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"] + 0.1
    assert outer["tid"] == inner["tid"]


def test_span_thread_attribution():
    t = trace.start_trace()

    def work():
        with trace.span("in-thread"):
            pass

    th = threading.Thread(target=work, name="obs-test-thread")
    with trace.span("on-main"):
        pass
    th.start()
    th.join()
    events = t.snapshot()
    spans = {e["name"]: e for e in events if e["ph"] == "X"}
    metas = {e["tid"]: e["args"]["name"] for e in events if e["ph"] == "M"}
    assert spans["on-main"]["tid"] != spans["in-thread"]["tid"]
    assert metas[spans["in-thread"]["tid"]] == "obs-test-thread"
    assert metas[spans["on-main"]["tid"]] == threading.current_thread().name


def test_span_records_error_type_and_propagates():
    t = trace.start_trace()
    with pytest.raises(ValueError):
        with trace.span("failing"):
            raise ValueError("boom")
    (ev,) = [e for e in t.snapshot() if e["ph"] == "X"]
    assert ev["args"]["error"] == "ValueError"


@pytest.mark.parametrize("cap,n", [(2, 5), (3, 10), (8, 8)])
def test_trace_cap_truncation_marker_and_metric(tmp_path, cap, n):
    METRICS.reset()
    t = trace.start_trace(max_events=cap)
    for i in range(n):
        with trace.span(f"s{i}"):
            pass
    assert len(t.snapshot()) <= cap
    out = tmp_path / "trunc.json"
    trace.write_trace(str(out), t)
    obj = json.loads(out.read_text())
    markers = [e for e in obj["traceEvents"]
               if e["name"] == "trace.truncated"]
    try:
        if t.dropped:
            assert len(markers) == 1
            assert markers[0]["args"]["dropped_events"] == t.dropped
            assert obj["otherData"]["dropped_events"] == t.dropped
            assert METRICS.get("trace.dropped_events") == t.dropped
        else:
            assert markers == []
    finally:
        METRICS.reset()


def test_write_trace_is_valid_chrome_json(tmp_path):
    t = trace.start_trace()
    with trace.span("a"):
        pass
    out = tmp_path / "trace.json"
    trace.write_trace(str(out), t)
    obj = json.loads(out.read_text())
    assert any(e["ph"] == "X" and e["name"] == "a"
               for e in obj["traceEvents"])
    for ev in obj["traceEvents"]:
        assert {"name", "ph", "pid", "tid"} <= set(ev)
    clock = obj["otherData"]["clock"]
    assert abs(clock["t_zero_unix"] - time.time()) < 60


@pytest.mark.parametrize("value,ok", [
    ("00-" + "a" * 32 + "-" + "b" * 16 + "-01", True),
    ("00-" + "0" * 32 + "-" + "b" * 16 + "-01", False),
    ("ff-" + "a" * 32 + "-" + "b" * 16 + "-01", False),
    ("00-" + "a" * 31 + "-" + "b" * 16 + "-01", False),
    (None, False)])
def test_traceparent_parse_matches_jax(value, ok):
    from fgumi_tpu.observe import trace as jax_trace

    got = trace.parse_traceparent(value)
    assert (got is not None) == ok
    assert got == jax_trace.parse_traceparent(value)


def test_run_stages_spans_inline():
    t = trace.start_trace()
    sunk = []
    run_stages(iter([1, 2, 3]), lambda x: [x * 2], sunk.append,
               threads=0, resolve_fn=lambda x: x + 1)
    assert sunk == [3, 5, 7]
    names = {e["name"] for e in t.snapshot() if e["ph"] == "X"}
    assert {"pipeline.read", "pipeline.process", "pipeline.resolve",
            "pipeline.sink"} <= names


@pytest.mark.parametrize("threads,sink_thread", [
    (2, "fgumi-writer"), (4, "fgumi-writer")])
def test_run_stages_threaded_spans_on_stage_threads(threads, sink_thread):
    t = trace.start_trace()
    sunk = []
    run_stages(iter(range(8)), lambda x: [x], sunk.append, threads=threads,
               resolve_fn=lambda x: x)
    assert sunk == list(range(8))
    events = t.snapshot()
    metas = {e["tid"]: e["args"]["name"] for e in events if e["ph"] == "M"}

    def names(span):
        return {metas[e["tid"]] for e in events
                if e["ph"] == "X" and e["name"] == span}

    assert names("pipeline.read") == {"fgumi-reader"}
    assert names("pipeline.sink") == {sink_thread}
    if threads >= 4:
        assert names("pipeline.resolve") == {"fgumi-worker-0"}


def test_run_stages_folds_stage_times_on_failure():
    METRICS.reset()

    def boom(x):
        raise RuntimeError("stage failed")

    with pytest.raises(RuntimeError):
        run_stages(iter([1]), boom, lambda x: None, threads=2)
    try:
        assert "pipeline.stage.read.busy_s" in METRICS.snapshot()
    finally:
        METRICS.reset()


def test_no_spans_and_no_threads_when_disabled(tmp_path, grouped):
    """No telemetry option: no tracer, no heartbeat thread, nothing in a
    trace (the global tracer stays unset)."""
    before = {t.name for t in threading.enumerate()}
    assert port_main(["simplex", "-i", grouped, "-o",
                      str(tmp_path / "o.bam"), "--device", "cpu",
                      "--threads", "2"]) == 0
    assert trace._tracer is None and not trace.tracing_enabled()
    new = {t.name for t in threading.enumerate()} - before
    assert not any(n in ("fgumi-heartbeat", "fgumi-flight-dump")
                   for n in new), new


# ---------------------------------------------------------------------------
# metrics and histograms


def test_metrics_inc_set_max_update_and_snapshot():
    m = MetricsRegistry()
    m.inc("b.count")
    m.inc("b.count", 4)
    m.set("a.gauge", 7)
    m.max("c.peak", 10)
    m.max("c.peak", 3)
    m.max("c.peak", 12)
    m.update({"dispatches": 2, "mode": "wire"}, prefix="device")
    m.update({"dispatches": 3}, prefix="device")
    snap = m.snapshot()
    assert snap == {"a.gauge": 7, "b.count": 5, "c.peak": 12,
                    "device.dispatches": 5, "device.mode": "wire"}
    assert list(snap) == sorted(snap)
    m.reset()
    assert m.snapshot() == {}


def test_record_stage_times_folds_like_jax():
    st = StageTimes()
    st.add_busy("read", 1.5)
    st.add_busy("read", 0.5)
    st.add_blocked("write", 0.25)
    st.sample_queues(2, 4)
    st.sample_queues(4, 0)
    st.peak_in_flight_bytes = 1024
    got = {}
    for mod, stats in ((port_metrics, st), (jax_metrics, st)):
        with (scoped_telemetry("x") if mod is port_metrics
              else _jax_scope()) as scope:
            mod.record_stage_times(stats)
            got[mod.__name__] = scope.metrics.snapshot()
    assert got["fgumi_tpu_torch.observe.metrics"] \
        == got["fgumi_tpu.observe.metrics"]
    assert got["fgumi_tpu.observe.metrics"]["pipeline.stage.read.busy_s"] \
        == 2.0


def _jax_scope():
    from fgumi_tpu.observe.scope import scoped_telemetry as jax_scoped

    return jax_scoped("x")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_histogram_summary_equals_jax(seed):
    import numpy as np

    rng = np.random.default_rng(seed)
    values = list(rng.lognormal(-6, 2, size=500)) + [0.0, 1e-9, 1e7]
    port_h = port_metrics.Histogram()
    jax_h = jax_metrics.Histogram()
    for v in values:
        port_h.observe(v)
        jax_h.observe(v)
    assert port_h.summary() == jax_h.summary()
    assert port_h.buckets() == jax_h.buckets()
    s = port_h.summary()
    assert s["p50"] <= s["p90"] <= s["p99"] <= s["max"]


def test_histogram_bucket_edges_rejects_and_merge():
    Histogram = port_metrics.Histogram
    assert port_metrics.HIST_EDGES == jax_metrics.HIST_EDGES
    edge = port_metrics.HIST_EDGES[40]
    assert Histogram.bucket_index(edge) == 40
    assert Histogram.bucket_index(edge * 1.0001) == 41
    assert Histogram.bucket_index(0.0) == 0
    assert Histogram.bucket_index(1e12) == len(port_metrics.HIST_EDGES) - 1
    a, b = Histogram(), Histogram()
    for v in (0.01, 0.02):
        a.observe(v)
    for v in (0.04, 8.0):
        b.observe(v)
    a.observe(-1.0)
    a.observe(float("nan"))
    a.merge(b)
    assert a.count == 4 and a.max == 8.0
    assert abs(a.total - 8.07) < 1e-9
    assert a.buckets()[-1][1] == 4


def test_histograms_per_scope_and_merged_on_publish():
    port_metrics._GLOBAL_REGISTRY.reset()
    try:
        scopes = []
        for _ in range(2):
            with scoped_telemetry("job") as scope:
                METRICS.observe("merge.wait_s", 0.25)
                assert METRICS.histogram("merge.wait_s").count == 1
            publish_to_global(scope)
            scopes.append(scope)
        g = port_metrics._GLOBAL_REGISTRY.histogram("merge.wait_s")
        assert g.count == 2
        with scoped_telemetry("other"):
            assert METRICS.histogram("merge.wait_s") is None
    finally:
        port_metrics._GLOBAL_REGISTRY.reset()


def test_report_latency_section_and_validators():
    with scoped_telemetry("simplex"):
        METRICS.observe("device.dispatch.wall_s", 0.125)
        report = port_report.build_report("simplex", ["simplex"], 0.0, 1.0,
                                          0)
    assert report["tool"] == "fgumi-tpu-torch"
    assert report["latency"]["device.dispatch.wall_s"]["count"] == 1
    assert port_report.validate_report(report) == []
    assert jax_report.validate_report(report) == []
    assert port_report.SCHEMA_VERSION == jax_report.SCHEMA_VERSION
    bad = dict(report)
    bad["latency"] = {"x": {"count": 1, "sum": 1, "p50": 2.0, "p90": 1.0,
                            "p99": 3.0, "max": 3.0}}
    assert any("not ordered" in e for e in port_report.validate_report(bad))
    bad["latency"] = {"x": {"count": 1}}
    assert any("missing numeric" in e
               for e in port_report.validate_report(bad))
    bad = dict(report, surprise=1)
    assert port_report.validate_report(bad) \
        == jax_report.validate_report(bad)


# ---------------------------------------------------------------------------
# progress and heartbeat


@pytest.mark.parametrize("every,n,level", [
    (1000, 5, logging.DEBUG), (10, 25, logging.INFO)])
def test_progress_finish_level_and_records_metric(caplog, every, n, level):
    with scoped_telemetry("p") as scope:
        p = ProgressTracker("cmd", every=every)
        with caplog.at_level(logging.DEBUG, logger=LOGGER):
            p.add(n)
            p.finish()
        assert scope.metrics.get("records.cmd") == n
    done = [r for r in caplog.records if f"done, {n} records" in r.message]
    assert done and done[0].levelno == level


def test_progress_zero_records_silent(caplog):
    p = ProgressTracker("emptycmd", every=10)
    with caplog.at_level(logging.DEBUG, logger=LOGGER):
        p.finish()
    assert not [r for r in caplog.records if "emptycmd" in r.message]


def test_heartbeat_beat_gauges_and_broken_gauge(caplog):
    def bad():
        raise RuntimeError("gauge broke")

    tokens = [hb.register_gauge(lambda: {"read": 7, "q_in": "2/4"}),
              hb.register_gauge(bad)]
    try:
        beat = hb.Heartbeat(0)
        with caplog.at_level(logging.INFO, logger=LOGGER):
            beat.beat()
        line = [r.message for r in caplog.records
                if r.message.startswith("heartbeat:")][0]
        assert "read=7" in line and "q_in=2/4" in line
    finally:
        for t in tokens:
            hb.unregister_gauge(t)
    beat.stop()


def test_heartbeat_thread_stops_and_joins():
    beat = hb.Heartbeat(60)
    assert any(t.name == "fgumi-heartbeat" for t in threading.enumerate())
    beat.stop()
    assert beat._t is None


def test_heartbeat_rate_ewma_and_eta(caplog):
    counter = {"n": 0}
    token = hb.register_gauge(lambda: {"written": counter["n"]})
    assert hb.set_goal(1000, "t-ewma")
    try:
        with scoped_telemetry("hb") as scope:
            beat = hb.Heartbeat(0)
            beat.beat()
            counter["n"] = 500
            time.sleep(0.02)
            with caplog.at_level(logging.INFO, logger=LOGGER):
                beat.beat()
            line = [r.message for r in caplog.records
                    if r.message.startswith("heartbeat:")][-1]
            assert "rate=" in line and "eta=" in line
            assert beat.rate_ewma > 0 and beat.last_eta_s is not None
            beat.stop()
            assert scope.metrics.get("heartbeat.records_per_s") > 0
            assert scope.metrics.get("heartbeat.last_eta_s") is not None
    finally:
        hb.clear_goal("t-ewma")
        hb.unregister_gauge(token)


def test_progress_total_arms_goal_first_holder_wins():
    a = ProgressTracker("job-a", every=10, total=100)
    b = ProgressTracker("job-b", total=999)
    try:
        assert hb._goal_total() == 100
        assert b._hb_token is None
        a.add(10)
        assert any(s.get("records") == 10 for _t, s in hb._gauge_states())
        b.finish()
        assert hb._goal_total() == 100
    finally:
        a.finish()
    assert hb._goal_total() is None


def test_heartbeat_reads_device_stats_under_lock(caplog):
    import torch

    from fgumi_tpu_torch.ops.kernel import DEVICE_STATS

    with scoped_telemetry("dev"):
        slot = DEVICE_STATS.begin(torch.device("cpu"), 64)
        beat = hb.Heartbeat(0)
        with caplog.at_level(logging.INFO, logger=LOGGER):
            beat.beat()
        DEVICE_STATS.end(slot, 32, 0.0)
    line = [r.message for r in caplog.records
            if r.message.startswith("heartbeat:")][-1]
    assert "device(dispatches=1 in-flight=1)" in line
    # --device cpu never initialises CUDA: no device-memory column
    assert "devmem=" not in line
    assert flight.device_memory_snapshot() is None


# ---------------------------------------------------------------------------
# scopes


def test_scope_isolation_and_fallback():
    METRICS.reset()
    METRICS.inc("x.count", 2)
    with scoped_telemetry("a") as a:
        assert current_scope() is a
        METRICS.inc("x.count", 5)
        assert METRICS.get("x.count") == 5
    assert current_scope() is None
    assert METRICS.get("x.count") == 2
    METRICS.reset()


def test_scope_propagates_to_spawned_threads():
    seen = {}
    with scoped_telemetry("t") as scope:
        def work():
            seen["scope"] = current_scope()
            METRICS.inc("from.thread")

        th = spawn_thread(work, name="obs-scope")
        th.start()
        th.join()
    assert seen["scope"] is scope
    assert scope.metrics.get("from.thread") == 1


def test_device_stats_scope_isolation_and_publish():
    import torch

    from fgumi_tpu_torch.ops import kernel

    with scoped_telemetry("a") as a:
        kernel.DEVICE_STATS.begin(torch.device("cpu"), 10)
    with scoped_telemetry("b") as b:
        assert kernel.DEVICE_STATS.dispatches == 0
    assert a.device_stats_if_any().dispatches == 1
    publish_to_global(a)
    assert kernel._GLOBAL_DEVICE_STATS.dispatches == 1
    publish_to_global(b)  # never touched the device: the global reads 0
    assert kernel._GLOBAL_DEVICE_STATS.dispatches == 0


def test_tracer_is_scope_local():
    with scoped_telemetry("a") as a:
        trace.start_trace()
        with trace.span("in-a"):
            pass
    with scoped_telemetry("b"):
        assert not trace.tracing_enabled()
    assert not trace.tracing_enabled()
    assert [e["name"] for e in a.tracer.snapshot() if e["ph"] == "X"] \
        == ["in-a"]


def test_command_argv_override_and_job_context():
    from fgumi_tpu_torch.observe.scope import (TelemetryScope,
                                               adopt_job_context,
                                               job_context)

    import sys

    assert current_argv() is sys.argv
    with command_argv(["x", "y"]):
        assert current_argv() == ["x", "y"]
    s = TelemetryScope("plain")
    adopt_job_context(s)  # standalone: nothing pending
    assert s.job_id is None and s.trace_id is None
    with job_context(job_id="j-1", trace_id="a" * 32):
        adopt_job_context(s)
    assert s.job_id == "j-1" and s.trace_id == "a" * 32


def test_concurrent_cli_commands_keep_separate_reports(tmp_path, grouped):
    solo_rpt = str(tmp_path / "solo.json")
    assert port_main(["--run-report", solo_rpt, "simplex", "-i", grouped,
                      "-o", str(tmp_path / "solo.bam"),
                      "--device", "cpu"]) == 0
    solo = json.load(open(solo_rpt))
    rcs = {}

    def run(tag):
        rcs[tag] = port_main(
            ["--run-report", str(tmp_path / f"{tag}.json"), "simplex",
             "-i", grouped, "-o", str(tmp_path / f"{tag}.bam"),
             "--device", "cpu"])

    threads = [threading.Thread(target=run, args=(t,)) for t in ("p", "q")]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert rcs == {"p": 0, "q": 0}
    for tag in ("p", "q"):
        report = json.load(open(str(tmp_path / f"{tag}.json")))
        assert report["records"] == solo["records"]
        assert report["device"]["dispatches"] \
            == solo["device"]["dispatches"]
        assert report["metrics"]["io.bytes_read"] \
            == solo["metrics"]["io.bytes_read"]


# ---------------------------------------------------------------------------
# flight recorder


@pytest.fixture
def fresh_flight():
    flight.FLIGHT.reset()
    yield flight.FLIGHT
    flight.FLIGHT.reset()


def test_ring_bounded_and_notes(fresh_flight):
    ring = flight.FlightRecorder(capacity=16)
    for i in range(40):
        ring.note("e", i=i)
    evs = ring.events()
    assert len(evs) == 16 and evs[-1]["i"] == 39
    assert evs[-1]["kind"] == "e" and "t" in evs[-1]
    assert evs[-1]["thread"] == threading.current_thread().name


def test_warning_logs_land_in_the_ring(fresh_flight):
    from fgumi_tpu_torch.observe.logs import setup_logging

    setup_logging("info")
    logging.getLogger(LOGGER).warning("ring check %d", 7)
    assert any(e["kind"] == "log" and "ring check 7" in e["msg"]
               for e in fresh_flight.events())


def test_dump_without_destination_is_none(fresh_flight, monkeypatch):
    monkeypatch.delenv("FGUMI_TPU_FLIGHT", raising=False)
    assert fresh_flight.dump("anything") is None


def test_dump_valid_deduped_and_capped(fresh_flight, tmp_path):
    from fgumi_tpu.observe.flight import validate_dump as jax_validate

    fresh_flight.configure(str(tmp_path))
    fresh_flight.note("x", a=1)
    try:
        raise ValueError("kaboom")
    except ValueError as e:
        path = fresh_flight.dump("unit-test", exc=e, extra=2)
    obj = json.load(open(path))
    assert flight.validate_dump(obj) == [] == jax_validate(obj)
    assert obj["tool"] == "fgumi-tpu-torch"
    assert obj["exception"]["type"] == "ValueError"
    assert obj["attrs"] == {"extra": 2}
    assert fresh_flight.dump("unit-test") is None  # once per reason
    for i in range(flight.MAX_DUMPS + 3):
        fresh_flight.dump(f"r{i}")
    assert len(fresh_flight.dump_paths()) == flight.MAX_DUMPS


@pytest.mark.parametrize("mutate,needle", [
    (lambda o: o.pop("reason"), "missing required field 'reason'"),
    (lambda o: o.update(schema_version=99), "schema_version"),
    (lambda o: o.update(events=[{"no": "kind"}]), "malformed ring event"),
    (lambda o: o.update(threads={"t": "nope"}), "stack is not a list")])
def test_validate_dump_flags_problems(mutate, needle):
    from fgumi_tpu.observe.flight import validate_dump as jax_validate

    obj = {"schema_version": flight.SCHEMA_VERSION, "tool": "t",
           "reason": "r", "unix": 1.0, "pid": 1, "argv": [], "events": [],
           "threads": {}}
    assert flight.validate_dump(obj) == []
    mutate(obj)
    errs = flight.validate_dump(obj)
    assert any(needle in e for e in errs)
    assert errs == jax_validate(obj)


def test_signal_dump_off_main_thread_is_noop(fresh_flight, tmp_path):
    import signal

    fresh_flight.configure(str(tmp_path))
    before = signal.getsignal(signal.SIGTERM)
    th = threading.Thread(target=flight.install_signal_dump)
    th.start()
    th.join()
    assert signal.getsignal(signal.SIGTERM) is before


def test_no_dump_on_clean_exit(tmp_path, grouped, fresh_flight):
    d = tmp_path / "fl"
    rpt = tmp_path / "r.json"
    assert port_main(["--flight-dump-dir", str(d), "--run-report",
                      str(rpt), "simplex", "-i", grouped, "-o",
                      str(tmp_path / "o.bam"), "--device", "cpu"]) == 0
    assert not d.exists() or not os.listdir(d)
    assert "flight_dumps" not in json.load(open(rpt))


# ---------------------------------------------------------------------------
# atomic commit


def test_commit_discard_and_context_manager(tmp_path):
    p = str(tmp_path / "out.txt")
    f = atomic.open_output(p, "w")
    f.write("hello")
    assert not os.path.exists(p)
    f.close()
    assert open(p).read() == "hello"
    q = str(tmp_path / "gone.txt")
    f = atomic.open_output(q, "w")
    f.write("x")
    atomic.discard_output(f)
    with pytest.raises(RuntimeError):
        with atomic.open_output(q, "w") as g:
            g.write("partial")
            raise RuntimeError("die")
    assert os.listdir(tmp_path) == ["out.txt"]


def test_stale_temp_swept_live_kept(tmp_path):
    target = tmp_path / "o.bam"
    dead = tmp_path / ".o.bam.tmp.999999999.3"
    live = tmp_path / f".o.bam.tmp.{os.getpid()}.5"
    dead.write_bytes(b"x")
    live.write_bytes(b"y")
    atomic.cleanup_stale_temps(str(target))
    assert not dead.exists() and live.exists()


@pytest.mark.parametrize("how", ["flag", "env"])
def test_no_atomic_output_writes_final_name(tmp_path, grouped, monkeypatch,
                                            how):
    out = tmp_path / "o.bam"
    seen = []
    real = atomic.open_output

    def spy(path, mode="wb"):
        f = real(path, mode)
        seen.append((path, type(f).__name__, getattr(f, "name", None)))
        return f

    monkeypatch.setattr(atomic, "open_output", spy)
    argv = ["simplex", "-i", grouped, "-o", str(out), "--device", "cpu"]
    if how == "flag":
        argv = ["--no-atomic-output"] + argv
    else:
        monkeypatch.setenv("FGUMI_TPU_NO_ATOMIC", "1")
    assert port_main(argv) == 0
    assert out.exists()
    (path, kind, name), = [s for s in seen if s[0] == str(out)]
    assert kind != "AtomicOutputFile" and name == str(out)
    # the flag is per invocation: the next run commits atomically again
    monkeypatch.delenv("FGUMI_TPU_NO_ATOMIC", raising=False)
    seen.clear()
    assert port_main(argv[1:] if how == "flag" else argv) == 0
    assert [k for p, k, _ in seen if p == str(out)] == ["AtomicOutputFile"]


def test_bam_writer_exception_leaves_no_file(tmp_path):
    from fgumi_tpu_torch.io.bam import BamHeader, BamWriter

    out = tmp_path / "o.bam"
    with pytest.raises(RuntimeError):
        with BamWriter(str(out), BamHeader("@HD\tVN:1.6\n", [], [])) as w:
            w.write_record_bytes(b"\0" * 40)
            raise RuntimeError("die")
    assert os.listdir(tmp_path) == []


# ---------------------------------------------------------------------------
# logging


@pytest.mark.parametrize("argv_flags,env,level", [
    ([], None, logging.INFO),
    (["-v"], None, logging.DEBUG),
    ([], "warning", logging.WARNING),
    (["-v"], "error", logging.ERROR),
    (["--log-level", "debug"], "error", logging.DEBUG),
    ([], "nonsense", logging.INFO)])
def test_log_level_resolution(monkeypatch, argv_flags, env, level):
    from fgumi_tpu.observe.logs import resolve_level as jax_resolve
    from fgumi_tpu_torch.observe.logs import resolve_level

    if env is None:
        monkeypatch.delenv("FGUMI_TPU_LOG", raising=False)
    else:
        monkeypatch.setenv("FGUMI_TPU_LOG", env)
    explicit = argv_flags[1] if argv_flags[:1] == ["--log-level"] else None
    verbose = "-v" in argv_flags
    assert resolve_level(explicit, verbose) == level \
        == jax_resolve(explicit, verbose)
    # through main: the port logger takes the level
    assert port_main(argv_flags + ["trace-merge", "/nonexistent.json",
                                   "-o", "/nonexistent/out.json"]) == 2
    assert logging.getLogger(LOGGER).level == level


def test_log_format_carries_thread_and_elapsed():
    from fgumi_tpu_torch.observe.logs import ElapsedFormatter

    rec = logging.LogRecord(LOGGER, logging.INFO, __file__, 1, "hi", None,
                            None)
    rec.threadName = "fgumi-writer"
    line = ElapsedFormatter().format(rec)
    assert "[fgumi-writer +" in line and line.endswith("]: hi")


# ---------------------------------------------------------------------------
# run reports against the JAX package's


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_observe")
    grouped = str(d / "g.bam")
    r1, r2 = str(d / "r1.fq.gz"), str(d / "r2.fq.gz")
    assert port_main(["simulate", "grouped-reads", "-o", grouped,
                      "--num-families", "200", "--seed", "7"]) == 0
    assert port_main(["simulate", "fastq-reads", "-1", r1, "-2", r2,
                      "--num-families", "200", "--seed", "7"]) == 0
    return {"grouped": grouped, "r1": r1, "r2": r2}


@pytest.fixture
def grouped(inputs):
    return inputs["grouped"]


#: top-level report sections allowed to differ, with the reason
_SECTION_REASONS = {
    # the JAX package's router sends small batches on the CPU backend to
    # its host engine, so its report may carry no device dispatch where
    # the port's plain-PyTorch route counts one
    "device": "the JAX router's host route records no dispatch",
    # sections of components the port does not have (serving, tuner,
    # xprof, sentinel): absent on both sides for a standalone CPU run
    "profile": "deployment profiles are not ported",
    "xla_profile_dir": "JAX-only",
    "audit": "the silent-corruption sentinel is not ported",
}


def _reports(tmp_path, argv, port_extra):
    out = {}
    for name, main, extra in (("port", port_main, port_extra),
                              ("jax", jax_main, [])):
        rpt = str(tmp_path / f"{name}.json")
        trc = str(tmp_path / f"{name}.trace.json")
        rc = main(["--run-report", rpt, "--trace", trc] + [
            a.replace("OUT", str(tmp_path / f"{name}.bam")) for a in argv]
            + extra)
        assert rc == 0, name
        out[name] = json.load(open(rpt))
    return out["port"], out["jax"]


@pytest.mark.parametrize("command", ["simplex", "pipeline",
                                     "pipeline-device-filter",
                                     "pipeline-staged"])
def test_run_report_matches_jax(tmp_path, inputs, command):
    if command == "simplex":
        argv = ["simplex", "-i", inputs["grouped"], "-o", "OUT",
                "--threads", "2"]
    else:
        argv = ["pipeline", "-i", inputs["r1"], inputs["r2"], "-r", "8M+T",
                "+T", "-o", "OUT", "--sample", "s", "--library", "l"]
        if command == "pipeline-device-filter":
            argv.append("--device-filter")
        if command == "pipeline-staged":
            argv.append("--no-fuse")
    port, jax = _reports(tmp_path, argv, ["--device", "cpu"])
    for r in (port, jax):
        assert port_report.validate_report(r) == []
        assert jax_report.validate_report(r) == []
    assert port["tool"] == "fgumi-tpu-torch"
    assert port["schema_version"] == jax["schema_version"]
    assert port["command"] == jax["command"]
    assert port["exit_status"] == jax["exit_status"] == 0
    assert sorted(port["stages"]) == sorted(jax["stages"])
    assert port["records"] == jax["records"]
    diff = set(port) ^ set(jax)
    assert diff <= set(_SECTION_REASONS), diff
    if command.startswith("pipeline"):
        for name in ("extract", "sort", "group", "simplex"):
            assert port["stages"][name]["wall_s"] > 0
