"""Schema-versioned machine-readable run report.

One JSON file per command (``--run-report out.json`` /
``FGUMI_TPU_RUN_REPORT``), committed atomically at command exit, success
or failure, so a harness can answer "where did the time go" without
parsing logs: wall time, per-stage busy/blocked seconds, queue occupancy,
device dispatches and bytes, latency histograms, bytes in and out, records
processed and the exit status.

The schema is the JAX package's (:data:`SCHEMA_VERSION` 7, the same
sections) and is validated structurally by :func:`validate_report`. The
sections of components the port does not have (the router, breaker,
sentinel, mesh, ``--xla-profile`` and deployment profiles) are looked up
by the port's own module names and stay absent.
"""

import json
import os
import sys
import time

#: The JAX package's run-report schema, whose sections this module emits.
SCHEMA_VERSION = 7


def _device_stats():
    """The module-wide DeviceStats, or None when ops.kernel was never
    imported this run (importing it here would tax the host-only commands
    at exit). getattr-with-default also covers a partially initialised
    module: the heartbeat thread can see sys.modules mid-import while a
    fused-chain stage thread still runs the kernel module's body."""
    kern = sys.modules.get("fgumi_tpu_torch.ops.kernel")
    return getattr(kern, "DEVICE_STATS", None)

#: Structural schema: top-level field -> required type (None = any JSON).
#: Sections marked optional may be absent when the command produced no such
#: activity (e.g. no device dispatch, no threaded pipeline).
_REQUIRED = {
    "schema_version": int,
    "tool": str,
    "command": str,
    "argv": list,
    "started_unix": (int, float),
    "wall_s": (int, float),
    "exit_status": int,
    "pid": int,
    "metrics": dict,
}
_OPTIONAL = {
    "stages": dict,     # stage -> {"busy_s": f, "blocked_s": f}
    "queues": dict,     # {"in_mean","in_max","out_mean","out_max","samples"}
    "device": dict,     # DeviceStats.snapshot()
    "io": dict,         # {"bytes_read","bytes_written"}
    "records": dict,    # progress label -> count
    "faults": dict,     # fault point -> fired count
    "resource": dict,   # governor snapshot: pressure state, events
                        # (enospc/watermarks), budget rebalancing counters
                        # (utils/governor.py)
    "latency": dict,    # histogram name -> {count,sum,p50,p90,p99,max}
                        # (observe/metrics.py latency histograms; v2)
    "audit": dict,      # silent-corruption sentinel scoreboard + output
                        # verification verdicts (ops/sentinel.py; v4)
    "flight_dumps": list,  # black-box paths the flight recorder wrote
                           # during this run (observe/flight.py; v2)
    "trace_path": str,
    "hostname": str,
    "trace_context": dict,  # fleet trace id / parent span / job id this
                            # run executed under (observe/trace.py; v5)
    "latency_decomposition": dict,  # end-to-end attribution: hop/queue/
                                    # device/commit components + residual,
                                    # summing <= total_s (v5)
    "xla_profile_dir": str,  # --xla-profile capture directory (v5)
    "profile": dict,  # applied deployment profile: path, knobs applied/
                      # skipped_explicit, fingerprint mismatches, whether
                      # router priors were seeded (tune/profile.py; v7)
}

#: Components a ``latency_decomposition`` section may carry besides
#: ``total_s`` (any subset; what was measurable for this run).
_DECOMP_COMPONENTS = (
    "client_to_balancer_s", "balancer_to_admit_s", "client_to_admit_s",
    "queue_s", "coalesce_hold_s", "device_s", "commit_s",
    "host_complete_s",
)

#: Required numeric fields of one ``latency`` summary entry, in the order
#: the quantile-monotonicity check walks them.
_LATENCY_FIELDS = ("count", "sum", "p50", "p90", "p99", "max")

#: Required integer counters of the ``audit`` section (v4).
_AUDIT_COUNTERS = ("sampled", "clean", "divergent", "dropped")


def validate_report(obj) -> list:
    """Return a list of human-readable schema violations (empty == valid)."""
    errors = []
    if not isinstance(obj, dict):
        return ["report is not a JSON object"]
    for key, typ in _REQUIRED.items():
        if key not in obj:
            errors.append(f"missing required field {key!r}")
        elif not isinstance(obj[key], typ):
            errors.append(f"field {key!r} has type {type(obj[key]).__name__}")
    for key, typ in _OPTIONAL.items():
        if key in obj and not isinstance(obj[key], typ):
            errors.append(f"field {key!r} has type {type(obj[key]).__name__}")
    unknown = set(obj) - set(_REQUIRED) - set(_OPTIONAL)
    if unknown:
        errors.append(f"unknown fields: {sorted(unknown)}")
    if isinstance(obj.get("schema_version"), int) \
            and obj["schema_version"] != SCHEMA_VERSION:
        errors.append(f"schema_version {obj['schema_version']} != "
                      f"{SCHEMA_VERSION}")
    if isinstance(obj.get("metrics"), dict):
        for k in obj["metrics"]:
            if not isinstance(k, str) or not k:
                errors.append(f"metrics key {k!r} is not a dotted name")
    if isinstance(obj.get("latency"), dict):
        for name, summ in obj["latency"].items():
            if not isinstance(summ, dict):
                errors.append(f"latency entry {name!r} is not an object")
                continue
            missing = [f for f in _LATENCY_FIELDS if not isinstance(
                summ.get(f), (int, float)) or isinstance(summ.get(f), bool)]
            if missing:
                errors.append(f"latency entry {name!r} missing numeric "
                              f"fields {missing}")
                continue
            if not (summ["p50"] <= summ["p90"] <= summ["p99"]
                    <= summ["max"]):
                errors.append(f"latency entry {name!r} quantiles are not "
                              "ordered (p50 <= p90 <= p99 <= max)")
    if isinstance(obj.get("audit"), dict):
        audit = obj["audit"]
        for f in _AUDIT_COUNTERS:
            v = audit.get(f)
            if not isinstance(v, int) or isinstance(v, bool):
                errors.append(f"audit field {f!r} is not an integer")
        if audit.get("divergent", 0) and not audit.get("divergence"):
            errors.append("audit.divergent > 0 but no divergence records")
        if "divergence" in audit and not isinstance(audit["divergence"],
                                                    list):
            errors.append("audit.divergence is not a list")
        if "output" in audit and not isinstance(audit["output"], list):
            errors.append("audit.output is not a list")
        if "devices" in audit and not isinstance(audit["devices"], dict):
            errors.append("audit.devices is not an object")
    if isinstance(obj.get("trace_context"), dict):
        tc = obj["trace_context"]
        for f in ("trace_id", "parent_span_id", "job_id"):
            if f in tc and not isinstance(tc[f], str):
                errors.append(f"trace_context field {f!r} is not a string")
        unknown = set(tc) - {"trace_id", "parent_span_id", "job_id"}
        if unknown:
            errors.append(f"trace_context unknown fields {sorted(unknown)}")
    if isinstance(obj.get("latency_decomposition"), dict):
        dec = obj["latency_decomposition"]
        total = dec.get("total_s")
        if not isinstance(total, (int, float)) or isinstance(total, bool) \
                or total < 0:
            errors.append("latency_decomposition.total_s is not a "
                          "non-negative number")
            total = None
        comp_sum = 0.0
        for name, v in dec.items():
            if name == "total_s":
                continue
            if name not in _DECOMP_COMPONENTS:
                errors.append("latency_decomposition unknown component "
                              f"{name!r}")
            elif not isinstance(v, (int, float)) or isinstance(v, bool) \
                    or v < 0:
                errors.append(f"latency_decomposition component {name!r} "
                              "is not a non-negative number")
            else:
                comp_sum += v
        # the attribution invariant (small epsilon for per-field rounding)
        if total is not None and comp_sum > total + 0.005:
            errors.append("latency_decomposition components sum "
                          f"{comp_sum:.6f} past total_s {total:.6f}")
    return errors


def _stage_sections(metrics: dict):
    """Derive the stages/queues sections from the flat dotted metrics."""
    stages = {}
    for name, v in metrics.items():
        if name.startswith("pipeline.stage.") and name.count(".") >= 3:
            _, _, stage, field = name.split(".", 3)
            stages.setdefault(stage, {})[field] = v
    queues = None
    samples = metrics.get("pipeline.queue.samples")
    if samples:
        queues = {
            "samples": samples,
            "in_mean": round(metrics.get("pipeline.queue.in.sum", 0)
                             / samples, 3),
            "in_max": metrics.get("pipeline.queue.in.max", 0),
            "out_mean": round(metrics.get("pipeline.queue.out.sum", 0)
                              / samples, 3),
            "out_max": metrics.get("pipeline.queue.out.max", 0),
        }
    return stages, queues


def _latency_decomposition(latency: dict, wall_s: float, scope) -> dict:
    """The v5 end-to-end attribution: where did submit-to-bytes-published
    go? Hop legs come from the propagated wall-clock timestamps on the
    telemetry scope (client_sent / balancer_recv / balancer_sent /
    admitted / started — a fleet-routed job has all five, a direct submit
    three, a plain CLI run none); in-process components are histogram sums
    (coalesce hold, device wall, output commit); ``host_complete_s`` is
    the residual. ``total_s`` spans client send to now when the client
    stamped its send time, else the command wall.

    Components are CAPPED in order so they can never sum past ``total_s``
    — this section is an *attribution* of the total (shares), not a raw
    measurement (raw sums stay in ``latency``); host clock skew or
    overlapped device work therefore shrinks later components instead of
    fabricating > 100% accounting. None when nothing was measurable
    (no hops and no timed component)."""
    hops = dict(scope.hops) if scope is not None and scope.hops else {}

    def hist_sum(name):
        summ = latency.get(name)
        return float(summ["sum"]) if isinstance(summ, dict) else 0.0

    cs = hops.get("client_sent_unix")
    br = hops.get("balancer_recv_unix")
    bs = hops.get("balancer_sent_unix")
    ad = hops.get("admitted_unix")
    st = hops.get("started_unix")
    measured = []
    if cs and br:
        measured.append(("client_to_balancer_s", br - cs))
    if bs and ad:
        measured.append(("balancer_to_admit_s", ad - bs))
    elif cs and ad and not br:
        measured.append(("client_to_admit_s", ad - cs))
    if ad and st:
        measured.append(("queue_s", st - ad))
    measured.append(("coalesce_hold_s",
                     hist_sum("device.coalesce.window_wait_s")))
    measured.append(("device_s", hist_sum("device.dispatch.wall_s")))
    measured.append(("commit_s", hist_sum("io.commit_s")))
    if not hops and not any(v > 0 for _, v in measured):
        return None
    total = (time.time() - cs) if cs else float(wall_s)
    if total <= 0:  # client clock ahead of ours: fall back to our wall
        total = max(float(wall_s), 0.0)
    out = {"total_s": round(total, 6)}
    spent = 0.0
    for name, v in measured:
        v = min(max(float(v), 0.0), max(total - spent, 0.0))
        if v <= 0 and name in ("coalesce_hold_s", "device_s", "commit_s"):
            continue  # component never armed this run: omit, not zero
        out[name] = round(v, 6)
        spent += v
    out["host_complete_s"] = round(max(total - spent, 0.0), 6)
    return out


def build_report(command: str, argv, started_unix: float, wall_s: float,
                 exit_status: int, trace_path: str = None) -> dict:
    """Assemble the report dict from the global registries.

    Reads :data:`METRICS`, the module-wide
    ``DEVICE_STATS`` (when the kernel module is loaded), and the fault
    registry; pure read — folding raw counters into METRICS is each
    component's job."""
    from ..utils import faults
    from .metrics import METRICS

    metrics = METRICS.snapshot()
    from ..cli import PROGRAM_ID

    report = {
        "schema_version": SCHEMA_VERSION,
        "tool": PROGRAM_ID,
        "command": command,
        "argv": list(argv),
        "started_unix": round(started_unix, 3),
        "wall_s": round(wall_s, 4),
        "exit_status": int(exit_status),
        "pid": os.getpid(),
        "metrics": metrics,
    }
    try:
        import socket

        report["hostname"] = socket.gethostname()
    except OSError:
        pass
    stages, queues = _stage_sections(metrics)
    if stages:
        report["stages"] = stages
    if queues:
        report["queues"] = queues
    stats = _device_stats()
    dev = stats.snapshot() if stats is not None else {}
    # a device mesh (none in the port yet) names its (dp, sp, devices)
    m_dp = metrics.get("device.mesh.dp")
    if m_dp:
        mesh_sec = {"dp": m_dp, "sp": metrics.get("device.mesh.sp", 1),
                    "devices": metrics.get("device.mesh.devices", m_dp)}
        pm = sys.modules.get("fgumi_tpu_torch.parallel.mesh")
        snap = getattr(pm, "LAST_MESH_SNAPSHOT", None) if pm else None
        if snap and snap.get("dp") == m_dp:
            mesh_sec["platform"] = snap.get("platform")
        dev["mesh"] = mesh_sec
    # the offload router's state (none in the port yet)
    router = sys.modules.get("fgumi_tpu_torch.ops.router")
    if router is not None and (dev.get("route_device")
                               or dev.get("route_host")
                               or router.ROUTER.prior_source != "cold"):
        dev["routing"] = router.ROUTER.snapshot()
    # the device circuit breaker (none in the port yet)
    breaker = sys.modules.get("fgumi_tpu_torch.ops.breaker")
    if breaker is not None:
        bsnap = breaker.BREAKER.snapshot()
        if bsnap["transitions"] or bsnap["state"] != "closed" \
                or bsnap["deadline_overruns"]:
            dev["breaker"] = bsnap
    if dev.get("dispatches") or dev.get("route_host") \
            or dev.get("breaker") or dev.get("mesh") or dev.get("routing"):
        report["device"] = dev
    io_sec = {k.split(".", 1)[1]: v for k, v in metrics.items()
              if k.startswith("io.")}
    if io_sec:
        report["io"] = io_sec
    records = {k.split(".", 1)[1]: v for k, v in metrics.items()
               if k.startswith("records.")}
    if records:
        report["records"] = records
    fired = {p: n for p, n in faults.snapshot().items() if n}
    if fired:
        report["faults"] = fired
    # resource governance: anything beyond a quiet run (a pressure
    # transition, an ENOSPC event, budget rebalancing) rides along, so a
    # degraded or resource-failed run's report explains itself
    gov = sys.modules.get("fgumi_tpu_torch.utils.governor")
    if gov is not None and gov.GOVERNOR.has_activity():
        report["resource"] = gov.GOVERNOR.snapshot()
    # silent-corruption sentinel (schema v4): anything beyond a quiet run
    # — sampled shadow audits, dropped samples, divergences, output-audit
    # verdicts — rides along, so an SDC-touched run's artifact names the
    # corrupt dispatch and which output to distrust (ops/sentinel.py)
    sentinel = sys.modules.get("fgumi_tpu_torch.ops.sentinel")
    if sentinel is not None and sentinel.SENTINEL.has_activity():
        report["audit"] = sentinel.SENTINEL.snapshot()
    # latency histogram summaries (schema v2): every instrumented hot path
    # that observed at least one sample this run — the "how slow was the
    # tail" counterpart of the flat counters above
    latency = METRICS.summaries()
    if latency:
        report["latency"] = latency
    # fleet trace context + end-to-end attribution (schema v5): a daemon
    # job adopted its job id / trace context / hop timestamps onto the
    # telemetry scope at entry (observe/scope.py adopt_job_context); the
    # report is where they become a queryable artifact
    from .scope import current_scope

    scope = current_scope()
    if scope is not None and (scope.trace_id or scope.job_id):
        tc = {}
        if scope.trace_id:
            tc["trace_id"] = scope.trace_id
        if scope.parent_span_id:
            tc["parent_span_id"] = scope.parent_span_id
        if scope.job_id:
            tc["job_id"] = scope.job_id
        report["trace_context"] = tc
    decomposition = _latency_decomposition(latency, wall_s, scope)
    if decomposition:
        report["latency_decomposition"] = decomposition
    # black boxes written during this run (flight recorder): the report is
    # the breadcrumb from "this run degraded" to the full evidence file
    flight = sys.modules.get("fgumi_tpu_torch.observe.flight")
    if flight is not None:
        dumps = flight.FLIGHT.dump_paths()
        if dumps:
            report["flight_dumps"] = dumps
    if trace_path:
        report["trace_path"] = trace_path
    # one-shot XLA device profile (--xla-profile): the capture directory
    # rides along so "device time regressed" links straight to the
    # op-level xprof timeline (observe/xprof.py; v5)
    xprof = sys.modules.get("fgumi_tpu_torch.observe.xprof")
    if xprof is not None:
        captured = xprof.captured_dir()
        if captured:
            report["xla_profile_dir"] = captured
    # applied deployment profile (tune/profile.py; v7): which knobs the
    # profile filled vs explicit overrides, fingerprint mismatches, and
    # whether router priors were seeded — pairs with
    # device.routing.prior_source to make first-batch routing attributable
    tune_prof = sys.modules.get("fgumi_tpu_torch.tune.profile")
    if tune_prof is not None:
        applied = tune_prof.applied_info()
        if applied:
            report["profile"] = {
                "path": applied["path"],
                "knobs_applied": list(applied["applied"]),
                "knobs_skipped_explicit":
                    list(applied["skipped_explicit"]),
                "fingerprint_mismatch":
                    list(applied["fingerprint_mismatch"]),
                "seeded_router": bool(applied["seeded_router"]),
                "seeded_choosers": list(applied["seeded_choosers"]),
            }
    return report


def write_report(path: str, report: dict):
    """Commit the report atomically (crash-safe like every other output)."""
    from ..utils.atomic import discard_output, open_output

    out = open_output(path, "w")
    try:
        json.dump(report, out, indent=1, sort_keys=False)
        out.write("\n")
    except BaseException:
        discard_output(out)
        raise
    out.close()


def emit(path: str, command: str, argv, started_unix: float, wall_s: float,
         exit_status: int, trace_path: str = None) -> dict:
    """Build + write in one step; never raises out of an exiting command
    (a telemetry failure must not turn a successful run into a failed one —
    it logs and returns None instead)."""
    import logging

    try:
        report = build_report(command, argv, started_unix, wall_s,
                              exit_status, trace_path)
        write_report(path, report)
        return report
    except Exception:
        logging.getLogger("fgumi_tpu_torch").exception(
            "failed to write run report %s", path)
        return None


def fold_device_stats():
    """Fold the module-wide DeviceStats into METRICS under ``device.*``.

    Called once at command exit (before the report is built) so the flat
    metrics view carries the same numbers as the ``device`` section."""
    from .metrics import METRICS

    stats = _device_stats()
    snap = stats.snapshot() if stats is not None else {}
    if snap.get("dispatches"):
        METRICS.update(snap, prefix="device")
