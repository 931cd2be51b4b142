"""Live serve introspection: the ``stats`` op payload, the Prometheus
text-format exporter, and the optional ``--metrics-port`` HTTP listener.

One snapshot builder (:func:`service_stats`) feeds both surfaces, so the
``stats`` protocol op and a ``/metrics`` scrape can never disagree about
the daemon's live state. The registries read here are the PROCESS-GLOBAL
ones: connection and worker threads run outside any job's telemetry scope,
every finished job publishes its counters to the globals at exit
(``observe.scope.publish_to_global``), and latency histograms *merge* on
publish — so counters/gauges are the last finished job's view while
histograms and the structural snapshots (scheduler depth, job counts,
breaker, governor, DeviceStats) are daemon-lifetime.

The HTTP listener binds loopback only, serves two endpoints and nothing
else:

- ``GET /metrics`` — Prometheus text format 0.0.4: every counter/gauge as
  ``fgumi_tpu_<dotted_name_with_underscores>``, every latency histogram as
  a cumulative ``_bucket{le=...}`` series + ``_sum``/``_count``, plus
  daemon gauges (job states, queue depth, breaker state, uptime).
- ``GET /healthz`` — JSON liveness backed by the health monitor and the
  device circuit breaker: HTTP 200 while the breaker is not open, 503
  once it trips (a load balancer can eject the replica).
"""

import json
import logging
import os
import re
import sys
import threading
import time

log = logging.getLogger("fgumi_tpu_torch")

#: stats payload schema: the JAX package's version 6. ``fleet`` is
#: journal-lease takeover accounting (None outside ``serve
#: --journal-dir``); ``router`` the offload cost model, ``routing_state``
#: the daemon's routing snapshot (path, loaded, saved), ``audit`` the
#: result sentinel's scoreboard (the fleet balancer holds a backend whose
#: ``divergent`` is above 0) and ``coalesce`` the cross-job coalescer's
#: (each None while its subsystem is idle or not loaded)
STATS_SCHEMA_VERSION = 6

_NAME_RE = re.compile(r"[^a-zA-Z0-9_]")


def _prom_name(dotted: str) -> str:
    return "fgumi_tpu_" + _NAME_RE.sub("_", dotted)


# ---------------------------------------------------------------------------
# the one snapshot builder


def service_stats(service) -> dict:
    """The ``stats`` op payload for a :class:`~.daemon.JobService`.

    Always includes every key; sections whose subsystem was never touched
    in this process are ``None`` (e.g. ``device`` before the first kernel
    import), so clients can rely on the shape."""
    from ..observe.flight import (audit_snapshot, breaker_snapshot,
                                  coalesce_snapshot, device_memory_snapshot,
                                  governor_snapshot, live_device_stats,
                                  router_snapshot)
    from ..observe.metrics import METRICS

    stats = live_device_stats()
    sched = service.scheduler
    return {
        "schema_version": STATS_SCHEMA_VERSION,
        "pid": os.getpid(),
        "uptime_s": round(time.time() - service.started_unix, 1),
        "jobs": service.registry.counts(),
        "scheduler": sched.depth(),
        "max_per_client": sched.max_per_client,
        "quota": sched.client_quota_state(),
        "journal": _journal_section(service),
        "fleet": _fleet_section(service),
        "metrics": METRICS.snapshot(),
        "latency": METRICS.summaries(),
        "device": stats.snapshot() if stats is not None else None,
        "device_memory": device_memory_snapshot(),
        "breaker": breaker_snapshot(),
        "governor": governor_snapshot(),
        "monitor": _monitor_section(service),
        "router": router_snapshot(),
        "routing_state": getattr(service, "routing_state", None),
        "audit": audit_snapshot(),
        "coalesce": coalesce_snapshot(),
    }


def _journal_section(service):
    if not service.journal_path:
        return None
    return {"path": service.journal_path,
            **getattr(service, "journal_stats", {})}


def _fleet_section(service):
    """Journal-lease fleet accounting (``serve --journal-dir``): fleet id,
    lease state, takeover history, and the live load figure the balancer
    routes by. None on a standalone daemon."""
    stats = getattr(service, "fleet_stats", None)
    if stats is None:
        return None
    return {**stats, "active_jobs": service.scheduler.active()}


def _monitor_section(service):
    """The health monitor's period and canaries run, and the launches of
    the canary's kernel K7 in this process (0 before it loads)."""
    monitor = getattr(service, "_monitor", None)
    if monitor is None:
        return None
    canary = sys.modules.get("fgumi_tpu_torch.ops.canary")
    return {"period_s": monitor.period_s, "canaries": monitor.canaries,
            "canary_launches": canary.CANARY_LAUNCHES if canary else 0}


# ---------------------------------------------------------------------------
# Prometheus text format


def render_prometheus(service) -> str:
    """The ``/metrics`` body, derived from the same :func:`service_stats`
    snapshot the ``stats`` op returns."""
    from ..observe.metrics import METRICS

    stats = service_stats(service)
    lines = []
    # duplicate guard, keyed on MUNGED names: distinct dotted names can
    # collide after underscore substitution (device.route_device from the
    # DeviceStats snapshot vs the device.route.device registry counter)
    emitted = set()

    def gauge(dotted, value, help_text=None, labels=""):
        name = _prom_name(dotted)
        emitted.add(name)
        if help_text:
            lines.append(f"# HELP {name} {help_text}")
            lines.append(f"# TYPE {name} gauge")
        lines.append(f"{name}{labels} {_num(value)}")

    # daemon structural gauges (always present)
    gauge("serve.uptime_s", stats["uptime_s"], "daemon uptime in seconds")
    jobs_name = _prom_name("serve.jobs")
    lines.append(f"# HELP {jobs_name} jobs by lifecycle state")
    lines.append(f"# TYPE {jobs_name} gauge")
    for state, n in sorted(stats["jobs"].items()):
        lines.append(f'{jobs_name}{{state="{state}"}} {n}')
    sched = stats["scheduler"]
    gauge("serve.queued", sched["queued"])
    gauge("serve.running", sched["running"])
    gauge("serve.workers", sched["workers"])
    gauge("serve.queue_limit", sched["queue_limit"])
    gauge("serve.draining", int(bool(sched["draining"])))
    if stats["breaker"] is not None:
        gauge("device.breaker.open",
              int(stats["breaker"]["state"] == "open"),
              "1 while the device circuit breaker is open")
    if stats["governor"] is not None:
        state = stats["governor"].get("state", "ok")
        gauge("resource.pressure",
              {"ok": 0, "soft": 1, "hard": 2}.get(state, 0),
              "resource pressure state (0 ok / 1 soft / 2 hard)")
    if stats["device"] is not None:
        for key, v in stats["device"].items():
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                gauge(f"device.{key}", v)
    if stats["device_memory"] is not None:
        # live accelerator memory (absent on CPU backends)
        gauge("device.memory.bytes_in_use",
              stats["device_memory"]["bytes_in_use"],
              "live accelerator bytes in use, summed over local devices")
        gauge("device.memory.peak_bytes",
              stats["device_memory"]["peak_bytes"])
    if stats["audit"] is not None:
        # the silent-corruption scoreboard a fleet balancer holds on:
        # daemon-lifetime counters straight from the sentinel
        for key in ("sampled", "clean", "divergent", "dropped"):
            gauge(f"device.audit.{key}", stats["audit"].get(key, 0),
                  "shadow-audit scoreboard (ops/sentinel.py)"
                  if key == "sampled" else None)
    if stats["coalesce"] is not None:
        # the cross-job coalescer's daemon-lifetime counters
        for key, v in stats["coalesce"].items():
            if isinstance(v, bool):
                gauge(f"device.coalesce.{key}", int(v))
            elif isinstance(v, (int, float)):
                gauge(f"device.coalesce.{key}", v,
                      "dispatch-coalescer scoreboard (ops/coalesce.py)"
                      if key == "merged_batches" else None)

    # flat counters/gauges from the SAME snapshot the stats op returns
    # (last finished job + anything written outside job scopes). Names the
    # structural loops above already rendered are skipped: a finished job
    # folds DeviceStats into the registry under the same device.* names,
    # and Prometheus rejects a scrape with duplicate series
    for dotted, v in stats["metrics"].items():
        if isinstance(v, bool) or not isinstance(v, (int, float)):
            continue
        name = _prom_name(dotted)
        if name in emitted:
            continue
        emitted.add(name)
        lines.append(f"{name} {_num(v)}")

    # latency histograms: cumulative le-buckets + sum + count. The one
    # read outside the service_stats snapshot — summaries carry no bucket
    # series, so the Histogram copies must come from the registry
    for dotted, hist in METRICS.histograms().items():
        name = _prom_name(dotted)
        lines.append(f"# TYPE {name} histogram")
        for edge, cum in hist.buckets():
            lines.append(f'{name}_bucket{{le="{edge:.9g}"}} {cum}')
        lines.append(f'{name}_bucket{{le="+Inf"}} {hist.count}')
        lines.append(f"{name}_sum {_num(round(hist.total, 6))}")
        lines.append(f"{name}_count {hist.count}")
    return "\n".join(lines) + "\n"


def _num(v):
    if isinstance(v, float) and v.is_integer():
        return str(int(v))
    return repr(v) if isinstance(v, float) else str(v)


def render_healthz(service) -> tuple:
    """``(http_status, body_dict)`` for ``/healthz``: 200 while the device
    breaker is not open (or was never loaded), 503 once it trips."""
    from ..observe.flight import breaker_snapshot

    breaker = breaker_snapshot()
    state = breaker["state"] if breaker else "closed"
    healthy = state != "open"
    body = {
        "status": "ok" if healthy else "degraded",
        "breaker": state,
        "uptime_s": round(time.time() - service.started_unix, 1),
        "jobs": service.registry.counts(),
        "draining": service.scheduler.draining,
    }
    monitor = _monitor_section(service)
    if monitor is not None:
        body["monitor"] = monitor
    return (200 if healthy else 503), body


# ---------------------------------------------------------------------------
# HTTP listener


class IntrospectionServer:
    """Loopback HTTP listener for ``/metrics`` + ``/healthz``.

    ``port=0`` binds an ephemeral port (tests); :attr:`port` reports the
    bound one. Runs on one daemon thread; ``stop()`` joins it.

    The renderers are pluggable so the fleet balancer can reuse the
    listener with its own surfaces (``serve.balancer``): ``metrics_fn``
    returns the ``/metrics`` text body, ``healthz_fn`` returns
    ``(http_status, body_dict)``. Defaults are the daemon renderers
    bound to ``service``."""

    def __init__(self, service, port: int, host: str = "127.0.0.1",
                 metrics_fn=None, healthz_fn=None):
        self.service = service
        self._metrics_fn = metrics_fn or \
            (lambda: render_prometheus(service))
        self._healthz_fn = healthz_fn or (lambda: render_healthz(service))
        self.host = host
        self._requested_port = int(port)
        self._httpd = None
        self._thread = None

    @property
    def port(self):
        return self._httpd.server_address[1] if self._httpd else \
            self._requested_port

    def bind(self):
        """Bind the HTTP listener without serving yet. A busy port
        raises OSError here, so the daemon can fail fast before the
        device warm-up (same discipline as the unix socket)."""
        if self._httpd is None:
            self._httpd = self._build_server()

    def start(self):
        self.bind()
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="fgumi-serve-metrics",
                                        daemon=True)
        self._thread.start()
        log.info("serve: metrics on http://%s:%d/metrics (healthz on "
                 "/healthz)", self.host, self.port)

    def _build_server(self):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        metrics_fn, healthz_fn = self._metrics_fn, self._healthz_fn

        class _Handler(BaseHTTPRequestHandler):
            # the metrics port is an operator surface, not a log source
            def log_message(self, *args):
                pass

            def do_GET(self):
                try:
                    if self.path.split("?", 1)[0] == "/metrics":
                        body = metrics_fn().encode()
                        ctype = "text/plain; version=0.0.4; charset=utf-8"
                        status = 200
                    elif self.path.split("?", 1)[0] == "/healthz":
                        status, obj = healthz_fn()
                        body = (json.dumps(obj, sort_keys=True) + "\n") \
                            .encode()
                        ctype = "application/json"
                    else:
                        status, body = 404, b"not found\n"
                        ctype = "text/plain"
                except Exception as e:  # noqa: BLE001 - scrape != crash
                    status, ctype = 500, "text/plain"
                    body = f"snapshot failed: {e}\n".encode()
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        httpd = ThreadingHTTPServer((self.host, self._requested_port),
                                    _Handler)
        httpd.daemon_threads = True
        return httpd

    def stop(self):
        if self._httpd is not None:
            if self._thread is not None:
                # shutdown() handshakes with a RUNNING serve_forever and
                # deadlocks otherwise (bound-but-never-started teardown)
                self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
