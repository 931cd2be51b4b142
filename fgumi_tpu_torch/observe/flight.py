"""Always-on flight recorder: a bounded ring of recent events plus a
black-box dump when something goes wrong.

A process that dies, or is killed, takes its state with it. The ring keeps
the last few hundred interesting events (every WARNING+ log line, resolved
device dispatches, span ends while tracing), one deque append each, and
:meth:`FlightRecorder.dump` freezes everything (the ring, every thread's
stack, metrics and latency summaries, the ``DeviceStats`` timeline, the
governor's snapshot) into one schema'd JSON file.

Dump triggers (each at most once per reason per process, at most
:data:`MAX_DUMPS` in all):

- an unhandled exception escaping a command (cli.py);
- ``ResourceExhausted``, the governor's clean failure on a hard limit;
- ``OutputIntegrityError``, a refuted ``--audit-output`` pass;
- a fatal signal (SIGTERM, via :func:`install_signal_dump`).

Dumps are written only when a destination is configured
(``--flight-dump-dir`` / ``FGUMI_TPU_FLIGHT``); the ring records either
way, so a destination changes where the evidence lands, not what is
collected. A clean exit writes nothing.
"""

import json
import logging
import os
import sys
import threading
import time
import traceback
from collections import deque

log = logging.getLogger("fgumi_tpu_torch")

SCHEMA_VERSION = 1

#: Ring capacity (events). Small on purpose: the ring answers "what were
#: the last few hundred interesting things", not "everything that happened"
#: — that is the trace's job. Override with FGUMI_TPU_FLIGHT_EVENTS.
DEFAULT_EVENTS = 512

#: Hard cap on black boxes per process: a wedge that re-fires per batch
#: must not turn the dump dir into a disk-pressure incident of its own.
MAX_DUMPS = 8

#: How many trailing DeviceStats timeline entries ride in a dump.
TIMELINE_TAIL = 16


# ---------------------------------------------------------------------------
# snapshots of lazily imported singletons; a module the port does not have
# (the breaker, router, sentinel, coalescer, mesh) is never in sys.modules,
# and its section reads None


def live_device_stats():
    """The process-global DeviceStats, or None before ops.kernel loads."""
    kern = sys.modules.get("fgumi_tpu_torch.ops.kernel")
    return getattr(kern, "DEVICE_STATS", None)


def breaker_snapshot():
    breaker = sys.modules.get("fgumi_tpu_torch.ops.breaker")
    return breaker.BREAKER.snapshot() if breaker is not None else None


def governor_snapshot():
    gov = sys.modules.get("fgumi_tpu_torch.utils.governor")
    return gov.GOVERNOR.snapshot() if gov is not None else None


def router_snapshot():
    router = sys.modules.get("fgumi_tpu_torch.ops.router")
    return router.ROUTER.snapshot() if router is not None else None


def audit_snapshot():
    """The silent-corruption sentinel's scoreboard (ops/sentinel.py), or
    None before it loads / while it has seen nothing."""
    sentinel = sys.modules.get("fgumi_tpu_torch.ops.sentinel")
    if sentinel is None or not sentinel.SENTINEL.has_activity():
        return None
    return sentinel.SENTINEL.snapshot()


def coalesce_snapshot():
    """The cross-job dispatch coalescer's scoreboard (ops/coalesce.py),
    or None before it loads / while it has merged nothing and is not
    armed."""
    coal = sys.modules.get("fgumi_tpu_torch.ops.coalesce")
    if coal is None:
        return None
    if not (coal.COALESCER.has_activity() or coal.COALESCER.armed()):
        return None
    return coal.COALESCER.snapshot()


def mesh_snapshot():
    """The active production mesh's {dp, sp, devices, platform}, or None
    when no mesh was built this process (single-device / host-only)."""
    pm = sys.modules.get("fgumi_tpu_torch.parallel.mesh")
    return getattr(pm, "LAST_MESH_SNAPSHOT", None) if pm is not None \
        else None


def device_memory_snapshot():
    """Live device memory of the current CUDA device: ``{bytes_in_use,
    peak_bytes}`` from ``torch.cuda.memory_allocated`` and
    ``max_memory_allocated``.

    None on ``--device cpu``, and whenever CUDA is not initialised yet or
    the kernel module is not loaded, so a telemetry path never initialises
    CUDA itself."""
    if sys.modules.get("fgumi_tpu_torch.ops.kernel") is None:
        return None
    torch_mod = sys.modules.get("torch")
    if torch_mod is None:
        return None
    try:
        if not torch_mod.cuda.is_initialized():
            return None
        return {"bytes_in_use": int(torch_mod.cuda.memory_allocated()),
                "peak_bytes": int(torch_mod.cuda.max_memory_allocated())}
    except Exception:  # noqa: BLE001 - telemetry never raises
        return None


def _ring_capacity() -> int:
    try:
        n = int(os.environ.get("FGUMI_TPU_FLIGHT_EVENTS",
                               str(DEFAULT_EVENTS)))
    except ValueError:
        n = DEFAULT_EVENTS
    return max(n, 16)


class FlightRecorder:
    """The process-wide ring + dump machinery (singleton :data:`FLIGHT`)."""

    def __init__(self, capacity: int = None):
        self._lock = threading.Lock()
        self._ring = deque(maxlen=capacity or _ring_capacity())
        self._t0 = time.monotonic()
        self._dump_dir = None          # explicit --flight-dump-dir override
        self._dumped_reasons = set()   # first dump per reason wins
        self._dump_paths = []
        self.events_noted = 0

    # ------------------------------------------------------------ recording

    def note(self, kind: str, **attrs) -> None:
        """Append one event to the ring. Always on, deliberately cheap:
        one dict build + one bounded deque append under a short lock."""
        ev = {"t": round(time.monotonic() - self._t0, 4), "kind": kind,
              "thread": threading.current_thread().name}
        if attrs:
            ev.update(attrs)
        with self._lock:
            self._ring.append(ev)
            self.events_noted += 1

    def events(self) -> list:
        with self._lock:
            return list(self._ring)

    # ---------------------------------------------------------- destination

    def configure(self, dump_dir) -> None:
        """Set (or clear, with None) the explicit dump destination; the
        ``FGUMI_TPU_FLIGHT`` environment is the fallback."""
        self._dump_dir = dump_dir

    def dump_dir(self):
        return self._dump_dir or os.environ.get("FGUMI_TPU_FLIGHT") or None

    def dump_paths(self) -> list:
        """Paths of every black box written so far (run-report carriage)."""
        with self._lock:
            return list(self._dump_paths)

    def reset(self) -> None:
        """Test hook: clear the ring and the per-reason dump dedupe."""
        with self._lock:
            self._ring.clear()
            self._dumped_reasons.clear()
            self._dump_paths.clear()
            self.events_noted = 0
        self._dump_dir = None

    # ------------------------------------------------------------- dumping

    def dump(self, reason: str, exc: BaseException = None, **attrs):
        """Write one black box; returns its path, or None when no dump dir
        is configured / this reason already dumped / the cap is reached.

        Never raises: a failing dump must not worsen the failure it is
        documenting. Must NOT be called while holding a lock the snapshot
        sections below also take (breaker/governor/DeviceStats locks)."""
        d = self.dump_dir()
        if not d:
            return None
        with self._lock:
            if reason in self._dumped_reasons \
                    or len(self._dump_paths) >= MAX_DUMPS:
                return None
            self._dumped_reasons.add(reason)
            seq = len(self._dump_paths)
        try:
            obj = self._build(reason, exc, attrs)
            safe = "".join(c if c.isalnum() or c in "-_" else "-"
                           for c in reason)
            path = os.path.join(d, f"flight-{os.getpid()}-{seq}-{safe}.json")
            os.makedirs(d, exist_ok=True)
            from ..utils.atomic import discard_output, open_output

            out = open_output(path, "w")
            try:
                json.dump(obj, out, indent=1, default=str)
                out.write("\n")
            except BaseException:
                discard_output(out)
                raise
            out.close()
        except Exception as e:  # noqa: BLE001 - evidence loss != new crash
            log.error("flight recorder: could not write black box (%s: %s)",
                      type(e).__name__, e)
            # a FAILED write must not consume the reason: the classic case
            # is resource-exhausted firing while the dump dir's filesystem
            # is the full one — a retrigger after space frees up (temps
            # swept) should still get its black box
            with self._lock:
                self._dumped_reasons.discard(reason)
            return None
        with self._lock:
            self._dump_paths.append(path)
        log.warning("flight recorder: black box -> %s (%s)", path, reason)
        return path

    def _build(self, reason: str, exc, attrs) -> dict:
        obj = {
            "schema_version": SCHEMA_VERSION,
            "tool": "fgumi-tpu-torch",
            "reason": reason,
            "unix": round(time.time(), 3),
            "pid": os.getpid(),
            "argv": sys.argv,
            "events": self.events(),
            "threads": self._thread_stacks(),
        }
        if attrs:
            obj["attrs"] = dict(attrs)
        # a dump raised inside a job names the job and its trace
        try:
            from .scope import current_scope

            scope = current_scope()
            if scope is not None:
                for key in ("job_id", "trace_id"):
                    val = getattr(scope, key, None)
                    if val:
                        obj[key] = val
        except Exception:  # noqa: BLE001 - identity is optional
            pass
        if exc is not None:
            obj["exception"] = {
                "type": type(exc).__name__,
                "message": str(exc),
                "traceback": traceback.format_exception(
                    type(exc), exc, exc.__traceback__),
            }
        # every section below is best-effort: a half-initialized module
        # must not take the black box down with it
        for name, fn in (("metrics", self._metrics_section),
                         ("device", self._device_section),
                         ("device_memory", device_memory_snapshot),
                         ("mesh", mesh_snapshot),
                         ("breaker", breaker_snapshot),
                         ("governor", governor_snapshot),
                         ("audit", audit_snapshot)):
            try:
                obj[name] = fn()
            except Exception as e:  # noqa: BLE001 - keep the rest
                obj[name] = {"error": f"{type(e).__name__}: {e}"}
        return obj

    @staticmethod
    def _thread_stacks() -> dict:
        """Current stack of every live thread, newest frame last."""
        names = {t.ident: t.name for t in threading.enumerate()}
        out = {}
        for tid, frame in sys._current_frames().items():
            label = f"{names.get(tid, 'unknown')}-{tid}"
            out[label] = [ln.rstrip("\n") for ln in
                          traceback.format_stack(frame)][-40:]
        return out

    @staticmethod
    def _metrics_section() -> dict:
        from .metrics import METRICS

        return {"values": METRICS.snapshot(), "latency": METRICS.summaries()}

    @staticmethod
    def _device_section():
        stats = live_device_stats()
        if stats is None:
            return None
        tail = stats.timeline_snapshot()  # entries carry their true slot
        tail = tail[-TIMELINE_TAIL:]
        # a dispatch with no t_fetched stamp at dump time is still (or was,
        # when abandoned) in flight: the wedge suspect list
        wedged = [t for t in tail if "t_fetched" not in t]
        out = {"snapshot": stats.snapshot(), "timeline_tail": tail,
               "wedged_dispatches": wedged}
        routing = router_snapshot()
        if routing is not None:
            out["routing"] = routing
        return out



#: Process-wide singleton. Flight evidence is a per-process fact: the ring
#: spans every scope, so a dump shows the neighbouring activity too.
FLIGHT = FlightRecorder()


def install_signal_dump() -> None:
    """Dump a black box on SIGTERM before dying with the default action.

    Installed by the CLI (the outermost ``main``) only when a dump dir is
    configured. A no-op off the main thread (in-process callers, the fused
    pipeline's stage threads): ``signal.signal`` refuses there."""
    if not FLIGHT.dump_dir():
        return
    import signal

    def _on_fatal(signum, frame):
        # the handler runs ON the interrupted thread, which may hold one
        # of the (non-reentrant) locks the dump's snapshot sections take
        # (metrics registry, the ring itself, DeviceStats) — dumping
        # inline could deadlock and turn SIGTERM into a hang. A helper
        # thread + bounded join keeps termination guaranteed: evidence is
        # best-effort, dying is not. The thread runs under a COPY of the
        # interrupted thread's context so the telemetry-scope proxies
        # (METRICS/DEVICE_STATS) resolve to the running command's
        # registries, not the process-global fallbacks.
        import contextvars

        ctx = contextvars.copy_context()
        t = threading.Thread(
            target=ctx.run, args=(FLIGHT.dump, "fatal-signal"),
            kwargs={"signal": signal.Signals(signum).name},
            name="fgumi-flight-dump", daemon=True)
        t.start()
        t.join(timeout=10)
        signal.signal(signum, signal.SIG_DFL)
        os.kill(os.getpid(), signum)

    try:
        signal.signal(signal.SIGTERM, _on_fatal)
    except (ValueError, OSError):
        pass


# ---------------------------------------------------------------------------
# dump validation

_REQUIRED = {
    "schema_version": int,
    "tool": str,
    "reason": str,
    "unix": (int, float),
    "pid": int,
    "argv": list,
    "events": list,
    "threads": dict,
}


def validate_dump(obj) -> list:
    """Structural validation of a black box; returns human-readable
    violations (empty == valid), mirroring report.validate_report."""
    errors = []
    if not isinstance(obj, dict):
        return ["flight dump is not a JSON object"]
    for key, typ in _REQUIRED.items():
        if key not in obj:
            errors.append(f"missing required field {key!r}")
        elif not isinstance(obj[key], typ):
            errors.append(f"field {key!r} has type {type(obj[key]).__name__}")
    if isinstance(obj.get("schema_version"), int) \
            and obj["schema_version"] != SCHEMA_VERSION:
        errors.append(f"schema_version {obj['schema_version']} != "
                      f"{SCHEMA_VERSION}")
    for ev in obj.get("events", []) if isinstance(obj.get("events"), list) \
            else []:
        if not isinstance(ev, dict) or "kind" not in ev or "t" not in ev:
            errors.append(f"malformed ring event: {ev!r}")
            break
    if isinstance(obj.get("threads"), dict):
        for name, stack in obj["threads"].items():
            if not isinstance(stack, list):
                errors.append(f"thread {name!r} stack is not a list")
                break
    return errors
