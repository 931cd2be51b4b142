"""Thread-aware span tracing with Chrome trace-event JSON export.

``span("pipeline.process", batch=3)`` times a region of one thread and
records it as a Chrome trace-event complete event (``ph: "X"``), so a run
traced with ``--trace out.json`` opens in Perfetto (or ``chrome://tracing``)
with one row per thread: a stall is a gap, a device round trip a block on
the thread that waited for it.

- **Zero overhead when disabled.** ``span()`` with tracing off returns one
  shared no-op context manager: no allocation, no lock, no clock read. Hot
  loops hoist ``tracing_enabled()`` once and skip their spans entirely.
- **Thread attribution.** Events carry the OS thread id, and each thread is
  named once by a ``thread_name`` metadata event (fgumi-reader,
  fgumi-writer, fgumi-worker-N, fgumi-bgzf_N, fgumi-prefetch, ...).
- **Bounded memory.** The buffer is capped (:data:`MAX_EVENTS`, override
  ``FGUMI_TPU_TRACE_MAX_EVENTS``); past the cap spans are dropped and the
  export carries a ``trace.truncated`` marker with the dropped count.
- **Cross-process linkage.** A W3C-style trace context (32-hex trace id +
  16-hex parent span id, as a ``traceparent`` string) can be attached; the
  export stamps it into ``otherData`` with a wall-clock anchor
  (``t_zero_unix`` beside the monotonic zero), which ``trace-merge`` aligns
  several files on.

CUDA launches are asynchronous: a ``device.dispatch`` span covers the
host's upload and enqueue, and the time the card takes shows up inside the
``device.fetch`` span of the thread that waits for the result.
"""

import json
import os
import threading
import time

# ---------------------------------------------------------------------------
# W3C-style trace context (trace-id + parent-span-id)

#: traceparent wire format, a strict subset of W3C Trace Context:
#: ``00-<32 hex trace-id>-<16 hex span-id>-01``. Malformed values are
#: IGNORED by every consumer (dropped, never rejected) so a buggy or
#: future-version peer can't fail a submission over telemetry garnish.
_TRACEPARENT_VERSION = "00"


def mint_trace_id() -> str:
    """A fresh 32-hex trace id (random, collision-safe across the fleet)."""
    return os.urandom(16).hex()


def mint_span_id() -> str:
    """A fresh 16-hex span id."""
    return os.urandom(8).hex()


def format_traceparent(trace_id: str, span_id: str) -> str:
    """``00-<trace-id>-<span-id>-01`` (sampled flag always set: fgumi-tpu
    traces are explicitly requested, never probabilistically sampled)."""
    return f"{_TRACEPARENT_VERSION}-{trace_id}-{span_id}-01"


def _is_hex(s: str, n: int) -> bool:
    if len(s) != n:
        return False
    try:
        int(s, 16)
    except ValueError:
        return False
    return True


def parse_traceparent(value):
    """``(trace_id, span_id)`` for a well-formed traceparent, else None.

    None for anything malformed — wrong type, wrong field count, non-hex,
    all-zero ids — per the propagation contract: telemetry context is
    best-effort garnish and must never fail a request."""
    if not isinstance(value, str):
        return None
    parts = value.split("-")
    if len(parts) != 4:
        return None
    version, trace_id, span_id, flags = parts
    if not (_is_hex(version, 2) and _is_hex(trace_id, 32)
            and _is_hex(span_id, 16) and _is_hex(flags, 2)):
        return None
    if version == "ff" or set(trace_id) == {"0"} or set(span_id) == {"0"}:
        return None
    return trace_id, span_id


# ---------------------------------------------------------------------------
# no-op fast path


class _NullSpan:
    """Shared do-nothing context manager returned while tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        """No-op attr update (mirrors the live span's API)."""


NULL_SPAN = _NullSpan()

_tracer = None  # process-global _Tracer, or None (used when no scope active)


def _current_tracer():
    """The tracer spans should record into: the active telemetry scope's
    (one per daemon job) when inside one, else the process-global tracer.
    A scope with tracing off shades the global tracer on purpose — job A
    tracing must not collect job B's spans."""
    from .scope import current_scope

    scope = current_scope()
    if scope is not None:
        return scope.tracer
    return _tracer


def tracing_enabled() -> bool:
    return _current_tracer() is not None


# ---------------------------------------------------------------------------
# live tracer

MAX_EVENTS = 500_000


class _Span:
    """One in-flight span: records a complete ("X") event on exit."""

    __slots__ = ("_tracer", "name", "_t0", "args")

    def __init__(self, tracer, name, args):
        self._tracer = tracer
        self.name = name
        self.args = args
        self._t0 = time.monotonic()

    def set(self, **attrs):
        """Attach attrs discovered mid-span (recorded at exit)."""
        if self.args is None:
            self.args = attrs
        else:
            self.args.update(attrs)

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        t1 = time.monotonic()
        self._tracer._complete(self.name, self._t0, t1, self.args,
                               error=exc_type.__name__ if exc_type else None)
        return False


class _Tracer:
    def __init__(self, max_events: int = None):
        if max_events is None:
            try:
                max_events = int(os.environ.get(
                    "FGUMI_TPU_TRACE_MAX_EVENTS", str(MAX_EVENTS)))
            except ValueError:
                max_events = MAX_EVENTS
        self.max_events = max_events
        # the clock anchor pair: one monotonic zero for in-file timestamps
        # and the wall-clock instant it corresponds to, captured
        # back-to-back. trace-merge aligns per-process files by shifting
        # each timeline so the anchors agree (the residual error is the
        # few-ns gap between these two calls plus any host clock skew,
        # correctable with the handshake offset estimate).
        self.t_zero = time.monotonic()
        self.t_zero_unix = time.time()
        #: W3C-style trace context (set via :meth:`set_context` when this
        #: process's work is part of a fleet-routed job); exported so
        #: trace-merge can group per-process files under one trace-id
        self.trace_id = None
        self.parent_span_id = None
        #: human label for this process's track group in a merged timeline
        #: (e.g. "client", "balancer", "backend j-3")
        self.process_label = None
        #: estimated local-minus-server wall clock skew (seconds), from
        #: the serve handshake round trip; trace-merge subtracts it from
        #: the anchor so cross-host timelines line up on the server clock
        self.clock_offset_s = None
        self.dropped = 0
        self._lock = threading.Lock()
        self._events = []
        self._named_tids = set()

    def set_context(self, trace_id: str = None, parent_span_id: str = None,
                    process_label: str = None):
        """Attach the fleet trace context (any subset; idempotent)."""
        if trace_id is not None:
            self.trace_id = trace_id
        if parent_span_id is not None:
            self.parent_span_id = parent_span_id
        if process_label is not None:
            self.process_label = process_label

    def _thread_meta_locked(self):
        """Emit a thread_name metadata event for the calling thread once."""
        tid = threading.get_ident()
        if tid not in self._named_tids:
            self._named_tids.add(tid)
            self._events.append({
                "name": "thread_name", "ph": "M", "pid": os.getpid(),
                "tid": tid,
                "args": {"name": threading.current_thread().name}})
        return tid

    def _complete(self, name, t0, t1, args, error=None):
        # span ends also feed the always-on flight recorder's ring (the
        # black box shows the last few hundred spans even when the trace
        # buffer overflowed or was never exported)
        from .flight import FLIGHT

        FLIGHT.note("span", name=name, dur_ms=round((t1 - t0) * 1e3, 3),
                    **({"error": error} if error else {}))
        ev = {"name": name, "ph": "X", "pid": os.getpid(),
              "ts": round((t0 - self.t_zero) * 1e6, 1),
              "dur": round((t1 - t0) * 1e6, 1)}
        if error is not None:
            args = dict(args or ())
            args["error"] = error
        if args:
            ev["args"] = args
        with self._lock:
            if len(self._events) >= self.max_events:
                self.dropped += 1
                return
            ev["tid"] = self._thread_meta_locked()
            self._events.append(ev)

    def instant(self, name, args=None):
        ev = {"name": name, "ph": "i", "s": "t", "pid": os.getpid(),
              "ts": round((time.monotonic() - self.t_zero) * 1e6, 1)}
        if args:
            ev["args"] = args
        with self._lock:
            if len(self._events) >= self.max_events:
                self.dropped += 1
                return
            ev["tid"] = self._thread_meta_locked()
            self._events.append(ev)

    def snapshot(self):
        with self._lock:
            return list(self._events)

    def to_json_obj(self):
        events = self.snapshot()
        if self.dropped:
            # an explicit truncation marker INSIDE the timeline: a human in
            # Perfetto sees where recording stopped instead of silently
            # reading a gap as "nothing happened after this"
            events.append({
                "name": "trace.truncated", "ph": "i", "s": "g",
                "pid": os.getpid(), "tid": 0,
                "ts": round((time.monotonic() - self.t_zero) * 1e6, 1),
                "args": {"dropped_events": self.dropped,
                         "max_events": self.max_events}})
        if self.process_label:
            # a process_name metadata event labels this pid's track group
            # when the file is merged with other processes' timelines
            events.append({"name": "process_name", "ph": "M",
                           "pid": os.getpid(), "tid": 0,
                           "args": {"name": self.process_label}})
        obj = {"traceEvents": events, "displayTimeUnit": "ms"}
        clock = {"t_zero_unix": round(self.t_zero_unix, 6)}
        if self.clock_offset_s is not None:
            clock["offset_estimate_s"] = round(self.clock_offset_s, 6)
        other = {"clock": clock,
                 "process": {"pid": os.getpid(),
                             "label": self.process_label}}
        if self.trace_id:
            other["trace_context"] = {"trace_id": self.trace_id,
                                      "parent_span_id": self.parent_span_id}
        if self.dropped:
            other["dropped_events"] = self.dropped
        obj["otherData"] = other
        return obj


# ---------------------------------------------------------------------------
# module API


def span(name: str, **attrs):
    """Time a region of the current thread as a named trace span.

    With tracing disabled this returns the shared :data:`NULL_SPAN` (no
    allocation); enabled, a complete event is recorded when the context
    exits, tagged with ``attrs`` and the thread's id/name. Exceptions
    propagate (the span records ``error: <type>``)."""
    t = _current_tracer()
    if t is None:
        return NULL_SPAN
    return _Span(t, name, attrs or None)


def instant(name: str, **attrs):
    """Record a zero-duration instant event (a timeline marker)."""
    t = _current_tracer()
    if t is not None:
        t.instant(name, attrs or None)


def set_trace_context(trace_id: str = None, parent_span_id: str = None,
                      process_label: str = None):
    """Attach the fleet trace context to the active tracer (no-op when
    tracing is off — context is garnish, never a reason to allocate)."""
    t = _current_tracer()
    if t is not None:
        t.set_context(trace_id, parent_span_id, process_label)


def set_clock_offset(offset_s: float):
    """Record the handshake clock-offset estimate on the active tracer
    (no-op when tracing is off)."""
    t = _current_tracer()
    if t is not None:
        t.clock_offset_s = float(offset_s)


def start_trace(max_events: int = None):
    """Enable tracing for the active telemetry scope (one per daemon job),
    or process-wide when no scope is entered. Idempotent (keeps the active
    tracer)."""
    global _tracer
    from .scope import current_scope

    scope = current_scope()
    if scope is not None:
        if scope.tracer is None:
            scope.tracer = _Tracer(max_events)
        return scope.tracer
    if _tracer is None:
        _tracer = _Tracer(max_events)
    return _tracer


def stop_trace():
    """Disable tracing (scope-local when inside a scope) and return the
    tracer (caller may still export it)."""
    global _tracer
    from .scope import current_scope

    scope = current_scope()
    if scope is not None:
        t, scope.tracer = scope.tracer, None
        return t
    t, _tracer = _tracer, None
    return t


def write_trace(path: str, tracer=None):
    """Export the trace as Chrome trace-event JSON, committed atomically.

    Writes the active tracer by default; pass the object returned by
    :func:`stop_trace` to export after disabling."""
    t = tracer if tracer is not None else _tracer
    if t is None:
        return
    if t.dropped:
        # overflow is an observability *defect* worth a counter: the run
        # report says how much of the timeline is missing
        from .metrics import METRICS

        METRICS.inc("trace.dropped_events", t.dropped)
    from ..utils.atomic import discard_output, open_output

    out = open_output(path, "w")
    try:
        json.dump(t.to_json_obj(), out, separators=(",", ":"))
    except BaseException:
        discard_output(out)
        raise
    out.close()
