"""Command-scoped telemetry: per-command registries resolved through a
contextvar.

A :class:`TelemetryScope` bundles one ``MetricsRegistry``, one
``DeviceStats`` and (optionally) one tracer, and a
:class:`contextvars.ContextVar` names the active scope. ``METRICS``
(``observe.metrics``), ``DEVICE_STATS`` (``ops.kernel``) and the tracer
(``observe.trace``) are proxies that resolve the active scope on every call
and fall back to process-global objects when none is active. So two
commands run at once in one process (two in-process ``main`` calls on two
threads) never mix their counters, and library users and tests outside any
scope see the globals.

Contextvars do not cross ``threading.Thread`` boundaries on their own, so
every helper thread that records telemetry (the stage runner's reader,
writer and workers, the fused chain's stages, the heartbeat, the tasks of
the BGZF pool and the read-ahead thread) runs in a copy of its creator's
context: :func:`spawn_thread`, or ``contextvars.copy_context().run`` for a
pool task.
"""

import contextvars
import threading

_SCOPE = contextvars.ContextVar("fgumi_tpu_torch_telemetry_scope",
                                default=None)
#: Command line (argv list) override for output provenance (@PG CL)
_ARGV = contextvars.ContextVar("fgumi_tpu_torch_command_argv", default=None)
#: Job context for the next telemetry scope created underneath: the job id,
#: a propagated W3C-style trace context and upstream hop timestamps, handed
#: across a ``main`` re-entry by whoever runs the command as a job
_JOB_CTX = contextvars.ContextVar("fgumi_tpu_torch_job_context",
                                  default=None)


class TelemetryScope:
    """One command's telemetry: metrics + device stats + tracer, and its
    tally of kernel launches.

    The ``DeviceStats`` is made on first use (it lives in ``ops.kernel``,
    which a command that never touches the device does not import)."""

    __slots__ = ("label", "metrics", "tracer", "_device_stats", "_lock",
                 "trace_id", "parent_span_id", "job_id", "hops", "_launches")

    def __init__(self, label: str = None):
        from .metrics import MetricsRegistry

        self.label = label
        self.metrics = MetricsRegistry()
        self.tracer = None  # set by trace.start_trace inside the scope
        self._device_stats = None
        self._lock = threading.Lock()
        #: trace context of a command run as a job (None standalone)
        self.trace_id = None
        self.parent_span_id = None
        self.job_id = None
        #: upstream hop wall-clock timestamps (None standalone)
        self.hops = None
        #: kernel launches of this command, by counter
        #: (``"<module>.<counter>"``; ``ops.cuda_kernel.count_launch``)
        self._launches = {}

    def device_stats(self, factory):
        """This scope's DeviceStats, made on first use by ``factory`` (the
        class, passed in to avoid an import cycle with ops.kernel)."""
        with self._lock:
            if self._device_stats is None:
                self._device_stats = factory()
            return self._device_stats

    def device_stats_if_any(self):
        with self._lock:
            return self._device_stats

    def count_launch(self, counter: str):
        with self._lock:
            self._launches[counter] = self._launches.get(counter, 0) + 1

    def launches(self, counter: str) -> int:
        """This command's launches counted under ``counter``."""
        with self._lock:
            return self._launches.get(counter, 0)


def current_scope():
    """The active :class:`TelemetryScope`, or None (process-global mode)."""
    return _SCOPE.get()


class scoped_telemetry:
    """Context manager entering a fresh (or given) telemetry scope: the
    body, and every thread it starts through :func:`spawn_thread`, record
    into their own metrics, device stats and tracer."""

    def __init__(self, label: str = None, scope: TelemetryScope = None):
        self.scope = scope if scope is not None else TelemetryScope(label)
        self._token = None

    def __enter__(self):
        self._token = _SCOPE.set(self.scope)
        return self.scope

    def __exit__(self, *exc):
        _SCOPE.reset(self._token)
        return False


class command_argv:
    """Context manager overriding the provenance command line (@PG CL):
    outputs written inside it record ``" ".join(argv)`` instead of the
    process's ``sys.argv``."""

    def __init__(self, argv):
        self._argv = list(argv)
        self._token = None

    def __enter__(self):
        self._token = _ARGV.set(self._argv)
        return self._argv

    def __exit__(self, *exc):
        _ARGV.reset(self._token)
        return False


class job_context:
    """Context manager naming the job context of scopes created inside it:
    ``trace_id``/``parent_span_id`` (propagated W3C-style ids, or None) and
    ``hops`` (upstream wall-clock timestamps)."""

    def __init__(self, job_id: str = None, trace_id: str = None,
                 parent_span_id: str = None, hops: dict = None):
        self._ctx = {"job_id": job_id, "trace_id": trace_id,
                     "parent_span_id": parent_span_id,
                     "hops": dict(hops) if hops else None}
        self._token = None

    def __enter__(self):
        self._token = _JOB_CTX.set(self._ctx)
        return self._ctx

    def __exit__(self, *exc):
        _JOB_CTX.reset(self._token)
        return False


def adopt_job_context(scope: TelemetryScope):
    """Stamp a pending :class:`job_context` onto a fresh scope (``main``
    calls it right after making the command's scope; a no-op for a
    standalone run)."""
    ctx = _JOB_CTX.get()
    if ctx is None:
        return
    scope.job_id = ctx["job_id"]
    scope.trace_id = ctx["trace_id"]
    scope.parent_span_id = ctx["parent_span_id"]
    scope.hops = ctx["hops"]


def command_line_override():
    """The :class:`command_argv` override of the provenance command line,
    or None outside one (a standalone command records its own argv)."""
    return _ARGV.get()


def current_argv():
    """The command line for provenance: the :class:`command_argv` override
    inside one, else ``sys.argv``."""
    override = _ARGV.get()
    if override is not None:
        return override
    import sys

    return sys.argv


def publish_to_global(scope: TelemetryScope):
    """Copy a finished scope's counters onto the process-global fallbacks,
    so ``METRICS`` and ``DEVICE_STATS`` read after ``main`` returns show the
    finished command's numbers. Two commands finishing at once race here
    (the last one wins); each command's own numbers live in its scope and
    its run report."""
    from . import metrics as _metrics

    _metrics._GLOBAL_REGISTRY.replace(scope.metrics.snapshot())
    # histograms merge: the global view is cumulative since the process
    # started, while each scope's report carries only its own
    _metrics._GLOBAL_REGISTRY.merge_histograms(scope.metrics.histograms())
    import sys

    kern = sys.modules.get("fgumi_tpu_torch.ops.kernel")
    if kern is not None:
        stats = scope.device_stats_if_any()
        if stats is not None:
            kern._GLOBAL_DEVICE_STATS.load_from(stats)
        else:
            # the command never touched the device: the global view reads
            # zero, not an earlier command's dispatches
            kern._GLOBAL_DEVICE_STATS.reset()


def spawn_thread(target, *, name=None, daemon=True, args=()):
    """A ``threading.Thread`` whose target runs in a copy of the caller's
    context, keeping a command's telemetry scope attached to its helper
    threads. Returned un-started."""
    ctx = contextvars.copy_context()
    return threading.Thread(target=lambda: ctx.run(target, *args),
                            name=name, daemon=daemon)
