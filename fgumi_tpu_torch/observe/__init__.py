"""Telemetry of the port: span tracing, metrics, run reports, heartbeat.

One layer with a zero-cost-when-disabled contract, mirroring the JAX
package's ``observe``:

- :mod:`.trace`: thread-aware ``span("name", **attrs)`` regions recorded
  across the pipeline stages, the BGZF and read-ahead threads, external-sort
  spills and the device dispatch/fetch; exported as Chrome trace-event JSON
  that Perfetto opens (``--trace`` / ``FGUMI_TPU_TRACE``).
- :mod:`.metrics`: a registry of counters, gauges and latency histograms
  under stable dotted names (``DeviceStats``, ``StageTimes``, fault fires,
  I/O bytes).
- :mod:`.report`: a schema-versioned JSON run report committed atomically
  at the end of every command (``--run-report`` / ``FGUMI_TPU_RUN_REPORT``).
- :mod:`.heartbeat`: a periodic one-line progress heartbeat on the log
  stream (``--heartbeat`` / ``FGUMI_TPU_HEARTBEAT_S``).
- :mod:`.logs`: ``--log-level`` logging with elapsed time and thread name.
- :mod:`.scope`: a contextvar-resolved :class:`TelemetryScope` per
  top-level command (metrics, ``DeviceStats`` and tracer), carried into the
  command's helper threads.
- :mod:`.flight`: the always-on flight recorder and its black-box dumps.
- :mod:`.trace_merge`: stitches several trace files into one timeline.

Disabled is the default and costs nothing on the hot path: ``span`` returns
a shared no-op context manager, counters fold once per command, and no
background thread starts unless asked for.
"""

from .metrics import METRICS, MetricsRegistry  # noqa: F401
from .trace import (NULL_SPAN, instant, span, start_trace, stop_trace,  # noqa: F401
                    tracing_enabled, write_trace)
