"""Persistent job service: warm-kernel serving over a Unix-domain socket.

A one-shot CLI pays process start, the torch import, the CUDA context and
the load of the kernel libraries before its first batch moves. This package
keeps one long-lived process holding all of that and runs commands
submitted over a newline-delimited JSON protocol on a Unix-domain socket
(and, optionally, TCP):

- :mod:`.protocol` — the schema-versioned wire protocol
  (``submit`` / ``status`` / ``cancel`` / ``drain`` / ``shutdown`` /
  ``ping`` / ``stats`` / ``hello``), frame limits, and validation; its
  frames are byte-equal to the JAX package's, so either client talks to
  either daemon.
- :mod:`.jobs` — the job registry and per-job state machine
  (queued -> running -> done/failed/cancelled).
- :mod:`.scheduler` — bounded worker pool, FIFO within priority classes,
  admission control with explicit rejection reasons, graceful drain.
- :mod:`.daemon` — the socket server (``serve``); executes each job by
  re-entering the ordinary CLI inside its own telemetry scope, so a job's
  metrics/trace/run-report are what the standalone command would have
  produced — and its output bytes are identical too.
- :mod:`.client` — the thin client used by ``submit``, ``jobs`` and
  ``stats``; retries idempotent requests across daemon restarts under a
  capped jittered exponential backoff, and surfaces admission sheds with
  the governor's ``retry_after_s`` hint.
- :mod:`.transport` — ``unix:``/``tcp:`` addresses, the TCP listener
  (per-connection deadlines, connection cap, shared-secret handshake for
  non-loopback binds), and the frame-serving loop.
- :mod:`.journal` — the append-only job WAL behind ``serve --journal``:
  fsync'd submit/state records, torn-tail truncation on replay, and the
  requeue-on-restart + dedupe-key recovery semantics that make serving
  crash-recoverable.
- :mod:`.introspect` — the ``stats`` payload, ``/metrics`` and
  ``/healthz``.

Fleet operation (``--journal-dir``, lease takeover, the balancer and
scatter), the cross-job coalescer and the routing-state snapshot are not
ported; ``serve`` refuses their options with exit 2.

Every job is byte-parity-committed: the daemon overrides provenance
(@PG CL) with the submitting client's command line, and the execution
state that would otherwise be process-global (metrics, device stats,
kernel launch tallies, atomic-output flag, CLI re-entry depth) is
context-scoped, so two concurrent jobs in one process behave like two
processes.
"""
