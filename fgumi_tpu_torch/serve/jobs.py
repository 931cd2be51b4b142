"""Job registry: per-job state machine and wire representation.

Each submitted command becomes a :class:`Job` with a strict lifecycle::

    queued ----> running ----> done     (exit status 0)
      |             \\-------> failed   (nonzero exit / exception; the
      |                                 diagnostic is kept on the record)
      \\----> cancelled                 (queued jobs only — running jobs
                                        are never preempted)

Transitions outside this graph raise, so a scheduler bug can never
resurrect a finished job or mark a cancelled one done. The registry is the
daemon's single source of truth for ``status`` responses and keeps every
terminal job until the daemon exits (bounded by ``keep_finished``, oldest
evicted first) so a client can poll a job that finished between polls.
"""

import collections
import threading
import time

STATES = ("queued", "running", "done", "failed", "cancelled")
_ALLOWED = {
    "queued": {"running", "cancelled"},
    "running": {"done", "failed"},
    "done": set(),
    "failed": set(),
    "cancelled": set(),
}

TERMINAL = frozenset(("done", "failed", "cancelled"))


class Job:
    """One submitted command and its lifecycle bookkeeping."""

    __slots__ = ("id", "argv", "argv0", "priority", "tag", "trace",
                 "client", "state", "submitted_unix", "started_unix",
                 "finished_unix", "exit_status", "error", "report_path",
                 "trace_path", "traceparent", "hops", "shard")

    def __init__(self, job_id: str, argv, priority: str, argv0: str = None,
                 tag: str = None, trace: bool = False, client: str = None,
                 traceparent: str = None, hops: dict = None,
                 shard: dict = None):
        self.id = job_id
        self.argv = list(argv)
        self.argv0 = argv0 or "fgumi-tpu-torch"
        self.priority = priority
        self.tag = tag
        self.trace = bool(trace)
        #: submitter identity for per-client admission quotas (protocol
        #: "client" field; None = anonymous, never quota-limited)
        self.client = client
        #: propagated W3C-style trace context (already validated by the
        #: daemon — malformed values were dropped at parse, so this is
        #: either a well-formed traceparent string or None)
        self.traceparent = traceparent
        #: upstream hop wall-clock timestamps for end-to-end latency
        #: attribution (client_sent_unix / balancer_recv_unix /
        #: balancer_sent_unix as propagated; None when the client sent none)
        self.hops = dict(hops) if hops else None
        #: scatter metadata stamped by a whale fan-out (protocol "shard"
        #: field: whale id / shard index / shard count / hash axis); None
        #: for every ordinary job
        self.shard = dict(shard) if shard else None
        self.state = "queued"
        self.submitted_unix = time.time()
        self.started_unix = None
        self.finished_unix = None
        self.exit_status = None
        self.error = None
        self.report_path = None
        self.trace_path = None

    def to_wire(self) -> dict:
        """The JSON-safe record sent in submit/status responses."""
        return {
            "id": self.id,
            "state": self.state,
            "argv": list(self.argv),
            "priority": self.priority,
            "tag": self.tag,
            "client": self.client,
            "submitted_unix": round(self.submitted_unix, 3),
            "started_unix": (round(self.started_unix, 3)
                             if self.started_unix else None),
            "finished_unix": (round(self.finished_unix, 3)
                              if self.finished_unix else None),
            "exit_status": self.exit_status,
            "error": self.error,
            "report_path": self.report_path,
            "trace_path": self.trace_path,
            "traceparent": self.traceparent,
            "shard": self.shard,
        }


class InvalidTransition(RuntimeError):
    """A state change outside the job lifecycle graph."""


class JobRegistry:
    """Thread-safe id -> :class:`Job` store enforcing the state machine."""

    def __init__(self, keep_finished: int = 1000, on_transition=None):
        self._lock = threading.Lock()
        self._jobs = {}
        self._order = []  # insertion order, for stable listing
        # terminal ids in completion order: O(1) eviction on create instead
        # of rescanning the whole history per submission
        self._finished = collections.deque()
        self._next_id = 1
        self._keep_finished = keep_finished
        #: called as on_transition(job) after every state change — the
        #: daemon's journal hook (fires outside the registry lock, after
        #: the record's fields are final)
        self.on_transition = on_transition

    def create(self, argv, priority: str, argv0: str = None,
               tag: str = None, trace: bool = False,
               client: str = None, traceparent: str = None,
               hops: dict = None, shard: dict = None) -> Job:
        with self._lock:
            job = Job(f"j-{self._next_id}", argv, priority,
                      argv0=argv0, tag=tag, trace=trace, client=client,
                      traceparent=traceparent, hops=hops, shard=shard)
            self._next_id += 1
            self._jobs[job.id] = job
            self._order.append(job.id)
            self._evict_locked()
            return job

    def restore(self, job: Job):
        """Insert a pre-built job (journal replay): the id is preserved so
        clients polling across a daemon restart still resolve it, and the
        id counter skips past it so new submissions never collide."""
        with self._lock:
            if job.id in self._jobs:
                raise ValueError(f"job id {job.id} already registered")
            self._jobs[job.id] = job
            self._order.append(job.id)
            suffix = job.id.rsplit("-", 1)[-1]
            if suffix.isdigit():
                self._next_id = max(self._next_id, int(suffix) + 1)
            if job.state in TERMINAL:
                self._finished.append(job.id)
            self._evict_locked()

    def _evict_locked(self):
        while len(self._finished) > self._keep_finished:
            jid = self._finished.popleft()
            if jid in self._jobs:  # may already be discard()ed
                del self._jobs[jid]
                self._order.remove(jid)

    def _note_terminal(self, job: Job):
        with self._lock:
            self._finished.append(job.id)

    def discard(self, job_id: str):
        """Forget a job entirely (admission-rejected submissions: keeping
        them would let a rejection storm evict real finished-job history)."""
        with self._lock:
            if job_id in self._jobs:
                del self._jobs[job_id]
                self._order.remove(job_id)

    def get(self, job_id: str) -> Job:
        with self._lock:
            return self._jobs.get(job_id)

    def list(self):
        with self._lock:
            return [self._jobs[j] for j in self._order]

    def counts(self) -> dict:
        with self._lock:
            out = dict.fromkeys(STATES, 0)
            for job in self._jobs.values():
                out[job.state] += 1
            return out

    # -- transitions --------------------------------------------------------

    def _transition(self, job: Job, new_state: str):
        with self._lock:
            if new_state not in _ALLOWED[job.state]:
                raise InvalidTransition(
                    f"job {job.id}: {job.state} -> {new_state} is not a "
                    "legal transition")
            job.state = new_state

    def _notify(self, job: Job):
        # every job transition lands in the flight recorder's always-on
        # ring: a daemon black box shows what the scheduler was doing
        from ..observe.flight import FLIGHT

        FLIGHT.note("serve.job", id=job.id, state=job.state,
                    **({"error": str(job.error)[:200]} if job.error else {}))
        cb = self.on_transition
        if cb is not None:
            try:
                cb(job)
            except Exception:  # noqa: BLE001 - journal loss != daemon loss
                import logging

                logging.getLogger("fgumi_tpu_torch").exception(
                    "job transition hook failed for %s", job.id)

    @staticmethod
    def _observe_latency(job: Job):
        """Fold one job's lifecycle walls into the latency histograms.

        Runs on the scheduler worker thread OUTSIDE any job telemetry
        scope, so the observations land in the process-global registry —
        the daemon-lifetime view the ``stats`` op and ``/metrics`` expose.
        queued→running is observed at start; running→terminal and
        submit→terminal at finish."""
        from ..observe.metrics import METRICS

        if job.state == "running":
            if job.started_unix and job.submitted_unix:
                METRICS.observe("serve.job.queue_wait_s",
                                job.started_unix - job.submitted_unix)
            return
        if job.state in ("done", "failed") and job.finished_unix:
            if job.started_unix:
                METRICS.observe("serve.job.run_s",
                                job.finished_unix - job.started_unix)
            if job.submitted_unix:
                METRICS.observe("serve.job.total_s",
                                job.finished_unix - job.submitted_unix)
            # end-to-end decomposition from the propagated hop timestamps
            # (present only when the client sent them; all clamped >= 0 —
            # host clock skew must not poison a histogram with negatives).
            # serve.job.e2e.submit_to_done_s is the fleet's
            # "p99 submit-to-bytes-published" series: client send wall to
            # job terminal, spanning every hop in between.
            hops = job.hops or {}
            cs = hops.get("client_sent_unix")
            br = hops.get("balancer_recv_unix")
            bs = hops.get("balancer_sent_unix")
            if cs and br:
                METRICS.observe("serve.job.e2e.client_to_balancer_s",
                                max(br - cs, 0.0))
            if bs and job.submitted_unix:
                METRICS.observe("serve.job.e2e.balancer_to_admit_s",
                                max(job.submitted_unix - bs, 0.0))
            elif cs and not bs and job.submitted_unix:
                # direct submit (no balancer hop): one client->admit leg
                METRICS.observe("serve.job.e2e.client_to_admit_s",
                                max(job.submitted_unix - cs, 0.0))
            if cs:
                METRICS.observe("serve.job.e2e.submit_to_done_s",
                                max(job.finished_unix - cs, 0.0))

    def mark_running(self, job: Job):
        self._transition(job, "running")
        job.started_unix = time.time()
        self._observe_latency(job)
        self._notify(job)

    def mark_done(self, job: Job, exit_status: int):
        job.exit_status = int(exit_status)
        if exit_status == 0:
            self._transition(job, "done")
        else:
            job.error = job.error or f"command exited {exit_status}"
            self._transition(job, "failed")
        job.finished_unix = time.time()
        self._note_terminal(job)
        self._observe_latency(job)
        self._notify(job)

    def mark_failed(self, job: Job, error: str):
        job.error = str(error)
        job.exit_status = job.exit_status if job.exit_status else 1
        self._transition(job, "failed")
        job.finished_unix = time.time()
        self._note_terminal(job)
        self._observe_latency(job)
        self._notify(job)

    def mark_cancelled(self, job: Job):
        self._transition(job, "cancelled")
        job.finished_unix = time.time()
        self._note_terminal(job)
        self._notify(job)
