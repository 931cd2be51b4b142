"""Bounded-pool job scheduler: priority FIFO, admission control, drain.

The scheduling problem here is deliberately simple — the daemon's scarce
resource is the one warm device and the host cores around it, so the pool
is small and the policy is legible: jobs run in submission order within
their priority class (``high`` > ``normal`` > ``low``), at most ``workers``
concurrently. The policy buys predictability: an operator can say exactly
why a job ran when it did.

Admission control is capacity-shaped, not queue-shaped: a submit is
admitted iff ``running + queued < workers + queue_limit``, otherwise it is
rejected immediately with a reason string (``queue full: ...``). Rejection
is a first-class answer — the protocol returns it as ``ok: false`` so a
caller can back off or route elsewhere; silently unbounded queues are how
serving systems die.

Drain (operator op or SIGTERM) closes admission; workers finish what is
queued and running, then park. ``join()`` waits for that quiescence.
"""

import heapq
import itertools
import logging
import threading

from .jobs import JobRegistry
from .protocol import PRIORITIES

log = logging.getLogger("fgumi_tpu_torch")

_PRIO_RANK = {p: i for i, p in enumerate(PRIORITIES)}


class Scheduler:
    """Priority-FIFO queue + worker pool executing jobs via ``execute``.

    ``execute(job)`` is the daemon's job runner: it must return the job's
    exit status (int) and never raise (it converts exceptions into the
    job's ``failed`` record); the scheduler still guards against a raise so
    one broken job cannot kill a worker."""

    def __init__(self, execute, registry: JobRegistry, workers: int = 2,
                 queue_limit: int = 8, max_per_client: int = 0):
        if workers < 1:
            raise ValueError("workers must be >= 1")
        if queue_limit < 0:
            raise ValueError("queue-limit must be >= 0")
        if max_per_client < 0:
            raise ValueError("max-per-client must be >= 0")
        self._execute = execute
        self.registry = registry
        self.workers = workers
        self.queue_limit = queue_limit
        #: per-submitter admission quota (0 = unlimited): a client id may
        #: hold at most this many ACTIVE (queued + running) jobs — the
        #: first slice of multi-tenant admission. Jobs
        #: submitted without a client id are anonymous and never limited.
        self.max_per_client = max_per_client
        self._client_active = {}  # client id -> queued + running count
        self._heap = []  # (priority rank, seq, job)
        self._seq = itertools.count()
        self._cv = threading.Condition()
        self._running = 0
        self._draining = False
        self._threads = []
        self._started = False

    # -- lifecycle ----------------------------------------------------------

    def start(self):
        if self._started:
            return
        self._started = True
        for i in range(self.workers):
            # plain threads on purpose (no contextvar copy): a worker must
            # NOT inherit the serve command's telemetry scope — each job
            # enters its own scope when the CLI re-enters main()
            t = threading.Thread(target=self._worker_loop, args=(i,),
                                 name=f"fgumi-serve-worker-{i}", daemon=True)
            t.start()
            self._threads.append(t)

    # -- admission ----------------------------------------------------------

    def submit(self, job):
        """Admit ``job`` or reject it. Returns (admitted, reason)."""
        from ..observe.metrics import METRICS

        with self._cv:
            if self._draining:
                return False, "draining: daemon is not accepting new jobs"
            client = getattr(job, "client", None)
            if self.max_per_client and client:
                held = self._client_active.get(client, 0)
                if held >= self.max_per_client:
                    METRICS.inc("serve.quota.rejected")
                    return False, (
                        f"quota exceeded: client {client!r} holds {held} "
                        f"active job(s) >= max-per-client "
                        f"{self.max_per_client}")
            active = self._running + len(self._heap)
            capacity = self.workers + self.queue_limit
            if active >= capacity:
                return False, (
                    f"queue full: {self._running} running + "
                    f"{len(self._heap)} queued >= capacity {capacity} "
                    f"({self.workers} workers + {self.queue_limit} queue "
                    "slots)")
            heapq.heappush(self._heap,
                           (_PRIO_RANK[job.priority], next(self._seq), job))
            if client:
                self._client_active[client] = \
                    self._client_active.get(client, 0) + 1
                METRICS.inc("serve.quota.admitted")
                METRICS.max("serve.quota.clients",
                            len(self._client_active))
            self._cv.notify()
            return True, None

    def _release_client_locked(self, job):
        client = getattr(job, "client", None)
        if not client:
            return
        held = self._client_active.get(client, 0) - 1
        if held > 0:
            self._client_active[client] = held
        else:
            self._client_active.pop(client, None)

    def client_quota_state(self) -> dict:
        """{client id: active job count} (status/debugging surface)."""
        with self._cv:
            return dict(self._client_active)

    def cancel(self, job_id: str):
        """Cancel a *queued* job. Returns (ok, reason)."""
        with self._cv:
            for i, (rank, seq, job) in enumerate(self._heap):
                if job.id == job_id:
                    del self._heap[i]
                    heapq.heapify(self._heap)
                    self._release_client_locked(job)
                    self.registry.mark_cancelled(job)
                    return True, None
        job = self.registry.get(job_id)
        if job is None:
            return False, f"unknown job {job_id}"
        if job.state == "running":
            return False, (f"job {job_id} is running; running jobs are "
                           "never preempted")
        if job.state == "queued":
            # popped by a worker but not yet marked running: it is starting
            # this instant — telling the caller "already queued" would
            # contradict the cancel-a-queued-job contract
            return False, (f"job {job_id} is starting; running jobs are "
                           "never preempted")
        return False, f"job {job_id} is already {job.state}"

    # -- drain --------------------------------------------------------------

    def drain(self):
        """Close admission. Queued + running jobs still run to completion."""
        with self._cv:
            if not self._draining:
                log.info("scheduler: draining (admission closed; %d queued, "
                         "%d running)", len(self._heap), self._running)
            self._draining = True
            self._cv.notify_all()

    @property
    def draining(self) -> bool:
        with self._cv:
            return self._draining

    def idle(self) -> bool:
        with self._cv:
            return not self._heap and self._running == 0

    def join(self, timeout: float = None) -> bool:
        """Block until drained-and-idle. True when quiescent."""
        import time

        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            while self._heap or self._running:
                wait = None
                if deadline is not None:
                    wait = deadline - time.monotonic()
                    if wait <= 0:
                        return False
                self._cv.wait(wait if wait is not None else 1.0)
            return True

    def depth(self) -> dict:
        with self._cv:
            return {"queued": len(self._heap), "running": self._running,
                    "workers": self.workers,
                    "queue_limit": self.queue_limit,
                    "draining": self._draining}

    def active(self) -> int:
        """queued + running — the load figure fleet routing is based on
        (the balancer reads it off the stats op; the stats `fleet`
        section carries it directly)."""
        with self._cv:
            return len(self._heap) + self._running

    # -- worker -------------------------------------------------------------

    @staticmethod
    def _note_active_jobs(n: int):
        """The running-job count to the cross-job dispatch coalescer
        (ops/coalesce.py): its window opens only while 2 or more jobs run
        in this process. Called under the scheduler condition, so two
        workers' counts publish in order; never fails a worker."""
        try:
            from ..ops.coalesce import COALESCER

            COALESCER.set_active_jobs(n)
        except Exception:  # noqa: BLE001 - telemetry must not kill workers
            log.debug("coalescer active-job signal failed", exc_info=True)

    def _worker_loop(self, widx: int):
        while True:
            with self._cv:
                while not self._heap:
                    self._cv.wait()
                _, _, job = heapq.heappop(self._heap)
                self._running += 1
                self._note_active_jobs(self._running)
            try:
                self.registry.mark_running(job)
                rc = self._execute(job)
                # executors normally record the outcome themselves; cover
                # the minimal contract for bare test executors
                if job.state == "running":
                    self.registry.mark_done(job, rc if rc is not None else 0)
            except BaseException as e:  # noqa: BLE001 - worker must survive
                log.exception("serve worker %d: job %s runner raised",
                              widx, job.id)
                if job.state == "running":
                    try:
                        self.registry.mark_failed(
                            job, f"{type(e).__name__}: {e}")
                    except Exception:
                        pass
            finally:
                with self._cv:
                    self._running -= 1
                    self._note_active_jobs(self._running)
                    self._release_client_locked(job)
                    self._cv.notify_all()
