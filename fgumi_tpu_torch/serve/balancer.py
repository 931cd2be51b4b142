"""Health-routed fleet balancer: one front end over N serve daemons.

``balance --listen ADDR --backend ADDR ...`` speaks the same
newline-JSON wire protocol as the daemon on its front listener (Unix or
TCP, through the same :class:`~.transport.FrameServer` — deadlines,
connection cap, and handshake auth included) and fans work out across the
backends:

- **Routing** — a ``submit`` goes to the healthy backend with the lowest
  queue depth (``queued + running`` from each backend's ``stats`` op,
  refreshed by the health loop and corrected per-submit). ``status`` /
  ``cancel`` follow a job-id -> backend map learned at submit time, with a
  fan-out fallback — after a lease takeover the job LIVES on a different
  backend than the one it was submitted to, and the fan-out finds it.
- **Health** — a background loop polls every backend's ``stats`` op.
  Failures feed a per-backend closed/open/half-open breaker (the
  ``DeviceBreaker`` shape): ``eject_failures`` consecutive probe failures
  eject the backend (open), a cooldown (doubling per re-trip) moves it to
  half-open, and ``probe_successes`` consecutive clean probes re-admit it.
  An ejected backend receives no traffic.
- **Failover** — a submit whose backend dies mid-request is re-routed to
  a surviving peer when (and only when) it carries a ``dedupe`` key: the
  key makes the retry idempotent even if the dead backend had already
  admitted it (journal-lease takeover requeues that copy, and the dedupe
  key arbitrates — exactly one executes). Keyless submits surface the
  transport error verbatim; the client owns that retry decision.
- **Backpressure** — a backend shedding under resource pressure answers
  with ``retry_after_s``; the balancer first tries the other backends,
  and only when EVERY healthy backend sheds does it sleep the smallest
  hint once and retry, then propagate the shed to the client (who sleeps
  the hint themselves — nobody hot-loops).
- **Scatter** (``--scatter N``) — a submitted ``pipeline``/``simplex``/
  ``duplex`` whale job is split into N dedupe-keyed shard sub-jobs
  fanned out through this same routing, tracked in the balancer's
  scatter WAL, and gathered into one byte-deterministic BAM
  (serve/scatter.py).

``drain``/``shutdown`` on the front apply to the balancer itself (close
admission; exit), never to the backends — operators stop daemons
directly. SIGTERM is the same drain.

The balancer is host code: it imports no torch and creates no CUDA
context. Its SDC hold reads each backend's ``audit`` section: a backend
whose result sentinel (``ops/sentinel.py``) counted a divergence is held,
a port daemon as a JAX-package one."""

import logging
import os
import threading
import time

from . import protocol, transport
from .client import (ServeClient, ServeError, TransportError,
                     TransportTimeout)

log = logging.getLogger("fgumi_tpu_torch")

#: breaker defaults (overridable via `balance` flags)
EJECT_FAILURES = 2
COOLDOWN_S = 5.0
PROBE_SUCCESSES = 2
MAX_COOLDOWN_FACTOR = 8

#: cap on one shed-hint sleep inside the balancer — a huge hint is the
#: client's problem to honor, not a reason to hold a connection hostage.
MAX_SHED_SLEEP_S = 10.0


class PeerBreaker:
    """Closed/open/half-open ejection state machine for one backend.

    The :class:`~fgumi_tpu_torch.ops.breaker.DeviceBreaker` shape re-applied to
    a network peer: consecutive failures eject (open), cooldown doubles
    per re-trip (a flapping backend converges to long ejections instead
    of oscillating), half-open admits ONE probe at a time, and
    ``probe_successes`` consecutive clean probes re-admit. ``now`` is
    injectable for tests."""

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half-open"

    def __init__(self, eject_failures: int = EJECT_FAILURES,
                 cooldown_s: float = COOLDOWN_S,
                 probe_successes: int = PROBE_SUCCESSES,
                 now=time.monotonic):
        self.eject_failures = max(int(eject_failures), 1)
        self.cooldown_s = float(cooldown_s)
        self.probe_successes = max(int(probe_successes), 1)
        self._now = now
        self._lock = threading.Lock()
        self._state = self.CLOSED
        self._score = 0
        self._opened_at = None
        self._trips = 0
        self._probe_inflight = False
        self._probe_ok = 0
        self.transitions = []  # [(t, from, to, reason)] bounded

    def _advance_locked(self):
        if self._state == self.OPEN:
            cool = self.cooldown_s * min(2 ** max(self._trips - 1, 0),
                                         MAX_COOLDOWN_FACTOR)
            if self._now() - self._opened_at >= cool:
                self._transition_locked(self.HALF_OPEN, "cooldown elapsed")
        return self._state

    def _transition_locked(self, new, reason):
        old = self._state
        if old == new:
            return
        self._state = new
        self.transitions.append((round(self._now(), 3), old, new, reason))
        del self.transitions[:-16]
        if new == self.OPEN:
            self._opened_at = self._now()
            self._trips += 1
        if new == self.HALF_OPEN:
            self._probe_inflight = False
            self._probe_ok = 0
        if new == self.CLOSED:
            self._score = 0
            self._trips = 0

    @property
    def state(self) -> str:
        with self._lock:
            return self._advance_locked()

    def allow(self) -> bool:
        """May the next request go to this backend? half-open claims the
        single probe slot; the matching record_* releases it."""
        with self._lock:
            state = self._advance_locked()
            if state == self.CLOSED:
                return True
            if state == self.OPEN:
                return False
            if self._probe_inflight:
                return False
            self._probe_inflight = True
            return True

    def record_success(self):
        with self._lock:
            state = self._advance_locked()
            if state == self.CLOSED:
                self._score = 0
                return
            if state == self.HALF_OPEN:
                self._probe_inflight = False
                self._probe_ok += 1
                if self._probe_ok >= self.probe_successes:
                    self._transition_locked(
                        self.CLOSED,
                        f"{self._probe_ok} consecutive probe successes")

    def record_failure(self, reason: str):
        with self._lock:
            state = self._advance_locked()
            if state == self.HALF_OPEN:
                self._probe_inflight = False
                self._transition_locked(self.OPEN, f"probe failed: {reason}")
                return
            if state == self.CLOSED:
                self._score += 1
                if self._score >= self.eject_failures:
                    self._transition_locked(self.OPEN, reason)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "state": self._advance_locked(),
                "trips": self._trips,
                "transitions": [
                    {"t": t, "from": a, "to": b, "reason": r}
                    for t, a, b, r in self.transitions],
            }


class Backend:
    """One routed-to daemon: its client, breaker, and last known depth."""

    def __init__(self, address: str, token: str = None,
                 timeout_s: float = 30.0, breaker: PeerBreaker = None):
        self.address = address
        # no client-side backoff retries inside the balancer: failure must
        # surface FAST so the breaker ejects and the submit re-routes —
        # the balancer IS the retry layer
        self.client = ServeClient(address, timeout=timeout_s,
                                  retry_policy=transport.RetryPolicy.none(),
                                  token=token)
        self.breaker = breaker or PeerBreaker()
        self._lock = threading.Lock()
        self._depth = None          # queued + running; None = unknown
        self.last_ok_unix = None
        self.last_error = None
        # silent-corruption quarantine: a backend whose stats
        # report audit divergences is held out of routing entirely until
        # a later health poll sees the counters back at zero — which only
        # a daemon restart produces, so "re-admitted on restart" is the
        # whole contract. Forwarded traffic succeeding must NOT lift it:
        # a submit that worked proves the backend answers, not that its
        # device tells the truth.
        self.sdc_hold = False
        self.audit_divergent = 0
        # last full stats payload the health poll fetched, plus the wall
        # time it landed: the balancer's /metrics endpoint and its
        # fleet_metrics stats section re-export backend series from THIS
        # cache, so a scrape never fans out live probes (and staleness is
        # visible as fleet.backend.stats_age_s)
        self._last_stats = None
        self._last_stats_unix = None

    @property
    def depth(self):
        with self._lock:
            return self._depth

    def note_depth(self, depth):
        with self._lock:
            self._depth = depth

    def note_ok(self):
        with self._lock:
            self.last_ok_unix = round(time.time(), 3)
            self.last_error = None

    def note_stats(self, stats: dict):
        with self._lock:
            self._last_stats = stats
            self._last_stats_unix = round(time.time(), 3)

    def cached_stats(self):
        """``(stats_payload, scrape_unix)`` from the last successful
        health poll — ``(None, None)`` before the first one lands."""
        with self._lock:
            return self._last_stats, self._last_stats_unix

    def note_error(self, err: str):
        with self._lock:
            self.last_error = str(err)[:200]

    def note_audit(self, divergent: int):
        """Record the latest stats poll's audit divergence count and
        advance the sdc hold; returns ``(became_held, became_clear)``."""
        with self._lock:
            self.audit_divergent = int(divergent)
            if divergent > 0 and not self.sdc_hold:
                self.sdc_hold = True
                return True, False
            if divergent == 0 and self.sdc_hold:
                self.sdc_hold = False
                return False, True
            return False, False

    def snapshot(self) -> dict:
        with self._lock:
            out = {
                "address": self.address,
                "state": self.breaker.state,
                "depth": self._depth,
                "last_ok_unix": self.last_ok_unix,
                "last_error": self.last_error,
            }
            if self.sdc_hold or self.audit_divergent:
                out["sdc_hold"] = self.sdc_hold
                out["audit_divergent"] = self.audit_divergent
            return out


class Balancer:
    """The front-end service: wire-protocol dispatch over the backends."""

    def __init__(self, listen: str, backends, token: str = None,
                 backend_token: str = None,
                 max_frame_bytes: int = protocol.MAX_FRAME_BYTES,
                 poll_period_s: float = 1.0,
                 eject_failures: int = EJECT_FAILURES,
                 cooldown_s: float = COOLDOWN_S,
                 probe_successes: int = PROBE_SUCCESSES,
                 conn_cap: int = transport.DEFAULT_CONN_CAP,
                 io_timeout_s: float = transport.DEFAULT_IO_TIMEOUT_S,
                 backend_timeout_s: float = 30.0,
                 job_map_limit: int = 10000,
                 metrics_port: int = None,
                 scatter_shards: int = 0,
                 scatter_axis: str = "umi",
                 scatter_wal: str = None,
                 scatter_grace_s: float = 20.0):
        if not backends:
            raise ValueError("balance needs at least one --backend")
        self.listen_addr = listen
        self.token = token
        self.max_frame_bytes = max_frame_bytes
        self.poll_period_s = float(poll_period_s)
        self.backends = [
            Backend(addr, token=backend_token, timeout_s=backend_timeout_s,
                    breaker=PeerBreaker(eject_failures, cooldown_s,
                                        probe_successes))
            for addr in backends]
        seen = set()
        for b in self.backends:
            if b.address in seen:
                raise ValueError(f"duplicate --backend {b.address}")
            seen.add(b.address)
        self.started_unix = time.time()
        self._jobs_lock = threading.Lock()
        self._job_backend = {}      # job id -> Backend (bounded FIFO-ish)
        #: dedupe key -> (Backend, job id | None): an idempotent resubmit
        #: must reach the backend HOLDING the key, or a fresh backend
        #: would execute a second copy. job id None = the key was SENT
        #: there but the answer never arrived (timeout) — the most
        #: dangerous state, resolved only by that backend answering or
        #: its jobs being taken over (best-effort — a takeover moves keys
        #: between backends, and the daemons' own maps stay the
        #: authority)
        self._dedupe_backend = {}
        self._job_map_limit = int(job_map_limit)
        self._draining = False
        self._drain_lock = threading.Lock()
        self._shutdown = threading.Event()
        self._poll_stop = threading.Event()
        self._poll_threads = []
        # the telemetry scope active at construction (cmd_balance's): the
        # FrameServer's connection threads are plain threads with no
        # contextvar inheritance, so handle_request re-enters this scope —
        # otherwise --trace forward spans and the propagated trace context
        # would land on a dead process-global tracer
        from ..observe.scope import current_scope

        self._telemetry_scope = current_scope()
        kind, target = transport.parse_address(listen)
        if kind == "unix":
            listener = transport.UnixListener(target)
        else:
            host, port = target
            listener = transport.TcpListener(
                host, port, token=token, io_timeout_s=io_timeout_s,
                conn_cap=conn_cap)
        self._listener = listener
        self._frames = transport.FrameServer(
            self.handle_request, [listener], max_frame_bytes,
            on_shutdown=self._shutdown.set, name="fgumi-balance")
        # optional fleet metrics endpoint: the daemon's IntrospectionServer
        # with the balancer's own renderers plugged in (/metrics re-exports
        # backend-labelled series from the health-poll cache; /healthz is
        # 200 while at least one backend is routable)
        self._metrics = None
        if metrics_port is not None:
            from .introspect import IntrospectionServer

            self._metrics = IntrospectionServer(
                self, metrics_port,
                metrics_fn=lambda: render_fleet_prometheus(self),
                healthz_fn=lambda: render_fleet_healthz(self))
        # whale scatter/gather (balance --scatter N): the planner/
        # coordinator that splits recognized consensus jobs across the
        # fleet and k-way merges the shard outputs (serve/scatter.py)
        self._scatter = None
        if scatter_shards:
            from .scatter import ScatterCoordinator

            self._scatter = ScatterCoordinator(
                self, scatter_shards, axis=scatter_axis,
                wal_path=scatter_wal, requeue_grace_s=scatter_grace_s,
                # shard status polls are cheap frame round-trips; track
                # them to the health-poll cadence so shard completion is
                # noticed promptly (capped: a lazy operator poll period
                # must not starve the gather)
                poll_s=min(0.5, poll_period_s))
        self._closed = False

    # -- lifecycle ----------------------------------------------------------

    def bind(self):
        self._frames.bind()
        if self._metrics is not None:
            # busy metrics port fails fast, before any backend traffic
            self._metrics.bind()

    def start(self):
        self.bind()
        self._frames.start()
        if self._metrics is not None:
            self._metrics.start()
        self._poll_threads = []
        for i, b in enumerate(self.backends):
            t = threading.Thread(target=self._poll_loop, args=(b,),
                                 name=f"fgumi-balance-health-{i}",
                                 daemon=True)
            t.start()
            self._poll_threads.append(t)
        if self._scatter is not None:
            # WAL-resumed whales start fanning out once routing is live
            self._scatter.start()
        log.info("balance: listening on %s over %d backend(s): %s%s",
                 self._listener.describe(), len(self.backends),
                 ", ".join(b.address for b in self.backends),
                 f"; scatter {self._scatter.shards}x/{self._scatter.axis}"
                 if self._scatter is not None else "")

    def request_shutdown(self):
        self._shutdown.set()

    def wait_until_shutdown(self, poll_s: float = 0.2):
        while not self._shutdown.wait(poll_s):
            pass
        self.drain()

    def drain(self):
        with self._drain_lock:
            if not self._draining:
                log.info("balance: draining (admission closed)")
            self._draining = True

    @property
    def draining(self) -> bool:
        with self._drain_lock:
            return self._draining

    def close(self, grace_s: float = 10.0):
        if self._closed:
            return
        self._closed = True
        self._shutdown.set()
        self._poll_stop.set()
        if self._scatter is not None:
            # in-flight whales stop cleanly; their WAL state resumes them
            # on the next start
            self._scatter.close()
        for t in self._poll_threads:
            t.join(timeout=5)
        if self._metrics is not None:
            self._metrics.stop()
        self._frames.close()
        # let in-flight forwards answer before the process exits
        deadline = time.monotonic() + grace_s
        while self._frames.live_connections() > 0 \
                and time.monotonic() < deadline:
            time.sleep(0.05)
        if isinstance(self._listener, transport.UnixListener):
            self._listener.unlink()
        log.info("balance: stopped")

    @property
    def listen_port(self):
        """Bound TCP port (ephemeral port 0 resolves after bind)."""
        return getattr(self._listener, "port", None)

    @property
    def metrics_port(self):
        """Bound metrics port (None without --metrics-port)."""
        return self._metrics.port if self._metrics is not None else None

    # -- health loop --------------------------------------------------------

    def _poll_loop(self, b: Backend):
        # ONE loop per backend: a hung-but-accepting backend stalls only
        # its own probe (bounded by the probe timeout), never the other
        # backends' depth/health cadence. First pass immediately:
        # routing before the first period would otherwise see every
        # depth as unknown
        while True:
            if b.breaker.allow():
                self._probe(b)
            if self._poll_stop.wait(self.poll_period_s):
                return

    def poll_backends_once(self):
        """One sequential health sweep: refresh depth + feed every
        breaker. Tests and the CLI's startup probe drive this; the live
        balancer runs one independent loop per backend."""
        for b in self.backends:
            if not b.breaker.allow():
                continue  # open, or half-open slot already claimed
            self._probe(b)

    def _probe(self, b: Backend):
        was = b.breaker.state
        try:
            # probe timeout is NOT tied to the poll period: a DEAD
            # backend fails instantly (connection refused), so a generous
            # deadline costs nothing on real deaths — while a tight one
            # ejects a live backend that is merely busy (a job building
            # its kernels on a loaded host), the spurious-ejection mode the
            # timeout-failover rule exists to prevent
            stats = b.client.stats(timeout=min(b.client.timeout, 10.0))
            b.note_stats(stats)
            sched = stats.get("scheduler") or {}
            b.note_depth(int(sched.get("queued", 0))
                         + int(sched.get("running", 0)))
            # silent-corruption check: a backend whose shadow
            # audit caught its device lying is ejected like a failed
            # probe — and held out of routing until its audit counters
            # read zero again, which only a restart produces
            divergent = int((stats.get("audit") or {}).get("divergent", 0))
            became_held, became_clear = b.note_audit(divergent)
            if became_held:
                from ..observe.metrics import METRICS

                METRICS.inc("fleet.balancer.sdc_ejected")
                from ..observe.flight import FLIGHT

                FLIGHT.note("balancer.sdc_eject", address=b.address,
                            divergent=divergent)
                log.error(
                    "balance: backend %s reports %d audit divergence(s) "
                    "— silent data corruption; holding it out of routing "
                    "until its counters reset (restart)",
                    b.address, divergent)
            if became_clear:
                log.warning(
                    "balance: backend %s audit counters are clean again "
                    "(restart observed); lifting the sdc hold", b.address)
            if divergent > 0:
                b.note_error(f"sdc: {divergent} audit divergence(s)")
                b.breaker.record_failure(
                    f"backend reports {divergent} audit divergence(s) "
                    "(silent data corruption)")
            else:
                b.note_ok()
                b.breaker.record_success()
        except ServeError as e:
            b.note_error(e)
            b.breaker.record_failure(f"health probe failed: {e}")
        self._transition_accounting(b, was)

    @staticmethod
    def _note_transition(b: Backend, was: str, now: str):
        from ..observe.flight import FLIGHT

        FLIGHT.note("balancer.backend", address=b.address, state=now,
                    previous=was)
        level = logging.WARNING if now == "open" else logging.INFO
        log.log(level, "balance: backend %s %s -> %s", b.address, was, now)

    # -- routing ------------------------------------------------------------

    def _healthy_backends(self):
        """Routable backends, least-loaded first (unknown depth last among
        the healthy — it answered the breaker but never a stats poll).
        SDC-held backends are excluded outright: half-open probing would
        otherwise route real jobs onto a device known to corrupt results
        (only the health poll's stats re-check can lift the hold)."""
        out = [b for b in self.backends
               if b.breaker.state != "open" and not b.sdc_hold]
        out.sort(key=lambda b: (b.depth is None,
                                b.depth if b.depth is not None else 0))
        return out

    def _bounded_put_locked(self, d: dict, key, value):
        """Insert with drop-oldest-half eviction (caller holds the jobs
        lock). Forgotten JOB entries degrade to the fan-out fallback;
        forgotten DEDUPE entries lose sticky routing (a resubmit of an
        evicted key routes by load again), so that eviction is loud."""
        if len(d) >= self._job_map_limit:
            dropped = list(d)[:self._job_map_limit // 2]
            for k in dropped:
                del d[k]
            if d is self._dedupe_backend:
                log.warning(
                    "balance: dedupe routing map overflowed (limit %d); "
                    "%d oldest keys forgot their sticky backend — "
                    "resubmits of those keys route by load and rely on "
                    "the daemons' own dedupe maps alone",
                    self._job_map_limit, len(dropped))
        d[key] = value

    def _remember_job(self, job_id: str, backend: Backend,
                      dedupe: str = None):
        with self._jobs_lock:
            self._bounded_put_locked(self._job_backend, job_id, backend)
            if dedupe:
                self._bounded_put_locked(self._dedupe_backend, dedupe,
                                         (backend, job_id))

    def _remember_dedupe_pending(self, dedupe: str, backend: Backend):
        """The key was SENT to ``backend`` but no answer arrived: it may
        hold (and be executing) the job. Never overwrite a confirmed
        entry with a pending one."""
        with self._jobs_lock:
            if dedupe not in self._dedupe_backend:
                self._bounded_put_locked(self._dedupe_backend, dedupe,
                                         (backend, None))

    def _note_id_collision(self, job_id: str, b: Backend, resp: dict):
        """Warn when ``b`` admits a new job under an id another backend
        already gave (daemons without ``--journal-dir``/``--fleet-id`` all
        mint ``j-<n>``): the id map keeps the newer, so ``status`` and
        ``cancel`` of that id reach ``b`` alone."""
        prev = self._backend_for_job(job_id)
        if prev is not None and prev is not b and not resp.get("deduped"):
            log.warning("balance: backends %s and %s both minted job id "
                        "%s; status and cancel of it now reach %s alone. "
                        "Give each daemon behind a balancer its own "
                        "--fleet-id (with --journal-dir)", prev.address,
                        b.address, job_id, b.address)

    def _backend_for_job(self, job_id: str):
        with self._jobs_lock:
            return self._job_backend.get(job_id)

    def _relocate_dedupe(self, dedupe: str, job_id: str):
        """The key's holder is ejected: find the backend that owns the
        job NOW (a lease takeover moves jobs — and their keys — to the
        claimant). Returns the new holder, or None when the job is
        nowhere reachable (unknown id, or the takeover has not happened
        yet)."""
        if job_id is None:
            return None  # the original submit never answered: no handle
        for b in self._healthy_backends():
            try:
                resp = self._forward(
                    b, {"v": protocol.PROTOCOL_VERSION, "op": "status",
                        "id": job_id})
            except ServeError:
                continue
            if resp.get("ok"):
                self._remember_job(job_id, b, dedupe=dedupe)
                log.info("balance: dedupe key %r relocated to %s "
                         "(takeover)", dedupe, b.address)
                return b
        return None

    # -- request dispatch ---------------------------------------------------

    def handle_request(self, req: dict) -> dict:
        from ..observe.scope import current_scope, scoped_telemetry

        if self._telemetry_scope is not None and current_scope() is None:
            with scoped_telemetry(scope=self._telemetry_scope):
                return self._handle_request(req)
        return self._handle_request(req)

    def _handle_request(self, req: dict) -> dict:
        err = protocol.validate_request(req)
        if err is not None:
            return protocol.error_response(err)
        op = req["op"]
        if op == "hello":
            return transport.hello_response("fgumi-tpu-torch-balance",
                                            self.token, req)
        if op == "ping":
            states = [b.breaker.state for b in self.backends]
            return protocol.ok_response(
                tool="fgumi-tpu-torch-balance", pid=os.getpid(),
                uptime_s=round(time.time() - self.started_unix, 1),
                backends={"total": len(states),
                          "healthy": sum(s != "open" for s in states)},
                draining=self.draining)
        if op == "stats":
            return protocol.ok_response(stats=self.stats_snapshot())
        if op == "scatter":
            if self._scatter is None:
                return protocol.error_response(
                    "scatter is not enabled on this balancer (start it "
                    "with `balance --scatter N`)")
            job_id = req.get("id")
            if job_id is None:
                return protocol.ok_response(
                    scatter=self._scatter.snapshot())
            whale = self._scatter.status(job_id)
            if whale is None:
                return protocol.error_response(f"unknown job {job_id}")
            return protocol.ok_response(scatter=whale)
        if op == "submit":
            if self._scatter is not None:
                resp = self._scatter.maybe_submit(req)
                if resp is not None:
                    return resp  # a whale: planned and fanned out
            return self._route_submit(req)
        if op == "status":
            return self._route_status(req)
        if op == "cancel":
            if self._scatter is not None:
                resp = self._scatter.cancel(req["id"])
                if resp is not None:
                    return resp
            return self._route_cancel(req)
        if op == "drain":
            self.drain()
            return protocol.ok_response(draining=True)
        if op == "shutdown":
            self.drain()
            return protocol.ok_response(draining=True)
        raise AssertionError(f"unhandled op {op}")

    def stats_snapshot(self, scrape=None) -> dict:
        """The balancer's ``stats`` op payload. v2 added ``fleet_metrics``
        (health-poll-cache rollup: fleet depth, per-backend breaker/SDC
        state, takeover counts, e2e latency summaries); v3 added
        ``scatter`` (whale scatter/gather state: per-whale shard counts
        by planned/running/done/requeued — null when ``--scatter`` is
        off). Pass a pre-taken :meth:`backend_scrape` so this payload and
        a concurrent ``/metrics`` render derive from ONE cache read (the
        same-snapshot rule the daemon's introspection keeps); the
        ``scatter`` section is likewise taken exactly once per payload,
        and the ``/metrics`` scatter gauges are rendered from THIS
        payload, never a second coordinator read."""
        from ..observe.metrics import METRICS

        if scrape is None:
            scrape = self.backend_scrape()
        with self._jobs_lock:
            tracked = len(self._job_backend)
        return {
            "schema_version": 3,
            "scatter": (self._scatter.snapshot()
                        if self._scatter is not None else None),
            "tool": "fgumi-tpu-torch-balance",
            "pid": os.getpid(),
            "uptime_s": round(time.time() - self.started_unix, 1),
            "draining": self.draining,
            "poll_period_s": self.poll_period_s,
            "tracked_jobs": tracked,
            "metrics": {k: v for k, v in METRICS.snapshot().items()
                        if k.startswith(("fleet.", "serve.transport."))},
            "fleet_metrics": self._fleet_metrics(scrape),
            "backends": [
                {**snap, "breaker": b.breaker.snapshot()}
                for b, snap, _, _ in scrape],
        }

    def backend_scrape(self):
        """One coherent read of the health loop's cache:
        ``[(Backend, snapshot, cached_stats | None, scrape_unix | None)]``
        in ``--backend`` order. Never touches a backend."""
        out = []
        for b in self.backends:
            stats, stats_unix = b.cached_stats()
            out.append((b, b.snapshot(), stats, stats_unix))
        return out

    @staticmethod
    def _fleet_metrics(scrape) -> dict:
        """Fleet rollup from one :meth:`backend_scrape`: aggregate depth,
        healthy-backend count, takeover totals, and a per-backend
        breakdown carrying each daemon's end-to-end
        ``serve.job.e2e.submit_to_done_s`` summary — the fleet's
        "p99 submit-to-bytes-published" figure, surfaced without a
        scrape of the backends themselves."""
        depth_total, depth_known, healthy = 0, 0, 0
        takeovers = takeover_jobs = 0
        per_backend = []
        for b, snap, stats, stats_unix in scrape:
            routable = (snap["state"] != "open"
                        and not snap.get("sdc_hold"))
            healthy += int(routable)
            if snap["depth"] is not None:
                depth_total += snap["depth"]
                depth_known += 1
            fleet = (stats or {}).get("fleet") or {}
            b_takeovers = int(fleet.get("takeovers") or 0)
            takeovers += b_takeovers
            takeover_jobs += int(fleet.get("takeover_jobs") or 0)
            entry = {
                "address": snap["address"],
                "state": snap["state"],
                "routable": routable,
                "depth": snap["depth"],
                "sdc_hold": bool(snap.get("sdc_hold")),
                "audit_divergent": int(snap.get("audit_divergent") or 0),
                "takeovers": b_takeovers,
                "stats_age_s": (round(time.time() - stats_unix, 1)
                                if stats_unix else None),
            }
            e2e = ((stats or {}).get("latency") or {}).get(
                "serve.job.e2e.submit_to_done_s")
            if e2e is not None:
                entry["submit_to_done_s"] = e2e
            per_backend.append(entry)
        return {
            "backends_total": len(scrape),
            "backends_healthy": healthy,
            "fleet_depth": depth_total,
            "fleet_depth_known_backends": depth_known,
            "takeovers": takeovers,
            "takeover_jobs": takeover_jobs,
            "per_backend": per_backend,
        }

    def _forward(self, b: Backend, req: dict, claimed: bool = False) -> dict:
        """One backend round-trip; never retried client-side (the
        balancer IS the retry layer — failure must surface fast).

        ``claimed``: the caller took the half-open probe slot
        (``breaker.allow()``) and this request IS the probe. Unclaimed
        read traffic (status fan-out, key relocation) feeds the breaker
        only while it is CLOSED — cheap status successes must not close
        a half-open breaker the real probe is still deciding, nor may a
        stray read failure re-trip it and double the cooldown."""
        was = b.breaker.state
        feed = claimed or was == PeerBreaker.CLOSED
        try:
            resp = b.client.request(req, retry=False)
        except TransportError as e:
            b.note_error(e)
            if feed:
                b.breaker.record_failure(f"request failed: {e}")
                self._transition_accounting(b, was)
            raise
        if feed:
            b.breaker.record_success()
            self._transition_accounting(b, was)
        return resp

    def _transition_accounting(self, b: Backend, was: str):
        """Log/flight-note/count a breaker transition caused by forwarded
        traffic — in BOTH directions: a submit acting as the half-open
        probe can re-admit a backend, and the ejected/readmitted metric
        pair must track it."""
        now = b.breaker.state
        if now == was:
            return
        self._note_transition(b, was, now)
        from ..observe.metrics import METRICS

        if was != "open" and now == "open":
            METRICS.inc("fleet.balancer.ejected")
        if was != "closed" and now == "closed":
            METRICS.inc("fleet.balancer.readmitted")

    @staticmethod
    def _stamp_submit(req: dict):
        """Copy a submit frame and stamp the balancer hop onto the copy:
        ``bal_recv_unix`` now, and the ``traceparent`` rewritten so its
        parent is the balancer's own hop span (same trace-id — the chain
        stays causally linked client -> balancer -> backend). A malformed
        incoming traceparent is dropped, never rejected. Returns
        ``(req_copy, (trace_id, parent_span_id, hop_span_id) | None)``;
        the copy is the balancer's to mutate (``bal_sent_unix`` per
        forward attempt), the caller's frame is never touched."""
        from ..observe import trace as trace_mod

        req = dict(req)
        req["bal_recv_unix"] = round(time.time(), 6)
        parsed = trace_mod.parse_traceparent(req.get("traceparent"))
        if parsed is None:
            req.pop("traceparent", None)
            return req, None
        trace_id, parent_span = parsed
        hop_span = trace_mod.mint_span_id()
        req["traceparent"] = trace_mod.format_traceparent(trace_id, hop_span)
        trace_mod.set_trace_context(trace_id=trace_id,
                                    parent_span_id=parent_span,
                                    process_label="balancer")
        return req, (trace_id, parent_span, hop_span)

    def _route_submit(self, req: dict) -> dict:
        from ..observe import trace as trace_mod
        from ..observe.metrics import METRICS

        if self.draining:
            return protocol.error_response(
                "draining: balancer is not accepting new jobs")
        METRICS.inc("fleet.balancer.submits")
        req, hop_ctx = self._stamp_submit(req)
        dedupe = req.get("dedupe")
        slept_hint = False
        # route passes are bounded: each re-scan needs a state change
        # (ejection, shed sleep) and the pathological flapping case must
        # terminate with an explicit answer, not a spin
        for _ in range(2 * len(self.backends) + 2):
            candidates = self._healthy_backends()
            holder = None
            if dedupe:
                with self._jobs_lock:
                    sticky = self._dedupe_backend.get(dedupe)
                if sticky is not None:
                    holder, known_id = sticky
                    if holder not in candidates:
                        # the holder is ejected — but it may be ALIVE and
                        # still executing (an ejection is a routing
                        # verdict, not a death certificate). Routing the
                        # key to a fresh backend would risk a second
                        # execution; first see whether a takeover already
                        # moved the job to a survivor, else refuse
                        # explicitly — a refusal is retryable, a double
                        # execution is not.
                        holder = self._relocate_dedupe(dedupe, known_id)
                        if holder is None:
                            addr = sticky[0].address
                            return protocol.error_response(
                                f"backend {addr} holding dedupe key "
                                f"{dedupe!r} is ejected and may still "
                                "be executing it; retry once it "
                                "recovers or its jobs are taken over")
                    # a known key goes to its holder and NOWHERE else:
                    # skipping past it mid-loop (probe slot taken, a
                    # refusal) must refuse, not spill — any other
                    # backend would execute a second copy
                    candidates = [holder]
            if not candidates:
                return protocol.error_response(
                    "no healthy backends (all "
                    f"{len(self.backends)} ejected)")
            sheds = []
            failed_over = False
            for b in candidates:
                if not b.breaker.allow():
                    if b is holder:
                        return protocol.error_response(
                            f"backend {b.address} holding dedupe key "
                            f"{dedupe!r} is recovering (half-open probe "
                            "in flight); retry shortly")
                    continue  # half-open probe slot already out
                try:
                    # the forwarded submit is the half-open probe when the
                    # backend is recovering — the breaker's "the batch IS the
                    # probe" idea applied to peers (allow() above claimed
                    # the slot). No client-side retry: failover below is
                    # the retry.
                    req["bal_sent_unix"] = round(time.time(), 6)
                    attrs = {"backend": b.address}
                    if hop_ctx is not None:
                        attrs["trace_id"] = hop_ctx[0]
                        attrs["span_id"] = hop_ctx[2]
                    with trace_mod.span("serve.forward", **attrs):
                        resp = self._forward(b, req, claimed=True)
                except ServeError as e:
                    if not isinstance(e, TransportError):
                        # the backend ANSWERED but refused the
                        # conversation itself — handshake rejection
                        # (token mismatch) or an old daemon rejecting the
                        # hello op. The submit never reached admission,
                        # so the next backend is safe regardless of
                        # dedupe; the breaker hears about the misfit
                        b.note_error(e)
                        b.breaker.record_failure(f"request refused: {e}")
                        if b is holder:
                            return protocol.error_response(
                                f"backend {b.address} holding dedupe "
                                f"key {dedupe!r} refused the "
                                f"conversation ({e}); not spilling the "
                                "key elsewhere — retry once it answers")
                        log.warning("balance: backend %s refused the "
                                    "conversation (%s); trying the next",
                                    b.address, e)
                        continue
                    if isinstance(e, TransportTimeout):
                        # the backend may be ALIVE and still executing:
                        # re-routing would run the job twice (the lease
                        # takeover only arbitrates against dead
                        # backends). Pin the key to this backend so a
                        # RESUBMIT is refused rather than routed to a
                        # fresh backend, and surface the timeout
                        if dedupe is not None:
                            self._remember_dedupe_pending(dedupe, b)
                        return protocol.error_response(
                            f"backend {b.address} timed out mid-submit "
                            f"({e}); not failing over — the backend may "
                            "still be executing it. Poll `status`, or "
                            "retry and the balancer will hold the "
                            "dedupe key to this backend")
                    if dedupe is None:
                        # the dead backend may have admitted it; without a
                        # key a second submit could double-execute —
                        # surface the failure, the client owns the retry
                        return protocol.error_response(
                            f"backend {b.address} failed mid-submit "
                            f"({e}); resubmit with a dedupe key for "
                            "automatic failover")
                    METRICS.inc("fleet.balancer.rerouted")
                    from ..observe.flight import FLIGHT

                    FLIGHT.note("balancer.reroute", address=b.address,
                                dedupe=dedupe)
                    log.warning("balance: backend %s failed mid-submit; "
                                "re-routing dedupe-keyed submit (%s)",
                                b.address, e)
                    failed_over = True
                    continue
                if resp.get("ok"):
                    job = resp.get("job") or {}
                    if job.get("id"):
                        self._note_id_collision(job["id"], b, resp)
                        self._remember_job(job["id"], b, dedupe=dedupe)
                        if not resp.get("deduped"):
                            b.note_depth((b.depth or 0) + 1)
                    return resp
                reason = resp.get("error", "")
                was_holder = b is holder
                if was_holder:
                    # the daemon answers a held dedupe key BEFORE any
                    # admission check — so a shed/queue-full/refusal from
                    # the holder proves the key is no longer held there
                    # (job evicted from history, key reissued): this is a
                    # fresh submit again, free to route anywhere
                    with self._jobs_lock:
                        self._dedupe_backend.pop(dedupe, None)
                    holder = None
                    failed_over = True  # state changed: re-scan unpinned
                if "retry_after_s" in resp:
                    sheds.append((resp["retry_after_s"], resp))
                    continue  # pressure here; try a less loaded peer
                if reason.startswith("queue full"):
                    b.note_depth((b.depth or 0) + 1)  # stale depth: learn
                    continue  # spill to the next backend
                if was_holder:
                    continue  # refusal from the ex-holder: others may admit
                return resp  # real refusal (draining/quota/validation)
            if sheds and not slept_hint:
                # EVERY reachable backend is shedding: honor the smallest
                # hint once (bounded), then retry the whole route — the
                # anti-hot-loop contract, balancer side
                hint = max(min(h for h, _ in sheds), 0.05)
                METRICS.inc("fleet.balancer.shed_sleeps")
                log.info("balance: all backends shedding; sleeping "
                         "retry_after_s hint %.2fs", hint)
                time.sleep(min(hint, MAX_SHED_SLEEP_S))
                slept_hint = True
                continue
            if sheds:
                # still shedding after one hint sleep: hand the (smallest)
                # hint to the client verbatim
                return min(sheds, key=lambda hr: hr[0])[1]
            if failed_over:
                continue  # every candidate died mid-submit: re-scan
            return protocol.error_response(
                "no backend admitted the job (all at capacity or "
                "probing)")
        return protocol.error_response(
            "no backend admitted the job (route retries exhausted)")

    def _route_status(self, req: dict) -> dict:
        job_id = req.get("id")
        if job_id is None:
            # aggregate listing: every healthy backend's jobs (+ the
            # balancer's own whale records) + our depth
            jobs = []
            if self._scatter is not None:
                jobs.extend(self._scatter.list_jobs())
            for b in self._healthy_backends():
                try:
                    resp = self._forward(b, req)
                except ServeError:
                    continue
                if resp.get("ok"):
                    jobs.extend(resp.get("jobs") or [])
            return protocol.ok_response(jobs=jobs)
        if self._scatter is not None:
            # whale ids live HERE, not on any backend
            whale = self._scatter.status(job_id)
            if whale is not None:
                return protocol.ok_response(job=whale)
        return self._routed_job_op(req, job_id)

    def _route_cancel(self, req: dict) -> dict:
        return self._routed_job_op(req, req["id"])

    def _routed_job_op(self, req: dict, job_id: str) -> dict:
        """status/cancel for one job id: mapped backend first, then fan
        out — a lease takeover moves jobs between backends and the map
        has no way to know. Fan-out reads never touch a half-open
        breaker's probe slot (_forward feeds only closed breakers)."""
        mapped = self._backend_for_job(job_id)
        tried = []
        last_refusal = None
        if mapped is not None and mapped.breaker.state != "open":
            tried.append(mapped)
            try:
                resp = self._forward(mapped, req)
                if resp.get("ok"):
                    return resp
                # the job's own backend KNOWS it: its refusal ("job is
                # running; never preempted" / "already cancelled") is the
                # actionable answer — the fan-out's "unknown job" from
                # peers must not mask it
                last_refusal = resp
            except ServeError:
                pass
        for b in self._healthy_backends():
            if b in tried:
                continue
            try:
                resp = self._forward(b, req)
            except ServeError:
                continue
            if resp.get("ok"):
                self._remember_job(job_id, b)  # learn the new home
                return resp
            if last_refusal is None:  # the mapped backend's answer wins
                last_refusal = resp
        return last_refusal or protocol.error_response(
            f"unknown job {job_id}")


# ---------------------------------------------------------------------------
# fleet metrics endpoint (balancer --metrics-port)


def render_fleet_prometheus(balancer: Balancer) -> str:
    """The balancer's ``/metrics`` body: fleet rollups, the balancer's own
    counters, and every backend's cached daemon series re-exported under
    the SAME metric names with a ``backend="ADDR"`` label (so one Grafana
    panel graphs ``fgumi_tpu_serve_job_e2e_submit_to_done_s`` quantiles
    per backend). Derived from one :meth:`Balancer.backend_scrape` — the
    identical cache read the ``stats`` op's ``fleet_metrics`` section
    uses, so the two surfaces can never disagree — and never probes a
    backend (staleness shows as ``fleet_backend_stats_age_s``)."""
    from .introspect import _num, _prom_name

    scrape = balancer.backend_scrape()
    snap = balancer.stats_snapshot(scrape=scrape)
    fleet = snap["fleet_metrics"]
    lines = []

    def gauge(dotted, value, labels="", help_text=None):
        name = _prom_name(dotted)
        if help_text:
            lines.append(f"# HELP {name} {help_text}")
            lines.append(f"# TYPE {name} gauge")
        lines.append(f"{name}{labels} {_num(value)}")

    gauge("fleet.balancer.uptime_s", snap["uptime_s"],
          help_text="balancer uptime in seconds")
    gauge("fleet.balancer.draining", int(bool(snap["draining"])))
    gauge("fleet.balancer.tracked_jobs", snap["tracked_jobs"])
    gauge("fleet.backends_total", fleet["backends_total"],
          help_text="configured backends")
    gauge("fleet.backends_healthy", fleet["backends_healthy"],
          help_text="routable backends (breaker not open, no sdc hold)")
    gauge("fleet.depth", fleet["fleet_depth"],
          help_text="queued+running summed over backends with known depth")
    gauge("fleet.takeovers", fleet["takeovers"],
          help_text="journal-lease takeovers summed over the fleet")
    gauge("fleet.takeover_jobs", fleet["takeover_jobs"])
    # whale scatter/gather gauges — from the SAME stats payload (one
    # coordinator snapshot per render, the same-snapshot rule again)
    scatter = snap.get("scatter")
    gauge("fleet.scatter.enabled", int(scatter is not None),
          help_text="1 when this balancer runs with --scatter N")
    if scatter is not None:
        gauge("fleet.scatter.shards_per_whale", scatter["shards"])
        for state, n in sorted(scatter["whales"].items()):
            gauge("fleet.scatter.whales_state",
                  n, f'{{state="{state}"}}')
        shard_states = {}
        for w in scatter["jobs"]:
            for state, n in w["shards"].items():
                shard_states[state] = shard_states.get(state, 0) + n
        for state, n in sorted(shard_states.items()):
            gauge("fleet.scatter.shards_state", n, f'{{state="{state}"}}')
    # the balancer's own flat counters (routing/transport activity —
    # includes the fleet.scatter.* whale/shard/gather counters)
    for dotted, v in sorted(snap["metrics"].items()):
        if isinstance(v, bool) or not isinstance(v, (int, float)):
            continue
        lines.append(f"{_prom_name(dotted)} {_num(v)}")
    # per-backend series, all labelled with the backend address
    for entry, (b, _, stats, _) in zip(fleet["per_backend"], scrape):
        label = f'{{backend="{entry["address"]}"}}'
        gauge("fleet.backend.up", int(entry["routable"]), label)
        gauge("fleet.backend.breaker_open",
              int(entry["state"] == "open"), label)
        gauge("fleet.backend.sdc_hold", int(entry["sdc_hold"]), label)
        gauge("fleet.backend.audit_divergent",
              entry["audit_divergent"], label)
        gauge("fleet.backend.takeovers", entry["takeovers"], label)
        if entry["depth"] is not None:
            gauge("fleet.backend.depth", entry["depth"], label)
        if entry["stats_age_s"] is not None:
            gauge("fleet.backend.stats_age_s", entry["stats_age_s"], label)
        if stats is None:
            continue  # no successful poll yet: nothing cached to re-export
        for dotted, v in sorted((stats.get("metrics") or {}).items()):
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                continue
            lines.append(f"{_prom_name(dotted)}{label} {_num(v)}")
        for dotted, summ in sorted((stats.get("latency") or {}).items()):
            if not isinstance(summ, dict):
                continue
            name = _prom_name(dotted)
            addr = entry["address"]
            for q, key in (("0.5", "p50"), ("0.9", "p90"), ("0.99", "p99")):
                if key in summ:
                    lines.append(f'{name}{{backend="{addr}",'
                                 f'quantile="{q}"}} {_num(summ[key])}')
            if "count" in summ:
                lines.append(f"{name}_count{label} {_num(summ['count'])}")
            if "sum" in summ:
                lines.append(f"{name}_sum{label} {_num(summ['sum'])}")
    return "\n".join(lines) + "\n"


def render_fleet_healthz(balancer: Balancer) -> tuple:
    """``(http_status, body_dict)`` for the balancer's ``/healthz``: 200
    while at least one backend is routable and the balancer is not
    draining, 503 otherwise (an upstream LB can eject the front end)."""
    scrape = balancer.backend_scrape()
    routable = sum(1 for _, snap, _, _ in scrape
                   if snap["state"] != "open" and not snap.get("sdc_hold"))
    healthy = routable > 0 and not balancer.draining
    body = {
        "status": "ok" if healthy else "degraded",
        "draining": balancer.draining,
        "backends_total": len(scrape),
        "backends_healthy": routable,
        "uptime_s": round(time.time() - balancer.started_unix, 1),
    }
    return (200 if healthy else 503), body
