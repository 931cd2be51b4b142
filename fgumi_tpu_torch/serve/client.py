"""Thin job-service client: one connection per request, blocking waits.

Used by ``submit`` / ``jobs`` / ``stats`` and by ``chip_smoke.py``. Deliberately dependency-free and synchronous — the
protocol is one JSON frame each way, and reconnect-per-request makes the
client robust to a daemon restart between polls.

Addresses are ``unix:/path``, ``tcp:host:port``, or a bare Unix socket
path (the pre-fleet spelling). On a TCP connection with a configured
token, every request opens with the hello handshake frame before the real
request (serve/transport.py).

Retries: a connection torn down under the client (``ECONNRESET``/
``EPIPE``/mid-frame close/connect refusal — exactly what a daemon SIGKILL
or restart looks like from this side) is retried for idempotent
operations under a capped jittered exponential-backoff
:class:`~.transport.RetryPolicy` (replacing the fixed single 0.5 s
reconnect); a ``dedupe``-keyed submit is idempotent by the daemon's
contract and retries the same way. ``cancel``/``shutdown`` never retry —
their responses are not idempotent. Daemon refusals (``ok: false``) are
surfaced with the daemon's reason verbatim; an admission shed under
resource pressure raises :class:`ShedError` carrying the governor's
``retry_after_s`` hint so callers (``submit --wait``, the balancer) can
sleep exactly that long instead of hot-looping.
"""

import errno
import time

from . import protocol, transport

#: the provenance program name a submit records when the caller names none:
#: the port's own (``cli.PROGRAM_ID``), so a job's @PG CL equals the
#: standalone command's
PROGRAM_ID = "fgumi-tpu-torch"


class ServeError(RuntimeError):
    """Transport failure or an ``ok: false`` response (reason in str())."""


class TransportError(ServeError):
    """The connection itself failed (unreachable daemon, reset, torn
    frame) — the daemon may or may not have seen the request. The
    balancer re-routes dedupe-keyed submits on exactly this class."""


class TransportTimeout(TransportError):
    """The request was SENT but no response arrived in time. The peer
    may be alive and still executing it — so the balancer must NOT fail
    a submit over to another backend on this class (a live backend plus
    a re-routed copy is two executions; journal-lease takeover only
    arbitrates against DEAD backends). A timeout during connect() is an
    ordinary TransportError: nothing reached the daemon."""


class ShedError(ServeError):
    """Admission shed under resource pressure: not admitted, safe to
    retry after :attr:`retry_after_s` (the governor's hint)."""

    def __init__(self, reason: str, retry_after_s: float):
        super().__init__(reason)
        self.retry_after_s = float(retry_after_s)


#: errnos that mean "the peer vanished mid-conversation" — the retryable
#: class together with connection refusal (daemon restarting).
_RESET_ERRNOS = frozenset({errno.ECONNRESET, errno.EPIPE})


def _is_reset(exc: OSError) -> bool:
    return isinstance(exc, (ConnectionResetError, BrokenPipeError)) \
        or getattr(exc, "errno", None) in _RESET_ERRNOS


class ServeClient:
    def __init__(self, address: str, timeout: float = 30.0,
                 max_frame_bytes: int = protocol.MAX_FRAME_BYTES,
                 retry_policy: transport.RetryPolicy = None,
                 token: str = None):
        self.address = address
        self.kind, _ = transport.parse_address(address)
        self.timeout = timeout
        self.max_frame_bytes = max_frame_bytes
        self.retry_policy = retry_policy or transport.RetryPolicy()
        #: shared-secret handshake token; sent (as a hello frame opening
        #: each connection) whenever set — required by non-loopback TCP
        #: listeners, harmless elsewhere
        self.token = token

    @property
    def socket_path(self) -> str:
        """Back-compat spelling for unix-socket callers."""
        return self.address

    # -- transport ----------------------------------------------------------

    def request(self, obj: dict, timeout: float = None,
                retry: bool = True) -> dict:
        """One request -> one response. Raises ServeError on transport
        failure; returns the response frame verbatim (check ``ok``).
        ``timeout`` overrides the client default for this request;
        ``retry=False`` disables the reconnect-on-failure backoff (for
        non-idempotent operations)."""
        policy = self.retry_policy if retry else transport.RetryPolicy.none()
        last = None
        for attempt in range(policy.attempts):
            if attempt:
                time.sleep(policy.delay_s(attempt))
            try:
                return self._request_once(obj, timeout)
            except _Retryable as e:
                last = e.error
        raise last

    def _request_once(self, obj: dict, timeout: float = None) -> dict:
        try:
            conn = transport.connect(
                self.address, self.timeout if timeout is None else timeout)
        except OSError as e:
            # includes connection-refused: a restarting daemon's window —
            # retryable for idempotent ops under the backoff policy
            raise _Retryable(TransportError(
                f"cannot reach daemon at {self.address}: {e}"))
        try:
            sent = False
            try:
                stream = conn.makefile("rb")
                if self.token is not None:
                    transport.client_hello(stream, conn, self.token,
                                           self.max_frame_bytes)
                conn.sendall(protocol.encode_frame(obj))
                sent = True
                resp = protocol.read_frame(stream, self.max_frame_bytes)
            except protocol.ProtocolError as e:
                # a handshake refusal or garbled frame is a loud daemon
                # answer, not weather — never retried
                raise ServeError(f"daemon connection failed: {e}")
            except TimeoutError as e:
                if sent:
                    # the COMPLETE frame is on the wire and the answer
                    # never came: the peer may be alive and still
                    # working — never treated like a death signature
                    raise TransportTimeout(
                        f"daemon did not answer within the timeout: {e}")
                # handshake or send-phase timeout: the request frame was
                # never fully delivered (a torn frame fails to decode and
                # is never acted on), so nothing is in flight — an
                # ordinary retryable transport failure
                raise _Retryable(TransportError(
                    f"daemon connection timed out before the request "
                    f"was delivered: {e}"))
            except OSError as e:
                err = TransportError(f"daemon connection failed: {e}")
                if _is_reset(e):
                    raise _Retryable(err)  # daemon restarting: retry
                raise err
            if resp is None:
                # clean close mid-request: the SIGKILL/restart signature
                raise _Retryable(TransportError(
                    "daemon closed the connection mid-request"))
            return resp
        finally:
            conn.close()

    def _checked(self, obj: dict, timeout: float = None,
                 retry: bool = True) -> dict:
        resp = self.request(obj, timeout=timeout, retry=retry)
        if not resp.get("ok"):
            # the daemon's reason verbatim — "queue full: ..." vs
            # "draining: ..." is how callers tell backpressure from refusal
            reason = resp.get("error", "daemon refused the request")
            if "retry_after_s" in resp:
                # resource_pressure shed: carries the governor's hint so
                # submit --wait / the balancer sleep it instead of looping
                raise ShedError(reason, resp["retry_after_s"])
            raise ServeError(reason)
        return resp

    # -- operations ---------------------------------------------------------

    def ping(self) -> dict:
        return self._checked({"v": protocol.PROTOCOL_VERSION, "op": "ping"})

    def stats(self, timeout: float = None) -> dict:
        """Live introspection snapshot (scheduler/quota/journal/breaker/
        governor/device/fleet + latency histogram summaries). A daemon
        predating the op answers ``unknown op 'stats'`` — surfaced
        verbatim as ServeError, the documented clean rejection."""
        return self._checked({"v": protocol.PROTOCOL_VERSION,
                              "op": "stats"}, timeout=timeout)["stats"]

    def submit(self, argv, priority: str = protocol.DEFAULT_PRIORITY,
               argv0: str = None, tag: str = None, trace: bool = False,
               dedupe: str = None, client: str = None,
               traceparent: str = None, shard: dict = None) -> dict:
        """Submit a command; returns the accepted job record. An admission
        rejection (queue full / draining / over quota) raises ServeError
        with the daemon's reason; a resource-pressure shed raises
        :class:`ShedError` with the retry hint. ``dedupe``: idempotency
        key — resubmitting the same key returns the original job instead of
        running it twice, which also makes the reconnect retry safe for
        submits; without a key, a submit whose connection resets is NOT
        retried (the daemon may already have admitted it). ``client``:
        submitter identity for the daemon's per-client admission quota
        (serve --max-per-client); anonymous submits are never quota-limited.

        Trace context: every submit carries a W3C-style ``traceparent``
        (minted here unless the caller provides one) plus its send wall
        time, so fleet-routed jobs are causally linkable end to end; old
        daemons ignore both fields (docs/observability.md). The minted
        context is recorded on the returned record under ``traceparent``
        and — when this process is itself tracing — as a ``serve.submit``
        span tagged with the ids, so a client-side trace file merges
        under the same trace-id as the balancer's and the backend's."""
        from ..observe import trace as trace_mod

        if traceparent is None:
            trace_id = trace_mod.mint_trace_id()
            span_id = trace_mod.mint_span_id()
            traceparent = trace_mod.format_traceparent(trace_id, span_id)
        else:
            parsed = trace_mod.parse_traceparent(traceparent)
            trace_id, span_id = parsed if parsed else (None, None)
        req = {"v": protocol.PROTOCOL_VERSION, "op": "submit",
               "argv": list(argv), "priority": priority,
               "argv0": argv0 if argv0 is not None else PROGRAM_ID,
               "trace": bool(trace), "traceparent": traceparent,
               "sent_unix": round(time.time(), 6)}
        if tag is not None:
            req["tag"] = tag
        if dedupe is not None:
            req["dedupe"] = dedupe
        if client is not None:
            req["client"] = client
        if shard is not None:
            # scatter metadata (a balancer's whale fan-out stamps it; see
            # serve/scatter.py) — old daemons ignore the field
            req["shard"] = dict(shard)
        if trace_id is not None:
            trace_mod.set_trace_context(trace_id=trace_id,
                                        process_label="client")
        with trace_mod.span("serve.submit", trace_id=trace_id,
                            span_id=span_id):
            job = self._checked(req, retry=dedupe is not None)["job"]
        return job

    def scatter(self, job_id: str = None, timeout: float = None) -> dict:
        """Whale scatter/gather introspection from a ``balance --scatter``
        front end: per-shard state for one whale id, or the whole scatter
        section without one. A daemon answers with its explicit
        balancer-only refusal, and daemons/balancers predating the op
        answer ``unknown op 'scatter'`` — both surfaced verbatim as
        ServeError (the documented clean rejection)."""
        req = {"v": protocol.PROTOCOL_VERSION, "op": "scatter"}
        if job_id is not None:
            req["id"] = job_id
        return self._checked(req, timeout=timeout)["scatter"]

    def status(self, job_id: str = None, timeout: float = None) -> dict:
        req = {"v": protocol.PROTOCOL_VERSION, "op": "status"}
        if job_id is not None:
            req["id"] = job_id
        return self._checked(req, timeout=timeout)

    def job(self, job_id: str) -> dict:
        return self.status(job_id)["job"]

    def cancel(self, job_id: str) -> dict:
        # no reconnect retry: if the daemon acted before the reset, the
        # retry would be answered "already cancelled" (ok: false) and a
        # cancel that succeeded would surface as a failure
        return self._checked({"v": protocol.PROTOCOL_VERSION, "op": "cancel",
                              "id": job_id}, retry=False)["job"]

    def drain(self) -> dict:
        # idempotent (re-draining a draining daemon is a no-op): retry ok
        return self._checked({"v": protocol.PROTOCOL_VERSION, "op": "drain"})

    def shutdown(self) -> dict:
        # no retry: after a successful shutdown the reconnect would hit
        # connection-refused and report failure for an op that succeeded
        return self._checked({"v": protocol.PROTOCOL_VERSION,
                              "op": "shutdown"}, retry=False)

    def wait(self, job_id: str, timeout: float = None,
             poll_s: float = 0.2, unknown_grace_s: float = 15.0) -> dict:
        """Poll until the job reaches a terminal state; returns the record.
        Raises ServeError on timeout (the job keeps running).

        An ``unknown job`` answer is tolerated for ``unknown_grace_s``
        before it is fatal: through a balancer, a job whose backend was
        just SIGKILL'd is briefly unknown FLEET-WIDE — until a survivor's
        lease scan adopts the dead daemon's journal and the id resolves
        again. Failing the wait inside that window would turn the exact
        failover the fleet tier exists for into a client error."""
        from .jobs import TERMINAL

        deadline = None if timeout is None else time.monotonic() + timeout
        unknown_since = None
        while True:
            try:
                job = self.job(job_id)
            except ServeError as e:
                if "unknown job" not in str(e):
                    raise
                now = time.monotonic()
                if unknown_since is None:
                    unknown_since = now
                if now - unknown_since >= unknown_grace_s or (
                        deadline is not None and now >= deadline):
                    raise
                time.sleep(poll_s)
                continue
            unknown_since = None
            if job["state"] in TERMINAL:
                return job
            if deadline is not None and time.monotonic() >= deadline:
                raise ServeError(
                    f"timed out waiting for job {job_id} "
                    f"(still {job['state']})")
            time.sleep(poll_s)


class _Retryable(Exception):
    """Internal: wraps a ServeError the transport may retry."""

    def __init__(self, error: ServeError):
        super().__init__(str(error))
        self.error = error
