"""Job-service wire protocol: newline-delimited JSON frames, schema v1.

One request frame per line, one response frame per line, UTF-8 JSON with a
trailing ``\\n``. A connection may carry any number of request/response
pairs (the client library opens one connection per request for simplicity;
the daemon supports either). The schema is versioned exactly like the run
report: every frame carries ``"v": PROTOCOL_VERSION`` and the daemon
rejects mismatches loudly instead of guessing.

Requests::

    {"v": 1, "op": "submit", "argv": ["simplex", "-i", ...],
     "priority": "normal", "argv0": "fgumi-tpu", "trace": false,
     "tag": "optional-label", "dedupe": "optional-idempotency-key",
     "client": "optional-submitter-id",
     "traceparent": "00-<32hex>-<16hex>-01",   # optional trace context
     "sent_unix": 1723.4,                      # client send wall time
     "bal_recv_unix": 1723.5,                  # stamped by a balancer
     "bal_sent_unix": 1723.5,                  # forward hop
     "shard": {"whale": "w-ab12-1",            # optional scatter metadata:
               "index": 0, "count": 4,         # stamped by a balancer's
               "axis": "umi"}}                 # whale fan-out; old daemons
                                               # ignore it (garnish)
    {"v": 1, "op": "status"}           # all jobs
    {"v": 1, "op": "status", "id": "j-3"}
    {"v": 1, "op": "cancel", "id": "j-3"}
    {"v": 1, "op": "drain"}            # stop admitting, keep serving status
    {"v": 1, "op": "shutdown"}         # drain, finish queued+running, exit
    {"v": 1, "op": "ping"}             # daemon liveness + config echo
    {"v": 1, "op": "stats"}            # live introspection snapshot
                                       # (scheduler/quota/journal/breaker/
                                       # governor/device/fleet + latency
                                       # histogram summaries; daemons
                                       # predating the op reject it cleanly
                                       # with "unknown op 'stats'")
    {"v": 1, "op": "hello",            # transport handshake (fleet tier):
     "token": "shared-secret"}         # REQUIRED as the first frame on a
                                       # non-loopback TCP connection; on a
                                       # Unix/loopback listener it is
                                       # accepted but optional. Old daemons
                                       # reject it cleanly with "unknown op
                                       # 'hello'" — a new balancer probing
                                       # an old daemon gets a loud answer
    {"v": 1, "op": "scatter"}          # whale scatter/gather introspection
    {"v": 1, "op": "scatter",          # (balancer-only: a `balance
     "id": "w-ab12-1"}                 # --scatter` front end answers with
                                       # per-shard state; daemons reject it
                                       # explicitly — they execute shard
                                       # sub-jobs, they never plan them —
                                       # and daemons predating the op
                                       # reject it cleanly with "unknown op
                                       # 'scatter'", docs/serving.md
                                       # "Scatter/gather")

Responses are ``{"v": 1, "ok": true, ...}`` or
``{"v": 1, "ok": false, "error": "<reason>"}``. Submit acceptance returns
the job record; admission rejection is ``ok: false`` with the reason
(queue full / draining) so a load balancer can tell backpressure from
breakage. A ``dedupe`` key makes submission idempotent: resubmitting the
same key — e.g. a client retrying across a daemon restart — returns the
original job record (``"deduped": true``) instead of running the command
twice; keys survive restarts via the job journal (docs/serving.md).

Malformed frames (bad JSON, not an object, unknown op, missing fields) get
an error response; oversized frames (> ``max_frame_bytes``, default 1 MiB)
get an error response and the connection is closed — the daemon must never
buffer unbounded garbage from a confused client.

The frames are byte-equal to the JAX package's (``encode_frame`` sorts
keys and uses compact separators), so a client of either package talks to
a daemon of either.

Version negotiation for the observability fields: ``traceparent`` and the
hop timestamps are OPTIONAL submit fields under the same ``v: 1`` schema,
because :func:`validate_request` deliberately ignores submit fields it
does not know — an old daemon receiving them executes the job exactly as
before (the context is garnish), and a new daemon receiving a frame
without them runs untraced. A *malformed* traceparent (wrong shape,
non-hex, all-zero ids) or a non-numeric hop timestamp is likewise IGNORED
— dropped at parse, never a rejection — so telemetry can never fail a
submission (docs/observability.md "Fleet tracing & attribution").
"""

import json

PROTOCOL_VERSION = 1

#: Hard cap on one frame's bytes (newline included). Large enough for any
#: realistic argv, small enough that a garbage stream cannot balloon the
#: daemon's memory. Override with serve --max-frame-bytes.
MAX_FRAME_BYTES = 1 << 20

OPS = frozenset({"submit", "status", "cancel", "drain", "shutdown", "ping",
                 "stats", "hello", "scatter"})

#: Priority classes, best-first. FIFO within a class.
PRIORITIES = ("high", "normal", "low")
DEFAULT_PRIORITY = "normal"


class ProtocolError(ValueError):
    """A frame this protocol refuses to act on (reason in str())."""


def encode_frame(obj: dict) -> bytes:
    """One JSON object as a newline-terminated wire frame."""
    return json.dumps(obj, separators=(",", ":"), sort_keys=True).encode() \
        + b"\n"


def decode_frame(line: bytes) -> dict:
    """Parse one frame; raises :class:`ProtocolError` with a diagnostic."""
    try:
        obj = json.loads(line)
    except ValueError as e:
        raise ProtocolError(f"malformed frame: not valid JSON ({e})")
    if not isinstance(obj, dict):
        raise ProtocolError(
            f"malformed frame: expected a JSON object, got "
            f"{type(obj).__name__}")
    return obj


def read_frame(stream, max_bytes: int = MAX_FRAME_BYTES):
    """Read one frame from a binary stream (``socket.makefile('rb')``).

    Returns the decoded dict, or None on clean EOF (peer closed between
    frames). Raises :class:`ProtocolError` for an oversized frame or a
    stream that ends mid-frame."""
    line = stream.readline(max_bytes + 1)
    if not line:
        return None
    if len(line) > max_bytes:
        raise ProtocolError(
            f"oversized frame: > {max_bytes} bytes (limit includes the "
            "trailing newline)")
    if not line.endswith(b"\n"):
        raise ProtocolError("truncated frame: stream ended before newline")
    return decode_frame(line)


def validate_request(obj: dict):
    """Return None for a well-formed request, else the rejection reason."""
    v = obj.get("v")
    if v != PROTOCOL_VERSION:
        return (f"unsupported protocol version {v!r} "
                f"(this daemon speaks v{PROTOCOL_VERSION})")
    op = obj.get("op")
    if op not in OPS:
        return f"unknown op {op!r} (known: {', '.join(sorted(OPS))})"
    if op == "submit":
        argv = obj.get("argv")
        if (not isinstance(argv, list) or not argv
                or not all(isinstance(a, str) for a in argv)):
            return "submit requires argv: a non-empty list of strings"
        prio = obj.get("priority", DEFAULT_PRIORITY)
        if prio not in PRIORITIES:
            return (f"unknown priority {prio!r} "
                    f"(known: {', '.join(PRIORITIES)})")
        argv0 = obj.get("argv0")
        if argv0 is not None and not isinstance(argv0, str):
            return "argv0 must be a string"
        dedupe = obj.get("dedupe")
        if dedupe is not None and (not isinstance(dedupe, str)
                                   or not dedupe):
            return "dedupe must be a non-empty string"
        client = obj.get("client")
        if client is not None and (not isinstance(client, str)
                                   or not client):
            return "client must be a non-empty string"
        shard = obj.get("shard")
        if shard is not None and not isinstance(shard, dict):
            return "shard must be an object (whale/index/count/axis)"
    if op == "hello":
        token = obj.get("token")
        if token is not None and not isinstance(token, str):
            return "hello token must be a string"
    if op in ("cancel",) and not isinstance(obj.get("id"), str):
        return f"{op} requires id: a job id string"
    if "id" in obj and obj["id"] is not None \
            and not isinstance(obj["id"], str):
        return "id must be a string"
    return None


def ok_response(**fields) -> dict:
    return {"v": PROTOCOL_VERSION, "ok": True, **fields}


def error_response(reason: str, **fields) -> dict:
    return {"v": PROTOCOL_VERSION, "ok": False, "error": reason, **fields}
