"""Serve transport abstraction: Unix-socket and TCP listeners, addresses,
the client retry policy, and the shared frame-serving loop.

The same newline-JSON wire protocol travels over a Unix socket on one host
and over TCP between hosts. This module keeps every transport concern in
one place:

- **Addresses** — ``unix:/path/to.sock`` or ``tcp:host:port`` (a bare path
  is a Unix socket). :func:`parse_address` is loud about anything else;
  :func:`connect` dials either kind.
- **Listeners** — :func:`claim_unix_socket` (a stale socket is replaced,
  a live one refused) and :class:`TcpListener`. A busy TCP
  port raises ``OSError`` at bind time so the CLI can exit 2 before any
  device warm-up, exactly like ``--metrics-port``.
- **The frame server** — :class:`FrameServer` runs the accept loops for
  any number of listeners and applies the per-connection contract: read/
  write deadlines (TCP), a connection cap (over-cap connections are
  answered with one error frame and closed, never silently dropped), and
  the shared-secret handshake. A listener bound to a non-loopback address
  REQUIRES the handshake: the first frame on each connection must be
  ``{"v": 1, "op": "hello", "token": <secret>}`` or the connection is
  rejected — the wire carries argv that the daemon will execute, so an
  open port must never accept work from strangers. Loopback and Unix
  listeners accept (but do not require) the handshake.
- **RetryPolicy** — capped, jittered exponential backoff for the client's
  idempotent operations, replacing the fixed single 0.5 s reconnect.

Nothing here knows about jobs: the server side takes a ``handle(request)
-> response`` callable (the daemon's dispatch) and a couple of lifecycle
hooks.
"""

import errno
import logging
import os
import socket
import threading
import time

from . import protocol

log = logging.getLogger("fgumi_tpu_torch")

#: env fallback for the shared-secret handshake token (serve --token-file /
#: balance --token-file / submit --token-file override it per process).
TOKEN_ENV = "FGUMI_TPU_SERVE_TOKEN"

#: default per-connection read/write deadline on TCP connections (seconds).
DEFAULT_IO_TIMEOUT_S = 30.0

#: default concurrent-connection cap on TCP listeners.
DEFAULT_CONN_CAP = 64


class SocketBusy(RuntimeError):
    """Another live daemon already serves this socket path."""


# ---------------------------------------------------------------------------
# addresses


def parse_address(addr: str):
    """``unix:/path`` / ``tcp:host:port`` / bare path -> (kind, target).

    Returns ``("unix", path)`` or ``("tcp", (host, port))``. A bare string
    with no scheme is a Unix socket path (the pre-fleet client spelling
    keeps working). Raises ``ValueError`` with a diagnostic otherwise."""
    if not isinstance(addr, str) or not addr:
        raise ValueError(f"empty serve address {addr!r}")
    if addr.startswith("unix:"):
        path = addr[len("unix:"):]
        if not path:
            raise ValueError(f"unix address without a path: {addr!r}")
        return "unix", path
    if addr.startswith("tcp:"):
        rest = addr[len("tcp:"):]
        host, sep, port_s = rest.rpartition(":")
        if not sep or not host:
            raise ValueError(
                f"tcp address must be tcp:host:port, got {addr!r}")
        try:
            port = int(port_s)
        except ValueError:
            raise ValueError(f"tcp port must be an integer, got {port_s!r}")
        if not 0 <= port <= 65535:
            raise ValueError(f"tcp port {port} out of range 0..65535")
        return "tcp", (host, port)
    if ":" in addr.split(os.sep)[0] and not addr.startswith(("/", ".")):
        # "host:1234" is almost certainly a mistyped tcp address; a Unix
        # socket named like that would be legal but is worth refusing
        # loudly over silently creating a weird socket file
        raise ValueError(
            f"ambiguous address {addr!r}: use unix:PATH or tcp:HOST:PORT")
    return "unix", addr


def is_loopback(host: str) -> bool:
    """True when ``host`` can only be reached from this machine. The
    empty host is NOT loopback — binding "" is INADDR_ANY (every
    interface), so it must hit the token requirement."""
    if not host:
        return False
    if host == "localhost":
        return True
    try:
        infos = socket.getaddrinfo(host, None)
    except socket.gaierror:
        return False  # unresolvable: treat as remote (require the token)
    ips = {info[4][0] for info in infos}
    return bool(ips) and all(
        ip == "::1" or ip.startswith("127.") for ip in ips)


def connect(addr: str, timeout: float = None) -> socket.socket:
    """Dial a serve address; returns the connected socket. ``OSError``
    surfaces to the caller (the client wraps it)."""
    kind, target = parse_address(addr)
    if kind == "unix":
        conn = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        if timeout is not None:
            conn.settimeout(timeout)
        conn.connect(target)
        return conn
    host, port = target
    conn = socket.create_connection((host, port), timeout=timeout)
    try:
        conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    except OSError:
        pass  # nagle stays on; correctness is unaffected
    return conn


def load_token(token_file: str = None) -> str:
    """The shared-secret handshake token: ``--token-file`` wins, else the
    ``FGUMI_TPU_SERVE_TOKEN`` env var, else None. A token file's content
    is stripped of surrounding whitespace (trailing newline from echo)."""
    if token_file:
        with open(token_file, "r") as f:
            token = f.read().strip()
        if not token:
            raise ValueError(f"token file {token_file} is empty")
        return token
    token = os.environ.get(TOKEN_ENV, "").strip()
    return token or None


# ---------------------------------------------------------------------------
# retry policy


class RetryPolicy:
    """Capped jittered exponential backoff for idempotent client requests.

    ``attempts`` is the TOTAL number of tries (1 = never retry). Delay
    before retry ``k`` (1-based) is ``min(base_s * multiplier**(k-1),
    cap_s)`` scaled by a uniform jitter in ``[1 - jitter, 1]`` so a fleet
    of clients bounced by the same daemon restart does not reconnect in
    lockstep. ``rng`` is injectable for deterministic tests."""

    def __init__(self, attempts: int = 4, base_s: float = 0.25,
                 cap_s: float = 5.0, multiplier: float = 2.0,
                 jitter: float = 0.5, rng=None):
        if attempts < 1:
            raise ValueError("attempts must be >= 1")
        if not 0.0 <= jitter <= 1.0:
            raise ValueError("jitter must be in [0, 1]")
        self.attempts = int(attempts)
        self.base_s = float(base_s)
        self.cap_s = float(cap_s)
        self.multiplier = float(multiplier)
        self.jitter = float(jitter)
        if rng is None:
            import random

            rng = random.random
        self._rng = rng

    def delay_s(self, retry_index: int) -> float:
        """Backoff before the ``retry_index``-th retry (1-based)."""
        raw = min(self.base_s * self.multiplier ** (retry_index - 1),
                  self.cap_s)
        return raw * (1.0 - self.jitter * self._rng())

    @classmethod
    def none(cls) -> "RetryPolicy":
        """Never retry (non-idempotent operations)."""
        return cls(attempts=1)

    def __repr__(self):
        return (f"RetryPolicy(attempts={self.attempts}, "
                f"base_s={self.base_s}, cap_s={self.cap_s})")


# ---------------------------------------------------------------------------
# listeners


def claim_unix_socket(path: str) -> socket.socket:
    """Bind a Unix listener, replacing a *dead* daemon's socket file only.

    Stale means the connect is actively refused (no listener behind the
    file). A timeout or transient error (daemon stopped in a debugger,
    backlog full under a client burst) is treated as BUSY — unlinking a
    live daemon's socket would split-brain the service and that daemon's
    exit would then delete *our* socket file."""
    if os.path.exists(path):
        probe = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        try:
            probe.settimeout(1.0)
            probe.connect(path)
        except (ConnectionRefusedError, FileNotFoundError):
            log.info("serve: replacing stale socket %s", path)
            try:
                os.unlink(path)
            except FileNotFoundError:
                pass
        except OSError as e:
            raise SocketBusy(
                f"daemon at {path} did not answer ({e}); "
                "not replacing a possibly-live socket")
        else:
            raise SocketBusy(f"another daemon is already serving {path}")
        finally:
            probe.close()
    sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    sock.bind(path)
    sock.listen(16)
    return sock


class Listener:
    """One bound listening socket plus its per-connection contract."""

    kind = None

    def __init__(self):
        self.sock = None
        #: per-connection read/write deadline (None = no deadline)
        self.io_timeout_s = None
        #: concurrent-connection cap (None = unlimited)
        self.conn_cap = None
        #: connections must open with a valid hello frame before any
        #: other op is answered
        self.require_auth = False

    def describe(self) -> str:
        raise NotImplementedError

    def close(self):
        if self.sock is not None:
            try:
                self.sock.close()
            except OSError:
                pass
            self.sock = None


class UnixListener(Listener):
    kind = "unix"

    def __init__(self, path: str):
        super().__init__()
        self.path = path
        self._bound = False

    def bind(self):
        if self.sock is None:
            self.sock = claim_unix_socket(self.path)
            self._bound = True
        return self

    def describe(self) -> str:
        return f"unix:{self.path}"

    def unlink(self):
        """Remove the socket file — ONLY if this listener bound it. A
        failed duplicate start (SocketBusy) must never delete the LIVE
        daemon's socket on its way out."""
        if not self._bound:
            return
        try:
            os.unlink(self.path)
        except OSError as e:
            if e.errno != errno.ENOENT:
                log.debug("serve: could not remove socket %s: %s",
                          self.path, e)


class TcpListener(Listener):
    """TCP listener with deadlines, a connection cap, and handshake auth.

    ``require_auth`` defaults to "is the bind address non-loopback":
    exposing the wire protocol beyond this machine without the
    shared-secret handshake is refused at construction (``token`` must be
    set), because a submit frame is arbitrary command execution."""

    kind = "tcp"

    def __init__(self, host: str, port: int, token: str = None,
                 io_timeout_s: float = DEFAULT_IO_TIMEOUT_S,
                 conn_cap: int = DEFAULT_CONN_CAP,
                 require_auth: bool = None):
        super().__init__()
        self.host = host
        self.port = int(port)
        self.token = token
        self.io_timeout_s = io_timeout_s if io_timeout_s and \
            io_timeout_s > 0 else None
        # 0/None = unlimited; negative is a caller bug (it would reject
        # every connection), refused loudly
        if conn_cap is not None and conn_cap < 0:
            raise ValueError(f"conn_cap must be >= 0, got {conn_cap}")
        self.conn_cap = int(conn_cap) if conn_cap else None
        if require_auth is None:
            # non-loopback binds MUST authenticate; a loopback bind with a
            # configured token enforces it too (configuring a secret and
            # not checking it would be a trap)
            require_auth = not is_loopback(host) or token is not None
        self.require_auth = bool(require_auth)
        if self.require_auth and not token:
            raise ValueError(
                f"refusing to listen on non-loopback tcp:{host}:{port} "
                "without a handshake token (--token-file or "
                f"{TOKEN_ENV}): the wire protocol executes submitted "
                "commands")

    def bind(self):
        """Bind + listen. A busy port raises ``OSError`` here so the CLI
        can exit 2 before the device warm-up (the --metrics-port
        discipline)."""
        if self.sock is not None:
            return self
        sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        try:
            # REUSEADDR skips TIME_WAIT on restart; it does NOT allow two
            # live listeners on one port, so busy-port still fails loudly
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            sock.bind((self.host, self.port))
            sock.listen(64)
        except OSError:
            sock.close()
            raise
        self.sock = sock
        if self.port == 0:
            self.port = sock.getsockname()[1]
        return self

    def describe(self) -> str:
        return f"tcp:{self.host}:{self.port}"


# ---------------------------------------------------------------------------
# the frame server


class FrameServer:
    """Accept loops + per-connection frame serving for N listeners.

    ``handle(request) -> response`` is the transport-independent dispatch
    (the daemon's or balancer's). ``on_shutdown()`` fires after a
    successful ``shutdown`` response is on the wire — arming the exit
    *after* the reply so an idle process cannot beat its own sendall.
    """

    def __init__(self, handle, listeners, max_frame_bytes: int,
                 on_shutdown=None, name: str = "fgumi-serve"):
        self._handle = handle
        self.listeners = list(listeners)
        self.max_frame_bytes = max_frame_bytes
        self._on_shutdown = on_shutdown
        self._name = name
        self._threads = []
        self._conn_lock = threading.Lock()
        #: live connections PER listener (keyed by identity): the cap is
        #: a per-listener contract — local Unix clients must never eat
        #: the TCP listener's budget
        self._live_by_listener = {id(lst): 0 for lst in self.listeners}
        self.started = False

    # -- lifecycle ----------------------------------------------------------

    def bind(self):
        for lst in self.listeners:
            lst.bind()
        return self

    def start(self):
        if self.started:
            return
        self.started = True
        self.bind()
        for i, lst in enumerate(self.listeners):
            t = threading.Thread(target=self._accept_loop, args=(lst,),
                                 name=f"{self._name}-accept-{i}",
                                 daemon=True)
            t.start()
            self._threads.append(t)

    def close(self):
        for lst in self.listeners:
            lst.close()

    def live_connections(self) -> int:
        with self._conn_lock:
            return sum(self._live_by_listener.values())

    # -- accept + serve -----------------------------------------------------

    def _accept_loop(self, lst: Listener):
        # keep accepting through a drain: clients must be able to poll
        # status while queued/running jobs finish; the loop ends when
        # close() closes the listener
        while True:
            sock = lst.sock  # close() nulls the attribute concurrently
            if sock is None:
                return
            try:
                conn, _ = sock.accept()
            except OSError:
                return  # listener closed during shutdown
            with self._conn_lock:
                held = self._live_by_listener[id(lst)]
                over = lst.conn_cap is not None and held >= lst.conn_cap
                if not over:
                    self._live_by_listener[id(lst)] = held + 1
            if over:
                self._reject_over_cap(conn, lst)
                continue
            t = threading.Thread(target=self._serve_connection,
                                 args=(conn, lst),
                                 name=f"{self._name}-conn", daemon=True)
            t.start()

    def _reject_over_cap(self, conn, lst):
        """One explicit error frame, then close — a silently dropped
        connection looks like a network fault and triggers client
        retries; an explicit refusal is actionable."""
        from ..observe.metrics import METRICS

        METRICS.inc("serve.transport.rejected_cap")
        try:
            conn.settimeout(2.0)
            conn.sendall(protocol.encode_frame(protocol.error_response(
                f"connection limit reached ({lst.conn_cap} concurrent "
                f"connections on {lst.describe()})")))
        except OSError:
            pass
        finally:
            conn.close()

    def _serve_connection(self, conn: socket.socket, lst: Listener):
        from ..observe.metrics import METRICS

        if lst.kind == "tcp":
            METRICS.inc("serve.transport.tcp.connections")
        if lst.io_timeout_s is not None:
            conn.settimeout(lst.io_timeout_s)
        authed = not lst.require_auth
        stream = conn.makefile("rb")
        try:
            while True:
                try:
                    req = protocol.read_frame(stream, self.max_frame_bytes)
                except protocol.ProtocolError as e:
                    self._send(conn, protocol.error_response(str(e)))
                    return  # framing is gone; close rather than resync
                except socket.timeout:
                    METRICS.inc("serve.transport.timeouts")
                    log.debug("serve: connection idle past %.0fs deadline; "
                              "closing", lst.io_timeout_s)
                    return
                if req is None:
                    return
                if not authed:
                    # the ONLY acceptable first frame is a valid hello;
                    # anything else is answered once and the connection
                    # closed — an unauthenticated peer never reaches the
                    # op dispatch
                    if req.get("op") != "hello":
                        METRICS.inc("serve.transport.rejected_auth")
                        self._send(conn, protocol.error_response(
                            "authentication required: this listener "
                            "requires a handshake token (send a hello "
                            "frame with the shared secret first)"))
                        return
                    resp = self._handle(req)
                    self._send(conn, resp)
                    if not resp.get("ok"):
                        METRICS.inc("serve.transport.rejected_auth")
                        return  # bad token: one answer, then hang up
                    authed = True
                    continue
                resp = self._handle(req)
                self._send(conn, resp)
                # arm shutdown only AFTER the reply is on the wire: the
                # main thread exits the process once the pool quiesces,
                # which on an idle daemon can beat this thread's sendall
                # and reset the client mid-response
                if req.get("op") == "shutdown" and resp.get("ok") \
                        and self._on_shutdown is not None:
                    self._on_shutdown()
        except OSError:
            pass  # peer went away mid-frame; nothing to answer
        finally:
            with self._conn_lock:
                self._live_by_listener[id(lst)] -= 1
            try:
                stream.close()
            except OSError:
                pass
            conn.close()

    @staticmethod
    def _send(conn, resp: dict):
        try:
            conn.sendall(protocol.encode_frame(resp))
        except OSError:
            pass


# ---------------------------------------------------------------------------
# handshake helpers (shared by daemon + balancer dispatch)


def hello_response(tool: str, expected_token: str, req: dict) -> dict:
    """Answer one hello frame. With a configured token, the frame's token
    must match (constant-time compare); without one the listener is open
    and any hello is acknowledged. ``server_unix`` (the server's wall
    clock at answer time) rides along so the client can estimate the
    host clock offset — ``fgumi-tpu trace-merge`` uses the estimate to
    align per-host trace timelines; old clients simply ignore it."""
    import hmac

    token = req.get("token")
    if expected_token:
        if not isinstance(token, str) or not hmac.compare_digest(
                token, expected_token):
            return protocol.error_response(
                "invalid handshake token")
        return protocol.ok_response(tool=tool, pid=os.getpid(),
                                    auth="token",
                                    server_unix=round(time.time(), 6))
    return protocol.ok_response(tool=tool, pid=os.getpid(), auth="open",
                                server_unix=round(time.time(), 6))


def clock_offset_estimate(hello_resp: dict, t_send: float,
                          t_recv: float):
    """Estimated ``local_clock - server_clock`` seconds from one
    handshake round trip: the server stamped ``server_unix`` mid-trip, so
    comparing it against the local midpoint bounds the skew by half the
    RTT — plenty for aligning trace timelines (milliseconds matter,
    microseconds don't). None when the server predates the field."""
    server_unix = hello_resp.get("server_unix")
    if not isinstance(server_unix, (int, float)) \
            or isinstance(server_unix, bool):
        return None
    return round((t_send + t_recv) / 2.0 - float(server_unix), 6)


def client_hello(stream, conn, token: str,
                 max_frame_bytes: int = protocol.MAX_FRAME_BYTES):
    """Client side of the handshake: send hello, require an ok answer.
    Returns the response; raises ``protocol.ProtocolError`` on a refusal
    so the caller can surface the daemon's reason verbatim. The response
    carries ``clock_offset_s`` (local minus server wall clock, estimated
    from the round trip) when the server stamps ``server_unix``."""
    t_send = time.time()
    conn.sendall(protocol.encode_frame(
        {"v": protocol.PROTOCOL_VERSION, "op": "hello", "token": token}))
    resp = protocol.read_frame(stream, max_frame_bytes)
    t_recv = time.time()
    if resp is None:
        raise protocol.ProtocolError(
            "connection closed during the handshake")
    if not resp.get("ok"):
        raise protocol.ProtocolError(
            f"handshake rejected: {resp.get('error', 'no reason given')}")
    offset = clock_offset_estimate(resp, t_send, t_recv)
    if offset is not None:
        resp["clock_offset_s"] = offset
        from ..observe import trace as trace_mod

        # stamp the estimate onto the active tracer (if any): its export
        # then carries clock.offset_estimate_s and trace-merge aligns
        # this host's timeline onto the server's clock automatically
        trace_mod.set_clock_offset(offset)
    return resp


__all__ = [
    "DEFAULT_CONN_CAP", "DEFAULT_IO_TIMEOUT_S", "FrameServer", "Listener",
    "RetryPolicy", "SocketBusy", "TcpListener", "TOKEN_ENV", "UnixListener",
    "claim_unix_socket", "client_hello", "clock_offset_estimate",
    "connect", "hello_response", "is_loopback",
    "load_token", "parse_address",
]
