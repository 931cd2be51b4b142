"""Batched consensus over ragged UMI families on the GPU (PyTorch + CUDA).

Re-expresses the reference's per-position scalar hot loop (crates/fgumi-
consensus/src/base_builder.rs:612-644,795-852) as one kernel launch over a
whole batch of families laid out as dense (N, L) read rows with per-family
row offsets: codes/quals -> per-position winner/qual/depth/errors (J, L).

Numerics strategy: the device computes in f32 from per-quality tables
precomputed in f64 on the host, with a *suspect mask*: positions whose result
could round to a different integer Phred (or whose winner margin is within
f32 noise) are flagged and recomputed on the host by the f64 oracle
(ops/oracle.py). Outside that guard band the device answer is exact, so the
resolved output is integer-identical to the oracle by construction.

Key algebraic reformulation: the four lane likelihoods are ll[b] = S_err +
C[b], where S_err (the sum of ln(err/3) over valid observations) is lane-
independent and C[b] = sum over observations matching b of (ln_correct -
ln_err) >= 0. Winner and posterior depend only on lane differences, so S_err
is never formed: gaps = C_max - C[b], s = sum_losers exp(-gap), and
ln_consensus_error = ln(s) - log1p(s).

Suspect guard band — derivation. Sources of f32 error in a lane sum C[b] of
delta[q] terms (f64 tables rounded once to f32):
  (1) table rounding: |fl(delta) - delta| <= eps32/2 * delta per term;
  (2) accumulation: summing n nonnegative terms in ANY order has error
      <= eps32 * n * sum(x_i) to first order (every partial sum is <= the
      final sum), and sum(x_i) = C[b] <= max_c.
A lane has at most `depth` matching observations, so |C_err| <= eps32 *
(depth + 1) * max_c, and a gap (one more subtraction) obeys
|g_err| <= eps_gap = eps32 * (depth + 2) * (1 + max_c). Downstream,
|d ln_cons_err| <= 2 * eps_gap + O(eps32), so the Phred error is at most
PHRED_PER_LN * 2 * eps_gap plus a few 1-ulp evaluations (~2.6e-6 Phred),
absorbed by _QUAL_GUARD_FLOOR = 3e-4 (kept below the 0.001 precision nudge).
Gates (any one sends the position to the f64 oracle): tie (margin <=
2 * eps_gap + _TIE_GUARD_FLOOR), quality (phred_f within err_phred +
_QUAL_GUARD_FLOOR of an integer), branch (|diff - 6| within the gap error of
the two-trials quick-path switch), nonfinite (a Q0-class -inf entry).

Because the band holds for any summation order, the CUDA kernel (row-serial
per thread), the plain PyTorch version (index_add_, atomics on CUDA) and the
JAX package's kernels may flag different suspect sets, yet agree on every
non-suspect position and, after the oracle patch, everywhere.

A dispatch enqueues on the current CUDA stream (the same default stream
on every thread, so launches stay in order): the host builds the wire
layout, stages it in a pinned buffer, copies it non-blocking and launches;
the resolve fetches the packed result (1.25 B per column + 4 B of
depth/errors). Dispatches may overlap: the stage runner
(``pipeline.run_stages``) resolves batch N on a worker while batch N + 1 is
dispatched, so each upload slot draws on a small pool of pinned buffers,
and a buffer is written again only once the event recorded after the copy
that read it has completed. Each dispatch carries its own upload stamp
(:class:`Dispatch`), every counter a resolve updates takes the kernel's
lock, and :data:`DEVICE_STATS` accounts the dispatches of a run for
``--stats``.

The fused consensus→filter route (``--device-filter``, K1-f) fetches only a
28 B stats row per consensus read; its masked and raw columns stay on the
device as plain tensors until the filter stage gathers the survivors
(``filter_gather_filtered``) and the suspect rows
(``filter_resolve_suspect_rows``).

The duplex route (``resident_thresholds``, K1-r) fetches K1's planes and
keeps the thresholded bases/quals and the lane observation counts on the
device in a :class:`ResidentHandles` for the strand combine
(:func:`duplex_combine_device`, K5); the CODEC combine runs through
:func:`codec_combine_device` (K6).

Resilience (the reference's ``device_retry_call`` and
``_recover_segments``): every upload and launch of K1, K1-f, K1-r, K1-p2,
K5 and K6 and every filter gather runs through :func:`device_retry_call`,
a bounded retry with exponential backoff (``FGUMI_TPU_DEVICE_RETRIES``,
default 3; ``FGUMI_TPU_DEVICE_BACKOFF_S``, default 0.05 s, doubling to at
most 2 s). Only an injected fault is worth another attempt: a real CUDA
error propagates at once (:class:`DeviceFailure`, exit 1), also where it
surfaces later, at the fetch of an asynchronous launch's results. An
out-of-memory (a real ``torch.cuda.OutOfMemoryError`` or an injected one)
is kept in the wire dispatch's handle, and its resolve halves the batch at
a family boundary and re-dispatches both halves on the same device and
route, up to ``FGUMI_TPU_MAX_SPLITS`` (default 4) deep; a split K1-r
batch joins its halves' resident arrays, so its strand combine runs on K5
as an unsplit batch's does. Unlike the reference, nothing
finishes a failed batch on a host engine: a retry budget that runs out or
an out-of-memory that cannot split re-raises, and the command publishes no
output.

Telemetry: each launch (K1, K1-f, K1-r, K1-p2, K5, K6) is a
``device.dispatch`` span (``what=`` the kernel, ``attempt=`` the retry
attempt, 0 first) around its upload and enqueue, and each wait for a
result a ``device.fetch`` span. A
CUDA launch returns before the kernel runs, so the card's time shows up
inside ``device.fetch``. Each resolved dispatch feeds the
``device.dispatch.{fetch_s,fetch_bytes,wall_s}`` histograms and the flight
recorder's ring. :data:`DEVICE_STATS` resolves the active command's
telemetry scope (``observe/scope.py``).

Device weather: every :func:`device_retry_call` feeds the process's
circuit breaker (``ops/breaker.py``): a clean call a success, a retry
budget that ran out a transient failure. :func:`device_canary` is the
serve daemon's health round trip through K7 (``ops/canary.py``); a clean
one feeds the offload router's link estimate.

The feeder and dispatch deadlines (the reference's ``DeviceFeeder``,
``DispatchTicket`` and ``dispatch_deadline_s``): every consensus
dispatch's upload and launch run on one feeder thread
(:data:`DEVICE_FEEDER`), in submission order, with at most
``FGUMI_TPU_FEEDER_DEPTH`` (default :data:`FEEDER_DEPTH`, at least 2)
dispatches launched and unresolved within ``FGUMI_TPU_FEEDER_BYTES``
(default 256 MiB) of uploads. A handle dropped unresolved (a runner's
error path) gives its slot back when it is collected.
On the card the feeder also records an event after the launch. A resolve
waits for the launch and polls that event under the dispatch's deadline
(``FGUMI_TPU_DISPATCH_DEADLINE_S``: ``CEILING`` or ``FLOOR:CEILING``,
default 30:300 s; the cost model's predicted wall times
``FGUMI_TPU_DEADLINE_FACTOR``, default 20, clamped; ``0``/``off``
disables), so the thread that watches the deadline is never the one that
is stuck, whether the launch hangs on the host or the card never signals
its event; only then does it copy the results to the host, on a stream
of its own, so the copy waits for no later launch. A dispatch past its
deadline is abandoned (its late result is
dropped when it comes), counted (``deadline_fallbacks`` in DeviceStats,
the JAX package's key: here it counts abandoned dispatches), fed to the
breaker, and raised as :class:`DeadlineExceeded`: the command exits 3
(an injected hang) or 1 and publishes nothing; the JAX package would
finish the batch on its host engine.

Routing (``ops/router.py``): :func:`route_and_call_segments` and the
engines ask ``ROUTER.decide_batch``; a host batch runs on the native f64
engine (:meth:`ConsensusKernel.host_call_segments`). The result sentinel
(``ops/sentinel.py``) taps every resolved wire dispatch, and the
cross-job coalescer (``ops/coalesce.py``) may merge plain K1/K1-p2
dispatches of concurrent serve jobs into one launch.
"""

import collections
import contextlib
import contextvars
import gc
import logging
import os
import threading
import time
import weakref

import numpy as np
import torch

from ..constants import MIN_PHRED, N_CODE
from ..observe.trace import NULL_SPAN, span
from . import combine as C
from . import cuda_kernel
from . import wire as W
from .breaker import BREAKER
from .tables import QualityTables, delta94

log = logging.getLogger("fgumi_tpu_torch")

#: ResidentHandles made and not yet released (a run ends with 0)
LIVE_RESIDENTS = 0
_RESIDENTS_LOCK = threading.Lock()

#: pinned staging buffers an upload slot holds (uploads of one slot that
#: may be in flight at once before a dispatch waits for the oldest)
STAGING_DEPTH = 4

#: consensus dispatches launched and unresolved at once, by default
#: (``FGUMI_TPU_FEEDER_DEPTH``; the stage runner holds fewer)
FEEDER_DEPTH = 8

#: consensus dispatches of every command in this process that are launched
#: and not yet fetched (a handle dropped unfetched, by a failed command,
#: leaves with its last reference)
_LIVE_DISPATCHES = weakref.WeakSet()
_LIVE_LOCK = threading.Lock()


def dispatches_in_flight() -> int:
    """Consensus dispatches in flight in this process, across commands:
    the health monitor skips its canary while real work is on the card."""
    with _LIVE_LOCK:
        return len(_LIVE_DISPATCHES)


class ResidentHandles:
    """K1-r's resident outputs (tb, tq, obs) kept on the device for the
    duplex strand combine. Every consumer calls :meth:`release` once the
    combine is done (idempotent, from any thread): the tensors are dropped
    and :data:`LIVE_RESIDENTS` goes down by one."""

    __slots__ = ("arrays", "_released")

    def __init__(self, arrays):
        global LIVE_RESIDENTS
        self.arrays = tuple(arrays)
        self._released = False
        with _RESIDENTS_LOCK:
            LIVE_RESIDENTS += 1

    def release(self):
        """Drop the device tensors (once; later calls do nothing)."""
        global LIVE_RESIDENTS
        with _RESIDENTS_LOCK:
            if self._released:
                return
            self._released = True
            LIVE_RESIDENTS -= 1
        self.arrays = None

    @classmethod
    def join(cls, parts):
        """One handle over the arrays of ``parts`` (the halves of a split
        batch) joined along the family axis, in order. The parts are
        released, and each of their arrays is dropped once it is copied."""
        cols = [list(p.arrays) for p in parts]
        for p in parts:
            p.release()
        arrays = []
        for i in range(len(cols[0])):
            arrays.append(torch.cat([c[i] for c in cols]))
            for c in cols:
                c[i] = None
        return cls(arrays)


class DeviceStats:
    """The device boundary of a run, for ``--stats`` (the reference's
    DeviceStats, trimmed): consensus dispatches, host seconds blocked in
    their fetches, bytes uploaded and fetched, dispatches in flight (and
    the most at once), and a timeline of the first
    :attr:`TIMELINE_CAP` dispatches. Thread-safe; one instance a
    command (its telemetry scope's, which :data:`DEVICE_STATS` resolves)
    aggregates every kernel object."""

    TIMELINE_CAP = 4096

    def __init__(self):
        self._lock = threading.Lock()
        self.reset()

    def reset(self):
        """Zero the counters (the global view of a command that never
        touched the device)."""
        with self._lock:
            self.dispatches = 0
            self.fetch_wait_s = 0.0
            self.bytes_uploaded = 0
            self.bytes_fetched = 0
            self.in_flight = 0
            self.in_flight_peak = 0
            self.device_types = set()
            # resilience: retried attempts and out-of-memory halvings
            self.retries = 0
            self.batch_splits = 0
            # dispatches abandoned at their deadline (the JAX package's
            # key; the port finishes none of them on the host)
            self.deadline_fallbacks = 0
            # the offload router's decisions (ops/router.py)
            self.route_device = 0
            self.route_host = 0
            # the feeder queue's high-water mark
            self.feeder_queue_peak = 0
            self.timeline = []
            self._t0 = time.monotonic()

    def begin(self, device: torch.device, up_bytes: int) -> int:
        """Count a dispatch in flight (uploaded and launched, not yet
        fetched); returns its timeline slot (-1 past the cap)."""
        with self._lock:
            self.dispatches += 1
            self.in_flight += 1
            self.in_flight_peak = max(self.in_flight_peak, self.in_flight)
            self.bytes_uploaded += int(up_bytes)
            self.device_types.add(device.type)
            if len(self.timeline) >= self.TIMELINE_CAP:
                return -1
            self.timeline.append({
                "t_dispatch": round(time.monotonic() - self._t0, 4),
                "up_bytes": int(up_bytes)})
            return len(self.timeline) - 1

    def end(self, slot: int, down_bytes: int, wait_s: float):
        """A dispatch's fetch: ``wait_s`` host seconds blocked in it."""
        with self._lock:
            self.in_flight -= 1
            self.fetch_wait_s += wait_s
            self.bytes_fetched += int(down_bytes)
            if 0 <= slot < len(self.timeline):
                self.timeline[slot].update(
                    t_fetched=round(time.monotonic() - self._t0, 4),
                    down_bytes=int(down_bytes),
                    fetch_wait_s=round(wait_s, 4))

    def note_upload(self, slot: int, upload_s: float):
        """A dispatch's upload + launch wall on the feeder thread."""
        with self._lock:
            if 0 <= slot < len(self.timeline):
                self.timeline[slot]["upload_s"] = round(upload_s, 6)

    def note_pred(self, slot: int, pred_s: float):
        """The cost model's predicted dispatch wall (ops/router.py)."""
        with self._lock:
            if 0 <= slot < len(self.timeline):
                self.timeline[slot]["pred_s"] = round(pred_s, 4)

    def timeline_entry(self, slot: int):
        """A copy of one timeline slot, or None past the cap."""
        with self._lock:
            if 0 <= slot < len(self.timeline):
                return dict(self.timeline[slot])
            return None

    def in_flight_count(self) -> int:
        with self._lock:
            return self.in_flight

    def add_route(self, side: str):
        with self._lock:
            if side == "device":
                self.route_device += 1
            else:
                self.route_host += 1

    def add_deadline_abandon(self):
        with self._lock:
            self.deadline_fallbacks += 1

    def note_queue_depth(self, depth: int):
        with self._lock:
            self.feeder_queue_peak = max(self.feeder_queue_peak, depth)

    def add_retry(self):
        with self._lock:
            self.retries += 1

    def add_split(self):
        with self._lock:
            self.batch_splits += 1

    def add_fetch(self, down_bytes: int, wait_s: float):
        """A fetch outside a dispatch's own (the fused route's gathers)."""
        with self._lock:
            self.fetch_wait_s += wait_s
            self.bytes_fetched += int(down_bytes)

    def snapshot(self) -> dict:
        with self._lock:
            out = {"dispatches": self.dispatches,
                   "devices": sorted(self.device_types),
                   "fetch_wait_s": self.fetch_wait_s,
                   "bytes_uploaded": self.bytes_uploaded,
                   "bytes_fetched": self.bytes_fetched,
                   "in_flight": self.in_flight,
                   "in_flight_peak": self.in_flight_peak}
            if self.retries:
                out["dispatch_retries"] = self.retries
            if self.batch_splits:
                out["batch_splits"] = self.batch_splits
            if self.deadline_fallbacks:
                out["deadline_fallbacks"] = self.deadline_fallbacks
            if self.route_device or self.route_host:
                out["route_device"] = self.route_device
                out["route_host"] = self.route_host
            if self.feeder_queue_peak:
                out["feeder_queue_depth"] = self.feeder_queue_peak
            return out

    def timeline_snapshot(self) -> list:
        with self._lock:
            return [dict(t) for t in self.timeline]

    def load_from(self, other: "DeviceStats"):
        """Adopt another instance's counters wholesale (a finished
        command's scope becomes the process-global view)."""
        with other._lock:
            state = {k: getattr(other, k) for k in (
                "dispatches", "fetch_wait_s", "bytes_uploaded",
                "bytes_fetched", "in_flight", "in_flight_peak", "retries",
                "batch_splits", "deadline_fallbacks", "route_device",
                "route_host", "feeder_queue_peak", "_t0")}
            state["device_types"] = set(other.device_types)
            state["timeline"] = [dict(t) for t in other.timeline]
        with self._lock:
            for k, v in state.items():
                setattr(self, k, v)

    def format_summary(self, wall_s: float = None) -> str:
        s = self.snapshot()
        parts = [f"device ({','.join(s['devices'])}): {s['dispatches']} "
                 f"dispatches, fetch-wait {s['fetch_wait_s']:.3f}s, "
                 f"{s['bytes_uploaded'] / 1e6:.1f} MB uploaded, "
                 f"{s['bytes_fetched'] / 1e6:.1f} MB fetched, "
                 f"at most {s['in_flight_peak']} in flight"]
        if wall_s:
            parts.append(f"fetch-wait {s['fetch_wait_s'] / wall_s:.2%} of "
                         f"{wall_s:.2f}s wall")
        if s.get("dispatch_retries") or s.get("batch_splits"):
            parts.append(f"{s.get('dispatch_retries', 0)} retries, "
                         f"{s.get('batch_splits', 0)} batch splits")
        return "; ".join(parts)


#: the fallback instance when no telemetry scope is active (library use,
#: tests); a finished command's counters are published onto it
_GLOBAL_DEVICE_STATS = DeviceStats()


class _DeviceStatsProxy:
    """Scope-resolving stand-in for the module-wide DeviceStats: every
    attribute access resolves the active telemetry scope first (one
    DeviceStats per top-level command) and falls back to the process-global
    instance, so two commands run at once never share counters."""

    __slots__ = ()

    @staticmethod
    def _target() -> DeviceStats:
        from ..observe.scope import current_scope

        scope = current_scope()
        if scope is not None:
            return scope.device_stats(DeviceStats)
        return _GLOBAL_DEVICE_STATS

    def __getattr__(self, name):
        return getattr(self._target(), name)


#: the active command's device accounting (``--stats``, the run report)
DEVICE_STATS = _DeviceStatsProxy()


def _observe_dispatch(wall_s: float, fetch_s: float, up: int, down: int):
    """Fold one resolved dispatch into the latency histograms and the
    flight recorder's ring (once per dispatch, never per record)."""
    from ..observe.flight import FLIGHT
    from ..observe.metrics import METRICS

    METRICS.observe("device.dispatch.fetch_s", fetch_s)
    METRICS.observe("device.dispatch.fetch_bytes", down)
    METRICS.observe("device.dispatch.wall_s", wall_s)
    FLIGHT.note("device.dispatch", wall_s=round(wall_s, 4), up_bytes=up,
                down_bytes=down)


def _observe_router(handle, down: int):
    """Feed one resolved dispatch's measured pieces to the offload cost
    model: its upload + launch wall on the feeder and its fetch wait (the
    dispatch's serial occupancy; queue time is priced by the model's
    in-flight term)."""
    from .router import ROUTER

    tl = DEVICE_STATS.timeline_entry(handle.slot)
    if tl is None:
        return
    up_s = tl.get("upload_s", 0.0)
    wait_s = tl.get("fetch_wait_s", 0.0)
    ROUTER.observe_device(handle.up, down, up_s, wait_s, up_s + wait_s)


def _dispatch_span(what: str, work: int, attempt: int = 0):
    """The ``device.dispatch`` span of one launch attempt of ``what``; the
    shared no-op when ``work`` is 0 (the wrapper then launches nothing)."""
    return span("device.dispatch", what=what, attempt=attempt) if work \
        else NULL_SPAN


# ---------------------------------------------------------------- resilience

class DeviceFailure(RuntimeError):
    """A CUDA error in a device dispatch (an illegal address, a failed
    launch): the command exits 1 with this one line, which names the
    dispatch and its attempts."""


def _is_oom(exc) -> bool:
    """Device memory exhausted (the batch is too big for what the card has
    free): halve, do not retry, since the same shape fails the same way."""
    from ..utils.faults import InjectedOom

    return isinstance(exc, (torch.cuda.OutOfMemoryError, InjectedOom))


def _is_transient(exc) -> bool:
    """Whether another attempt may succeed. The JAX package retries XLA
    statuses of a runtime hiccup (UNAVAILABLE, ABORTED, ...); a CUDA error
    on this card is never one: it is sticky (an illegal address or a failed
    launch leaves the context unusable, and every later call fails the
    same way) or a programming error, so it propagates at once. Only an
    injected fault other than an out-of-memory is retried; nothing on the
    card dies with one, so nothing is uploaded again but the batch."""
    from ..utils.faults import InjectedFault

    return isinstance(exc, InjectedFault) and not _is_oom(exc)


def _is_cuda_error(exc) -> bool:
    """A real error of the CUDA runtime (not an out-of-memory)."""
    accel = getattr(torch, "AcceleratorError", None)
    if accel is not None and isinstance(exc, accel):
        return True
    return isinstance(exc, RuntimeError) and "CUDA error" in str(exc)


def _first_line(exc) -> str:
    lines = str(exc).strip().splitlines()
    return lines[0] if lines else type(exc).__name__


@contextlib.contextmanager
def _fetch_failure(what: str):
    """A launch returns before its kernel runs, so a kernel's CUDA error
    (an illegal address) surfaces at the fetch of its results: raise it
    there as a :class:`DeviceFailure` naming the dispatch."""
    try:
        yield
    except BaseException as e:  # noqa: BLE001 - classified, re-raised
        if _is_cuda_error(e) and not _is_oom(e):
            raise DeviceFailure(
                f"device {what} fetch failed: {type(e).__name__}: "
                f"{_first_line(e)}") from e
        raise


def _retry_budget():
    tries = max(int(os.environ.get("FGUMI_TPU_DEVICE_RETRIES", "3")), 0)
    base = float(os.environ.get("FGUMI_TPU_DEVICE_BACKOFF_S", "0.05"))
    return tries, base


def device_retry_call(fn, what: str, launches: int = 1):
    """Run ``fn()`` (uploads and launch) with a bounded exponential backoff
    on transient errors. An out-of-memory and any other error re-raise at
    once (an out-of-memory is answered by the batch split at resolve time;
    a CUDA error becomes a :class:`DeviceFailure`). ``device.wedge`` fires
    once before the loop and ``device.dispatch`` on every attempt; each
    attempt is a ``device.dispatch`` span (``attempt=`` its index) unless
    ``launches`` is 0. A clean call is a success of the device breaker
    (:data:`~.breaker.BREAKER`), a retry budget that runs out a transient
    failure of it; the breaker moves no work."""
    from ..utils import faults

    faults.fire("device.wedge")
    retries, delay = _retry_budget()
    for attempt in range(retries + 1):
        try:
            faults.fire("device.dispatch")
            with _dispatch_span(what, launches, attempt):
                out = fn()
        except BaseException as e:  # noqa: BLE001 - classified below
            if _is_cuda_error(e) and not _is_oom(e):
                raise DeviceFailure(
                    f"device {what} dispatch failed on attempt "
                    f"{attempt + 1} of {retries + 1}: {type(e).__name__}: "
                    f"{_first_line(e)}") from e
            if _is_oom(e) or not _is_transient(e):
                raise
            if attempt >= retries:
                BREAKER.record_transient_failure()
                raise
            DEVICE_STATS.add_retry()
            log.warning("device %s failed (%s: %s); retry %d/%d in %.2fs",
                        what, type(e).__name__, e, attempt + 1, retries,
                        delay)
            time.sleep(delay)
            delay = min(delay * 2, 2.0)
            continue
        BREAKER.record_success()
        return out


# ------------------------------------------------- deadlines and the feeder

class DeadlineExceeded(RuntimeError):
    """A dispatch overran its deadline and was abandoned. Raised by the
    deadline-bounded waits of the resolve, never by the device. The JAX
    package finishes such a batch on its host engine; the port does not:
    the command exits 3 when an injected fault caused the overrun
    (``injected``), 1 otherwise, and publishes nothing."""

    def __init__(self, msg: str, injected: bool = False):
        super().__init__(msg)
        self.injected = injected


def _deadline_bounds():
    """(floor_s, ceiling_s) from ``FGUMI_TPU_DISPATCH_DEADLINE_S``, or
    (None, None) when dispatch deadlines are disabled. Accepted forms:
    ``""`` (defaults 30:300), ``"CEILING"``, ``"FLOOR:CEILING"``, or
    ``0``/``off``/``none``/``inf`` to disable (the JAX package's parsing).
    The floor absorbs a first dispatch's kernel build; the ceiling bounds
    what a wedged card can cost when the cost model has no prediction."""
    spec = os.environ.get("FGUMI_TPU_DISPATCH_DEADLINE_S", "").strip().lower()
    if spec in ("off", "none", "inf"):
        return None, None
    floor, ceil = 30.0, 300.0
    if spec:
        try:
            parts = [float(p) for p in spec.split(":", 1)]
        except ValueError:
            log.warning("FGUMI_TPU_DISPATCH_DEADLINE_S=%r is not "
                        "S or FLOOR:CEILING; using the default", spec)
            return floor, ceil
        if len(parts) == 1:
            ceil = parts[0]
            floor = min(floor, ceil)
        else:
            floor, ceil = parts
        if ceil <= 0:
            return None, None
        floor = min(max(floor, 0.01), ceil)
    return floor, ceil


def dispatch_deadline_s(pred_s=None):
    """Deadline (seconds) of one dispatch's resolve wait, or None when
    disabled: the router's predicted dispatch wall times
    ``FGUMI_TPU_DEADLINE_FACTOR`` (default 20), clamped to the floor and
    ceiling; with no prediction the ceiling applies."""
    floor, ceil = _deadline_bounds()
    if ceil is None:
        return None
    if pred_s is None or pred_s <= 0:
        return ceil
    try:
        factor = float(os.environ.get("FGUMI_TPU_DEADLINE_FACTOR", "20"))
    except ValueError:
        factor = 20.0
    return min(max(pred_s * factor, floor), ceil)


#: the feeder's gate holds a launch at most this long before it proceeds
GATE_TIMEOUT_S = 60.0


class DispatchTicket:
    """The future of one launch submitted to the feeder: :meth:`wait`
    returns the launch's result or re-raises its error. A ticket whose
    wait timed out goes to :meth:`DeviceFeeder.abandon`: its late result
    is dropped and its slot reclaimed when (if) the launch returns."""

    __slots__ = ("_started", "_event", "_result", "_exc", "upload_bytes",
                 "t_start", "_released", "_abandoned", "_dropped")

    def __init__(self, upload_bytes: int = 0):
        self._started = threading.Event()
        self._event = threading.Event()
        self._result = None
        self._exc = None
        self.upload_bytes = int(upload_bytes)
        self.t_start = None
        self._released = False
        self._abandoned = False
        self._dropped = False

    def done(self) -> bool:
        return self._event.is_set()

    def _set(self, result=None, exc=None):
        self._result = result
        self._exc = exc
        self._event.set()

    def wait(self, timeout: float = None):
        """The launch's result, or raise its error. ``timeout`` seconds
        (None: forever) count from the launch's start on the feeder; the
        wait before it (the gate, launches ahead) is bounded by
        :data:`GATE_TIMEOUT_S` more. On expiry raises
        :class:`DeadlineExceeded` without abandoning (the caller
        decides)."""
        if timeout is None:
            self._event.wait()
        else:
            if not self._started.wait(GATE_TIMEOUT_S + timeout):
                raise DeadlineExceeded(
                    f"device dispatch did not start within "
                    f"{GATE_TIMEOUT_S + timeout:.1f}s")
            left = timeout - (time.monotonic() - self.t_start)
            if not self._event.wait(max(left, 0.0)):
                raise DeadlineExceeded(
                    f"device dispatch did not complete within "
                    f"{timeout:.1f}s")
        if self._exc is not None:
            raise self._exc
        return self._result


class DeviceFeeder:
    """The uploads and launches of every consensus dispatch, on one
    background thread, in submission order (the reference's
    ``DeviceFeeder``). Up to ``FGUMI_TPU_FEEDER_DEPTH`` dispatches (default
    :data:`FEEDER_DEPTH`, at least 2) may be launched and unresolved at
    once, within ``FGUMI_TPU_FEEDER_BYTES`` (default 256 MiB, at least 1
    MiB) of uploads; the next launch waits at that gate until one resolves
    (at most :data:`GATE_TIMEOUT_S`, then it proceeds with a warning: a
    caller that holds more unresolved dispatches than the depth, or
    dropped one unresolved, must not freeze the process). The submitter
    waits for its own launch under the dispatch's deadline, so the launch
    runs here while the thread that watches the deadline is the
    submitter. The submitter's context travels with its work item, so
    spans, retries and counters raised on the feeder thread land in the
    submitting command's telemetry scope.

    Resolve sites call :meth:`mark_resolved` (or :meth:`abandon` past a
    deadline) exactly once a dispatch; both are idempotent. A handle that
    is dropped unresolved (a runner's error path drops the dispatches it
    had pending) reaches :meth:`release_dropped` through its finalizer,
    so a failed command leaves no slot or byte of the process's gate
    behind."""

    def __init__(self):
        self._q = collections.deque()
        self._cv = threading.Condition()
        self._thread = None
        self._exit = False
        self._active = False
        self._inflight = 0
        self._inflight_bytes = 0
        self._depth = None
        self._budget = None
        # tickets of handles collected unresolved (appended by finalizers,
        # which take no lock; released under the lock)
        self._dropped = collections.deque()

    def _config(self):
        with self._cv:
            if self._depth is None:
                try:
                    depth = max(int(os.environ.get(
                        "FGUMI_TPU_FEEDER_DEPTH", str(FEEDER_DEPTH))), 2)
                except ValueError:
                    depth = FEEDER_DEPTH
                try:
                    budget = max(int(os.environ.get(
                        "FGUMI_TPU_FEEDER_BYTES", str(256 << 20))), 1 << 20)
                except ValueError:
                    budget = 256 << 20
                self._depth, self._budget = depth, budget
            return self._depth, self._budget

    @property
    def depth(self) -> int:
        return self._config()[0]

    def submit(self, fn, upload_bytes: int = 0) -> DispatchTicket:
        """Run ``fn()`` (upload + launch) on the feeder thread, in the
        submitter's context; returns its ticket at once."""
        ticket = DispatchTicket(upload_bytes)
        ctx = contextvars.copy_context()
        with self._cv:
            if self._thread is None or not self._thread.is_alive():
                self._exit = False
                self._thread = threading.Thread(
                    target=self._loop, name="fgumi-device-feeder",
                    daemon=True)
                self._thread.start()
            self._reap_dropped_locked()
            self._q.append((fn, ctx, ticket))
            depth_now = len(self._q) + (1 if self._active else 0)
            self._cv.notify_all()
        DEVICE_STATS.note_queue_depth(depth_now)
        return ticket

    def mark_resolved(self, ticket: DispatchTicket):
        """Release a dispatch's slot and bytes (idempotent)."""
        with self._cv:
            self._reap_dropped_locked()
            if ticket._released:
                return
            ticket._released = True
            self._inflight -= 1
            self._inflight_bytes -= ticket.upload_bytes
            self._cv.notify_all()

    def release_dropped(self, ticket: DispatchTicket):
        """The finalizer of a dispatch handle: give an unresolved
        ticket's slot and bytes back. It runs wherever the collector runs,
        so it only queues the ticket; the next submit, resolve or gate
        check releases it under the lock."""
        self._dropped.append(ticket)

    def _reap_dropped_locked(self):
        while self._dropped:
            ticket = self._dropped.popleft()
            if ticket._released or ticket._abandoned:
                continue  # resolved, or reclaimed when its launch returns
            if not ticket._event.is_set():
                # queued (the loop skips it) or launching (the loop
                # reclaims its slot when the launch returns)
                ticket._dropped = True
                continue
            ticket._released = True
            self._inflight -= 1
            self._inflight_bytes -= ticket.upload_bytes
            self._cv.notify_all()

    def abandon(self, ticket: DispatchTicket):
        """Give up on a dispatch past its deadline: the caller walks away
        now; a late result is dropped and the slot reclaimed when the
        launch returns (here, if it already has)."""
        from ..observe.flight import FLIGHT

        with self._cv:
            ticket._abandoned = True
            completed = ticket._event.is_set()
            if completed:
                ticket._result = None
        FLIGHT.note("device.feeder.abandon",
                    upload_bytes=ticket.upload_bytes,
                    completed_late=completed)
        if completed:
            self.mark_resolved(ticket)

    def drain(self, timeout: float = None) -> bool:
        """Run the queue dry and let the thread exit (the serve daemon's
        drain). True when it emptied and its thread ended within
        ``timeout`` seconds. A later submit starts a fresh thread.

        The thread's end is waited for, not only the queue's: woken here,
        a thread that has run this process's launches and still runs when
        the interpreter finalizes dies in it, and its torch thread state
        with it, which can abort the process (SIGABRT, "terminate called
        without an active exception") after a clean shutdown."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            self._exit = True
            thread = self._thread
            self._cv.notify_all()
            while self._q or self._active:
                left = None if deadline is None \
                    else deadline - time.monotonic()
                if left is not None and left <= 0:
                    return False
                self._cv.wait(min(left, 0.5) if left is not None else 0.5)
        if thread is None or thread is threading.current_thread():
            return True
        thread.join(None if deadline is None
                    else max(deadline - time.monotonic(), 0.0))
        return not thread.is_alive()

    def _gated_locked(self, depth: int, budget: int) -> bool:
        head = self._q[0][2]
        return self._inflight >= depth or (
            self._inflight > 0
            and self._inflight_bytes + head.upload_bytes > budget)

    def _loop(self):
        while True:
            with self._cv:
                self._active = False
                self._cv.notify_all()
                while not self._q:
                    if self._exit:
                        self._thread = None
                        return
                    self._cv.wait()
                depth, budget = self._config()
                gate_until = None
                collected = False
                while True:
                    self._reap_dropped_locked()
                    if not (self._q and not self._exit
                            and self._gated_locked(depth, budget)):
                        break
                    now = time.monotonic()
                    if gate_until is None:
                        gate_until = now + GATE_TIMEOUT_S
                    elif not collected and now >= gate_until \
                            - GATE_TIMEOUT_S + 1.0:
                        # held a second: handles dropped in reference
                        # cycles (an error's traceback) are finalized only
                        # by the cycle collector
                        collected = True
                        self._cv.release()
                        try:
                            gc.collect()
                        finally:
                            self._cv.acquire()
                        continue
                    if now >= gate_until:
                        log.warning(
                            "device feeder gate timed out with %d "
                            "dispatch(es) unresolved; proceeding",
                            self._inflight)
                        break
                    self._cv.wait(min(gate_until - now, 1.0))
                fn, ctx, ticket = self._q.popleft()
                if ticket._abandoned or ticket._dropped:
                    # given up while still queued: never start it
                    ticket._released = True
                    ticket.t_start = time.monotonic()
                    ticket._started.set()
                    ticket._set(exc=DeadlineExceeded(
                        "dispatch abandoned before it started"))
                    continue
                self._inflight += 1
                self._inflight_bytes += ticket.upload_bytes
                self._active = True
                ticket.t_start = time.monotonic()
                ticket._started.set()
            try:
                result, exc = ctx.run(fn), None
            except BaseException as e:  # noqa: BLE001 - relayed to waiter
                # an out-of-memory is kept without its traceback: the
                # frames would keep the attempt's device tensors alive
                # while the halves allocate
                result, exc = None, (e.with_traceback(None) if _is_oom(e)
                                     else e)
            with self._cv:
                late = ticket._abandoned or ticket._dropped
                ticket._set(result=None if late else result, exc=exc)
            del result
            if late:
                if ticket._abandoned:
                    log.warning("device dispatch completed after its "
                                "deadline; late result dropped")
                self.mark_resolved(ticket)


#: the process's feeder (every command and serve job shares the card)
DEVICE_FEEDER = DeviceFeeder()


def default_max_inflight() -> int:
    """The hybrid route's backlog cap (``FGUMI_TPU_MAX_INFLIGHT``, ``0`` =
    always host) or, unset, the feeder depth + 1, as on the JAX package."""
    env_cap = os.environ.get("FGUMI_TPU_MAX_INFLIGHT", "").strip()
    if env_cap:
        try:
            return int(env_cap)
        except ValueError:
            log.warning("FGUMI_TPU_MAX_INFLIGHT=%r is not an integer; "
                        "using the default", env_cap)
    return DEVICE_FEEDER.depth + 1


_FETCH_STREAMS = {}
_FETCH_LOCK = threading.Lock()


def _fetch_stream(device):
    """The side stream a device's result copies run on: a copy queued on
    the launch stream would also wait for every launch made since."""
    with _FETCH_LOCK:
        stream = _FETCH_STREAMS.get(device)
        if stream is None:
            stream = _FETCH_STREAMS[device] = torch.cuda.Stream(device)
        return stream


def fetch_results(out, event, n_fetch: int, deadline_at):
    """The host arrays of a launch's first ``n_fetch`` outputs: on the card
    copied once the event recorded after the launch completes (polled
    until ``deadline_at``, monotonic; None past it), on the CPU the
    outputs themselves. The copy goes to pageable memory, as a plain
    ``.cpu()`` does: a fresh pinned buffer a dispatch costs more to
    allocate than the copy saves."""
    if event is None:
        return [t.cpu().numpy() for t in out[:n_fetch]]
    if not _poll_event(event, deadline_at):
        return None
    with torch.cuda.stream(_fetch_stream(out[0].device)):
        return [t.cpu().numpy() for t in out[:n_fetch]]


def _poll_event(event, deadline_at):
    """Wait for a CUDA event by polling (the waiting thread never blocks
    in the driver); False when ``deadline_at`` (monotonic) passes first."""
    if deadline_at is None:
        event.synchronize()
        return True
    delay = 2e-5
    while not event.query():
        if time.monotonic() >= deadline_at:
            return False
        time.sleep(delay)
        delay = min(delay * 2, 1e-3)
    return True


class Dispatch:
    """One launched consensus dispatch: its feeder ticket, the launch's
    device outputs (``out``), how many of them a resolve fetches
    (``n_fetch``), on the card the event recorded after the launch, the
    kernel it ran (``what``), the host clock of its submission,
    its :data:`DEVICE_STATS` timeline slot and upload bytes, the cost
    model's predicted wall (its deadline) and, for K1-f, its filter
    parameters (the sentinel's audit). A dispatch that ran out of device
    memory holds the error instead (``failure``, nothing in flight) and the
    K1-r thresholds it was launched with, for the split at resolve time."""

    __slots__ = ("ticket", "out", "event", "what", "t0", "slot",
                 "up", "failure", "thresholds", "n_fetch", "pred_s",
                 "filter_ctx", "abandoned", "_closed", "__weakref__")

    def __init__(self, ticket, out, what: str, t0: float, slot: int,
                 up: int, failure=None, thresholds=None, n_fetch: int = 4,
                 pred_s=None, event=None):
        self.ticket = ticket
        self.out = out
        self.event = event
        self.what = what
        self.t0 = t0
        self.slot = slot
        self.up = up
        self.failure = failure
        self.thresholds = thresholds
        self.n_fetch = n_fetch
        self.pred_s = pred_s
        self.filter_ctx = None
        self.abandoned = False
        self._closed = failure is not None

    def close(self, down: int, wait_s: float):
        """End the dispatch's accounting once: its DEVICE_STATS slot, the
        in-flight set, and (unless abandoned) its feeder slot."""
        if self._closed:
            return
        self._closed = True
        DEVICE_STATS.end(self.slot, down, wait_s)
        with _LIVE_LOCK:
            _LIVE_DISPATCHES.discard(self)
        if not self.abandoned:
            DEVICE_FEEDER.mark_resolved(self.ticket)


def _abandon(ticket, what: str, deadline: float) -> "DeadlineExceeded":
    """Give up on a dispatch past its deadline: the feeder drops its late
    result, the breaker records a wedge, the flight recorder freezes a
    black box. Returns the :class:`DeadlineExceeded` to raise."""
    from ..observe.flight import FLIGHT
    from ..utils import faults

    DEVICE_FEEDER.abandon(ticket)
    DEVICE_STATS.add_deadline_abandon()
    BREAKER.record_deadline_overrun()
    FLIGHT.note("device.deadline_fallback", what=what,
                deadline_s=round(deadline, 3))
    FLIGHT.dump("dispatch-deadline", what=what)
    return DeadlineExceeded(
        f"device {what} dispatch did not complete within {deadline:.1f}s "
        "(FGUMI_TPU_DISPATCH_DEADLINE_S); abandoned",
        injected=faults.hang_fired())


#: stands in for a dispatch handle where the router sent a batch to the
#: native f64 host engine: its resolve runs the engine on the rows
HOST_DISPATCH = ("host-dispatch",)


def _last_prediction():
    """The cost model's predicted dispatch wall of this thread's latest
    routing decision, or None (ops/router.py)."""
    from .router import ROUTER

    pred = ROUTER.last_prediction()
    return pred[0] if pred else None


class _Staging:
    """One pinned staging buffer and the event recorded after the last
    copy that read it (None: never used)."""

    __slots__ = ("buf", "event", "used")

    def __init__(self):
        self.buf = None
        self.event = None
        self.used = 0

    def idle(self) -> bool:
        return self.event is None or self.event.query()


def pad_segments_gather(codes: np.ndarray, quals: np.ndarray,
                        rows: np.ndarray, L_max: int, counts: np.ndarray):
    """Gather ``rows`` of the packed (R, stride) code/qual arrays into the
    dense (N, L_max) segment layout in one copy (L_max % 4 == 0, <= the
    stride; columns past a read's end are already N/Q0). Returns (codes,
    quals, starts)."""
    counts = np.asarray(counts, dtype=np.int64)
    starts = np.concatenate(([0], np.cumsum(counts)))
    return (np.ascontiguousarray(codes[rows, :L_max]),
            np.ascontiguousarray(quals[rows, :L_max]), starts)


def pad_segments(codes2d: np.ndarray, quals2d: np.ndarray,
                 counts: np.ndarray):
    """Lay a dense (N, L) row batch out for the wire kernel: columns pad
    with N/Q0 to a multiple of 4 (the kernel's 4-positions-per-thread
    word), rows need no padding. Returns (codes, quals, starts)."""
    counts = np.asarray(counts, dtype=np.int64)
    starts = np.concatenate(([0], np.cumsum(counts)))
    N, L = codes2d.shape
    L4 = -(-L // 4) * 4
    if L4 != L:
        c = np.full((N, L4), N_CODE, dtype=np.uint8)
        q = np.zeros((N, L4), dtype=np.uint8)
        c[:, :L] = codes2d
        q[:, :L] = quals2d
        codes2d, quals2d = c, q
    return codes2d, quals2d, starts


class ConsensusKernel:
    """Batched consensus caller for one (pre, post) error-rate pair on one
    torch device: ``cuda`` runs the CUDA kernel, ``cpu`` its plain PyTorch
    version. Results are integer-exact against ops/oracle by construction.

    Dispatches may come from several threads and be resolved on others, in
    any order: the staging pool and every counter below take locks.
    """

    def __init__(self, tables: QualityTables, device="cuda"):
        self.tables = tables
        self.device = torch.device(device)
        if self.device.type == "cuda":
            # the reference's f32 contract: no TF32 anywhere
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self._pre = np.float32(tables.ln_error_pre_umi)
        self._delta94 = torch.from_numpy(delta94(tables))
        self._tables_dev = None
        self._staging = {}  # slot -> [_Staging]
        self._staging_clock = 0
        self._staging_lock = threading.Lock()
        # guards every counter below and the lazily uploaded tables
        self._lock = threading.Lock()
        self.fallback_positions = 0
        self.total_positions = 0
        self.batches = 0
        # each dispatch's upload-to-fetch span, host clock, summed (spans
        # of overlapping dispatches overlap)
        self.device_s = 0.0
        self.patch_s = 0.0   # f64 oracle patch of suspect positions
        # fused consensus→filter route (K1-f)
        self._emin_dev = {}
        self.fused_batches = 0          # dispatches through K1-f
        self.packed2_columns_batches = 0  # filtered batches on packed2
        self.stats_bytes = 0            # stats rows fetched
        self.gathered_rows = 0          # survivor + suspect rows gathered
        self.batch_shapes = []          # (rows N, columns L, segments J)
        # the router's host route (ops/host_kernel.py)
        self._host_engine = None
        self.host_batches = 0
        self._coalesce_key_cache = None

    # ------------------------------------------------------------ dispatch

    def add_device_s(self, dt: float):
        """Credit ``dt`` seconds of device work done outside a dispatch
        (the strand combines' upload, launch and fetch)."""
        with self._lock:
            self.device_s += dt

    def _staging_entry(self, slot: str, n: int) -> _Staging:
        """A pinned buffer of ``slot`` that no copy in flight still reads,
        at least ``n`` bytes (caller holds the staging lock). An idle
        buffer is reused, a slot holds up to :data:`STAGING_DEPTH`, and
        with all of them busy the least recently used one is waited for.
        A buffer grows (to a power of two, at least 1 MiB) only when a
        larger upload than any before it comes."""
        pool = self._staging.setdefault(slot, [])
        idle = [e for e in pool if e.idle()]
        fits = [e for e in idle
                if e.buf is not None and e.buf.numel() >= n]
        if fits:
            entry = fits[0]
        elif idle:
            entry = idle[0]
        elif len(pool) < STAGING_DEPTH:
            entry = _Staging()
            pool.append(entry)
        else:
            entry = min(pool, key=lambda e: e.used)
            entry.event.synchronize()
        if entry.buf is None or entry.buf.numel() < n:
            cap = 1 << max(20, (max(n, 1) - 1).bit_length())
            entry.buf = torch.empty(cap, dtype=torch.uint8, pin_memory=True)
        self._staging_clock += 1
        entry.used = self._staging_clock
        return entry

    def _to_device(self, t: torch.Tensor, slot: str) -> torch.Tensor:
        """Host tensor -> device through a pinned staging buffer of
        ``slot``; the event recorded after the non-blocking copy keeps the
        buffer from being written again before the copy has read it."""
        if self.device.type != "cuda":
            return t
        n = t.numel() * t.element_size()
        with self._staging_lock:
            entry = self._staging_entry(slot, n)
            staged = entry.buf[:n].view(t.dtype).view(t.shape)
            staged.copy_(t)
            out = staged.to(self.device, non_blocking=True)
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))
            entry.event = event
        return out

    def _await(self, handle: Dispatch):
        """Wait for ``handle``'s results under its deadline (on the card:
        poll the event recorded after their copy, never blocking in the
        driver) and close its accounting: (device outputs, host numpy
        arrays of the first ``n_fetch``). The span from submission to the
        fetched result goes into ``device_s``, the wait into
        :data:`DEVICE_STATS`. Raises a CUDA error at the fetch as a
        :class:`DeviceFailure`, or :class:`DeadlineExceeded` (the dispatch
        abandoned)."""
        deadline = dispatch_deadline_s(handle.pred_s)
        t_fetch = time.monotonic()
        down = 0
        try:
            with span("device.fetch") as sp, _fetch_failure(handle.what):
                host = fetch_results(
                    handle.out, handle.event, handle.n_fetch,
                    None if deadline is None else t_fetch + deadline)
                if host is None:
                    handle.abandoned = True
                    raise _abandon(handle.ticket, handle.what, deadline)
                down = sum(a.nbytes for a in host)
                sp.set(bytes=down)
        finally:
            handle.close(down, time.monotonic() - t_fetch)
        now = time.monotonic()
        with self._lock:
            self.device_s += now - handle.t0
            self.batches += 1
        _observe_dispatch(now - handle.t0, now - t_fetch, handle.up, down)
        _observe_router(handle, down)
        out = handle.out
        handle.out = handle.event = None
        return out, host

    # ------------------------------------------------------------ routing

    def host_mode(self) -> bool:
        """Every consensus batch on the native f64 engine
        (``FGUMI_TPU_ROUTE=host`` or ``FGUMI_TPU_HOST_ENGINE=1``)."""
        from .router import route_mode

        return route_mode() == "host"

    def _host(self):
        """The native f64 host engine of these tables (built once)."""
        with self._lock:
            if self._host_engine is None:
                from .host_kernel import HostConsensusEngine

                self._host_engine = HostConsensusEngine(self.tables)
            return self._host_engine

    def host_call_segments(self, codes2d: np.ndarray, quals2d: np.ndarray,
                           starts) -> tuple:
        """One segment batch on the native f64 host engine (the router's
        host route): (winner, qual, depth, errors) (J, L), bit-exact with
        the oracle; its rate feeds the router's host EWMA."""
        from .router import ROUTER

        t0 = time.monotonic()
        w, q, d, e, n_slow = self._host().call_segments_counted(
            codes2d, quals2d, np.asarray(starts, dtype=np.int64))
        ROUTER.observe_host(codes2d.size, time.monotonic() - t0)
        with self._lock:
            self.total_positions += w.size
            self.fallback_positions += n_slow
            self.host_batches += 1
        return w, q, d, e

    def _coalesce_key(self) -> str:
        """Fingerprint of the tables a merged dispatch must share (the
        cross-job coalescer, ops/coalesce.py): the f32 quality tables and
        the pre-UMI prior, so warm serve jobs with the same error rates
        merge across kernel objects."""
        if self._coalesce_key_cache is None:
            import hashlib

            h = hashlib.blake2b(digest_size=16)
            for a in (self.tables.adjusted_correct,
                      self.tables.adjusted_error_per_alt):
                h.update(np.asarray(a, dtype=np.float32).tobytes())
            h.update(self._pre.tobytes())
            h.update(str(self.device).encode())
            self._coalesce_key_cache = h.hexdigest()
        return self._coalesce_key_cache

    def _device_tables(self):
        with self._lock:
            if self._tables_dev is None:
                self._tables_dev = tuple(
                    torch.tensor(np.asarray(a, dtype=np.float32),
                                 device=self.device)
                    for a in (self.tables.adjusted_correct,
                              self.tables.adjusted_error_per_alt))
            return self._tables_dev

    def device_call_segments_wire(self, codes2d: np.ndarray,
                                  quals2d: np.ndarray, starts: np.ndarray,
                                  resident_thresholds=None):
        """Launch the full-column consensus of a padded (N, L) row batch
        (L % 4 == 0; family f = rows [starts[f], starts[f+1])). Builds the
        1-byte wire for K1 — or the packed2 layout for K1-p2 when the batch
        has > 63 distinct quals — and returns the handle for
        :meth:`resolve_segments_wire`.

        ``resident_thresholds=(min_reads, min_qual)`` launches K1-r
        instead of K1 on the wire layout: the outputs then also hold the
        duplex combine's resident (tb, tq, obs). The packed2 route has no
        resident variant and ignores it (its rows take the host combine).
        Callers ask for it only when every family has fewer than 65,536
        reads (the u16 counts are exact). A plain dispatch may be merged
        with other serve jobs' (ops/coalesce.py): its handle is then a
        ``CoalescedTicket``, resolved through the same call."""
        with self._lock:
            self.batch_shapes.append((*codes2d.shape, len(starts) - 1))
        if resident_thresholds is None:
            from .coalesce import COALESCER

            merged = COALESCER.maybe_submit(self, codes2d, quals2d, starts)
            if merged is not None:
                return merged
        return self._dispatch(*self._wire_plan(codes2d, quals2d, starts,
                                               resident_thresholds))

    def _wire_plan(self, codes2d, quals2d, starts, resident_thresholds=None,
                   fault_point=None):
        """The launch of one wire dispatch, built but not submitted:
        (launch closure, kernel name, J, host tensors uploaded, K1-r
        thresholds). ``fault_point``: a fault point fired inside the
        launch (the coalescer's ``serve.coalesce``)."""
        J = len(starts) - 1
        codes_t = torch.from_numpy(codes2d)
        quals_t = torch.from_numpy(quals2d)
        starts_t = torch.from_numpy(np.asarray(starts, dtype=np.int32))

        def fire():
            if fault_point is not None:
                from ..utils import faults

                faults.fire(fault_point)

        w = W.build_wire(codes_t, quals_t, self._delta94)
        if w is not None:
            wire, dict64 = w
            what = "K1" if resident_thresholds is None else "K1-r"

            def launch():
                fire()
                args = (self._to_device(wire, "wire"),
                        self._to_device(starts_t, "starts"),
                        self._to_device(dict64, "dict"), self._pre)
                if resident_thresholds is not None:
                    return cuda_kernel.consensus_wire_resident(
                        *args, *resident_thresholds)
                return cuda_kernel.consensus_wire_full(*args)

            return (launch, what, J, (wire, starts_t, dict64),
                    resident_thresholds)
        cp, qsent = W.pack_codes2(codes_t, quals_t)

        def launch_packed2():
            fire()
            ct, et = self._device_tables()
            return cuda_kernel.consensus_wire_packed2(
                self._to_device(cp, "wire"), self._to_device(qsent, "quals"),
                self._to_device(starts_t, "starts"), ct, et, self._pre)

        return (launch_packed2, "K1-p2", J, (cp, qsent, starts_t),
                resident_thresholds)

    def _dispatch(self, launch, what: str, J: int, host,
                  thresholds=None, n_fetch: int = 4) -> Dispatch:
        """One dispatch of ``J`` families: its launch runs on the feeder
        (:meth:`feeder_run`) while this thread waits for it under the
        dispatch's deadline (a launch that hangs is abandoned:
        :class:`DeadlineExceeded`). An out-of-memory is kept in the
        returned handle, which its resolve answers by halving the batch
        (where the reference's surfaces); any other error raises here."""
        up = sum(t.numel() * t.element_size() for t in host)
        pred = _last_prediction()
        deadline = dispatch_deadline_s(pred)
        t0 = time.monotonic()
        ticket = DEVICE_FEEDER.submit(
            self.feeder_run(launch, what, J, n_fetch), up)
        try:
            out, event, upload_s = ticket.wait(deadline)
        except DeadlineExceeded:
            raise _abandon(ticket, what, deadline) from None
        except BaseException as e:  # noqa: BLE001 - only an OOM is kept
            DEVICE_FEEDER.mark_resolved(ticket)
            if not _is_oom(e):
                raise
            # without its traceback: the frames would keep the attempt's
            # device tensors alive while the halves allocate
            return Dispatch(None, None, what, t0, -1, 0,
                            failure=e.with_traceback(None),
                            thresholds=thresholds)
        slot = DEVICE_STATS.begin(self.device, up)
        DEVICE_STATS.note_upload(slot, upload_s)
        if pred is not None:
            DEVICE_STATS.note_pred(slot, pred)
        handle = Dispatch(ticket, out, what, t0, slot, up,
                          thresholds=thresholds, n_fetch=n_fetch,
                          pred_s=pred, event=event)
        with _LIVE_LOCK:
            _LIVE_DISPATCHES.add(handle)
        weakref.finalize(handle, DEVICE_FEEDER.release_dropped,
                         ticket).atexit = False
        return handle

    def feeder_run(self, launch, what: str, J: int, n_fetch: int = 4):
        """The feeder's work item of one launch: :func:`device_retry_call`
        around ``launch`` and, on the card, an event recorded after it.
        Returns (outputs, event or None, the launch's wall)."""
        cuda = self.device.type == "cuda"

        def run():
            t_up = time.monotonic()
            out = device_retry_call(launch, what, J)
            upload_s = time.monotonic() - t_up
            if not cuda:
                return out, None, upload_s
            with _fetch_failure(what):
                event = torch.cuda.Event()
                event.record(torch.cuda.current_stream(self.device))
            return out, event, upload_s

        return run

    def _emin(self, table: np.ndarray) -> torch.Tensor:
        """The filter's error-rate table as an int32 tensor on the device,
        narrowed and uploaded once per distinct table."""
        key = table.tobytes()
        with self._lock:
            got = self._emin_dev.get(key)
            if got is None:
                got = torch.from_numpy(np.ascontiguousarray(
                    table, dtype=np.int32)).to(self.device)
                self._emin_dev[key] = got
            return got

    def device_call_segments_wire_filtered(self, codes2d: np.ndarray,
                                           quals2d: np.ndarray,
                                           starts: np.ndarray, lens,
                                           filter_params):
        """Fused consensus→filter dispatch of a padded (N, L) row batch
        (K1-f). ``lens``: (J,) consensus lengths; ``filter_params``:
        (min_reads_c, min_qual_c, DeviceFilterParams). Returns a ticket for
        :meth:`resolve_segments_wire_filtered`: ``(True, K1-f handle)``,
        or ``(False, full-column handle)`` when the batch has more than 63
        distinct quals and takes the packed2 full-column route."""
        mr, mq, fparams = filter_params
        codes_t = torch.from_numpy(codes2d)
        quals_t = torch.from_numpy(quals2d)
        w = W.build_wire(codes_t, quals_t, self._delta94)
        if w is None:
            with self._lock:
                self.packed2_columns_batches += 1
            return False, self.device_call_segments_wire(codes2d, quals2d,
                                                         starts)
        wire, dict64 = w
        with self._lock:
            self.batch_shapes.append((*codes2d.shape, len(starts) - 1))
        starts_t = torch.from_numpy(np.asarray(starts, dtype=np.int32))
        lens_t = torch.from_numpy(np.ascontiguousarray(lens, dtype=np.int32))

        def launch():
            return cuda_kernel.consensus_wire_filter(
                self._to_device(wire, "wire"),
                self._to_device(starts_t, "starts"),
                self._to_device(dict64, "dict"), self._pre, mr, mq,
                self._to_device(lens_t, "lens"), fparams.min_reads,
                self._emin(fparams.emin_tab), fparams.min_base_q,
                fparams.per_base)

        handle = self._dispatch(launch, "K1-f", len(starts) - 1,
                                (wire, starts_t, dict64, lens_t),
                                n_fetch=1)
        handle.filter_ctx = (mr, mq, np.asarray(lens, dtype=np.int64),
                             fparams)
        return True, handle

    def resolve_segments_wire_filtered(self, ticket, codes2d: np.ndarray,
                                       quals2d: np.ndarray,
                                       starts: np.ndarray):
        """Resolve a fused ticket: ``("stats", stats (J, 7) int32,
        resident)`` with ``resident`` the device-side (fb, fq, depth,
        errors, qs, wp) for the gathers, or ``("columns", winner, qual,
        depth, errors)`` — full post-oracle columns — for the packed2
        route, a split batch, a host-routed one and a dispatch the
        sentinel's inline audit repaired, where the caller's host filter
        pass takes over."""
        fused, handle = ticket
        if not fused:
            return ("columns",) + self.resolve_segments_wire(
                handle, codes2d, quals2d, starts)
        if handle.failure is not None:
            # the reference's fused-route recovery: the halves go through
            # K1 and come back as full columns for the host filter pass
            return ("columns",) + self._recover_segments(
                handle.failure, codes2d, quals2d, starts, 0)
        dev, (stats,) = self._await(handle)
        from ..utils import faults

        # the sentinel's corruption drill point: the fused route's only
        # default fetch is its stats rows
        stats = faults.fire("device.fetch", stats)
        with self._lock:
            self.fused_batches += 1
            self.stats_bytes += stats.nbytes
            self.total_positions += dev[1].numel()
        from .sentinel import SENTINEL

        J = len(starts) - 1
        repaired = SENTINEL.maybe_audit_filter(
            self, codes2d, quals2d, starts, stats[:J], dev[1:],
            handle.filter_ctx, slot=handle.slot)
        if repaired is not None:
            return ("columns",) + tuple(repaired)
        return "stats", stats, dev[1:]

    def _gather(self, arrays, rows):
        """Rows ``rows`` of every resident (J, ...) array, fetched to the
        host: the survivors-only gathers (plain tensor indexing)."""
        t0 = time.monotonic()
        with span("device.fetch", what="gather") as sp:
            idx = torch.from_numpy(np.ascontiguousarray(rows,
                                                        dtype=np.int64))

            def gather():
                on_dev = idx.to(arrays[0].device)
                return [t[on_dev] for t in arrays]

            # plain tensor indexing, no kernel of the port: the attempts
            # carry no device.dispatch span (the fetch span covers them)
            got = device_retry_call(gather, "filter gather", launches=0)
            with _fetch_failure("filter gather"):
                out = [t.cpu().numpy() for t in got]
            sp.set(bytes=sum(a.nbytes for a in out))
        dt = time.monotonic() - t0
        with self._lock:
            self.device_s += dt
            self.gathered_rows += len(rows)
        DEVICE_STATS.add_fetch(sum(a.nbytes for a in out), dt)
        return out

    def filter_resolve_suspect_rows(self, resident, rows, starts,
                                    codes2d: np.ndarray,
                                    quals2d: np.ndarray):
        """Ordinary host completion of the fused route's suspect rows:
        gather their raw packed words + depth/errors off the resident
        columns, then unpack, restore no-calls and run the f64 oracle patch
        over the host-side dense rows. Returns post-oracle (winner, qual,
        depth, errors) for ``rows`` — PRE consensus thresholds."""
        _fb, _fq, d16, e16, qs, wp = resident
        rows = np.asarray(rows, dtype=np.int64)
        qs_r, wp_r, d_r, e_r = self._gather((qs, wp, d16, e16), rows)
        k = len(rows)
        winner, qual, suspect = W.unpack_result_split(qs_r, wp_r, k)
        depth = d_r.view(np.uint16).astype(np.int32)
        errors = e_r.view(np.uint16).astype(np.int32)
        no_call = depth == 0
        if no_call.any():
            winner[no_call] = N_CODE
            qual[no_call] = MIN_PHRED
            errors[no_call] = 0
        # the batch's positions were counted when its stats came back
        with self._lock:
            self.fallback_positions += int(suspect.sum())
        starts = np.asarray(starts, dtype=np.int64)
        if suspect.any():
            t0 = time.monotonic()
            self._oracle_patch(
                suspect, winner, qual, depth, errors,
                lambda f: (codes2d[starts[rows[f]]:starts[rows[f] + 1]],
                           quals2d[starts[rows[f]]:starts[rows[f] + 1]]))
            self._add_patch_s(time.monotonic() - t0)
        return winner, qual, depth, errors

    def filter_gather_filtered(self, resident, rows):
        """Survivors-only gather off the fused route's resident columns:
        (masked bases u8, masked quals u8, depth i32, errors i32) for
        ``rows``, in row order."""
        fb, fq, d16, e16 = resident[:4]
        fb_r, fq_r, d_r, e_r = self._gather((fb, fq, d16, e16), rows)
        return (fb_r, fq_r, d_r.view(np.uint16).astype(np.int32),
                e_r.view(np.uint16).astype(np.int32))

    def resolve_segments_wire(self, dev_out, codes2d: np.ndarray,
                              quals2d: np.ndarray, starts: np.ndarray,
                              want_extras: bool = False,
                              _split_depth: int = 0):
        """Fetch + complete a dispatch: (winner, qual, depth, errors) (J, L)
        host arrays with every suspect recomputed by the f64 oracle.

        ``want_extras=True`` appends a dict: ``suspect``, the (J, L) mask
        of the positions the oracle patched, and ``resident``, the
        dispatch's :class:`ResidentHandles` (None unless it went through
        K1-r), which the caller releases. Without it a resident dispatch's
        handles are released here. A dispatch that ran out of device memory
        is completed by :meth:`_recover_segments`, with the same extras.
        :data:`HOST_DISPATCH` runs the native f64 engine on the rows
        (extras None); a coalesced handle resolves through the coalescer
        (its slice of the merged fetch, the same completion)."""
        if dev_out is HOST_DISPATCH:
            out = self.host_call_segments(codes2d, quals2d, starts)
            return out + ({"suspect": None, "resident": None},) \
                if want_extras else out
        from .coalesce import COALESCER, CoalescedTicket

        if isinstance(dev_out, CoalescedTicket):
            return COALESCER.resolve_partner(self, dev_out, codes2d, quals2d,
                                             starts, _split_depth,
                                             want_extras)
        if dev_out.failure is not None:
            return self._recover_segments(dev_out.failure, codes2d, quals2d,
                                          starts, _split_depth,
                                          dev_out.thresholds, want_extras)
        dev, host = self._await(dev_out)
        from ..utils import faults

        # the sentinel's corruption drill point: after the device, before
        # any host consumer
        qs, wp, d16, e16 = faults.fire("device.fetch", host)
        resident = ResidentHandles(dev[4:]) if len(dev) == 7 else None
        del dev
        return self.finish_wire(qs, wp, d16, e16, codes2d, quals2d, starts,
                                want_extras, resident, slot=dev_out.slot)

    def finish_wire(self, qs, wp, d16, e16, codes2d, quals2d, starts,
                    want_extras=False, resident=None, slot: int = -1,
                    partner=None):
        """The host completion of fetched wire columns (int16 depth and
        errors read as u16): unpack, no-call restore, the f64 oracle patch,
        then the sentinel's audit tap. Shared by the solo resolve and the
        coalescer's per-partner slices, so a merged job's bytes cannot
        diverge from its solo run's. An inline audit that found the
        columns divergent hands back the oracle's, and the dispatch's
        resident arrays are dropped (its strand combine takes the host
        path)."""
        out = self._complete_wire_columns(
            qs, wp, np.asarray(d16).view(np.uint16),
            np.asarray(e16).view(np.uint16), codes2d, quals2d, starts)
        from .sentinel import SENTINEL

        repaired = SENTINEL.maybe_audit(self, codes2d, quals2d, starts, *out,
                                        slot=slot, partner=partner)
        if repaired is not None:
            out = tuple(repaired)
            if resident is not None:
                resident.release()
                resident = None
        if want_extras:
            suspect = None if repaired is not None \
                else (qs[:len(starts) - 1] >> 7).astype(bool)
            return out + ({"suspect": suspect, "resident": resident},)
        if resident is not None:
            resident.release()
        return out

    def _recover_segments(self, exc, codes2d: np.ndarray,
                          quals2d: np.ndarray, starts, split_depth: int,
                          thresholds=None, want_extras: bool = False):
        """Completion of a dispatch that ran out of device memory (the
        reference's ``_recover_segments`` without its host-engine tail): a
        batch of more than one family halves at a family boundary, both
        halves are dispatched again on the card through the same route
        (K1, K1-r with ``thresholds``, K1-p2 where a half has more than 63
        distinct quals; a fused dispatch's halves through K1) and resolved,
        both even if the first raises, and their columns are concatenated
        in order. With ``want_extras`` the halves' extras are joined too:
        their suspect masks, and their K1-r resident arrays into one
        :class:`ResidentHandles` (None where a half has none: the packed2
        route keeps none). At most ``FGUMI_TPU_MAX_SPLITS`` (default 4)
        deep, and only where the layout is the wire's (L % 4 == 0);
        otherwise the error re-raises and the command publishes nothing."""
        starts = np.asarray(starts, dtype=np.int64)
        J = len(starts) - 1
        max_splits = int(os.environ.get("FGUMI_TPU_MAX_SPLITS", "4"))
        if not (J > 1 and split_depth < max_splits
                and codes2d.ndim == 2 and codes2d.shape[1] % 4 == 0):
            raise exc
        DEVICE_STATS.add_split()
        mid = J // 2
        log.warning("device batch exhausted memory (%s); halving %d "
                    "segments into %d + %d and re-dispatching",
                    _first_line(exc), J, mid, J - mid)
        if self.device.type == "cuda":
            # hand the allocator's cached blocks back before the halves
            torch.cuda.empty_cache()
        halves, first = [], None
        from .coalesce import bypassed

        # the halves never enter the coalescer's window: they exist because
        # a (maybe merged) batch was too large
        with bypassed():
            for lo, hi in ((0, mid), (mid, J)):
                r0, r1 = int(starts[lo]), int(starts[hi])
                c, q = codes2d[r0:r1], quals2d[r0:r1]
                sub = starts[lo:hi + 1] - r0
                try:
                    halves.append((self.device_call_segments_wire(
                        c, q, sub, resident_thresholds=thresholds), c, q,
                        sub))
                except BaseException as e:  # noqa: BLE001 - re-raised below
                    first = e
                    break
        # resolve every half that went out, even past a failure: an
        # unresolved one would hold its in-flight slot and its outputs
        parts = []
        for handle, c, q, sub in halves:
            try:
                parts.append(self.resolve_segments_wire(
                    handle, c, q, sub, want_extras=True,
                    _split_depth=split_depth + 1))
            except BaseException as e:  # noqa: BLE001 - re-raised below
                if first is None:
                    first = e
        del halves
        residents = [p[4]["resident"] for p in parts]
        if first is not None or not want_extras \
                or any(r is None for r in residents):
            for r in residents:
                if r is not None:
                    r.release()
            residents = None
        if first is not None:
            raise first
        out = tuple(np.concatenate([p[i] for p in parts], axis=0)
                    for i in range(4))
        if not want_extras:
            return out
        if residents is None:
            return out + ({"suspect": None, "resident": None},)
        return out + ({"suspect": np.concatenate(
            [p[4]["suspect"] for p in parts], axis=0),
            "resident": ResidentHandles.join(residents)},)

    def _complete_wire_columns(self, qs, wp, d16, e16, codes2d, quals2d,
                               starts):
        """Host completion: unpack, depth/error counts, no-call restore,
        f64 oracle patch."""
        J = len(starts) - 1
        winner, qual, suspect = W.unpack_result_split(qs, wp, J)
        counts = np.diff(starts)
        if J and counts.max() >= 65536:
            # u16 device counts would wrap: recount on the host
            valid = (codes2d != N_CODE).astype(np.int32)
            depth = np.add.reduceat(valid, starts[:-1], axis=0)
            winner_rows = np.repeat(winner, counts, axis=0)
            match = ((codes2d == winner_rows)
                     & (codes2d != N_CODE)).astype(np.int32)
            errors = depth - np.add.reduceat(match, starts[:-1], axis=0)
        else:
            depth = d16[:J].astype(np.int32)
            errors = e16[:J].astype(np.int32)
        # no-call: depth == 0 is not encodable in the 2-bit winner
        no_call = depth == 0
        if no_call.any():
            winner[no_call] = N_CODE
            qual[no_call] = MIN_PHRED
            errors[no_call] = 0
        self._count_suspects(suspect)
        if suspect.any():
            t0 = time.monotonic()
            self._oracle_patch(
                suspect, winner, qual, depth, errors,
                lambda f: (codes2d[starts[f]:starts[f + 1]],
                           quals2d[starts[f]:starts[f + 1]]))
            self._add_patch_s(time.monotonic() - t0)
        return winner, qual, depth, errors

    def _count_suspects(self, suspect: np.ndarray):
        n = int(suspect.sum())
        with self._lock:
            self.total_positions += suspect.size
            self.fallback_positions += n

    def _add_patch_s(self, dt: float):
        with self._lock:
            self.patch_s += dt

    def _oracle_patch(self, suspect, winner, qual, depth, errors,
                      family_rows):
        """Recompute suspect positions exactly with the f64 oracle (in
        place). ``family_rows(f) -> (codes (R, L), quals (R, L))``.

        Suspect (family, position) pairs are stacked as columns of a shared
        (R_bucket, C) pileup and recomputed in one oracle call per pow2
        family-depth bucket: the oracle is vectorized over positions and
        N-row padding is a no-op for it, so this equals the per-family loop
        with far fewer numpy round trips; depth bucketing caps pad waste
        at 2x."""
        from . import oracle

        fam_idx, pos_idx = np.nonzero(suspect)
        fams, first = np.unique(fam_idx, return_index=True)
        bounds = np.append(first, len(fam_idx))  # fam_idx is sorted
        buckets = {}  # depth class -> [(codes, quals, col pair slice)]
        for i, f in enumerate(fams):
            sel = slice(bounds[i], bounds[i + 1])
            positions = pos_idx[sel]
            fam_codes, fam_quals = family_rows(f)
            cls = max(int(fam_codes.shape[0]) - 1, 0).bit_length()
            buckets.setdefault(cls, []).append(
                (fam_codes[:, positions], fam_quals[:, positions], sel))
        for cols in buckets.values():
            r_max = max(cc.shape[0] for cc, _, _ in cols)
            c_tot = sum(cc.shape[1] for cc, _, _ in cols)
            col_codes = np.full((r_max, c_tot), N_CODE, dtype=np.uint8)
            col_quals = np.zeros((r_max, c_tot), dtype=np.uint8)
            c0 = 0
            for cc, cq, _ in cols:
                col_codes[:cc.shape[0], c0:c0 + cc.shape[1]] = cc
                col_quals[:cq.shape[0], c0:c0 + cq.shape[1]] = cq
                c0 += cc.shape[1]
            w, q, d, e = oracle.call_family(col_codes, col_quals, self.tables)
            c0 = 0
            for cc, _, sel in cols:
                c1 = c0 + cc.shape[1]
                fi, pi = fam_idx[sel], pos_idx[sel]
                winner[fi, pi] = w[c0:c1]
                qual[fi, pi] = q[c0:c1]
                depth[fi, pi] = d[c0:c1]
                errors[fi, pi] = e[c0:c1]
                c0 = c1


def route_and_call_segments(kernel: ConsensusKernel, codes2d, quals2d,
                            counts, starts):
    """Route one dense (N, L) segment batch (``ROUTER.decide_batch``) and
    resolve it synchronously: the native f64 host engine, or the wire
    kernels on the kernel's device. (winner, qual, depth, errors) (J, L)."""
    from .router import ROUTER

    route = ROUTER.decide_batch(kernel, codes2d.shape[0], len(counts),
                                codes2d.shape[1])
    if route == "host":
        return kernel.host_call_segments(codes2d, quals2d, starts)
    cd, qd, starts = pad_segments(codes2d, quals2d, counts)
    dev = kernel.device_call_segments_wire(cd, qd, starts)
    out = kernel.resolve_segments_wire(dev, cd, qd, starts)
    L = codes2d.shape[1]
    return tuple(a[:, :L] for a in out)


# ------------------------------------------------------------ strand combines

def duplex_combine_device(resident: ResidentHandles, a_idx, b_idx, lens):
    """The duplex strand combine (K5) on the resident stage-1 arrays.

    a_idx/b_idx index rows of the resident (J, L) arrays (multi-read
    strand order); lens (K,) are the combined lengths. Only the three
    index vectors go up and only the (K, L) outputs come back: host
    (out_b u8, out_q u8, out_e int32), equal to the numpy combine for rows
    whose strands carry no oracle-patched position. A failed launch
    raises."""
    tb, tq, obs = resident.arrays
    host = torch.from_numpy(np.stack([
        np.asarray(a, dtype=np.int32) for a in (a_idx, b_idx, lens)]))

    def launch():
        idx = host.to(tb.device)
        return C.duplex_combine(tb, tq, obs, idx[0], idx[1], idx[2])

    out = device_retry_call(launch, "K5", len(lens))
    with span("device.fetch"), _fetch_failure("K5"):
        return tuple(t.cpu().numpy() for t in out)


def codec_combine_device(device, ba, bb, qa, qb, da, db, ea, eb):
    """The CODEC concordance combine (K6) on ``device`` over the batch
    engine's concatenated (T,) position arrays (uint8 bases/quals, int32
    depths/errors capped at I16_MAX): host (base u8, qual u8, depth int32,
    errors int32, both bool, disag bool), equal to
    ``consensus/codec.combine_arrays``. A failed launch raises.

    On CUDA the eight inputs are staged as the planes of one pinned buffer
    (``combine.plane_views``: 16-byte-aligned planes of T rounded up to 16)
    and go up in one copy; K6 writes the six results into one device
    buffer, fetched in one copy into pinned memory, and the results are
    numpy views of it. The pinned buffers come from PyTorch's caching host
    allocator, so a batch reuses the blocks of the batches before it once
    their copies are done. Calls cannot race one another: each stages into
    blocks of its own (the allocator hands a freed block out again only
    after the events of the copies that used it have completed), and its
    fetch is synchronous."""
    dev = torch.device(device)
    arrays = (ba, bb, qa, qb, da, db, ea, eb)
    T = len(ba)
    if dev.type != "cuda":
        ops = [torch.from_numpy(np.ascontiguousarray(a, dtype=dt))
               for a, dt in zip(arrays, (np.uint8,) * 4 + (np.int32,) * 4)]
        out = device_retry_call(lambda: C.codec_combine(*ops), "K6", T)
        return tuple(t.numpy() for t in out)
    staged = torch.empty(C.plane_bytes(T, C.CODEC_IN), dtype=torch.uint8,
                         pin_memory=True)
    for plane, a in zip(C.plane_views(staged, T, C.CODEC_IN), arrays):
        plane.numpy()[:] = a

    def launch():
        up = staged.to(dev, non_blocking=True)
        res = torch.empty(C.plane_bytes(T, C.CODEC_OUT), dtype=torch.uint8,
                          device=dev)
        C.codec_combine(*C.plane_views(up, T, C.CODEC_IN), out=res)
        return res

    out = device_retry_call(launch, "K6", T)
    with span("device.fetch"), _fetch_failure("K6"):
        host = torch.empty(out.numel(), dtype=torch.uint8, pin_memory=True)
        host.copy_(out)
    return tuple(v.numpy() for v in C.plane_views(host, T, C.CODEC_OUT))


# ------------------------------------------------------------------ canary

#: the canary's payload: 1 MiB of zeros (the JAX package's ``_CANARY_BYTES``)
CANARY_BYTES = 1 << 20
_CANARY_POLL_S = 0.001


class _Canary:
    """One device's canary state: its own CUDA stream, the pinned zero
    payload every round trip copies from (read-only, so reused), and the
    round trips given up at their deadline, each kept alive (its event and
    buffers) until its event completes."""

    def __init__(self, device: torch.device):
        self.stream = torch.cuda.Stream(device)
        self.payload = torch.zeros(CANARY_BYTES,
                                   dtype=torch.uint8).pin_memory()
        self.abandoned = []

    def reap(self):
        self.abandoned = [a for a in self.abandoned if not a[0].query()]


_CANARIES = {}
_CANARY_LOCK = threading.Lock()


def device_canary(timeout_s: float = 10.0):
    """One tiny end-to-end round trip on the card under its own deadline.

    Returns ``(ok, wall_s, error)``. On the canary's own stream: the zero
    payload up from the reused pinned buffer, its sum through K7
    (``ops/canary.canary_sum``), the 4-byte result down into pinned memory,
    and an event recorded after them; the host polls the event until the
    deadline and never blocks on the card. A round trip past the deadline
    is abandoned (its buffers live until its event completes) and reported
    as ``(False, wall, "deadline ...")``; a result other than 0 is
    corruption. Used by the health monitor
    (:class:`fgumi_tpu_torch.ops.breaker.HealthMonitor`); callers feed the
    breaker from the result; a clean round trip feeds the router's link
    and overhead estimates, as the JAX package's does."""
    from .canary import canary_sum

    t0 = time.monotonic()
    deadline = t0 + timeout_s
    with _CANARY_LOCK:  # one canary at a time
        try:
            dev = torch.device("cuda", torch.cuda.current_device())
            state = _CANARIES.get(dev.index)
            if state is None:
                state = _CANARIES[dev.index] = _Canary(dev)
            state.reap()
            with torch.cuda.device(dev), torch.cuda.stream(state.stream):
                x = torch.empty(CANARY_BYTES, dtype=torch.uint8, device=dev)
                x.copy_(state.payload, non_blocking=True)
                total = canary_sum(x).reshape(1)
                host = torch.empty(1, dtype=torch.int32, pin_memory=True)
                host.copy_(total, non_blocking=True)
                done = torch.cuda.Event()
                done.record(state.stream)
            while not done.query():
                if time.monotonic() >= deadline:
                    state.abandoned.append((done, (x, total, host)))
                    return (False, time.monotonic() - t0,
                            f"deadline {timeout_s:g}s exceeded; the "
                            "canary round trip was abandoned")
                time.sleep(_CANARY_POLL_S)
        except BaseException as e:  # noqa: BLE001 - canary outcome
            if not (_is_cuda_error(e) or _is_oom(e)):
                raise
            return (False, time.monotonic() - t0,
                    f"{type(e).__name__}: {_first_line(e)}")
    wall = time.monotonic() - t0
    got = int(host[0])
    if got != 0:  # the payload is zeros; anything else is corruption
        return False, wall, f"canary sum mismatch: {got}"
    from .router import ROUTER

    # a clean round trip is one more sample of the per-dispatch overhead
    # (the reference's canary feed; its upload is not timed apart here, so
    # it gives no link sample)
    ROUTER.observe_device(CANARY_BYTES, 4, 0.0, wall, wall)
    return True, wall, None
