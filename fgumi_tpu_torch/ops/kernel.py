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

Telemetry: each launch (K1, K1-f, K1-r, K1-p2, K5, K6) is a
``device.dispatch`` span (``what=`` the kernel, ``attempt=0``) around its
upload and enqueue, and each wait for a result a ``device.fetch`` span. A
CUDA launch returns before the kernel runs, so the card's time shows up
inside ``device.fetch``. Each resolved dispatch feeds the
``device.dispatch.{fetch_s,fetch_bytes,wall_s}`` histograms and the flight
recorder's ring. :data:`DEVICE_STATS` resolves the active command's
telemetry scope (``observe/scope.py``).
"""

import threading
import time

import numpy as np
import torch

from ..constants import MIN_PHRED, N_CODE
from ..observe.trace import NULL_SPAN, span
from . import combine as C
from . import cuda_kernel
from . import wire as W
from .tables import QualityTables, delta94

#: ResidentHandles made and not yet released (a run ends with 0)
LIVE_RESIDENTS = 0
_RESIDENTS_LOCK = threading.Lock()

#: pinned staging buffers an upload slot holds (uploads of one slot that
#: may be in flight at once before a dispatch waits for the oldest)
STAGING_DEPTH = 4


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

    def add_fetch(self, down_bytes: int, wait_s: float):
        """A fetch outside a dispatch's own (the fused route's gathers)."""
        with self._lock:
            self.fetch_wait_s += wait_s
            self.bytes_fetched += int(down_bytes)

    def snapshot(self) -> dict:
        with self._lock:
            return {"dispatches": self.dispatches,
                    "devices": sorted(self.device_types),
                    "fetch_wait_s": self.fetch_wait_s,
                    "bytes_uploaded": self.bytes_uploaded,
                    "bytes_fetched": self.bytes_fetched,
                    "in_flight": self.in_flight,
                    "in_flight_peak": self.in_flight_peak}

    def timeline_snapshot(self) -> list:
        with self._lock:
            return [dict(t) for t in self.timeline]

    def load_from(self, other: "DeviceStats"):
        """Adopt another instance's counters wholesale (a finished
        command's scope becomes the process-global view)."""
        with other._lock:
            state = {k: getattr(other, k) for k in (
                "dispatches", "fetch_wait_s", "bytes_uploaded",
                "bytes_fetched", "in_flight", "in_flight_peak", "_t0")}
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


def _dispatch_span(what: str, work: int):
    """The ``device.dispatch`` span of one launch of ``what``; the shared
    no-op when ``work`` is 0 (the wrapper then launches nothing)."""
    return span("device.dispatch", what=what, attempt=0) if work \
        else NULL_SPAN


class Dispatch:
    """One consensus dispatch in flight: the kernel's device outputs, the
    host clock when its upload began, and its :data:`DEVICE_STATS`
    timeline slot."""

    __slots__ = ("out", "t0", "slot", "up")

    def __init__(self, out, t0: float, slot: int, up: int):
        self.out = out
        self.t0 = t0
        self.slot = slot
        self.up = up


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

    def _begin(self, t0: float, out, *host) -> Dispatch:
        """The handle of a dispatch whose upload began at ``t0`` (the host
        tensors ``host`` went up)."""
        up = sum(t.numel() * t.element_size() for t in host)
        return Dispatch(out, t0, DEVICE_STATS.begin(self.device, up), up)

    def _fetch(self, handle: Dispatch, tensors):
        """Fetch ``tensors`` of ``handle``'s dispatch to host numpy arrays
        and close its accounting: its span (upload to fetched) goes into
        ``device_s``, its fetch wait into :data:`DEVICE_STATS`."""
        t_fetch = time.monotonic()
        with span("device.fetch") as sp:
            host = [t.cpu().numpy() for t in tensors]
            down = sum(a.nbytes for a in host)
            sp.set(bytes=down)
        now = time.monotonic()
        with self._lock:
            self.device_s += now - handle.t0
            self.batches += 1
        DEVICE_STATS.end(handle.slot, down, now - t_fetch)
        _observe_dispatch(now - handle.t0, now - t_fetch, handle.up, down)
        return host

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
        has > 63 distinct quals — and returns the device outputs (qs, wp,
        depth, errors) for :meth:`resolve_segments_wire`.

        ``resident_thresholds=(min_reads, min_qual)`` launches K1-r
        instead of K1 on the wire layout: the outputs then also hold the
        duplex combine's resident (tb, tq, obs). The packed2 route has no
        resident variant and ignores it (its rows take the host combine).
        Callers ask for it only when every family has fewer than 65,536
        reads (the u16 counts are exact)."""
        J = len(starts) - 1
        codes_t = torch.from_numpy(codes2d)
        quals_t = torch.from_numpy(quals2d)
        starts_t = torch.from_numpy(np.asarray(starts, dtype=np.int32))
        with self._lock:
            self.batch_shapes.append((*codes2d.shape, J))
        w = W.build_wire(codes_t, quals_t, self._delta94)
        if w is not None:
            wire, dict64 = w
            what = "K1" if resident_thresholds is None else "K1-r"
            t0 = time.monotonic()
            # a batch of no families launches nothing: no span either
            with _dispatch_span(what, J):
                args = (self._to_device(wire, "wire"),
                        self._to_device(starts_t, "starts"),
                        self._to_device(dict64, "dict"), self._pre)
                if resident_thresholds is not None:
                    out = cuda_kernel.consensus_wire_resident(
                        *args, *resident_thresholds)
                else:
                    out = cuda_kernel.consensus_wire_full(*args)
            return self._begin(t0, out, wire, starts_t, dict64)
        cp, qsent = W.pack_codes2(codes_t, quals_t)
        t0 = time.monotonic()
        with _dispatch_span("K1-p2", J):
            ct, et = self._device_tables()
            out = cuda_kernel.consensus_wire_packed2(
                self._to_device(cp, "wire"), self._to_device(qsent, "quals"),
                self._to_device(starts_t, "starts"), ct, et, self._pre)
        return self._begin(t0, out, cp, qsent, starts_t)

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
        :meth:`resolve_segments_wire_filtered`: ``(True, K1-f outputs)``,
        or ``(False, full outputs)`` when the batch has more than 63
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
        t0 = time.monotonic()
        with _dispatch_span("K1-f", len(starts) - 1):
            out = cuda_kernel.consensus_wire_filter(
                self._to_device(wire, "wire"),
                self._to_device(starts_t, "starts"),
                self._to_device(dict64, "dict"), self._pre, mr, mq,
                self._to_device(lens_t, "lens"), fparams.min_reads,
                self._emin(fparams.emin_tab), fparams.min_base_q,
                fparams.per_base)
        return True, self._begin(t0, out, wire, starts_t, dict64, lens_t)

    def resolve_segments_wire_filtered(self, ticket, codes2d: np.ndarray,
                                       quals2d: np.ndarray,
                                       starts: np.ndarray):
        """Resolve a fused ticket: ``("stats", stats (J, 7) int32,
        resident)`` with ``resident`` the device-side (fb, fq, depth,
        errors, qs, wp) for the gathers, or ``("columns", winner, qual,
        depth, errors)`` — full post-oracle columns — for the packed2
        route, where the caller's host filter pass takes over."""
        fused, handle = ticket
        if not fused:
            return ("columns",) + self.resolve_segments_wire(
                handle, codes2d, quals2d, starts)
        dev = handle.out
        stats, = self._fetch(handle, dev[:1])
        with self._lock:
            self.fused_batches += 1
            self.stats_bytes += stats.nbytes
            self.total_positions += dev[1].numel()
        return "stats", stats, dev[1:]

    def _gather(self, arrays, rows):
        """Rows ``rows`` of every resident (J, ...) array, fetched to the
        host: the survivors-only gathers (plain tensor indexing)."""
        t0 = time.monotonic()
        with span("device.fetch", what="gather") as sp:
            idx = torch.from_numpy(np.ascontiguousarray(rows,
                                                        dtype=np.int64))
            idx = idx.to(arrays[0].device)
            out = [t[idx].cpu().numpy() for t in arrays]
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
                              want_extras: bool = False):
        """Fetch + complete a dispatch: (winner, qual, depth, errors) (J, L)
        host arrays with every suspect recomputed by the f64 oracle.

        ``want_extras=True`` appends a dict: ``suspect``, the (J, L) mask
        of the positions the oracle patched, and ``resident``, the
        dispatch's :class:`ResidentHandles` (None unless it went through
        K1-r), which the caller releases. Without it a resident dispatch's
        handles are released here."""
        dev = dev_out.out
        resident = None
        if len(dev) == 7:
            resident = ResidentHandles(dev[4:])
        qs, wp, d16, e16 = self._fetch(dev_out, dev[:4])
        out = self._complete_wire_columns(
            qs, wp, d16.view(np.uint16), e16.view(np.uint16), codes2d,
            quals2d, starts)
        if want_extras:
            suspect = (qs[:len(starts) - 1] >> 7).astype(bool)
            return out + ({"suspect": suspect, "resident": resident},)
        if resident is not None:
            resident.release()
        return out

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
    """Dispatch one dense (N, L) segment batch on the kernel's device and
    resolve it synchronously: (winner, qual, depth, errors) (J, L)."""
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
    with _dispatch_span("K5", len(lens)):
        idx = torch.from_numpy(np.stack([
            np.asarray(a, dtype=np.int32) for a in (a_idx, b_idx, lens)]))
        idx = idx.to(tb.device)
        out = C.duplex_combine(tb, tq, obs, idx[0], idx[1], idx[2])
    with span("device.fetch"):
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
        with _dispatch_span("K6", T):
            return tuple(t.numpy() for t in C.codec_combine(*ops))
    with _dispatch_span("K6", T):
        staged = torch.empty(C.plane_bytes(T, C.CODEC_IN),
                             dtype=torch.uint8, pin_memory=True)
        for plane, a in zip(C.plane_views(staged, T, C.CODEC_IN), arrays):
            plane.numpy()[:] = a
        up = staged.to(dev, non_blocking=True)
        out = torch.empty(C.plane_bytes(T, C.CODEC_OUT), dtype=torch.uint8,
                          device=dev)
        C.codec_combine(*C.plane_views(up, T, C.CODEC_IN), out=out)
    with span("device.fetch"):
        host = torch.empty(out.numel(), dtype=torch.uint8, pin_memory=True)
        host.copy_(out)
    return tuple(v.numpy() for v in C.plane_views(host, T, C.CODEC_OUT))
