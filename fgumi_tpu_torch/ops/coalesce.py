"""Cross-job dispatch coalescer: merged launches for concurrent serve jobs
(the JAX package's ops/coalesce.py, on the port's feeder and kernels).

In the serve daemon every job dispatches its own wire batches, so N
concurrent small jobs each pay a launch, an upload and a fetch where one
merged launch could serve them. Compatible pending batches are admitted
into one in-flight super-batch:

- ``ConsensusKernel.device_call_segments_wire`` offers every plain (not
  K1-r, not K1-f) wire dispatch to :meth:`DispatchCoalescer.maybe_submit`.
  While the window is armed the batch is held for up to
  ``FGUMI_TPU_COALESCE_WINDOW_MS`` (default 2 ms; 0 disables; ``serve
  --coalesce-window-ms`` sets it) waiting for partners with the same merge
  key — the same table fingerprint (the f32 quality tables and pre-UMI
  prior, and the device) and the same padded read length L (a multiple of
  4: the wire contract) — then the partners' rows are concatenated along
  the family axis into one dispatch through the ordinary feeder. Wire (K1)
  or packed2 (K1-p2) is chosen over the union, as for a solo batch.
- The coalescer is opt-in on the port (the JAX package arms it in every
  serving daemon): with neither ``FGUMI_TPU_COALESCE`` nor a window
  configured (``FGUMI_TPU_COALESCE_WINDOW_MS``, which ``serve
  --coalesce-window-ms`` sets; a deployment profile fills it only where
  ``FGUMI_TPU_COALESCE`` is set) it is off. Configured, or with
  ``FGUMI_TPU_COALESCE=auto``, the window arms only where it can pay: the
  serve daemon reports serving (:meth:`set_serving`) and the scheduler the
  running-job count (:meth:`set_active_jobs`); it opens at 2 or more. The
  hold is priced against the router's measured per-dispatch overhead
  (merging k batches saves about k - 1 overheads, so a longer hold can
  only lose). ``FGUMI_TPU_COALESCE=1`` forces the window (with the
  configured hold), ``0`` disables it.
- At resolve each partner takes exactly its own family slice of the merged
  fetch and runs the unchanged host completion — unpack, no-call restore,
  f64 oracle patch, the sentinel's audit tap — over its own rows under its
  own telemetry scope, so each job's output is byte-identical to its solo
  run. Bytes and waits are attributed to each partner in proportion.
- Faults: the ``serve.coalesce`` point fires inside every merged launch,
  under the same bounded retry as any launch. A failure that outlasts it
  reaches every partner's resolve, and each partner's job fails (exit 3,
  4 or 1, nothing published) — the port never finishes a batch on the
  host; an out-of-memory halves each partner's own rows on the card (the
  halves bypass the window: :func:`bypassed`).

Fairness: a batch above ``FGUMI_TPU_COALESCE_PARTNER_ROWS`` (default 64 Ki
rows) never rides or holds a window; a group closes at
``FGUMI_TPU_COALESCE_PARTNERS`` (default 8) partners or
``FGUMI_TPU_COALESCE_MAX_ROWS`` (default 256 Ki) merged rows; admission is
arrival-ordered (a newcomer that would overflow a group flushes it and
opens the next).

Telemetry: ``device.coalesce.*`` counters (``joined``, ``merged_batches``,
``solo_flushes``, ``partners``, ``oversize_solo``, ``partner_degraded``)
and histograms (``fill_ratio``, ``window_wait_s`` in each partner's scope),
a flight note per merge, and :meth:`snapshot` for the serve ``stats``
``coalesce`` section and ``/metrics``.
"""

import contextlib
import contextvars
import logging
import os
import threading
import time
import weakref

import numpy as np

log = logging.getLogger("fgumi_tpu_torch")

_BYPASS = contextvars.ContextVar("fgumi_tpu_torch_coalesce_bypass",
                                 default=False)


@contextlib.contextmanager
def bypassed():
    """No coalescing for dispatches made inside the block (the halves of
    an out-of-memory split)."""
    token = _BYPASS.set(True)
    try:
        yield
    finally:
        _BYPASS.reset(token)


def window_s() -> float:
    """The configured hold: ``FGUMI_TPU_COALESCE_WINDOW_MS`` (default 2;
    0 disables coalescing)."""
    try:
        ms = float(os.environ.get("FGUMI_TPU_COALESCE_WINDOW_MS", "2"))
    except ValueError:
        ms = 2.0
    return max(ms, 0.0) / 1e3


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, str(default)))
    except ValueError:
        return default


def max_partners() -> int:
    """A group closes at this many partners."""
    return max(_env_int("FGUMI_TPU_COALESCE_PARTNERS", 8), 2)


def partner_row_cap() -> int:
    """A batch of more rows than this dispatches solo at once."""
    return max(_env_int("FGUMI_TPU_COALESCE_PARTNER_ROWS", 1 << 16), 1)


def merged_row_cap() -> int:
    """A merged batch's row budget."""
    return max(_env_int("FGUMI_TPU_COALESCE_MAX_ROWS", 1 << 18), 1)


def _force_mode() -> str:
    """``force``, ``auto`` or ``off``: ``FGUMI_TPU_COALESCE`` when it says
    one of them, else ``auto`` where a window is configured and ``off``
    where none is (opt-in: the card's per-dispatch overhead is a few
    milliseconds, so the priced hold rarely meets a partner)."""
    v = os.environ.get("FGUMI_TPU_COALESCE", "").strip().lower()
    if v in ("1", "true", "on", "force"):
        return "force"
    if v in ("0", "false", "off"):
        return "off"
    if v == "auto" or os.environ.get("FGUMI_TPU_COALESCE_WINDOW_MS",
                                     "").strip():
        return "auto"
    return "off"


class CoalescedTicket:
    """One partner's handle of a merged dispatch, returned by
    ``device_call_segments_wire`` in place of a ``Dispatch``; its
    ``resolve_segments_wire`` routes through
    :meth:`DispatchCoalescer.resolve_partner`."""

    __slots__ = ("group", "index")

    def __init__(self, group, index: int):
        self.group = group
        self.index = index


class _Partner:
    """One job's pending batch inside a merge group."""

    __slots__ = ("kernel", "codes", "quals", "starts", "j", "rows", "pred_s",
                 "slot", "ctx", "t_submit")

    def __init__(self, kernel, codes, quals, starts, pred_s, slot):
        self.kernel = kernel
        self.codes = codes
        self.quals = quals
        self.starts = np.asarray(starts, dtype=np.int64)
        self.j = len(starts) - 1
        self.rows = int(codes.shape[0])
        self.pred_s = pred_s
        self.slot = slot
        # the submitter's context: the merged launch's accounting on the
        # flusher and feeder threads resolves this job's telemetry scope
        self.ctx = contextvars.copy_context()
        self.t_submit = time.monotonic()


class _MergeGroup:
    """Partners sharing one merged dispatch and its one fetch."""

    __slots__ = ("key", "seq", "partners", "deadline", "closed", "rows",
                 "total_j", "dispatched", "ticket", "what", "upload",
                 "flush_failure", "seg_bases", "t_flush", "_fetch_lock",
                 "_result", "_failure", "_settled", "__weakref__")

    def __init__(self, key, seq: int, deadline: float):
        self.key = key
        self.seq = seq
        self.partners = []
        self.deadline = deadline
        self.closed = False
        self.rows = 0
        self.total_j = 0
        self.dispatched = threading.Event()
        self.ticket = None
        self.what = "K1"
        self.upload = 0
        self.flush_failure = None
        self.seg_bases = None
        self.t_flush = None
        self._fetch_lock = threading.Lock()
        self._result = None
        self._failure = None
        self._settled = False

    def fetch(self, deadline):
        """(host arrays, total bytes, wall) of the merged result. The
        first partner to arrive waits and fetches (under its deadline);
        later partners get the cached result or the recorded failure."""
        with self._fetch_lock:
            if self._result is None and self._failure is None:
                self._do_fetch(deadline)
            if self._failure is not None:
                raise self._failure
            return self._result

    def settle(self, completed: bool):
        """Release the feeder slot once (``abandon`` unless the launch is
        known to have returned)."""
        from . import kernel as K

        if self._settled or self.ticket is None:
            return
        self._settled = True
        with K._LIVE_LOCK:
            K._LIVE_DISPATCHES.discard(self)
        if completed:
            K.DEVICE_FEEDER.mark_resolved(self.ticket)
        else:
            K.DEVICE_FEEDER.abandon(self.ticket)

    def _do_fetch(self, deadline):
        from ..utils import faults
        from . import kernel as K

        t0 = time.monotonic()
        completed = False
        try:
            if not self.dispatched.wait(deadline):
                raise K.DeadlineExceeded(
                    f"coalesced dispatch was not flushed within "
                    f"{deadline:.1f}s", injected=faults.hang_fired())
            if self.flush_failure is not None:
                raise self.flush_failure
            t_disp = time.monotonic()
            left = None if deadline is None else max(
                deadline - (t_disp - t0), 0.1)
            try:
                out, event, up_s = self.ticket.wait(left)
            except K.DeadlineExceeded:
                raise K.DeadlineExceeded(
                    f"device {self.what} coalesced dispatch did not "
                    f"complete within {deadline:.1f}s "
                    "(FGUMI_TPU_DISPATCH_DEADLINE_S); abandoned",
                    injected=faults.hang_fired()) from None
            except BaseException:
                completed = True
                raise
            completed = True
            left = None if deadline is None else max(
                deadline - (time.monotonic() - t0), 1.0)
            with K._fetch_failure(self.what):
                got = K.fetch_results(out, event, 4,
                                      None if left is None
                                      else time.monotonic() + left)
            del out
            if got is None:
                completed = False
                raise K.DeadlineExceeded(
                    f"device {self.what} coalesced dispatch did not "
                    f"complete within {deadline:.1f}s "
                    "(FGUMI_TPU_DISPATCH_DEADLINE_S); abandoned",
                    injected=faults.hang_fired())
            # the sentinel's drill point: merged results corrupt like solo
            # ones; each partner's audit tap attributes the damage
            got = faults.fire("device.fetch", got)
        except BaseException as e:  # noqa: BLE001 - replayed per partner
            self._failure = e
            self.settle(completed)
            if isinstance(e, K.DeadlineExceeded):
                K.DEVICE_STATS.add_deadline_abandon()
                K.BREAKER.record_deadline_overrun()
            return
        self.settle(True)
        total = sum(int(g.nbytes) for g in got)
        wall = time.monotonic() - t_disp
        self._result = (got, total, wall)
        # one cost-model feed with the merged economics
        from .router import ROUTER

        ROUTER.observe_device(self.upload, total, up_s, wall, up_s + wall)


class DispatchCoalescer:
    """The process's merge window between the engines and the feeder."""

    #: flusher threads (groups of different keys build independently)
    MAX_FLUSHERS = 4

    def __init__(self):
        self._lock = threading.Condition()
        self._groups = {}    # key -> the open group
        self._pending = []   # groups not yet flushed
        self._threads = []
        self._seq = 0
        self._serving = False
        self._active_jobs = 0
        self._reset_counters_locked()

    def _reset_counters_locked(self):
        self.merged_batches = 0
        self.solo_flushes = 0
        self.partners_merged = 0
        self.max_partners_seen = 0
        self.oversize_solo = 0
        self.rows_in = 0
        self.rows_dispatched = 0

    def reset(self):
        """Tests: flush pending groups and zero the counters."""
        self.drain(timeout=10.0)
        with self._lock:
            self._reset_counters_locked()

    # ----------------------------------------------------------- arming

    def set_serving(self, serving: bool):
        """The serve daemon's lifecycle: the window auto-arms only while a
        daemon serves."""
        with self._lock:
            self._serving = bool(serving)

    def set_active_jobs(self, n: int):
        """The scheduler's running-job count: the window auto-arms at 2
        or more."""
        with self._lock:
            self._active_jobs = int(n)
        from ..observe.metrics import METRICS

        METRICS.set("device.coalesce.active_jobs", int(n))

    def armed(self) -> bool:
        mode = _force_mode()
        if mode == "off" or window_s() <= 0:
            return False
        if mode == "force":
            return True
        with self._lock:
            return self._serving and self._active_jobs >= 2

    def _effective_window_s(self) -> float:
        """min(configured window, the router's per-dispatch overhead)."""
        win = window_s()
        if win <= 0:
            return 0.0
        from .router import ROUTER

        return min(win, max(ROUTER.device_overhead_s(), 0.0))

    # --------------------------------------------------------- admission

    def maybe_submit(self, kernel, codes2d, quals2d, starts):
        """Admit one plain wire dispatch into the window, or return None
        (the caller dispatches solo). Runs on the submitting thread, in
        the job's telemetry scope."""
        J = len(starts) - 1
        if J <= 0 or _BYPASS.get() or not self.armed():
            return None
        win = window_s() if _force_mode() == "force" \
            else self._effective_window_s()
        if win <= 0:
            return None
        from ..observe.metrics import METRICS
        from . import kernel as K

        rows = int(codes2d.shape[0])
        if rows > partner_row_cap():
            with self._lock:
                self.oversize_solo += 1
            METRICS.inc("device.coalesce.oversize_solo")
            return None
        L = int(codes2d.shape[1])
        # the partner's own accounting: what its solo dispatch would have
        # charged its scope (the merged upload goes to the feeder once)
        slot = K.DEVICE_STATS.begin(kernel.device, rows * L + 4 * (J + 1))
        pred = K._last_prediction()
        if pred is not None:
            K.DEVICE_STATS.note_pred(slot, pred)
        partner = _Partner(kernel, codes2d, quals2d, starts, pred, slot)
        key = (kernel._coalesce_key(), L)
        now = time.monotonic()
        with self._lock:
            self.rows_in += rows
            group = self._groups.get(key)
            if group is not None and (
                    group.closed
                    or group.rows + rows > merged_row_cap()
                    or len(group.partners) >= max_partners()):
                self._close_locked(group)
                group = None
            if group is None:
                self._seq += 1
                group = _MergeGroup(key, self._seq, deadline=now + win)
                self._groups[key] = group
                self._pending.append(group)
                with K._LIVE_LOCK:
                    K._LIVE_DISPATCHES.add(group)
            group.partners.append(partner)
            group.rows += rows
            group.total_j += partner.j
            ticket = CoalescedTicket(group, len(group.partners) - 1)
            # every running job has joined: nobody is left to wait for
            target = self._active_jobs if (self._serving
                                           and self._active_jobs >= 2) \
                else None
            if (len(group.partners) >= max_partners()
                    or group.rows >= merged_row_cap()
                    or (target is not None
                        and len(group.partners) >= target)):
                self._close_locked(group)
            self._ensure_thread_locked()
            self._lock.notify_all()
        METRICS.inc("device.coalesce.joined")
        return ticket

    def _close_locked(self, group: _MergeGroup):
        group.closed = True
        if self._groups.get(group.key) is group:
            del self._groups[group.key]

    # ------------------------------------------------------------ flusher

    def _ensure_thread_locked(self):
        self._threads = [t for t in self._threads if t.is_alive()]
        want = min(self.MAX_FLUSHERS, max(len(self._pending), 1))
        while len(self._threads) < want:
            t = threading.Thread(
                target=self._loop,
                name=f"fgumi-coalesce-flush-{len(self._threads)}",
                daemon=True)
            t.start()
            self._threads.append(t)

    def _loop(self):
        while True:
            with self._lock:
                group = None
                while group is None:
                    now = time.monotonic()
                    for g in self._pending:
                        if g.closed or g.deadline <= now:
                            group = g
                            break
                    if group is not None:
                        self._pending.remove(group)
                        self._close_locked(group)
                        break
                    nxt = min((g.deadline for g in self._pending),
                              default=None)
                    self._lock.wait(None if nxt is None
                                    else max(nxt - now, 0.0005))
            try:
                self._flush(group)
            except BaseException as e:  # noqa: BLE001 - replayed per partner
                from . import kernel as K

                log.exception("coalesce: merged dispatch build failed; its "
                              "%d partner(s) fail", len(group.partners))
                group.flush_failure = K.DeviceFailure(
                    f"coalesced dispatch build failed: {type(e).__name__}: "
                    f"{K._first_line(e)}")
                group.dispatched.set()
                group.settle(False)

    def drain(self, timeout: float = 5.0) -> bool:
        """Flush every held group now (daemon drain, tests). True when all
        reached the feeder within ``timeout``."""
        with self._lock:
            pend = list(self._pending)
            for g in pend:
                g.closed = True
            self._lock.notify_all()
        deadline = time.monotonic() + timeout
        for g in pend:
            if not g.dispatched.wait(max(deadline - time.monotonic(), 0.0)):
                return False
        return True

    def _flush(self, group: _MergeGroup):
        """Build and submit one merged dispatch (flusher thread)."""
        from ..observe.flight import FLIGHT
        from ..observe.metrics import METRICS
        from . import kernel as K

        group.t_flush = time.monotonic()
        partners = group.partners
        leader = partners[0]
        k = len(partners)
        if k == 1:
            codes_m, quals_m, starts_m = (leader.codes, leader.quals,
                                          leader.starts)
            group.seg_bases = (0,)
        else:
            codes_m = np.concatenate([p.codes for p in partners])
            quals_m = np.concatenate([p.quals for p in partners])
            bases, parts, row = [], [np.zeros(1, dtype=np.int64)], 0
            base = 0
            for p in partners:
                bases.append(base)
                parts.append(p.starts[1:] + row)
                row += p.rows
                base += p.j
            starts_m = np.concatenate(parts)
            group.seg_bases = tuple(bases)
        launch, what, J, host, _ = leader.kernel._wire_plan(
            codes_m, quals_m, starts_m, fault_point="serve.coalesce")
        group.what = what
        group.upload = sum(t.numel() * t.element_size() for t in host)
        run = leader.kernel.feeder_run(launch, what, J)
        group.ticket = leader.ctx.run(
            lambda: K.DEVICE_FEEDER.submit(run, group.upload))
        # partners that never resolve (their jobs failed) give the slot back
        weakref.finalize(group, K.DEVICE_FEEDER.release_dropped,
                         group.ticket).atexit = False
        fill = group.rows / max(codes_m.shape[0], 1)
        with self._lock:
            self.rows_dispatched += int(codes_m.shape[0])
            if k > 1:
                self.merged_batches += 1
                self.partners_merged += k
                self.max_partners_seen = max(self.max_partners_seen, k)
            else:
                self.solo_flushes += 1
        if k > 1:
            METRICS.inc("device.coalesce.merged_batches")
            METRICS.inc("device.coalesce.partners", k)
        else:
            METRICS.inc("device.coalesce.solo_flushes")
        METRICS.observe("device.coalesce.fill_ratio", fill)
        FLIGHT.note("device.coalesce.merge", partners=k,
                    rows=int(codes_m.shape[0]), segments=J,
                    upload=group.upload, kernel=what)
        group.dispatched.set()

    # ------------------------------------------------------------ resolve

    def resolve_partner(self, kernel, ticket: CoalescedTicket, codes2d,
                        quals2d, starts, split_depth: int = 0,
                        want_extras: bool = False):
        """One partner's resolve: the shared fetch, its family slice, the
        unchanged host completion (``ConsensusKernel.finish_wire``). A
        failure of the merged dispatch fails this partner (an
        out-of-memory halves its own rows on the card)."""
        from ..observe.metrics import METRICS
        from . import kernel as K

        group = ticket.group
        partner = group.partners[ticket.index]
        t0 = time.monotonic()
        deadline = K.dispatch_deadline_s(partner.pred_s)
        failure = got = None
        share = 0
        try:
            got, total, _wall = group.fetch(deadline)
            share = int(total * partner.j / max(group.total_j, 1))
        except BaseException as e:  # noqa: BLE001 - classified below
            failure = e
        now = time.monotonic()
        K.DEVICE_STATS.end(partner.slot, share, now - t0)
        METRICS.observe("device.coalesce.window_wait_s",
                        max((group.t_flush or t0) - partner.t_submit, 0.0))
        if failure is not None:
            METRICS.inc("device.coalesce.partner_degraded")
            if K._is_oom(failure):
                return kernel._recover_segments(
                    failure, codes2d, quals2d, starts, split_depth, None,
                    want_extras)
            raise failure
        with kernel._lock:
            kernel.device_s += now - partner.t_submit
            kernel.batches += 1
        K._observe_dispatch(now - partner.t_submit, now - t0,
                            partner.rows * partner.codes.shape[1], share)
        base = group.seg_bases[ticket.index]
        j = partner.j
        qs, wp, d16, e16 = (a[base:base + j] for a in got)
        return kernel.finish_wire(
            qs, wp, d16, e16, codes2d, quals2d, starts, want_extras,
            slot=partner.slot,
            partner={"group": group.seq, "index": ticket.index,
                     "partners": len(group.partners)})

    # ----------------------------------------------------------- surface

    def has_activity(self) -> bool:
        with self._lock:
            return bool(self.merged_batches or self.solo_flushes
                        or self.oversize_solo or self._pending)

    def snapshot(self) -> dict:
        """The serve ``stats`` op / ``/metrics`` ``coalesce`` section."""
        armed = self.armed()
        with self._lock:
            return {
                "armed": armed,
                "mode": _force_mode(),
                "window_ms": round(window_s() * 1e3, 3),
                # the hold the auto mode would take now: the window
                # priced at the router's per-dispatch overhead
                "priced_window_ms": round(
                    self._effective_window_s() * 1e3, 4),
                "serving": self._serving,
                "active_jobs": self._active_jobs,
                "merged_batches": self.merged_batches,
                "solo_flushes": self.solo_flushes,
                "partners": self.partners_merged,
                "max_partners": self.max_partners_seen,
                "oversize_solo": self.oversize_solo,
                "rows_in": self.rows_in,
                "rows_dispatched": self.rows_dispatched,
                "pending_groups": len(self._pending),
            }


#: the process's merge window (it spans every job of a daemon)
COALESCER = DispatchCoalescer()
