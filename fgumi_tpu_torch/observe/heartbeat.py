"""Periodic one-line progress heartbeat on the standard log stream.

The stall watchdog (:class:`fgumi_tpu_torch.pipeline._Watchdog`) speaks only
when nothing moves; a long run also wants the inverse, a regular "still
alive, here is where I am" line. Every ``interval`` seconds the heartbeat
logs the registered gauges (the stage runner's counters and queue depths,
the fused chain's running stages), device activity, the records/s rate and
ETA, device memory and RSS at INFO::

    heartbeat: +120s read=48 processed=47 written=45 q_in=2/4 q_out=1/8 \
device(dispatches=47 in-flight=1) rate=39000/s eta=30s rss=812MB

Components publish live state by registering a gauge callable returning a
``{label: value}`` dict (:func:`register_gauge`). Enabled by ``--heartbeat
SECONDS`` / ``FGUMI_TPU_HEARTBEAT_S``; off (0) by default, and then no
thread starts.
"""

import logging
import threading
import time

log = logging.getLogger("fgumi_tpu_torch")

_lock = threading.Lock()
_gauges = {}  # token -> callable() -> {label: value}
_next_token = [0]
#: expected total records for the ETA column (None = unknown), set by
#: whoever knows the workload size upfront (ProgressTracker(total=...));
#: the beat divides what remains by the records/s EWMA.
_goal = [None]

#: EWMA smoothing for the records/s estimate (per beat).
RATE_ALPHA = 0.3

#: gauge keys treated as "records so far", best first (the most-downstream
#: counter is the honest progress number).
_RECORD_KEYS = ("written", "processed", "read", "records")


def register_gauge(fn):
    """Register a live-state callable; returns a token for unregister."""
    with _lock:
        _next_token[0] += 1
        token = _next_token[0]
        _gauges[token] = fn
    return token


def unregister_gauge(token):
    with _lock:
        _gauges.pop(token, None)


def set_goal(total_records, token, gauge_token=None):
    """Declare the expected record total so beats can print an ETA.

    First claimant wins: ``token`` (any hashable owner id) must clear the
    goal before another can arm one, so two goal-declaring commands run
    at once in one process never clobber each other's ETA. ``gauge_token`` names the
    owner's OWN record gauge (register_gauge return value): the ETA is
    computed against that gauge only, never against whatever unrelated
    counter another concurrent command happens to publish. Returns True
    when armed."""
    if not total_records:
        return False
    with _lock:
        if _goal[0] is not None and _goal[0][0] != token:
            return False
        _goal[0] = (token, int(total_records), gauge_token)
        return True


def clear_goal(token):
    with _lock:
        if _goal[0] is not None and _goal[0][0] == token:
            _goal[0] = None


def _goal_info():
    """``(total, gauge_token)`` of the armed goal, or ``(None, None)``."""
    with _lock:
        if _goal[0] is None:
            return None, None
        return _goal[0][1], _goal[0][2]


def _goal_total():
    return _goal_info()[0]


def _gauge_states() -> list:
    """Live ``(token, {label: value})`` state of every registered gauge,
    registration order. A list, not a merged dict: concurrent gauges
    (fused-pipeline stages) publish identical keys, and last-wins merging
    would hide all but one stage's progress."""
    with _lock:
        fns = list(_gauges.items())
    out = []
    for token, fn in fns:
        try:
            out.append((token, fn()))
        except Exception:  # noqa: BLE001 - a gauge must never kill the beat
            continue
    return out


def _records_from(states: list):
    """``(token, value)`` of the record counter to pace the rate EWMA by:
    the FIRST-registered gauge exposing a record key, most-downstream key
    first. Pinning to one stable gauge (not a merged view) keeps the EWMA
    from flipping between unrelated stage counters mid-run."""
    for token, state in states:
        for key in _RECORD_KEYS:
            v = state.get(key)
            if isinstance(v, int) and not isinstance(v, bool):
                return token, v
    return None, None


def _rss_mb():
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS"):
                    return int(line.split()[1]) // 1024
    except (OSError, ValueError, IndexError):
        pass
    return None


class Heartbeat:
    """Daemon timer logging one progress line every ``interval`` seconds."""

    def __init__(self, interval: float):
        self.interval = interval
        self._t0 = time.monotonic()
        self._stop = threading.Event()
        self._t = None
        # records/s EWMA state (fed per beat from ONE record gauge,
        # re-baselined whenever the source gauge changes)
        self.rate_ewma = None
        self._last_records = None
        self._last_records_t = None
        self._rate_source = None
        self.last_eta_s = None
        if interval > 0:
            # carry the caller's telemetry scope so the beat reads the
            # owning command's DeviceStats, not the process-global fallback
            from .scope import spawn_thread

            self._t = spawn_thread(self._loop, name="fgumi-heartbeat")
            self._t.start()

    def _loop(self):
        while not self._stop.wait(self.interval):
            self.beat()

    def _update_rate(self, states: list):
        """Advance the records/s EWMA from this beat's record gauge;
        returns (rate, eta_s) — either may be None."""
        goal, goal_gauge = _goal_info()
        if goal_gauge is not None:
            # a goal owner paces BOTH the rate and the ETA by its own
            # gauge; an unrelated concurrent command's counter must not
            # cross-contaminate either number
            own = [(t, s) for t, s in states if t == goal_gauge]
            source, records = _records_from(own)
            if records is None:
                goal = None  # owner's gauge gone: no ETA this beat
        else:
            source, records = _records_from(states)
        now = time.monotonic()
        if records is not None:
            if source != self._rate_source:
                # the pacing gauge changed (a stage finished, another
                # registered): re-baseline instead of computing a bogus
                # delta across unrelated counters
                self._rate_source = source
                self._last_records = None
            if self._last_records is not None:
                dt = now - self._last_records_t
                if dt > 0:
                    inst = max(records - self._last_records, 0) / dt
                    self.rate_ewma = inst if self.rate_ewma is None else \
                        (1.0 - RATE_ALPHA) * self.rate_ewma \
                        + RATE_ALPHA * inst
            self._last_records = records
            self._last_records_t = now
        eta = None
        if goal and records is not None and self.rate_ewma:
            eta = max(goal - records, 0) / self.rate_ewma
            self.last_eta_s = eta
        return self.rate_ewma, eta

    def beat(self):
        """Log one heartbeat line (also callable directly from tests)."""
        from .metrics import METRICS
        from .report import _device_stats

        parts = [f"heartbeat: +{time.monotonic() - self._t0:.0f}s"]
        states = _gauge_states()
        for _token, state in states:
            if state:
                parts.append(" ".join(f"{k}={v}" for k, v in state.items()))
        rate, eta = self._update_rate(states)
        if rate is not None:
            parts.append(f"rate={rate:.0f}/s")
        if eta is not None:
            parts.append(f"eta={eta:.0f}s")
        stats = _device_stats()  # None while ops.kernel is unimported
        # one locked snapshot: the counters move on resolve threads
        snap = stats.snapshot() if stats is not None else {}
        if snap.get("dispatches"):
            parts.append(
                f"device(dispatches={snap['dispatches']}"
                f" in-flight={snap['in_flight']})")
        # live device memory (None on --device cpu): logged and kept as
        # gauges, so the run report carries the figures the beat printed
        from .flight import device_memory_snapshot

        mem = device_memory_snapshot()
        if mem is not None:
            METRICS.set("device.memory.bytes_in_use", mem["bytes_in_use"])
            METRICS.set("device.memory.peak_bytes", mem["peak_bytes"])
            parts.append(f"devmem={mem['bytes_in_use'] / 1e6:.0f}MB"
                         f"(peak {mem['peak_bytes'] / 1e6:.0f}MB)")
        # tail visibility: the p99 dispatch wall straight from the latency
        # histogram (the counter above says how MUCH, this says how SLOW)
        wall = METRICS.histogram("device.dispatch.wall_s")
        if wall is not None and wall.count:
            parts.append(f"p99-dispatch={wall.quantile(0.99) * 1e3:.0f}ms")
        rss = _rss_mb()
        if rss is not None:
            parts.append(f"rss={rss}MB")
        # resource pressure (utils/governor.py): only worth a column when
        # the run is actually degrading
        import sys

        gov = sys.modules.get("fgumi_tpu_torch.utils.governor")
        if gov is not None and gov.GOVERNOR.state != "ok":
            parts.append(f"pressure={gov.GOVERNOR.state}")
        log.info(" ".join(parts))

    def stop(self):
        """Stop AND join (same discipline as the watchdog: a finished
        command must not leave a daemon timer logging behind it). The
        final rate/ETA estimates fold into the run report's metrics."""
        self._stop.set()
        if self._t is not None:
            self._t.join(timeout=5)
            self._t = None
        if self.rate_ewma is not None:
            from .metrics import METRICS

            METRICS.set("heartbeat.records_per_s", round(self.rate_ewma, 3))
            if self.last_eta_s is not None:
                METRICS.set("heartbeat.last_eta_s",
                            round(self.last_eta_s, 1))
