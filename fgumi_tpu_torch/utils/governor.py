"""Process-wide resource governor: dynamic byte budgets and pressure
sentinels.

The host pipeline's byte budgets (``pipeline.run_stages``' input budget
under ``--max-memory``, the fused chain's channels) share one process. The
reference rebalances them: its ``DynamicRebalancer``
(unified_pipeline/rebalancer.rs:20-66) samples each queue's demand and
moves budget from idle queues to contended ones under one global cap. This
module is that, plus RSS and disk-free watermarks that degrade a run
predictably (soft: budgets shrink, the sort spills early, the merge stops
prefetching) or end it cleanly (hard: :class:`ResourceExhausted`, exit 4,
temporary files swept by the ordinary error paths) instead of letting it
die on an ``OSError`` mid-merge.

- :class:`DynamicBudget`: acquire/release accounting with the one item
  always admitted, plus damped grow/shrink clamped to a floor and a
  ceiling, with direction hysteresis so rebalancing cannot oscillate.
- :class:`ResourceGovernor` (the process's :data:`GOVERNOR`): components
  register budgets (with a demand callback reporting producer and consumer
  wait time) and watch paths (spill directories, the output directory); a
  thread started by every command samples demand and pressure each period,
  moves budget toward starved producers under the global cap
  (``FGUMI_TPU_MEM_BUDGET``) and runs the soft/hard watermark states.

Budgets change *when* bytes move, never *what* is written: a governed
run's output equals an ungoverned one's (``FGUMI_TPU_GOVERNOR=0``).

Knobs (the reference's names):

- ``FGUMI_TPU_GOVERNOR=0``: no thread; every budget stays static.
- ``FGUMI_TPU_MEM_BUDGET``: the global cap (a human size; default the
  detected available memory less a reserve, ``utils.memory.auto_budget``).
- ``FGUMI_TPU_GOVERNOR_PERIOD_S``: the sample period (default 0.5 s).
- ``FGUMI_TPU_RSS_SOFT`` / ``FGUMI_TPU_RSS_HARD``: RSS watermarks (human
  sizes; default 85% / 95% of the detected memory total).
- ``FGUMI_TPU_DISK_SOFT`` / ``FGUMI_TPU_DISK_HARD``: free-space watermarks
  of the watched paths (default 512 MiB / 64 MiB).
- ``FGUMI_TPU_MERGE_PREFETCH``: the sort merge's prefetch budget (default
  64 MiB; 0 turns it off; 0 under soft pressure).
"""

import errno as _errno
import logging
import os
import threading
import time

log = logging.getLogger("fgumi_tpu_torch")

#: default floor of a governed budget (shrunk below it a budget stops
#: being a pipeline and becomes a serializer)
_DEFAULT_FLOOR = 4 << 20

_MB = 1 << 20


class ResourceExhausted(RuntimeError):
    """A hard resource limit was hit (disk full, an RSS or disk hard
    watermark): the command ends with exit 4 and one line. ``kind`` names
    the event (``enospc``, ``hard_watermark``)."""

    def __init__(self, message: str, kind: str = "resource"):
        super().__init__(message)
        self.kind = kind


class StopSignal(threading.Event):
    """A stop event that wakes condition-variable waiters immediately:
    :meth:`DynamicBudget.acquire` subscribes its condition, so ``set()``
    releases a blocked producer at once instead of at a poll tick."""

    def __init__(self):
        super().__init__()
        self._subs_lock = threading.Lock()
        self._subs = []

    def subscribe(self, cv: threading.Condition):
        with self._subs_lock:
            self._subs.append(cv)

    def unsubscribe(self, cv: threading.Condition):
        with self._subs_lock:
            try:
                self._subs.remove(cv)
            except ValueError:
                pass

    def set(self):  # noqa: A003 - threading.Event API
        super().set()
        with self._subs_lock:
            subs = list(self._subs)
        for cv in subs:
            with cv:
                cv.notify_all()


class DynamicBudget:
    """Bytes-in-flight budget with damped, hysteretic resizing.

    Producers block in :meth:`acquire` while admitting another item would
    pass the limit, except that one item is always admitted (an oversized
    batch degrades to serial flow instead of deadlocking); ``limit <= 0``
    turns accounting off. ``peak`` is the most bytes charged at once,
    ``wait_s`` the producers' time blocked.

    Resizing (the governor's lever) is damped: at most one resize per
    ``damp_s`` window, a change of direction only after ``4 * damp_s`` of
    quiet, every limit clamped to ``[floor, ceiling]``. The stall
    watchdog's :meth:`widen` bypasses the damping (a wedged pipeline cannot
    wait out a cooldown) and raises the ceiling if it must.
    """

    def __init__(self, name: str, limit: int, floor: int = None,
                 ceiling: int = None, damp_s: float = None):
        limit = int(limit)
        self.name = name
        self.limit = limit
        if limit > 0:
            self.floor = int(floor) if floor is not None \
                else min(limit, _DEFAULT_FLOOR)
            self.ceiling = int(ceiling) if ceiling is not None \
                else limit * 8
        else:
            self.floor = 0
            self.ceiling = 0
        self.used = 0
        self.peak = 0
        self.wait_s = 0.0
        self.grows = 0
        self.shrinks = 0
        self.flips = 0  # direction reversals (the oscillation gauge)
        self.widenings = 0
        self.damp_s = governor_period() if damp_s is None else damp_s
        #: called (outside the lock) after every applied resize: a channel
        #: hooks its own condition here, so a grown budget releases its
        #: blocked producers at once
        self.on_resize = None
        self._last_resize = 0.0
        self._last_dir = 0
        self._cv = threading.Condition()

    def acquire(self, n: int, stop=None) -> bool:
        """Charge ``n`` bytes, blocking while the budget is exhausted.
        Returns False (nothing charged) once ``stop`` is set; a
        :class:`StopSignal` wakes the wait immediately, a plain Event is
        polled every 0.1 s. Raises :class:`ResourceExhausted` under hard
        pressure: a producer that must wait is the one that should stop."""
        if self.limit <= 0:
            return True
        sub = getattr(stop, "subscribe", None)
        t0 = time.monotonic()
        waited = False
        with self._cv:
            if sub is not None:
                sub(self._cv)
            try:
                while self.used > 0 and self.used + n > self.limit:
                    if stop is not None and stop.is_set():
                        return False
                    GOVERNOR.check_hard()
                    waited = True
                    self._cv.wait(None if sub is not None else 0.1)
            finally:
                if sub is not None:
                    stop.unsubscribe(self._cv)
                if waited:
                    self.wait_s += time.monotonic() - t0
            self.used += n
            self.peak = max(self.peak, self.used)
            return True

    def release(self, n: int):
        if self.limit <= 0:
            return
        with self._cv:
            self.used -= n
            self._cv.notify_all()

    def widen(self, factor: int = 2):
        """The stall watchdog's deadlock breaker: multiply the limit,
        undamped and past the rebalance ceiling (which is raised, so the
        escape stays), and wake every blocked producer."""
        with self._cv:
            if self.limit <= 0:
                return
            new = self.limit * factor
            if new > self.ceiling:
                log.warning("budget %s: stall widen %d -> %d MiB passes the "
                            "rebalance ceiling; raising it", self.name,
                            self.limit // _MB, new // _MB)
                self.ceiling = new
            self.widenings += 1
        # outside the lock: _resize runs the on_resize hook, which takes
        # the owner's condition
        self._resize(new, +1, force=True)

    def grow(self, add: int) -> int:
        """Damped grow by ``add`` bytes; returns the bytes granted."""
        before = self.limit
        self._resize(self.limit + int(add), +1)
        return self.limit - before

    def shrink(self, factor: float = 0.5) -> int:
        """Damped shrink toward the floor; returns the bytes given up."""
        before = self.limit
        self._resize(int(self.limit * factor), -1)
        return before - self.limit

    def _resize(self, new_limit: int, direction: int, force: bool = False):
        cb = None
        with self._cv:
            if self.limit <= 0:
                return
            now = time.monotonic()
            if not force:
                if now - self._last_resize < self.damp_s:
                    return  # damped: one resize per window
                if self._last_dir and direction != self._last_dir \
                        and now - self._last_resize < 4 * self.damp_s:
                    return  # hysteresis: no quick change of direction
            new_limit = max(self.floor, min(int(new_limit), self.ceiling))
            if new_limit == self.limit:
                return
            if self._last_dir and direction != self._last_dir:
                self.flips += 1
            self._last_dir = direction
            self._last_resize = now
            if new_limit > self.limit:
                self.grows += 1
            else:
                self.shrinks += 1
            self.limit = new_limit
            self._cv.notify_all()
            cb = self.on_resize
        if cb is not None:
            try:
                cb()
            except Exception:  # noqa: BLE001 - a hook must not undo a resize
                log.exception("budget %s: on_resize hook failed", self.name)

    def snapshot(self) -> dict:
        with self._cv:
            return {"limit": self.limit, "used": self.used,
                    "peak": self.peak, "floor": self.floor,
                    "ceiling": self.ceiling,
                    "wait_s": round(self.wait_s, 6), "grows": self.grows,
                    "shrinks": self.shrinks, "flips": self.flips,
                    "widenings": self.widenings}


# --------------------------------------------------------------------- config


def _parse_size_env(name: str, default: int) -> int:
    raw = os.environ.get(name, "")
    if not raw.strip():
        return default
    from .memory import parse_size

    try:
        return parse_size(raw)
    except ValueError:
        log.warning("%s=%s: unparseable size; using default %d", name, raw,
                    default)
        return default


def governor_enabled() -> bool:
    """False only under ``FGUMI_TPU_GOVERNOR=0``."""
    return os.environ.get("FGUMI_TPU_GOVERNOR", "").strip() != "0"


def governor_period() -> float:
    """The sample period, ``FGUMI_TPU_GOVERNOR_PERIOD_S`` (default 0.5 s,
    at least 0.05)."""
    try:
        return max(float(os.environ.get("FGUMI_TPU_GOVERNOR_PERIOD_S",
                                        "0.5")), 0.05)
    except ValueError:
        return 0.5


def mem_budget() -> int:
    """The global cap every governed budget shares
    (``FGUMI_TPU_MEM_BUDGET``, default detected available less a
    reserve)."""
    from .memory import auto_budget

    return _parse_size_env("FGUMI_TPU_MEM_BUDGET", auto_budget())


def _mem_total():
    """The detected memory ceiling: the cgroup's limit in a container,
    else MemTotal; None when neither is readable."""
    from .memory import _cgroup_limit

    limit = _cgroup_limit()
    if limit:
        return limit
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemTotal:"):
                    return int(line.split()[1]) << 10
    except (OSError, ValueError, IndexError):
        pass
    return None


def _read_rss():
    """This process's resident set size in bytes, or None."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS"):
                    return int(line.split()[1]) << 10
    except (OSError, ValueError, IndexError):
        pass
    return None


def _disk_free(path: str):
    """Free bytes on the filesystem holding ``path``, or None."""
    try:
        st = os.statvfs(path)
    except OSError:
        return None
    return st.f_bavail * st.f_frsize


def merge_prefetch_bytes() -> int:
    """The sort merge's frame prefetch budget (``sort/external.py``):
    ``FGUMI_TPU_MERGE_PREFETCH`` (0 turns it off), default 64 MiB, and 0
    while the governor reports pressure."""
    n = _parse_size_env("FGUMI_TPU_MERGE_PREFETCH", 64 << 20)
    if n > 0 and GOVERNOR.soft_pressure():
        return 0
    return n


# ------------------------------------------------------------------ governor


class _Entry:
    __slots__ = ("budget", "demand_fn", "last_put", "last_get")

    def __init__(self, budget, demand_fn):
        self.budget = budget
        self.demand_fn = demand_fn
        self.last_put = 0.0
        self.last_get = 0.0


#: producer wait growth in one tick that marks a queue contended / idle
_HOT_WAIT_S = 0.02
_COLD_WAIT_S = 0.001

#: resource events kept for :meth:`ResourceGovernor.snapshot`
_MAX_EVENTS = 50


class ResourceGovernor:
    """The process-wide budget rebalancer and pressure sentinel.

    Passive until :meth:`maybe_start` (every command calls it): registering
    alone never starts the thread, so library users and tests keep static
    budgets unless they opt in. :meth:`sample_once` is the whole body of a
    tick, and tests drive it directly with injected RSS and disk samplers
    (``_rss_fn``, ``_disk_fn``).
    """

    def __init__(self):
        self._lock = threading.RLock()
        self._entries = {}
        self._watch = {}
        self._next_token = 0
        self._thread = None
        self._stop = threading.Event()
        # the pressure state: a plain attribute, read without a lock on
        # the hot paths (a str reference cannot tear)
        self.state = "ok"  # ok | soft | hard
        self.hard_reason = None
        self._soft_reason = None
        self.rss_peak = 0
        self.disk_free_min = None
        self.samples = 0
        self.rebalances = 0
        self._events = []
        # injectable samplers (tests): () -> bytes | None, path -> bytes
        self._rss_fn = _read_rss
        self._disk_fn = _disk_free

    # ------------------------------------------------------------ registration

    def register_budget(self, budget: DynamicBudget, demand_fn=None) -> int:
        """Govern ``budget``. ``demand_fn()`` (optional) returns
        ``{"put_wait_s": float, "get_wait_s": float}``, the producers' and
        consumers' cumulative wait seconds; a budget without one is left out
        of demand rebalancing but still shrinks under pressure. Returns a
        token for :meth:`unregister_budget`."""
        with self._lock:
            self._next_token += 1
            token = self._next_token
            self._entries[token] = _Entry(budget, demand_fn)
            return token

    def unregister_budget(self, token):
        if token is None:
            return
        with self._lock:
            self._entries.pop(token, None)

    def watch_path(self, label: str, path: str) -> int:
        """Watch the filesystem holding ``path`` (a spill directory, the
        output directory) against the disk watermarks. Returns a token for
        :meth:`unwatch_path`."""
        with self._lock:
            self._next_token += 1
            token = self._next_token
            self._watch[token] = (label, path)
            return token

    def unwatch_path(self, token):
        if token is None:
            return
        with self._lock:
            self._watch.pop(token, None)

    # ---------------------------------------------------------------- lifecycle

    def maybe_start(self):
        """Start the sampling thread (idempotent; nothing under
        ``FGUMI_TPU_GOVERNOR=0``)."""
        if not governor_enabled():
            return
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return
            self._stop = threading.Event()
            self._thread = threading.Thread(target=self._loop,
                                            name="fgumi-governor",
                                            daemon=True)
            self._thread.start()

    def stop(self):
        with self._lock:
            thread = self._thread
            self._thread = None
        self._stop.set()
        if thread is not None and thread.is_alive():
            thread.join(timeout=5)

    def _loop(self):
        while not self._stop.wait(governor_period()):
            try:
                self.sample_once()
            except Exception:  # noqa: BLE001 - the sentinel must survive
                log.exception("resource governor sample failed")

    def record_event(self, kind: str, **info):
        """Keep one resource event (an ENOSPC, a watermark transition) for
        :meth:`snapshot`."""
        ev = {"kind": kind, "t": round(time.time(), 3), **info}
        with self._lock:
            self._events.append(ev)
            del self._events[:-_MAX_EVENTS]

    # ---------------------------------------------------------------- pressure

    def check_hard(self):
        """Raise :class:`ResourceExhausted` while the hard watermark is
        passed (from budget waits, channel puts and the sorter: the spots
        where stopping is clean)."""
        if self.state == "hard":
            raise ResourceExhausted(
                f"resource hard limit: {self.hard_reason}",
                kind="hard_watermark")

    def soft_pressure(self) -> bool:
        return self.state != "ok"

    def _sample_pressure(self):
        rss = self._rss_fn()
        soft = hard = None
        if rss is not None:
            self.rss_peak = max(self.rss_peak, rss)
            total = _mem_total()
            rss_soft = _parse_size_env(
                "FGUMI_TPU_RSS_SOFT",
                int(total * 0.85) if total else 1 << 62)
            rss_hard = _parse_size_env(
                "FGUMI_TPU_RSS_HARD",
                int(total * 0.95) if total else 1 << 62)
            if rss >= rss_hard:
                hard = (f"rss {rss // _MB} MiB >= hard watermark "
                        f"{rss_hard // _MB} MiB")
            elif rss >= rss_soft:
                soft = (f"rss {rss // _MB} MiB >= soft watermark "
                        f"{rss_soft // _MB} MiB")
        disk_soft = _parse_size_env("FGUMI_TPU_DISK_SOFT", 512 << 20)
        disk_hard = _parse_size_env("FGUMI_TPU_DISK_HARD", 64 << 20)
        with self._lock:
            watched = list(self._watch.values())
        for label, path in watched:
            free = self._disk_fn(path)
            if free is None:
                continue
            if self.disk_free_min is None or free < self.disk_free_min:
                self.disk_free_min = free
            if free <= disk_hard:
                hard = (f"{label} ({path}): {free // _MB} MiB free <= hard "
                        f"watermark {disk_hard // _MB} MiB")
            elif free <= disk_soft and soft is None:
                soft = (f"{label} ({path}): {free // _MB} MiB free <= soft "
                        f"watermark {disk_soft // _MB} MiB")
        new_state = "hard" if hard else ("soft" if soft else "ok")
        if new_state != self.state:
            self.record_event(f"pressure_{new_state}",
                              reason=hard or soft or "cleared")
            if new_state == "ok":
                log.info("resource pressure cleared")
            else:
                log.warning("resource pressure %s: %s", new_state,
                            hard or soft)
        self.hard_reason = hard
        self._soft_reason = soft
        self.state = new_state
        if new_state != "ok":
            # degrade: walk every governed budget toward its floor (damped
            # inside the budget: one step a tick) and wake blocked
            # producers, so they meet the hard state
            with self._lock:
                budgets = [e.budget for e in self._entries.values()]
            for b in budgets:
                b.shrink(0.5)
                if new_state == "hard":
                    with b._cv:
                        b._cv.notify_all()

    # --------------------------------------------------------------- rebalance

    def sample_once(self):
        """One tick: the chaos point, the pressure sentinels, then (without
        pressure) the demand rebalance. What the thread runs; tests call it
        directly."""
        from . import faults

        faults.fire("governor.sample")
        self.samples += 1
        self._sample_pressure()
        if self.state == "ok":
            self._rebalance()

    def _rebalance(self):
        with self._lock:
            entries = list(self._entries.values())
        hot, cold, total = [], [], 0
        for e in entries:
            b = e.budget
            if b.limit <= 0:
                continue
            total += b.limit
            if e.demand_fn is None:
                continue
            try:
                d = e.demand_fn()
            except Exception:  # noqa: BLE001 - a dead gauge never governs
                continue
            dput = float(d.get("put_wait_s", 0.0)) - e.last_put
            dget = float(d.get("get_wait_s", 0.0)) - e.last_get
            e.last_put += dput
            e.last_get += dget
            if dput > _HOT_WAIT_S:
                hot.append((dput, e))
            elif dput <= _COLD_WAIT_S:
                cold.append((dget, e))
        if not hot:
            return
        cap = mem_budget()
        hot.sort(key=lambda pair: pair[0], reverse=True)
        # donors: queues whose producers never wait; a starved consumer
        # (get wait growing) shows the queue runs empty, so the most
        # consumer-starved give first, then the most headroom above floor
        cold.sort(key=lambda pair: (pair[0],
                                    pair[1].budget.limit
                                    - pair[1].budget.floor),
                  reverse=True)
        for dput, e in hot:
            b = e.budget
            want = min(max(b.limit // 2, _MB), b.ceiling - b.limit)
            if want <= 0:
                continue
            for _, c in cold:
                if cap - total >= want:
                    break
                total -= c.budget.shrink(0.5)
            grant = min(want, cap - total)
            if grant <= 0:
                continue
            granted = b.grow(grant)
            if granted:
                total += granted
                self.rebalances += 1
                log.debug("governor: +%d MiB to %s (put wait +%.3fs, limit "
                          "now %d MiB)", granted // _MB, b.name, dput,
                          b.limit // _MB)

    def has_activity(self) -> bool:
        """Anything beyond a quiet run: an event, a rebalance, pressure."""
        with self._lock:
            return bool(self._events or self.rebalances
                        or self.state != "ok")

    def fold_metrics(self):
        """Fold the governor's state into ``METRICS`` (called at command
        exit inside the command's telemetry scope; the sampling thread
        itself belongs to no scope)."""
        from ..observe.metrics import METRICS

        with self._lock:
            METRICS.set("governor.samples", self.samples)
            METRICS.set("governor.rebalances", self.rebalances)
            METRICS.set("resource.state", self.state)
            if self.rss_peak:
                METRICS.max("resource.rss_peak_bytes", self.rss_peak)
            if self.disk_free_min is not None:
                METRICS.set("resource.disk_free_min_bytes",
                            self.disk_free_min)
            kinds = {}
            for ev in self._events:
                kinds[ev["kind"]] = kinds.get(ev["kind"], 0) + 1
            for kind, n in kinds.items():
                METRICS.set(f"resource.event.{kind}", n)
            for e in self._entries.values():
                snap = e.budget.snapshot()
                p = f"governor.budget.{e.budget.name}"
                METRICS.set(f"{p}.limit", snap["limit"])
                METRICS.max(f"{p}.peak", snap["peak"])
                METRICS.set(f"{p}.wait_s", snap["wait_s"])
                METRICS.set(f"{p}.grows", snap["grows"])
                METRICS.set(f"{p}.shrinks", snap["shrinks"])
                METRICS.set(f"{p}.flips", snap["flips"])

    def snapshot(self) -> dict:
        """The governor's state as JSON-safe data."""
        with self._lock:
            out = {
                "state": self.state,
                "samples": self.samples,
                "rebalances": self.rebalances,
                "rss_peak_bytes": self.rss_peak,
                "events": list(self._events),
                "budgets": {e.budget.name: e.budget.snapshot()
                            for e in self._entries.values()},
            }
            if self.disk_free_min is not None:
                out["disk_free_min_bytes"] = self.disk_free_min
            if self.hard_reason:
                out["hard_reason"] = self.hard_reason
        return out

    def reset_for_tests(self):
        """Stop the thread and restore the pristine pressure and event
        state (registrations are their owners' to manage)."""
        self.stop()
        with self._lock:
            self.state = "ok"
            self.hard_reason = None
            self._soft_reason = None
            self.rss_peak = 0
            self.disk_free_min = None
            self.samples = 0
            self.rebalances = 0
            self._events = []
            self._rss_fn = _read_rss
            self._disk_fn = _disk_free


#: The process-wide governor every component registers with.
GOVERNOR = ResourceGovernor()


def reraise_enospc(exc: BaseException, where: str, path: str = None):
    """Turn ``OSError(ENOSPC)`` into :class:`ResourceExhausted` (exit 4),
    recording an ``enospc`` event; any other exception returns, for the
    caller to re-raise. Call from ``except`` blocks around disk writes::

        except OSError as e:
            reraise_enospc(e, "sort.spill", path=tmp_dir)
            raise
    """
    if not isinstance(exc, OSError) or exc.errno != _errno.ENOSPC:
        return
    info = {"where": where}
    if path:
        info["path"] = path
        free = _disk_free(path)
        if free is not None:
            info["free_bytes"] = free
    GOVERNOR.record_event("enospc", **info)
    raise ResourceExhausted(
        f"disk full during {where}"
        + (f" ({path})" if path else "")
        + f": {exc}", kind="enospc") from exc
