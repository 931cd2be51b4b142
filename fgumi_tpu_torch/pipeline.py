"""The staged host runner: fixed-role threads around a serial process stage.

The reference's unified pipeline runs a pool of workers over nine steps
(unified_pipeline/base.rs:1123-1150); the batch engines need fewer roles,
joined by bounded queues for backpressure: a reader (BGZF inflate and
record boundaries, native), the processor (decode, group, pack, kernel
dispatch; the caller's thread), optional resolve workers (device fetch,
thresholds, strand combine, serialize) and a writer (BGZF deflate,
native). The native calls, ``zlib`` and the device fetches release the
GIL, so reading, processing, device work and writing overlap.

``threads <= 1`` runs everything on the caller's thread. Without a resolve
stage that is the strictly serial path; with one, the default holds one
output in flight, so a kernel dispatched for item N runs while item N+1 is
read and prepared (``FGUMI_TPU_INLINE_FLIGHT=1`` restores the strictly
serial order).

Telemetry (``observe/``): with tracing on, each pull from the source is a
``pipeline.read`` span and each item's process, resolve and sink a
``pipeline.process`` / ``pipeline.resolve`` / ``pipeline.sink`` span, on
whichever thread runs it; every exit path folds the :class:`StageTimes`
into the metrics registry; a threaded run publishes its counters and queue
depths to the heartbeat; every helper thread runs in the caller's telemetry
scope; and the ``pipeline.process`` fault point fires once per item.
"""

import logging
import os
import queue
import threading
import time
from collections import deque

from .observe.scope import spawn_thread
from .utils.governor import GOVERNOR, DynamicBudget, StopSignal

log = logging.getLogger("fgumi_tpu_torch")


class StageTimes:
    """Each stage's busy and blocked wall time, and queue-occupancy samples
    (the reference's per-step timers and QueueSample history,
    base.rs:2853-3379). Stages on several threads overlap, so the busy
    times do not add up to the wall."""

    def __init__(self):
        self.busy = {}
        self.blocked = {}
        self.q_samples = 0
        self.q_in_sum = 0
        self.q_in_max = 0
        self.q_out_sum = 0
        self.q_out_max = 0
        #: the input budget's most bytes held at once (0: no budget)
        self.peak_in_flight_bytes = 0
        #: the input budget's final snapshot (threaded runs)
        self.input_budget = None
        self._lock = threading.Lock()

    def add_busy(self, stage: str, dt: float):
        with self._lock:
            self.busy[stage] = self.busy.get(stage, 0.0) + dt

    def add_blocked(self, stage: str, dt: float):
        with self._lock:
            self.blocked[stage] = self.blocked.get(stage, 0.0) + dt

    def sample_queues(self, q_in_depth: int, q_out_depth: int):
        """One occupancy sample per processed item."""
        with self._lock:
            self.q_samples += 1
            self.q_in_sum += q_in_depth
            self.q_in_max = max(self.q_in_max, q_in_depth)
            self.q_out_sum += q_out_depth
            self.q_out_max = max(self.q_out_max, q_out_depth)

    def as_dict(self) -> dict:
        """The table's numbers (``--stats-json``)."""
        with self._lock:
            return {"busy_s": dict(self.busy),
                    "blocked_s": dict(self.blocked),
                    "q_samples": self.q_samples,
                    "q_in_max": self.q_in_max, "q_out_max": self.q_out_max,
                    "peak_in_flight_bytes": self.peak_in_flight_bytes,
                    "input_budget": self.input_budget}

    def format_table(self) -> str:
        stages = sorted(set(self.busy) | set(self.blocked))
        lines = ["stage        busy_s   blocked_s"]
        for s in stages:
            lines.append(f"{s:<12} {self.busy.get(s, 0.0):7.3f}   "
                         f"{self.blocked.get(s, 0.0):7.3f}")
        if self.q_samples:
            lines.append(
                f"queues       in avg {self.q_in_sum / self.q_samples:.1f} "
                f"max {self.q_in_max}; out avg "
                f"{self.q_out_sum / self.q_samples:.1f} max {self.q_out_max} "
                f"({self.q_samples} samples)")
        return "\n".join(lines)


class _Err:
    __slots__ = ("exc",)

    def __init__(self, exc):
        self.exc = exc


_DONE = object()


class _Watchdog:
    """Stall detector of the threaded modes (the reference's deadlock
    watchdog, deadlock.rs:1-60): a daemon thread samples the stage counters
    every ``interval`` seconds and, when no stage made progress between two
    samples, logs a queue and stage snapshot. With ``recover`` it also
    doubles the queue and byte limits on a stall where a limit is saturated
    (``--deadlock-recover``, deadlock.rs:409), at most four times."""

    def __init__(self, counters, q_in, q_out, interval: float,
                 recover: bool = False, budget: DynamicBudget = None):
        self._counters = counters
        self._q_in = q_in
        self._q_out = q_out
        self._interval = interval
        self._recover = recover
        self._budget = budget
        self._widenings_left = 4
        # a pipeline wedged on its first item reports after one interval
        self._last = (0, 0, 0)
        self._stop = threading.Event()
        self._t = None
        if interval > 0:  # <= 0 disables the watchdog
            self._t = spawn_thread(self._loop, name="fgumi-watchdog")
            self._t.start()

    def _loop(self):
        while not self._stop.wait(self._interval):
            snap = tuple(self._counters)
            if snap == self._last:
                log.warning(
                    "pipeline stalled for %.1fs: read=%d processed=%d "
                    "written=%d q_in=%d/%d q_out=%d/%d: no stage progressed "
                    "(device hang or downstream block?)",
                    self._interval, snap[0], snap[1], snap[2],
                    self._q_in.qsize(), self._q_in.maxsize,
                    self._q_out.qsize(), self._q_out.maxsize)
                if self._recover and self._widenings_left > 0 \
                        and self._capacity_bound():
                    self._widenings_left -= 1
                    self._widen()
            self._last = snap

    def _capacity_bound(self) -> bool:
        """Widen only when a limit is saturated: a stall with idle queues
        (a slow stage, a device hang) is no capacity deadlock."""
        full_in = 0 < self._q_in.maxsize <= self._q_in.qsize()
        full_out = 0 < self._q_out.maxsize <= self._q_out.qsize()
        b = self._budget
        saturated = b is not None and b.limit > 0 and b.used >= b.limit
        return full_in or full_out or saturated

    def _widen(self):
        for q in (self._q_in, self._q_out):
            with q.mutex:
                if q.maxsize > 0:
                    q.maxsize *= 2
                q.not_full.notify_all()
        if self._budget is not None:
            self._budget.widen()
        log.warning("deadlock-recover: queue limits doubled to q_in=%d "
                    "q_out=%d bytes=%s", self._q_in.maxsize,
                    self._q_out.maxsize,
                    self._budget.limit if self._budget else "n/a")

    def stop(self):
        """Stop and join the sampling thread."""
        self._stop.set()
        if self._t is not None:
            self._t.join(timeout=5)


def inline_flight() -> int:
    """Outputs held in flight by the inline mode with a resolve stage:
    ``FGUMI_TPU_INLINE_FLIGHT`` (the reference's switch; default 2, 1 for
    strict serial order)."""
    try:
        return max(int(os.environ.get("FGUMI_TPU_INLINE_FLIGHT", "2")), 1)
    except ValueError:
        return 2


def _traced_source(source_iter):
    """Each pull from the source as a ``pipeline.read`` span (on whichever
    thread drives the iterator)."""
    from .observe.trace import span

    it = iter(source_iter)
    while True:
        with span("pipeline.read"):
            try:
                item = next(it)
            except StopIteration:
                return
        yield item


def _traced_stage(name, fn, materialize=False):
    """A stage callable in a named span. ``materialize`` lists a lazy
    process output, so the span covers the work and not just the
    generator's construction."""
    from .observe.trace import span

    if materialize:
        def wrapped(item):
            with span(name):
                return list(fn(item))
    else:
        def wrapped(item):
            with span(name):
                return fn(item)
    return wrapped


def run_stages(source_iter, process_fn, sink_fn, threads: int = 0,
               queue_items: int = 4, stats: StageTimes = None,
               watchdog_interval: float = 120.0, resolve_fn=None,
               max_bytes: int = 0, item_bytes=None,
               deadlock_recover: bool = False, resolve_workers: int = None):
    """source -> process [-> resolve] -> sink, with optional threads.

    - ``source_iter`` yields work items (record batches);
    - ``process_fn(item)`` returns an iterable of outputs (serial: the
      carry and grouping state lives here);
    - ``resolve_fn(output)`` completes an output (optional, parallel: it
      must be pure per item, with its shared counters lock-guarded). With
      ``threads >= 4`` a pool of ``threads - 3`` workers (or
      ``resolve_workers``) applies it concurrently, and the writer puts
      the outputs back in serial order (the reference's write reorder,
      base.rs:1724-1920);
    - ``sink_fn(output)`` takes the outputs in input order (serial);
    - ``max_bytes`` with ``item_bytes(item)`` bounds the bytes of the
      queued input: the reader blocks while admitting another item would
      pass ``max_bytes`` (one item always admits);
    - ``deadlock_recover``: the stall watchdog doubles the queue and byte
      limits on a saturated stall instead of only logging.

    ``threads <= 1`` runs inline (see :func:`inline_flight`); ``threads``
    2-3 put a reader and a writer thread around the caller's processing
    thread, the resolve running on the writer; ``threads >= 4`` add the
    resolve workers. An exception in any stage propagates to the caller
    (the first one wins), and every thread is joined on every exit path.
    Returns ``stats``.
    """
    if stats is None:
        stats = StageTimes()
    from .observe import trace as _trace
    from .utils import faults

    if _trace.tracing_enabled():
        # wrapped only with tracing on: off, the hot path runs the
        # caller's bare callables
        source_iter = _traced_source(source_iter)
        process_fn = _traced_stage("pipeline.process", process_fn,
                                   materialize=True)
        if resolve_fn is not None:
            resolve_fn = _traced_stage("pipeline.resolve", resolve_fn)
        sink_fn = _traced_stage("pipeline.sink", sink_fn)
    if faults.armed("pipeline.process"):
        inner_process = process_fn

        def process_fn(item):
            faults.fire("pipeline.process")
            return inner_process(item)
    has_resolve = resolve_fn is not None
    if resolve_fn is None:
        resolve_fn = lambda out: out  # noqa: E731
    try:
        if threads <= 1:
            return _run_inline(source_iter, process_fn, sink_fn, stats,
                               resolve_fn,
                               inline_flight() if has_resolve else 1)
        return _run_threaded(source_iter, process_fn, sink_fn, threads,
                             queue_items, stats, watchdog_interval,
                             resolve_fn, max_bytes, item_bytes,
                             deadlock_recover, resolve_workers)
    finally:
        # every exit path, success or failure, so the run report can say
        # where the time went
        from .observe.metrics import record_stage_times

        record_stage_times(stats)


def _run_inline(source_iter, process_fn, sink_fn, stats, resolve_fn,
                max_pend):
    if max_pend == 1:
        t_last = time.monotonic()
        for item in source_iter:
            now = time.monotonic()
            stats.add_busy("read", now - t_last)
            for out in process_fn(item):
                sink_fn(resolve_fn(out))
            t_last = time.monotonic()
            stats.add_busy("process+write", t_last - now)
        return stats
    pend = deque()
    in_resolve = False
    try:
        t_last = time.monotonic()
        for item in source_iter:
            now = time.monotonic()
            stats.add_busy("read", now - t_last)
            for out in process_fn(item):
                pend.append(out)
                while len(pend) >= max_pend:
                    in_resolve = True
                    sink_fn(resolve_fn(pend.popleft()))
                    in_resolve = False
            t_last = time.monotonic()
            stats.add_busy("process+write", t_last - now)
        now = time.monotonic()
        while pend:
            in_resolve = True
            sink_fn(resolve_fn(pend.popleft()))
            in_resolve = False
        stats.add_busy("process+write", time.monotonic() - now)
    except BaseException:
        # a source or process failure still writes the outputs in flight
        # (the serial path wrote output N before it touched item N + 1);
        # when the resolve or the sink itself failed, writing the outputs
        # after the failed one would leave a hole, so they are dropped as
        # the threaded error path drops them. The first error wins.
        if not in_resolve:
            try:
                while pend:
                    sink_fn(resolve_fn(pend.popleft()))
            except BaseException:  # noqa: BLE001 - the first error wins
                pass
        raise
    return stats


def _run_threaded(source_iter, process_fn, sink_fn, threads, queue_items,
                  stats, watchdog_interval, resolve_fn, max_bytes,
                  item_bytes, deadlock_recover, resolve_workers):
    # resolve_workers overrides the threads - 3 pool (device runs want at
    # least 2, so a worker waiting on a fetch never starves the next one)
    if resolve_workers is not None:
        n_workers = max(int(resolve_workers), 0)
    else:
        n_workers = max(threads - 3, 0)
    q_in = queue.Queue(maxsize=queue_items)
    # the sink queue carries deferred work that holds whole batches, so its
    # depth bounds the bytes in flight too
    q_out = queue.Queue(maxsize=queue_items * 2)
    writer_exc = []
    counters = [0, 0, 0]  # read, processed, written
    stop = StopSignal()  # tells the reader to end on the error path
    # max_bytes is the user's cap (half of --max-memory): the governor may
    # lend part of it to a contended channel and give it back, never pass
    # it (only the stall watchdog's --deadlock-recover widens past it)
    budget = DynamicBudget("pipeline.input",
                           max_bytes if item_bytes is not None else 0,
                           ceiling=max_bytes)
    # governed, the input budget competes for the process's cap with the
    # fused chain's channels; its demand is the reader's wait in acquire
    # (producer starved) against the process stage's wait for input
    # (consumer starved)
    gov_token = None
    if budget.limit > 0:
        gov_token = GOVERNOR.register_budget(
            budget, demand_fn=lambda: {
                "put_wait_s": budget.wait_s,
                "get_wait_s": stats.blocked.get("process", 0.0)})

    def put_in(item) -> bool:
        while not stop.is_set():
            try:
                q_in.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def reader():
        # items travel as (charged bytes, item): each admission's charge is
        # released exactly once
        try:
            t_last = time.monotonic()
            for item in source_iter:
                now = time.monotonic()
                stats.add_busy("read", now - t_last)
                nb = 0
                if budget.limit > 0:
                    nb = int(item_bytes(item))
                    if not budget.acquire(nb, stop):
                        return
                if not put_in((nb, item)):
                    return
                counters[0] += 1
                t_last = time.monotonic()
                stats.add_blocked("read", t_last - now)
            put_in(_DONE)
        except BaseException as e:  # noqa: BLE001 - relayed to the caller
            put_in(_Err(e))

    # resolve pool: q_out carries (serial, output); workers push (serial,
    # resolved | _Err) to q_done; the writer restores serial order through
    # a holdback map, bounded by q_out's depth plus the workers
    q_done = queue.Queue() if n_workers else None

    def worker(widx):
        while True:
            got = q_out.get()
            if got is _DONE:
                q_done.put(_DONE)
                return
            serial, item = got
            t0 = time.monotonic()
            try:
                q_done.put((serial, resolve_fn(item)))
            except BaseException as e:  # noqa: BLE001 - relayed by the writer
                q_done.put((serial, _Err(e)))
            stats.add_busy(f"resolve[{widx}]", time.monotonic() - t0)

    def emit_ready(holdback, next_serial):
        while next_serial in holdback:
            out = holdback.pop(next_serial)
            next_serial += 1
            if isinstance(out, _Err):
                raise out.exc
            sink_fn(out)
            counters[2] += 1
        return next_serial

    def writer_pooled():
        next_serial = 0
        holdback = {}
        done_workers = 0
        try:
            while done_workers < n_workers:
                t0 = time.monotonic()
                got = q_done.get()
                now = time.monotonic()
                stats.add_blocked("write", now - t0)
                if got is _DONE:
                    done_workers += 1
                    continue
                serial, resolved = got
                holdback[serial] = resolved
                next_serial = emit_ready(holdback, next_serial)
                stats.add_busy("write", time.monotonic() - now)
            emit_ready(holdback, next_serial)
        except BaseException as e:  # noqa: BLE001 - relayed to the caller
            writer_exc.append(e)
            while done_workers < n_workers:
                if q_done.get() is _DONE:
                    done_workers += 1

    def writer_direct():
        try:
            while True:
                t0 = time.monotonic()
                out = q_out.get()
                now = time.monotonic()
                stats.add_blocked("write", now - t0)
                if out is _DONE:
                    return
                sink_fn(resolve_fn(out))
                counters[2] += 1
                stats.add_busy("write", time.monotonic() - now)
        except BaseException as e:  # noqa: BLE001 - relayed to the caller
            writer_exc.append(e)
            # drain, so the processor never blocks on a dead writer
            while q_out.get() is not _DONE:
                pass

    # every thread runs in a copy of the caller's context: a command's
    # telemetry scope follows its whole thread tree
    rt = spawn_thread(reader, name="fgumi-reader")
    wt = spawn_thread(writer_pooled if n_workers else writer_direct,
                      name="fgumi-writer")
    wts = [spawn_thread(worker, name=f"fgumi-worker-{i}", args=(i,))
           for i in range(n_workers)]
    watchdog = _Watchdog(counters, q_in, q_out, watchdog_interval,
                         recover=deadlock_recover, budget=budget)
    # the watchdog's view, for the heartbeat, while the stages run
    from .observe import heartbeat as _hb

    hb_token = _hb.register_gauge(lambda: {
        "read": counters[0], "processed": counters[1],
        "written": counters[2],
        "q_in": f"{q_in.qsize()}/{q_in.maxsize}",
        "q_out": f"{q_out.qsize()}/{q_out.maxsize}"})
    rt.start()
    wt.start()
    for t in wts:
        t.start()
    serial = 0
    try:
        while True:
            t0 = time.monotonic()
            item = q_in.get()
            now = time.monotonic()
            stats.add_blocked("process", now - t0)
            if item is _DONE:
                break
            if isinstance(item, _Err):
                raise item.exc
            nb, item = item
            try:
                for out in process_fn(item):
                    if n_workers:
                        q_out.put((serial, out))
                        serial += 1
                    else:
                        q_out.put(out)
            finally:
                if nb:
                    budget.release(nb)
            counters[1] += 1
            stats.add_busy("process", time.monotonic() - now)
            stats.sample_queues(q_in.qsize(), q_out.qsize())
            if writer_exc:
                raise writer_exc[0]
    finally:
        for _ in range(max(n_workers, 1)):
            q_out.put(_DONE)
        for t in wts:
            t.join()
        wt.join()  # the watchdog stays armed while the writer drains
        watchdog.stop()
        # stop, and drain until the reader ends: it tests the stop signal
        # on every bounded put, so it cannot block again past this join
        stop.set()
        while rt.is_alive():
            try:
                while True:
                    q_in.get_nowait()
            except queue.Empty:
                pass
            rt.join(timeout=0.2)
        _hb.unregister_gauge(hb_token)
        GOVERNOR.unregister_budget(gov_token)
        stats.peak_in_flight_bytes = budget.peak
        stats.input_budget = budget.snapshot()
    if writer_exc:
        raise writer_exc[0]
    if budget.limit > 0:
        # was the input queue budget-bound? (the run report's gauges)
        from .observe.metrics import METRICS

        p = f"governor.budget.{budget.name}"
        METRICS.set(f"{p}.limit", budget.limit)
        METRICS.max(f"{p}.peak", budget.peak)
        METRICS.inc(f"{p}.wait_s", round(budget.wait_s, 6))
    return stats
