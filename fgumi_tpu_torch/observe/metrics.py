"""Metrics registry under stable dotted names, with latency histograms.

Components fold their counters in (at close or end of run, never per
record) and the run report reads one flat ``{dotted.name: number}``
mapping. The names (the run report's schema relies on the prefixes):

- ``pipeline.stage.<stage>.busy_s`` / ``.blocked_s``: ``run_stages``
  timings; ``pipeline.stage.<name>.wall_s``: the ``pipeline`` command's
  wall of each stage (extract, sort, group, simplex, filter)
- ``pipeline.chain.fused`` (1 when the fused chain ran) and
  ``pipeline.chain.<producer>.<consumer>.{batches,bytes,peak_bytes,
  put_wait_s,get_wait_s}``: the fused chain's channels
- ``pipeline.queue.{in,out}.{sum,max}``, ``pipeline.queue.samples``
- ``device.*``: the ``DeviceStats`` snapshot (dispatches, bytes uploaded
  and fetched, fetch wait, dispatches in flight)
- ``io.bytes_read`` / ``io.bytes_written``: compressed bytes through the
  BGZF reader and writer
- ``records.<label>``: ``ProgressTracker`` totals per command label
- ``governor.*`` / ``resource.*``: the resource governor's state

Latency histograms (``METRICS.observe(name, seconds)``) fold into the run
report's ``latency`` section as ``{count, sum, p50, p90, p99, max}``:

- ``device.dispatch.{fetch_s,fetch_bytes,wall_s}``: per consensus
  dispatch, at its fetch
- ``pipeline.chain.{put_wait_s,get_wait_s}``: per-blob waits of the fused
  chain's channels
- ``sort.{spill_s,merge_frame_s}``: spill runs and merge frame reads
- ``io.bgzf.{compress_s,decompress_s}``: per BGZF compress or inflate run
- ``io.commit_s`` and ``io.output_audit_s``: atomic commits and
  ``--audit-output`` passes
"""

import bisect
import math
import threading

# ---------------------------------------------------------------------------
# histograms

#: Geometric bucket growth: 4 buckets per octave (~19% wide), deterministic
#: for a given value — the same observation always lands in the same bucket
#: on every platform, so summaries are reproducible across runs.
HIST_GROWTH = 2.0 ** 0.25
#: Lowest bucket upper edge (1 µs) and bucket count: edges span ~1 µs to
#: ~1e6 s, far past any real latency; values beyond either end clamp to the
#: boundary buckets.
HIST_MIN = 1e-6
HIST_BUCKETS = 164

#: Inclusive upper edges of every bucket, precomputed once.
HIST_EDGES = tuple(HIST_MIN * HIST_GROWTH ** i for i in range(HIST_BUCKETS))


class Histogram:
    """Deterministic log-bucketed latency histogram.

    Observations land in geometric buckets (:data:`HIST_EDGES`); quantiles
    are read as the upper edge of the bucket holding the quantile rank,
    clamped to the exact observed max — so ``p50 <= p90 <= p99 <= max``
    holds by construction and the error of any quantile is bounded by one
    bucket width (~19%). Not thread-safe on its own; the owning
    :class:`MetricsRegistry` serializes access."""

    __slots__ = ("count", "total", "max", "_buckets")

    def __init__(self):
        self.count = 0
        self.total = 0.0
        self.max = 0.0
        self._buckets = {}  # bucket index -> observation count (sparse)

    @staticmethod
    def bucket_index(value: float) -> int:
        """The (deterministic) bucket a value lands in."""
        idx = bisect.bisect_left(HIST_EDGES, float(value))
        return min(idx, HIST_BUCKETS - 1)

    def observe(self, value) -> None:
        v = float(value)
        if v < 0.0 or math.isnan(v):
            return  # a backwards clock must not poison the distribution
        idx = self.bucket_index(v)
        self._buckets[idx] = self._buckets.get(idx, 0) + 1
        self.count += 1
        self.total += v
        if v > self.max:
            self.max = v

    def merge(self, other: "Histogram") -> None:
        """Fold another histogram in (scope-exit publishing, shard joins)."""
        for idx, n in other._buckets.items():
            self._buckets[idx] = self._buckets.get(idx, 0) + n
        self.count += other.count
        self.total += other.total
        if other.max > self.max:
            self.max = other.max

    def copy(self) -> "Histogram":
        h = Histogram()
        h.count = self.count
        h.total = self.total
        h.max = self.max
        h._buckets = dict(self._buckets)
        return h

    def quantile(self, q: float) -> float:
        """The q-quantile (0 < q <= 1) as a bucket upper edge, clamped to
        the observed max."""
        if not self.count:
            return 0.0
        rank = q * self.count
        seen = 0
        for idx in sorted(self._buckets):
            seen += self._buckets[idx]
            if seen >= rank:
                return min(HIST_EDGES[idx], self.max)
        return self.max

    def buckets(self):
        """``[(upper_edge_s, cumulative_count), ...]`` over non-empty
        buckets, cumulative — the Prometheus ``le`` series shape."""
        out = []
        seen = 0
        for idx in sorted(self._buckets):
            seen += self._buckets[idx]
            out.append((HIST_EDGES[idx], seen))
        return out

    def summary(self) -> dict:
        """The run-report summary: count, sum, p50/p90/p99, max."""
        return {
            "count": self.count,
            "sum": round(self.total, 6),
            "p50": round(self.quantile(0.50), 6),
            "p90": round(self.quantile(0.90), 6),
            "p99": round(self.quantile(0.99), 6),
            "max": round(self.max, 6),
        }


class MetricsRegistry:
    """Thread-safe flat registry of numeric metrics under dotted names."""

    def __init__(self):
        self._lock = threading.Lock()
        self._values = {}
        self._hists = {}  # dotted name -> Histogram

    def inc(self, name: str, n=1):
        """Add ``n`` to a counter (creating it at 0)."""
        with self._lock:
            self._values[name] = self._values.get(name, 0) + n

    def set(self, name: str, value):
        """Set a gauge to ``value`` (last write wins)."""
        with self._lock:
            self._values[name] = value

    def max(self, name: str, value):
        """Raise a high-water-mark gauge to ``value`` if larger."""
        with self._lock:
            if value > self._values.get(name, value - 1):
                self._values[name] = value

    def update(self, mapping, prefix: str = ""):
        """Fold a ``{name: number}`` mapping in under an optional prefix.

        Numeric values accumulate (so two pipeline stages or two CLI
        sub-stages of one chained command sum rather than clobber);
        non-numeric values overwrite."""
        p = prefix + "." if prefix and not prefix.endswith(".") else prefix
        with self._lock:
            for k, v in mapping.items():
                key = p + k
                if isinstance(v, bool) or not isinstance(v, (int, float)):
                    self._values[key] = v
                else:
                    self._values[key] = self._values.get(key, 0) + v

    def get(self, name: str, default=None):
        with self._lock:
            return self._values.get(name, default)

    def observe(self, name: str, value) -> None:
        """Record one latency observation into the named histogram
        (created on first use)."""
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = Histogram()
            h.observe(value)

    def histogram(self, name: str):
        """A copy of one histogram, or None."""
        with self._lock:
            h = self._hists.get(name)
            return h.copy() if h is not None else None

    def histograms(self) -> dict:
        """Name-sorted ``{name: Histogram}`` copies of every histogram."""
        with self._lock:
            return {k: self._hists[k].copy() for k in sorted(self._hists)}

    def summaries(self) -> dict:
        """Name-sorted ``{name: {count,sum,p50,p90,p99,max}}`` — the run
        report's ``latency`` section."""
        with self._lock:
            return {k: self._hists[k].summary() for k in sorted(self._hists)}

    def merge_histograms(self, hists: dict) -> None:
        """Fold ``{name: Histogram}`` in (scope-exit publishing: the
        process-global registry accumulates every finished scope's
        distributions: the cumulative view since the process started)."""
        with self._lock:
            for name, h in hists.items():
                mine = self._hists.get(name)
                if mine is None:
                    self._hists[name] = h.copy()
                else:
                    mine.merge(h)

    def snapshot(self) -> dict:
        """Name-sorted copy of every metric."""
        with self._lock:
            return dict(sorted(self._values.items()))

    def reset(self):
        with self._lock:
            self._values.clear()
            self._hists.clear()

    def replace(self, mapping: dict):
        """Overwrite this registry's counter/gauge content (scope
        publishing; histograms merge separately via
        :meth:`merge_histograms`)."""
        with self._lock:
            self._values = dict(mapping)


#: Fallback registry used when no telemetry scope is active (library use,
#: tests).
_GLOBAL_REGISTRY = MetricsRegistry()


def current_registry() -> MetricsRegistry:
    """The registry writes should land in: the active scope's (observe.scope)
    when one is entered (one per top-level command) else the process-global
    fallback."""
    from .scope import current_scope

    scope = current_scope()
    return scope.metrics if scope is not None else _GLOBAL_REGISTRY


class _RegistryProxy:
    """Drop-in stand-in for the old module-global registry: every call
    resolves the active scope first, so ``from ..observe.metrics import
    METRICS`` keeps working at every existing fold site while two scoped
    commands in one process stay isolated."""

    __slots__ = ()

    def inc(self, name: str, n=1):
        current_registry().inc(name, n)

    def set(self, name: str, value):
        current_registry().set(name, value)

    def max(self, name: str, value):
        current_registry().max(name, value)

    def update(self, mapping, prefix: str = ""):
        current_registry().update(mapping, prefix)

    def get(self, name: str, default=None):
        return current_registry().get(name, default)

    def observe(self, name: str, value):
        current_registry().observe(name, value)

    def histogram(self, name: str):
        return current_registry().histogram(name)

    def histograms(self) -> dict:
        return current_registry().histograms()

    def summaries(self) -> dict:
        return current_registry().summaries()

    def snapshot(self) -> dict:
        return current_registry().snapshot()

    def reset(self):
        current_registry().reset()


#: The registry every component folds into (scope-resolving proxy).
METRICS = _RegistryProxy()


def record_stage_times(stats) -> None:
    """Fold a :class:`fgumi_tpu_torch.pipeline.StageTimes` into :data:`METRICS`.

    Called once per run_stages completion (success or failure path), so
    every command that ran a pipeline contributes its per-stage busy/blocked
    seconds and queue-occupancy statistics to the run report."""
    for stage, dt in stats.busy.items():
        METRICS.inc(f"pipeline.stage.{stage}.busy_s", round(dt, 6))
    for stage, dt in stats.blocked.items():
        METRICS.inc(f"pipeline.stage.{stage}.blocked_s", round(dt, 6))
    if stats.q_samples:
        METRICS.inc("pipeline.queue.samples", stats.q_samples)
        METRICS.inc("pipeline.queue.in.sum", stats.q_in_sum)
        METRICS.inc("pipeline.queue.out.sum", stats.q_out_sum)
        METRICS.max("pipeline.queue.in.max", stats.q_in_max)
        METRICS.max("pipeline.queue.out.max", stats.q_out_max)
    peak = getattr(stats, "peak_in_flight_bytes", None)
    if peak:
        METRICS.max("pipeline.peak_in_flight_bytes", peak)
