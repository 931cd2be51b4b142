"""Every-N-records progress logging.

Analog of the reference's ProgressTracker (fgumi-bam-io progress.rs:130):
a long-running command logs its cumulative count and rate every ``every``
records, so an operator can tell slow from stuck. A known ``total`` arms
the heartbeat's goal, so its beats print the rate and an ETA.
"""

import logging
import time

log = logging.getLogger("fgumi_tpu_torch")


class ProgressTracker:
    def __init__(self, label: str, every: int = 1_000_000,
                 total: int = None):
        self.label = label
        self.every = every
        self.count = 0
        self.total = total
        self._next = every
        self._t0 = time.monotonic()
        self._hb_token = None
        if total:
            # the goal plus a live record gauge let the beat print
            # `rate=N/s eta=Ms`; the first goal holder wins (a command run
            # at once in the same process gets no ETA, not a clobbered
            # one), and the ETA reads this tracker's own gauge
            from ..observe import heartbeat

            token = heartbeat.register_gauge(
                lambda: {"records": self.count})
            if heartbeat.set_goal(total, self, gauge_token=token):
                self._hb_token = token
            else:
                heartbeat.unregister_gauge(token)

    def add(self, n: int = 1):
        """Count ``n`` records (from one thread: the process stage)."""
        self.count += n
        if self.count < self._next:
            return
        dt = time.monotonic() - self._t0
        log.info("%s: %d records processed (%.0f/s)", self.label,
                 self.count, self.count / dt if dt else 0)
        while self._next <= self.count:
            self._next += self.every

    def finish(self):
        """The done line: at info level for a run of at least ``every``
        records, at debug level for a shorter one; nothing when nothing
        was counted. The total folds into the metrics registry
        (``records.<label>``, the run report's ``records`` section)."""
        if self._hb_token is not None:
            from ..observe import heartbeat

            heartbeat.clear_goal(self)
            heartbeat.unregister_gauge(self._hb_token)
            self._hb_token = None
        if self.count <= 0:
            return
        dt = time.monotonic() - self._t0
        level = logging.INFO if self.count >= self.every else logging.DEBUG
        log.log(level, "%s: done, %d records in %.1fs (%.0f/s)", self.label,
                self.count, dt, self.count / dt if dt else 0)
        from ..observe.metrics import METRICS

        METRICS.inc(f"records.{self.label}", self.count)
