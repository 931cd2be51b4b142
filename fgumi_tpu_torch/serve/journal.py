"""Append-only job journal (write-ahead log) for crash-recoverable serving.

Without it the daemon keeps its job registry in memory only: a SIGKILL
(OOM killer, node preemption) forgets every queued and running job, and
clients are left polling ids that no longer exist. The journal is the
daemon's durable memory — one JSONL record per event, fsync'd before the event is
acted on, schema-versioned like the wire protocol and the run report:

    {"v": 1, "ev": "submit", "t": <unix>, "id": "j-3", "argv": [...],
     "priority": "normal", "argv0": "fgumi-tpu", "tag": null,
     "trace": false, "dedupe": "<idempotency key or null>",
     "client": "<submitter id or null>",
     "traceparent": "<propagated trace context or null>",
     "hops": {"client_sent_unix": ...} | null,
     "shard": {"whale": "w-ab12-1", "index": 0, ...} | null}
    {"v": 1, "ev": "state", "t": <unix>, "id": "j-3",
     "state": "running" | "done" | "failed" | "cancelled" | "requeued",
     "exit_status": <int or null>, "error": "<diagnostic or null>"}

Write discipline (the ``utils/atomic`` philosophy applied to an append-only
file): every record is one ``write() + flush() + fsync()`` of a single
``\\n``-terminated line, so a crash can tear at most the final line. Replay
therefore treats the first undecodable line as the torn tail, truncates the
file back to the last good record, and carries on — a corrupt tail costs
one un-acknowledged event, never the history before it.

Recovery semantics (docs/serving.md "Crash recovery"): a job whose last
journaled state is non-terminal (``queued``/``running``/``requeued``) is
**requeued** on daemon restart, in original submission order. This is safe
because job outputs are atomic-commit (``utils/atomic``): a job killed mid-run never
published a partial artifact, so re-running it from scratch is
byte-identical to having run it once. Terminal jobs are restored to the
registry read-only so clients polling an old id get its final record, and
``dedupe`` keys are rebuilt so an idempotent resubmit after the crash
returns the already-finished job instead of running it twice.
"""

import json
import logging
import os
import threading
import time

from .jobs import TERMINAL, Job

log = logging.getLogger("fgumi_tpu_torch")

JOURNAL_VERSION = 1

#: journaled states beyond the registry's own (requeued marks a recovery)
_EVENTS = ("submit", "state")


class ReplayResult:
    """Everything a restarting daemon needs from the journal."""

    def __init__(self):
        self.jobs = []            # [record dicts] in submission order
        self.by_id = {}           # id -> merged record (spec + last state)
        self.dedupe = {}          # dedupe key -> job id
        self.max_job_num = 0      # highest numeric j-<n> suffix seen
        self.records = 0          # good records read
        self.truncated_bytes = 0  # torn-tail bytes removed
        self.last_entry_unix = None  # t of the last good record

    def incomplete(self):
        """Submission-ordered records whose last state is non-terminal —
        the requeue set."""
        return [r for r in self.jobs if r["state"] not in TERMINAL]


def replay(path: str) -> ReplayResult:
    """Read a journal, truncating a torn tail in place.

    Missing file -> empty result (first boot). The first line that fails
    to decode — torn write, partial flush, disk garbage — marks the tail:
    everything from its byte offset on is discarded AND the file is
    truncated back to the last good record, so the next append continues
    a clean log instead of interleaving with garbage."""
    out = ReplayResult()
    if not os.path.exists(path):
        return out
    good_end = 0
    with open(path, "rb") as f:
        while True:
            line = f.readline()
            if not line:
                break
            if not line.endswith(b"\n"):
                break  # torn tail: no newline made it to disk
            try:
                rec = json.loads(line)
                if not isinstance(rec, dict) or rec.get("ev") not in _EVENTS:
                    raise ValueError(f"not a journal record: {rec!r:.80}")
                if rec.get("v") != JOURNAL_VERSION:
                    raise ValueError(
                        f"journal version {rec.get('v')!r} != "
                        f"{JOURNAL_VERSION}")
            except ValueError as e:
                log.warning("journal %s: undecodable record at byte %d "
                            "(%s); truncating tail", path, good_end, e)
                break
            good_end += len(line)
            out.records += 1
            out.last_entry_unix = rec.get("t", out.last_entry_unix)
            _fold(out, rec)
        f.seek(0, os.SEEK_END)
        total = f.tell()
    if total > good_end:
        out.truncated_bytes = total - good_end
        with open(path, "r+b") as f:
            f.truncate(good_end)
        log.warning("journal %s: dropped %d torn-tail byte(s)", path,
                    out.truncated_bytes)
    return out


def _fold(out: ReplayResult, rec: dict):
    ev = rec["ev"]
    jid = rec.get("id")
    if not isinstance(jid, str):
        return
    if ev == "submit":
        merged = {
            "id": jid,
            "argv": list(rec.get("argv") or []),
            "priority": rec.get("priority", "normal"),
            "argv0": rec.get("argv0"),
            "tag": rec.get("tag"),
            "trace": bool(rec.get("trace")),
            "dedupe": rec.get("dedupe"),
            "client": rec.get("client"),
            # trace context survives restart AND fleet takeover: the job
            # keeps its client-visible correlation ids wherever it lands
            "traceparent": rec.get("traceparent"),
            "hops": rec.get("hops"),
            # scatter metadata survives too: a taken-over shard sub-job
            # stays attributable to its whale
            "shard": rec.get("shard"),
            "state": "queued",
            "exit_status": None,
            "error": None,
            "submitted_unix": rec.get("t"),
        }
        if jid not in out.by_id:  # first submit wins (resubmits dedupe)
            out.by_id[jid] = merged
            out.jobs.append(merged)
            if rec.get("dedupe"):
                out.dedupe[rec["dedupe"]] = jid
        suffix = jid.rsplit("-", 1)[-1]
        if suffix.isdigit():
            out.max_job_num = max(out.max_job_num, int(suffix))
    else:  # state
        merged = out.by_id.get(jid)
        if merged is None:
            return  # state for a job whose submit fell off the tail
        state = rec.get("state")
        merged["state"] = "queued" if state == "requeued" else state
        merged["exit_status"] = rec.get("exit_status")
        merged["error"] = rec.get("error")
        if state in TERMINAL:
            merged["finished_unix"] = rec.get("t")


class JobJournal:
    """The append side: one fsync'd line per event (thread-safe).

    Construct AFTER :func:`replay` has truncated any torn tail — the
    journal opens in append mode and trusts the file to end on a record
    boundary."""

    def __init__(self, path: str):
        self.path = path
        self._lock = threading.Lock()
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        self._f = open(path, "ab")
        self.appended = 0

    def _append(self, rec: dict):
        rec = {"v": JOURNAL_VERSION, "t": round(time.time(), 3), **rec}
        line = json.dumps(rec, separators=(",", ":"),
                          sort_keys=True).encode() + b"\n"
        with self._lock:
            if self._f.closed:
                return  # daemon already shut down; nothing left to promise
            self._f.write(line)
            self._f.flush()
            try:
                os.fsync(self._f.fileno())
            except OSError:
                pass  # fsync-incapable target: flush is the best we have
            self.appended += 1

    def record_submit(self, job: Job, dedupe: str = None):
        self._append({"ev": "submit", "id": job.id, "argv": job.argv,
                      "priority": job.priority, "argv0": job.argv0,
                      "tag": job.tag, "trace": job.trace, "dedupe": dedupe,
                      "client": job.client, "traceparent": job.traceparent,
                      "hops": job.hops, "shard": job.shard})

    def record_state(self, job: Job):
        self._append({"ev": "state", "id": job.id, "state": job.state,
                      "exit_status": job.exit_status, "error": job.error})

    def record_requeued(self, job_id: str):
        self._append({"ev": "state", "id": job_id, "state": "requeued",
                      "exit_status": None, "error": None})

    def close(self):
        with self._lock:
            if not self._f.closed:
                self._f.close()

