"""Silent-corruption sentinel: online shadow audit of device results (the
JAX package's ops/sentinel.py, with the port's devices and imports).

A card that returns wrong calls without failing corrupts consensus output
with no signal in any other metric, breaker or flight dump. The sentinel
re-executes a deterministic counter-based sample of resolved wire
dispatches (K1, K1-f, K1-r, K1-p2; ``FGUMI_TPU_AUDIT``: ``off``, ``all``
or N, one in N) on the native f64 host engine (ops/host_kernel.py) and
compares winner/qual/depth/errors exactly. Unset, the rate is 1 in
:data:`DEFAULT_RATE` for dispatches on the card; the plain PyTorch
versions of ``--device cpu`` are audited only under an explicit value.
Any mismatch is an SDC verdict:

- the breaker (ops/breaker.py) trips with reason ``sdc``: a quarantine
  that only ``FGUMI_TPU_AUDIT_READMIT`` fully audited clean probes lift;
- the flight recorder freezes a black box with both results' sha256
  digests;
- the run report, ``stats`` and ``/metrics`` carry ``audit.divergence``,
  and the fleet balancer holds any backend whose ``divergent`` is above 0.

Two modes:

- **sampled** (rate N > 1): the audit runs on one background thread; the
  resolve pays the sample decision and one copy of the dispatch's inputs
  and outputs. The queue is bounded (``FGUMI_TPU_AUDIT_QUEUE``, default
  :data:`DEFAULT_QUEUE`): an overflow drops the sample (counted).
- **inline** (``all``, or every dispatch while the breaker is
  SDC-quarantined): the audit runs on the resolving thread and a divergent
  dispatch is repaired — the resolve returns the oracle's result, so the
  published output stays byte-identical to a pure host run. Under the
  port's default route every dispatch keeps running on the card during a
  quarantine, audited inline: a repair is loud (counted, in the run
  report and the flight recorder, ``/healthz`` 503, the balancer's hold).

Resident columns (K1-f's survivors' gather) ride only inline audits. The
``--audit-output`` pass (io/bam.py) records its verdicts here too.
"""

import hashlib
import logging
import os
import threading
import time
from collections import deque

import numpy as np

log = logging.getLogger("fgumi_tpu_torch")

#: Default sample rate: one audited dispatch per this many device resolves.
DEFAULT_RATE = 64

#: Default bound on queued (not yet executed) background audits; overflow
#: drops the newest sample (counted in ``dropped``) instead of retaining
#: staging buffers without bound.
DEFAULT_QUEUE = 4

#: Bounded evidence kept for the run report.
MAX_DIVERGENCE_RECORDS = 16
MAX_OUTPUT_RECORDS = 8
#: Recent sampled dispatch ordinals (debug/determinism tests).
MAX_SAMPLED_ORDINALS = 64


def audit_rate(device_type: str = "cuda") -> int:
    """Parsed ``FGUMI_TPU_AUDIT``: 0 = off, 1 = every dispatch (inline),
    N > 1 = one audited dispatch per N resolves (background). Unset, the
    default applies to the card's dispatches (``device_type`` "cuda") and
    is off for the plain versions on the CPU."""
    v = os.environ.get("FGUMI_TPU_AUDIT", "").strip().lower()
    if v in ("", "default"):
        return DEFAULT_RATE if device_type == "cuda" else 0
    if v in ("off", "0", "false", "none"):
        return 0
    if v in ("all", "always", "1"):
        return 1
    try:
        return max(int(v), 0)
    except ValueError:
        log.warning("FGUMI_TPU_AUDIT=%r: expected off/all/N; using the "
                    "default 1/%d", v, DEFAULT_RATE)
        return DEFAULT_RATE


def _queue_cap() -> int:
    try:
        return max(int(os.environ.get("FGUMI_TPU_AUDIT_QUEUE",
                                      str(DEFAULT_QUEUE))), 1)
    except ValueError:
        return DEFAULT_QUEUE


_FIELDS = ("winner", "qual", "depth", "errors")


def _digest(arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


class AuditSentinel:
    """The process-wide shadow-audit machinery (singleton :data:`SENTINEL`).

    Like the breaker and the router, audit state is a per-process fact —
    the card under audit is shared by every job in the process — while
    the ``device.audit.*`` METRICS land in whichever telemetry scope
    observed them (the audit worker runs under the sampling resolve's
    captured context, as the device feeder does)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._q = deque()
        self._busy = False
        self._thread = None
        self._reset_locked()

    def _reset_locked(self):
        self._counter = 0
        self.sampled = 0
        self.clean = 0
        self.divergent = 0
        self.dropped = 0
        self.inline_audits = 0
        self.sampled_ordinals = deque(maxlen=MAX_SAMPLED_ORDINALS)
        # device index -> {"sampled", "clean", "divergent"}; single-device
        # dispatches attribute to device 0, mesh dispatches to every shard
        # that contributed rows (divergent rows name their shard exactly)
        self.devices = {}
        self.divergences = deque(maxlen=MAX_DIVERGENCE_RECORDS)
        self.output_audits = deque(maxlen=MAX_OUTPUT_RECORDS)

    def reset(self):
        """Tests: drop counters/evidence and any queued audits (their
        staging buffers are released)."""
        with self._lock:
            items, self._q = list(self._q), deque()
            self._reset_locked()
        for item in items:
            self._release(item)

    # ----------------------------------------------------------- sampling

    def maybe_audit(self, kernel, codes2d, quals2d, starts,
                    winner, qual, depth, errors, devices: int = 1,
                    gather=None, f_loc=None, slot: int = -1, partner=None):
        """The resolve-path tap: decide, retain, and (maybe) audit.

        Called once per cleanly-resolved *device* dispatch with the dense
        host-side inputs and the final post-oracle outputs the caller is
        about to consume. Returns ``None`` (caller proceeds unchanged) or,
        for an inline audit that found a divergence, the repaired
        ``(winner, qual, depth, errors)`` oracle tuple the caller must
        publish instead. Never raises: a broken audit must not fail a
        healthy resolve.

        ``partner``: merge attribution for a coalesced dispatch
        (ops/coalesce.py) — ``{"group", "index", "partners"}`` naming this
        job's slice of the merged launch; a divergence record carries it
        so the operator knows which partner's output (and which merge) to
        distrust. Each partner's resolve taps here separately, over its
        own family slice."""
        try:
            return self._maybe_audit(kernel, codes2d, quals2d, starts,
                                     winner, qual, depth, errors,
                                     devices, gather, f_loc, slot, partner)
        except Exception:  # noqa: BLE001 - audit failure != batch failure
            log.exception("audit sentinel: tap failed; dispatch unaudited")
            return None

    def _maybe_audit(self, kernel, codes2d, quals2d, starts, winner, qual,
                     depth, errors, devices, gather, f_loc, slot, partner):
        rate = audit_rate(kernel.device.type)
        from .breaker import BREAKER

        # while SDC-quarantined every admitted dispatch IS a re-admission
        # probe and must be fully audited, whatever the sample rate
        forced = BREAKER.audit_required()
        if rate <= 0 and not forced:
            return None
        t0 = time.monotonic()
        with self._lock:
            self._counter += 1
            ordinal = self._counter
        if not (forced or rate == 1 or ordinal % rate == 0):
            return None
        from ..observe.metrics import METRICS

        inline = forced or rate == 1
        with self._lock:
            if not inline and len(self._q) >= _queue_cap():
                # bounded retention: drop THIS sample — before paying the
                # input copies — rather than pile staging buffers behind
                # a slow oracle (an overloaded audit path must be nearly
                # free, not the most expensive tap outcome)
                self.sampled += 1
                self.sampled_ordinals.append(ordinal)
                self.dropped += 1
                drop = True
            else:
                drop = False
                self.sampled += 1
                self.sampled_ordinals.append(ordinal)
                for d in range(max(int(devices), 1)):
                    self._device_locked(d)["sampled"] += 1
        METRICS.inc("device.audit.sampled")
        if drop:
            METRICS.inc("device.audit.dropped")
            return None
        item = self._retain(kernel, codes2d, quals2d, starts, winner, qual,
                            depth, errors, devices, gather, f_loc, slot,
                            ordinal, partner)
        # only a FORCED (quarantine-probe) audit may later feed
        # record_audit_clean: a stale background sample taken before the
        # trip proves nothing about the quarantined device's probes
        item["forced"] = forced
        if inline:
            # inline: verdict before the caller consumes the result, so a
            # divergent dispatch can be repaired with the oracle tuple the
            # audit just computed (byte-identity preserved end to end)
            with self._lock:
                self.inline_audits += 1
            repaired = self._audit_one(item)
            METRICS.observe("device.audit.tap_s", time.monotonic() - t0)
            return repaired
        with self._lock:
            # benign overshoot: concurrent resolvers may each have passed
            # the pre-retain check; the queue grows past the cap by at
            # most the feeder depth
            import contextvars

            self._q.append((contextvars.copy_context(), item))
            self._ensure_thread_locked()
            self._cv.notify_all()
        METRICS.observe("device.audit.tap_s", time.monotonic() - t0)
        return None

    # ------------------------------------------- fused-filter route tap

    def maybe_audit_filter(self, kernel, codes2d, quals2d, starts, stats,
                           resident, filter_ctx, slot: int = -1):
        """The fused consensus→filter resolve tap (K1-f): `--device-filter`
        dispatches fetch only a (J, 7) i32 stats row, so the column tap
        never sees them.

        Audits against the f64 host oracle + the numpy twin of the
        device's integer filter epilogue
        (consensus.device_filter.fused_stats_oracle), restricted to rows
        whose device stats carry suspect == 0 — the guard band proves
        those rows exact on every backend, and device-suspect rows are
        re-resolved host-side downstream regardless (a corrupt bit that
        turns suspect ON costs performance, never bytes; one that turns
        it OFF exposes the row to this comparison). Inline audits
        additionally verify the survivors-gather bytes off the resident
        columns. Returns None, or — inline divergence — the repaired
        pre-threshold (winner, qual, depth, errors) oracle tuple; the
        caller then releases the resident columns and falls back to its
        host filter pass. Never raises."""
        try:
            return self._maybe_audit_filter(kernel, codes2d, quals2d,
                                            starts, stats, resident,
                                            filter_ctx, slot)
        except Exception:  # noqa: BLE001 - audit failure != batch failure
            log.exception("audit sentinel: filter tap failed; dispatch "
                          "unaudited")
            return None

    def _maybe_audit_filter(self, kernel, codes2d, quals2d, starts, stats,
                            resident, filter_ctx, slot):
        rate = audit_rate(kernel.device.type)
        from .breaker import BREAKER

        forced = BREAKER.audit_required()
        if (rate <= 0 and not forced) or filter_ctx is None:
            return None
        t0 = time.monotonic()
        with self._lock:
            self._counter += 1
            ordinal = self._counter
        if not (forced or rate == 1 or ordinal % rate == 0):
            return None
        from ..observe.metrics import METRICS

        inline = forced or rate == 1
        with self._lock:
            self.sampled += 1
            self.sampled_ordinals.append(ordinal)
            if not inline and len(self._q) >= _queue_cap():
                self.dropped += 1
                drop = True
            else:
                drop = False
                self._device_locked(0)["sampled"] += 1
        METRICS.inc("device.audit.sampled")
        if drop:
            METRICS.inc("device.audit.dropped")
            return None
        mr, mq, lens_j, fparams = filter_ctx
        item = self._retain(kernel, codes2d, quals2d, starts,
                            *(np.zeros(0, np.int32),) * 4, 1, None, None,
                            slot, ordinal)
        item["forced"] = forced
        item["filter"] = {
            "stats": np.array(stats, copy=True),
            "mr": int(mr), "mq": int(mq),
            "lens": np.array(lens_j, dtype=np.int64, copy=True),
            "fparams": fparams,
            # resident columns only ride an INLINE audit: a background
            # sample must not race the caller's survivor gather/release
            "resident": resident if inline else None,
        }
        if inline:
            with self._lock:
                self.inline_audits += 1
            repaired = self._audit_filter_one(item)
            METRICS.observe("device.audit.tap_s", time.monotonic() - t0)
            return repaired
        with self._lock:
            import contextvars

            self._q.append((contextvars.copy_context(), item))
            self._ensure_thread_locked()
            self._cv.notify_all()
        METRICS.observe("device.audit.tap_s", time.monotonic() - t0)
        return None

    def _audit_filter_one(self, item):
        """Oracle re-derivation of one fused-filter dispatch: stats rows
        always; survivor-gather bytes when the resident columns rode
        along (inline). Returns the repaired pre-threshold oracle tuple
        on divergence, else None."""
        try:
            from ..consensus.device_filter import (S_SUSPECT,
                                                   fused_stats_oracle)

            fctx = item["filter"]
            engine = item["kernel"]._host()
            # same deliberate bypass of _host_engine_complete as
            # _audit_one: measurement, not workload
            w, q, d, e, _n_slow = engine.call_segments_counted(
                item["codes"], item["quals"], item["starts"])
            host_stats, host_fb, host_fq = fused_stats_oracle(
                w, q, d, e, fctx["lens"], fctx["mr"], fctx["mq"],
                fctx["fparams"])
            dev_stats = item["stats"] = fctx["stats"]
            trusted = dev_stats[:, S_SUSPECT] == 0
            mask = trusted & (dev_stats[:, :S_SUSPECT]
                              != host_stats[:, :S_SUSPECT]).any(axis=1)
            bad_fields = ["stats"] if mask.any() else []
            resident = fctx["resident"]
            if resident is not None and not mask.any():
                gmask = self._gather_divergence(
                    item["kernel"], resident, trusted, fctx["lens"],
                    host_fb, host_fq, d, e)
                if gmask is None:
                    return None  # gather weather: unaudited, no verdict
                if gmask.any():
                    mask = gmask
                    bad_fields = ["gather"]
            if not bad_fields:
                self._verdict_clean(item)
                return None
            self._filter_divergent(item, host_stats, bad_fields, mask)
            return w, q, d, e
        finally:
            self._release(item)

    def _gather_divergence(self, kernel, resident, trusted, lens,
                           host_fb, host_fq, host_d, host_e):
        """Inline-only survivor-gather audit: fetch every row's masked
        columns off the resident arrays and compare the consumed surface
        (in-length positions of non-suspect rows) against the oracle.
        None = gather failed (device weather), no verdict either way."""
        J = len(lens)
        try:
            fb, fq, dd, ee = kernel.filter_gather_filtered(
                resident, np.arange(J, dtype=np.int64))
        except Exception as exc:  # noqa: BLE001 - weather, not corruption
            log.warning("audit sentinel: survivor-gather audit skipped "
                        "(gather failed: %s)", exc)
            return None
        in_len = (np.arange(host_fb.shape[1], dtype=np.int64)[None, :]
                  < np.asarray(lens)[:, None])
        keep = trusted[:, None] & in_len
        diff = ((fb != host_fb) | (fq != host_fq)
                | (dd != host_d) | (ee != host_e)) & keep
        return diff.any(axis=1)

    def _filter_divergent(self, item, host_stats, bad_fields, fam_mask):
        """Divergence verdict for the fused-filter route: same evidence
        chain as _verdict_divergent (record, flight note + black box,
        SDC quarantine), with the stats rows as the compared buffers."""
        fam_idx = np.nonzero(fam_mask)[0]
        record = {
            "ordinal": item["ordinal"],
            "slot": item["slot"],
            "route": "device-filter",
            "families": int(len(fam_idx)),
            "first_families": [int(f) for f in fam_idx[:8]],
            "fields": bad_fields,
            "devices": [0],
            "device_digest": _digest([item["stats"]]),
            "host_digest": _digest([host_stats]),
        }
        from ..observe.metrics import METRICS

        with self._lock:
            self.divergent += 1
            self.divergences.append(record)
            self._device_locked(0)["divergent"] += 1
        METRICS.inc("device.audit.divergent")
        log.error(
            "AUDIT DIVERGENCE: fused-filter dispatch (slot %d) disagrees "
            "with the f64 host oracle on %d/%d reads (fields: %s) — "
            "silent data corruption; quarantining the device (device "
            "digest %.12s..., host digest %.12s...)",
            item["slot"], len(fam_idx), len(fam_mask),
            ",".join(bad_fields), record["device_digest"],
            record["host_digest"])
        from ..observe.flight import FLIGHT

        FLIGHT.note("audit.divergence", **{k: v for k, v in record.items()
                                           if k != "first_families"})
        from .breaker import BREAKER

        BREAKER.record_sdc(
            f"{len(fam_idx)} reads, fused-filter fields "
            f"{','.join(bad_fields)}")
        FLIGHT.dump("sdc-divergence", **record)

    def _retain(self, kernel, codes2d, quals2d, starts, winner, qual,
                depth, errors, devices, gather, f_loc, slot, ordinal,
                partner=None):
        """Copy everything the audit needs (the caller may mutate or free
        its arrays the moment the resolve returns)."""
        return {
            "kernel": kernel,
            "codes": np.array(codes2d, copy=True),
            "quals": np.array(quals2d, copy=True),
            "starts": np.array(starts, dtype=np.int64, copy=True),
            "device_result": tuple(np.array(a, copy=True) for a in
                                   (winner, qual, depth, errors)),
            "devices": max(int(devices), 1),
            "gather": None if gather is None
            else np.array(gather, copy=True),
            "f_loc": f_loc,
            "slot": slot,
            "ordinal": ordinal,
            "partner": dict(partner) if partner else None,
        }

    @staticmethod
    def _release(item):
        """Drop the retained inputs (both verdicts, and on drop/reset)."""
        item.pop("codes", None)
        item.pop("quals", None)

    def _device_locked(self, d: int) -> dict:
        entry = self.devices.get(int(d))
        if entry is None:
            entry = self.devices[int(d)] = {"sampled": 0, "clean": 0,
                                            "divergent": 0}
        return entry

    # ------------------------------------------------------ audit worker

    def _ensure_thread_locked(self):
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(target=self._loop,
                                            name="fgumi-audit-sentinel",
                                            daemon=True)
            self._thread.start()

    def _loop(self):
        while True:
            with self._lock:
                self._busy = False
                self._cv.notify_all()
                while not self._q:
                    self._cv.wait()
                ctx, item = self._q.popleft()
                self._busy = True
            try:
                # the submitting resolve's context rides along so the
                # clean/divergent metrics land in its telemetry scope
                ctx.run(self._audit_filter_one if "filter" in item
                        else self._audit_one, item)
            except Exception:  # noqa: BLE001 - worker must survive
                log.exception("audit sentinel: background audit raised")

    def drain(self, timeout: float = 30.0) -> bool:
        """Wait for every queued background audit to finish (command exit,
        before the run report is built). True when idle within timeout."""
        deadline = time.monotonic() + timeout
        with self._lock:
            while self._q or self._busy:
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                self._cv.wait(min(left, 0.5))
        return True

    # -------------------------------------------------------- the audit

    def _audit_one(self, item):
        """Re-execute one retained dispatch on the f64 host oracle and
        compare exactly. Returns the oracle tuple when divergent (the
        inline caller's repair value), else None."""
        try:
            engine = item["kernel"]._host()
            # deliberately NOT routed through _host_engine_complete: the
            # audit must not feed the router's host-rate EWMA (it would
            # skew the offload crossover) nor the kernel's oracle-fallback
            # accounting — the shadow run is measurement, not workload
            w, q, d, e, _n_slow = engine.call_segments_counted(
                item["codes"], item["quals"], item["starts"])
            host = (w, q, d, e)
            dev = item["device_result"]
            bad_fields = [name for name, da, ha in
                          zip(_FIELDS, dev, host)
                          if not np.array_equal(da, ha)]
            if not bad_fields:
                self._verdict_clean(item)
                return None
            return self._verdict_divergent(item, host, bad_fields)
        finally:
            self._release(item)

    def _verdict_clean(self, item):
        from ..observe.metrics import METRICS

        with self._lock:
            self.clean += 1
            for dv in range(item["devices"]):
                self._device_locked(dv)["clean"] += 1
        METRICS.inc("device.audit.clean")
        if item.get("forced"):
            # a fully-audited re-admission probe came back clean: this is
            # the ONLY feedback that counts toward lifting the quarantine.
            # Checking the item's own flag — not the breaker's live state
            # — so a stale background sample taken BEFORE the trip can
            # never masquerade as a probe verdict after it.
            from .breaker import BREAKER

            BREAKER.record_audit_clean()

    def _verdict_divergent(self, item, host, bad_fields):
        dev = item["device_result"]
        # which families (and, on a mesh dispatch, which shard devices)
        # produced corrupt rows — the per-device attribution the fleet
        # tier ejects on
        mask = np.zeros(len(item["starts"]) - 1, dtype=bool)
        for name, da, ha in zip(_FIELDS, dev, host):
            if name in bad_fields:
                diff = np.asarray(da) != np.asarray(ha)
                mask[: len(mask)] |= diff.reshape(len(mask), -1).any(axis=1)
        fam_idx = np.nonzero(mask)[0]
        gather, f_loc = item["gather"], item["f_loc"]
        if gather is not None and f_loc:
            shards = sorted(set(
                int(gather[f]) // int(f_loc) for f in fam_idx))
        else:
            shards = [0]
        record = {
            "ordinal": item["ordinal"],
            "slot": item["slot"],
            "families": int(len(fam_idx)),
            "first_families": [int(f) for f in fam_idx[:8]],
            "fields": bad_fields,
            "devices": shards,
            "device_digest": _digest(dev),
            "host_digest": _digest(host),
        }
        if item.get("partner"):
            # coalesced dispatch: name the merge + the partner slice the
            # corruption landed in (ops/coalesce.py attribution)
            record["partner"] = item["partner"]
        from ..observe.metrics import METRICS

        with self._lock:
            self.divergent += 1
            self.divergences.append(record)
            for dv in shards:
                self._device_locked(dv)["divergent"] += 1
            for dv in range(item["devices"]):
                if dv not in shards:
                    self._device_locked(dv)["clean"] += 1
        METRICS.inc("device.audit.divergent")
        log.error(
            "AUDIT DIVERGENCE: device dispatch (slot %d) disagrees with "
            "the f64 host oracle on %d/%d families (fields: %s; shard "
            "devices %s) — silent data corruption; quarantining the "
            "device (device digest %.12s..., host digest %.12s...)",
            item["slot"], len(fam_idx), len(mask), ",".join(bad_fields),
            shards, record["device_digest"], record["host_digest"])
        from ..observe.flight import FLIGHT

        FLIGHT.note("audit.divergence", **{k: v for k, v in record.items()
                                           if k != "first_families"})
        from .breaker import BREAKER

        BREAKER.record_sdc(
            f"{len(fam_idx)} families, fields {','.join(bad_fields)}")
        # the black box carries both buffers' digests (the breaker's own
        # trip dump may have fired first under reason breaker-open; this
        # one is audit-specific and carries the divergence evidence)
        FLIGHT.dump("sdc-divergence", **record)
        return host

    # ------------------------------------------------------ output audit

    def note_output_audit(self, path: str, ok: bool, members: int = 0,
                          records: int = 0, error: str = None):
        """Record one ``--audit-output`` pre-commit verification verdict
        (io/bam.py) so the run report's ``audit`` section covers the
        output side too."""
        rec = {"path": path, "ok": bool(ok), "members": int(members),
               "records": int(records)}
        if error:
            rec["error"] = str(error)[:300]
        with self._lock:
            self.output_audits.append(rec)
        from ..observe.metrics import METRICS

        METRICS.inc("io.output_audit." + ("ok" if ok else "failed"))
        if not ok:
            from ..observe.flight import FLIGHT

            FLIGHT.note("audit.output_failed", path=path,
                        error=rec.get("error"))

    # ---------------------------------------------------------- snapshot

    def has_activity(self) -> bool:
        with self._lock:
            return bool(self.sampled or self.dropped or self.divergent
                        or self.output_audits)

    def snapshot(self) -> dict:
        """The run report / ``stats`` op ``audit`` section."""
        with self._lock:
            out = {
                "rate": os.environ.get("FGUMI_TPU_AUDIT", "") or
                f"1/{DEFAULT_RATE}",
                "sampled": self.sampled,
                "clean": self.clean,
                "divergent": self.divergent,
                "dropped": self.dropped,
                "pending": len(self._q) + (1 if self._busy else 0),
                "devices": {str(k): dict(v)
                            for k, v in sorted(self.devices.items())},
            }
            if self.divergences:
                out["divergence"] = [dict(r) for r in self.divergences]
            if self.output_audits:
                out["output"] = [dict(r) for r in self.output_audits]
            return out


#: Process-wide singleton: the device under audit is a per-process fact.
SENTINEL = AuditSentinel()
