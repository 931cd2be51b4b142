"""Device-resident consensus→filter fusion (``simplex --device-filter``).

The two-command pipeline ``simplex | filter`` fetches every consensus
column, serializes it, and re-parses the bytes only to drop most of them on
a filter-heavy run. Fused:

- stage 1, the CUDA kernel K1-f (ops/cuda_kernel.consensus_wire_filter),
  keeps the consensus columns on the device, applies the consensus
  thresholds and the filter's simplex per-base masks, and fetches a 28 B
  stats row per consensus read (max/total depth, total errors, qual sum,
  N count after the mask, newly-masked count, suspect flag);
- the host judges every read from those integers with the SAME array core
  the record filter uses (consensus/filter.py), so the fused route cannot
  drift from ``filter``;
- stage 2 gathers only the surviving reads' masked columns and the native
  serializer emits them — byte-identical to ``simplex | filter``.

Exactness: every floating-point comparison is recomputed on the host from
exactly-fetched integer sums (cE, mean quality, no-call fraction) or is an
integer compare on the device (consensus/filter.base_error_rate_table).
Reads touching an oracle-suspect position fetch their raw columns and run
the ordinary host completion (f64 oracle patch + host filter math).

The classic engine (``--classic``), the fast engine's boundary groups and
``duplex --device-filter`` filter in process through :class:`HostFilterTap`,
the per-record filter.
"""

import os
import threading

import numpy as np

from ..constants import MIN_PHRED, N_CODE
from ..ops import oracle
from ..ops.wire import (I16_MAX, S_MAXD, S_NAFTER, S_NEWLY, S_QSUM, S_SUMD,
                        S_SUME, S_SUSPECT, STATS_COLS)
from .filter import (R_PASS, RESULT_NAMES, FilterConfig,
                     base_error_rate_table, simplex_base_mask_arrays,
                     simplex_read_verdicts)


def device_filter_requested(args) -> bool:
    """Whether a consensus command filters its records in process:
    ``--device-filter``, or ``FGUMI_TPU_DEVICE_FILTER`` set to ``1``,
    ``true``, ``on`` or ``force`` (any case), as the reference reads it.
    Any other value, ``0``/``false``/``off`` too, requests nothing; with
    ``--device-filter`` the fast engine's fused filter stays on the card
    (the records are those of the reference's full-column route)."""
    if getattr(args, "device_filter", False):
        return True
    return os.environ.get("FGUMI_TPU_DEVICE_FILTER", "").strip().lower() \
        in ("1", "true", "on", "force")


def filter_config_from_args(args) -> FilterConfig:
    """FilterConfig from ``simplex``'s ``--filter-*`` options (the same
    grammar as the ``filter`` command's)."""
    return FilterConfig.new(
        [int(v) for v in str(args.filter_min_reads).split(",")],
        [float(v) for v in str(args.filter_max_read_error_rate).split(",")],
        [float(v) for v in str(args.filter_max_base_error_rate).split(",")],
        min_base_quality=args.filter_min_base_quality,
        min_mean_base_quality=args.filter_min_mean_base_quality,
        max_no_call_fraction=args.filter_max_no_call_fraction)


class DeviceFilterParams:
    """Device-side constants of the fused simplex mask kernel (one set per
    run; the kernel object caches the table on the device)."""

    __slots__ = ("min_reads", "emin_tab", "min_base_q", "per_base")

    def __init__(self, config: FilterConfig, produce_per_base_tags: bool):
        t = config.single_strand
        self.min_reads = int(t.min_reads)
        self.emin_tab = base_error_rate_table(t.max_base_error_rate)
        self.min_base_q = (-1 if config.min_base_quality is None
                           else int(config.min_base_quality))
        # mask_bases applies the depth/error masks only when the record
        # carries cd+ce tags, i.e. when the engine writes them
        self.per_base = bool(produce_per_base_tags)


def fused_stats_oracle(winner, qual, depth, errors, lens, min_reads_c,
                       min_qual_c, params: DeviceFilterParams):
    """Numpy twin of the fused kernel's threshold + filter epilogue over
    PRE-threshold (J, L) columns (e.g. the f64 oracle's): the masked
    columns and the stats rows with exactly the device's integer math. The
    suspect column is device-internal and stays 0 here. Returns (stats
    int32, masked bases u8, masked quals u8)."""
    w = np.asarray(winner, dtype=np.int32)
    q = np.asarray(qual, dtype=np.int32)
    d = np.asarray(depth, dtype=np.int32)
    e = np.asarray(errors, dtype=np.int32)
    n, L = w.shape
    lens = np.asarray(lens, dtype=np.int64)
    low_depth = d < np.int32(min_reads_c)
    low_qual = q < np.int32(min_qual_c)
    tb = np.where(low_depth | low_qual, N_CODE, w)
    tq = np.where(low_depth, 0, np.where(low_qual, MIN_PHRED, q))
    in_len = np.arange(L, dtype=np.int64)[None, :] < lens[:, None]
    d16 = np.minimum(d, I16_MAX)
    e16 = np.minimum(e, I16_MAX)
    if params.per_base:
        fmask = (d16 < params.min_reads) \
            | ((d16 > 0) & (e16 >= params.emin_tab[d16]))
    else:
        fmask = np.zeros((n, L), dtype=bool)
    if params.min_base_q >= 0:
        fmask = fmask | (tq < params.min_base_q)
    fmask = fmask & in_len
    fb = np.where(fmask, N_CODE, tb).astype(np.uint8)
    fq = np.where(fmask, MIN_PHRED, tq).astype(np.uint8)
    stats = np.zeros((n, STATS_COLS), dtype=np.int32)
    if L:
        stats[:, S_MAXD] = np.max(np.where(in_len, d16, 0), axis=1)
    stats[:, S_SUMD] = np.sum(np.where(in_len, d16, 0), axis=1,
                              dtype=np.int32)
    stats[:, S_SUME] = np.sum(np.where(in_len, e16, 0), axis=1,
                              dtype=np.int32)
    stats[:, S_QSUM] = np.sum(np.where(in_len, tq, 0), axis=1,
                              dtype=np.int32)
    stats[:, S_NAFTER] = np.sum(in_len & (fb == N_CODE), axis=1)
    stats[:, S_NEWLY] = np.sum(fmask & (tb != N_CODE), axis=1)
    return stats, fb, fq


class SimplexFilterStage:
    """Fused filter stage for the fast simplex engine (one per run).

    Thread-safe: resolve workers call :meth:`resolve_chunk` concurrently
    while the processing thread filters boundary groups
    (:meth:`filter_records_blob`); only the stats are shared, under a
    lock."""

    def __init__(self, config: FilterConfig, options,
                 filter_by_template: bool = True):
        from ..commands.filter import FilterStats

        self.config = config
        self.options = options  # VanillaOptions (consensus thresholds)
        self.filter_by_template = filter_by_template
        self.stats = FilterStats()
        self.dev_params = DeviceFilterParams(config,
                                             options.produce_per_base_tags)
        self._lock = threading.Lock()
        self._slow_tap = None

    # ---------------------------------------------------------- host twin

    def host_filter_columns(self, bases, quals, depth, errors, lens):
        """Host twin of the fused kernel's filter math over post-threshold
        (J, L) columns. Returns (masked bases, masked quals, stats (J, 7))
        in the device's stats layout, so the verdicts are path-blind."""
        cfg = self.config
        n, L = bases.shape
        lens = np.asarray(lens, dtype=np.int64)
        in_len = np.arange(L)[None, :] < lens[:, None]
        d16 = np.minimum(depth, I16_MAX).astype(np.int64)
        e16 = np.minimum(errors, I16_MAX).astype(np.int64)
        if self.dev_params.per_base:
            mask = simplex_base_mask_arrays(d16, e16, quals, in_len,
                                            cfg.single_strand,
                                            cfg.min_base_quality)
        else:
            mask = np.zeros((n, L), dtype=bool)
            if cfg.min_base_quality is not None:
                mask = (quals < cfg.min_base_quality) & in_len
        fb = np.where(mask, N_CODE, bases).astype(np.uint8)
        fq = np.where(mask, MIN_PHRED, quals).astype(np.uint8)
        stats = np.zeros((n, STATS_COLS), dtype=np.int64)
        stats[:, S_MAXD] = np.max(np.where(in_len, d16, 0), axis=1) \
            if L else 0
        stats[:, S_SUMD] = np.sum(np.where(in_len, d16, 0), axis=1)
        stats[:, S_SUME] = np.sum(np.where(in_len, e16, 0), axis=1)
        stats[:, S_QSUM] = np.sum(
            np.where(in_len, quals.astype(np.int64), 0), axis=1)
        stats[:, S_NAFTER] = np.sum(in_len & (fb == N_CODE), axis=1)
        stats[:, S_NEWLY] = np.sum(mask & (bases != N_CODE), axis=1)
        return fb, fq, stats

    # ------------------------------------------------------------ verdicts

    def read_verdicts(self, stats, lens):
        """Per-read verdict codes from stats rows (device or host). cE is
        float32(tot_e) / float32(tot_d) — the serializer's arithmetic —
        from the exact integer sums."""
        sum_d = stats[:, S_SUMD]
        ce = np.zeros(len(sum_d), dtype=np.float32)
        nz = sum_d > 0
        ce[nz] = stats[nz, S_SUME].astype(np.float32) \
            / sum_d[nz].astype(np.float32)
        cfg = self.config
        return simplex_read_verdicts(
            stats[:, S_MAXD], ce, stats[:, S_QSUM], stats[:, S_NAFTER],
            lens, cfg.single_strand, cfg.min_mean_base_quality,
            cfg.max_no_call_fraction)

    def template_keep(self, verdicts, mi_rec):
        """Keep flags under --filter-by-template: consensus outputs are all
        primary, and the jobs of one group (same ``mi_rec``) share a QNAME,
        so a template passes iff every member passes."""
        ok = verdicts == R_PASS
        if not self.filter_by_template or not len(ok):
            return ok
        mi_rec = np.asarray(mi_rec)
        t_of = np.concatenate(([0], np.cumsum(mi_rec[1:] != mi_rec[:-1])))
        t_fail = np.zeros(int(t_of[-1]) + 1, dtype=bool)
        np.logical_or.at(t_fail, t_of, ~ok)
        return ~t_fail[t_of]

    def _account(self, verdicts, keep, newly):
        kept = int(keep.sum())
        masked = int(np.asarray(newly)[keep].sum())
        with self._lock:
            st = self.stats
            st.total_records += len(verdicts)
            st.passed_records += kept
            st.failed_records += len(verdicts) - kept
            st.bases_masked += masked
            for v in verdicts[~keep]:
                st.rejection_reasons[
                    RESULT_NAMES[int(v)] if v != R_PASS
                    else "template_failed"] += 1

    # ------------------------------------------------------------- resolve

    def resolve_chunk(self, chunk) -> bytes:
        """Fused resolve of one fast-engine chunk: complete the device work,
        judge every job, serialize only the survivors."""
        fast = chunk.fast
        kernel = fast.caller.kernel
        table = chunk.jobs
        opts = fast.caller.options
        J = len(table)
        blocks = []  # (idxs, fb, fq, d32, e32): the masked columns
        stats_all = np.zeros((J, STATS_COLS), dtype=np.int64)
        newly = np.zeros(J, dtype=np.int64)

        def add_post_threshold(idxs, b, q, depth, errors):
            fb, fq, stats = self.host_filter_columns(
                b, q, depth, errors, table.cons_len[idxs])
            stats_all[idxs] = stats
            newly[idxs] = stats[:, S_NEWLY]
            blocks.append((np.asarray(idxs, dtype=np.int64),
                           np.ascontiguousarray(fb), np.ascontiguousarray(fq),
                           np.ascontiguousarray(depth, dtype=np.int32),
                           np.ascontiguousarray(errors, dtype=np.int32)))

        def add_full_columns(idxs, winner, qual, depth, errors):
            """Full post-oracle columns: thresholds + host filter math."""
            b, q = oracle.apply_consensus_thresholds(
                winner, qual, depth, opts.min_reads,
                opts.min_consensus_base_quality)
            add_post_threshold(idxs, b, q, depth, errors)

        # single-read host blocks arrive post-threshold
        for idxs, b, q, d, e in chunk.blocks:
            add_post_threshold(idxs, b, q, d, e)

        fused = None
        pending = chunk.pending
        if pending is not None:
            kind, idxs, starts, codes_d, quals_d, ticket = pending
            if kind == "segwf":
                out = kernel.resolve_segments_wire_filtered(
                    ticket, codes_d, quals_d, starts)
                if out[0] == "columns":
                    add_full_columns(idxs, *out[1:])
                else:
                    fused = self._fused_rows(kernel, idxs, starts, codes_d,
                                             quals_d, out[1], out[2],
                                             stats_all, newly,
                                             add_full_columns)
            else:  # "segw": a family too deep for the fused route
                add_full_columns(idxs, *kernel.resolve_segments_wire(
                    ticket, codes_d, quals_d, starts))

        verdicts = self.read_verdicts(stats_all, table.cons_len)
        keep = self.template_keep(verdicts, table.mi_rec)
        self._account(verdicts, keep, newly)

        if fused is not None:
            idxs, resident, clean = fused
            rows = np.nonzero(clean & keep[idxs])[0]
            if len(rows):
                fb, fq, d32, e32 = kernel.filter_gather_filtered(resident,
                                                                 rows)
                blocks.append((idxs[rows], fb, fq, d32, e32))

        keep_idx = np.nonzero(keep)[0]
        # rejected jobs still count as consensus reads called
        fast.caller.stats.add_consensus_reads(J - len(keep_idx))
        remap = np.full(J, -1, dtype=np.int64)
        remap[keep_idx] = np.arange(len(keep_idx))
        kept_blocks = []
        for idxs, fb, fq, d32, e32 in blocks:
            sel = keep[idxs]
            if not sel.any():
                continue
            kept_blocks.append((remap[idxs[sel]], fb[sel], fq[sel],
                                np.ascontiguousarray(d32[sel]),
                                np.ascontiguousarray(e32[sel])))
        return fast._serialize_jobs(chunk.batch, table.subset(keep_idx),
                                    kept_blocks)

    def _fused_rows(self, kernel, idxs, starts, codes_d, quals_d, dev_stats,
                    resident, stats_all, newly, add_full_columns):
        """Fold a fused stats fetch into the per-job arrays; suspect rows
        take the raw-column gather + ordinary host completion. Returns
        (idxs, resident, clean) for the survivors' gather."""
        idxs = np.asarray(idxs, dtype=np.int64)
        st = dev_stats[:len(idxs)].astype(np.int64)
        clean = st[:, S_SUSPECT] == 0
        stats_all[idxs[clean]] = st[clean]
        newly[idxs[clean]] = st[clean, S_NEWLY]
        if not clean.all():
            rows = np.nonzero(~clean)[0]
            w, q, d, e = kernel.filter_resolve_suspect_rows(
                resident, rows, starts, codes_d, quals_d)
            add_full_columns(idxs[rows], w, q, d, e)
        return idxs, resident, clean

    def filter_records_blob(self, blob: bytes) -> bytes:
        """Per-record filter over a classic-path blob (complete name groups
        only); stats fold into this stage's counters, under its lock."""
        with self._lock:
            if self._slow_tap is None:
                self._slow_tap = HostFilterTap(self.config,
                                               self.filter_by_template,
                                               stats=self.stats)
            return self._slow_tap.feed(blob) + self._slow_tap.flush()


class HostFilterTap:
    """In-process consensus-output filter over serialized record chunks.

    Each fed blob is a run of block_size-prefixed records; records are
    judged by the per-record filter (commands/filter.py) with template
    grouping by QNAME, and only survivors are returned. Call :meth:`flush`
    after the last blob (the open name group is held back)."""

    def __init__(self, config: FilterConfig, filter_by_template: bool = True,
                 stats=None):
        from ..commands.filter import FilterStats

        self.config = config
        self.filter_by_template = filter_by_template
        self.stats = stats if stats is not None else FilterStats()
        self._group = []
        self._group_name = None

    @staticmethod
    def _records(blob):
        off = 0
        view = memoryview(blob)
        while off < len(view):
            size = int.from_bytes(view[off:off + 4], "little")
            yield bytes(view[off + 4:off + 4 + size])
            off += 4 + size

    def feed(self, blob: bytes) -> bytes:
        """Filter one serialized chunk; returns the kept wire bytes."""
        out = []
        for data in self._records(blob):
            name = bytes(data[32:32 + data[8] - 1])
            if name != self._group_name and self._group:
                out.append(self._emit_group())
            self._group_name = name
            self._group.append(data)
        return b"".join(out)

    def flush(self) -> bytes:
        return self._emit_group() if self._group else b""

    def _emit_group(self) -> bytes:
        from ..commands.filter import _process_one, judge_template
        from ..io.bam import RawRecord

        records = self._group
        self._group = []
        self._group_name = None
        processed = [_process_one(data, self.config) for data in records]
        recs = [RawRecord(d) for d, _, _ in processed]
        keep = judge_template(recs, [r for _, r, _ in processed],
                              [m for _, _, m in processed], self.stats,
                              self.filter_by_template)
        return b"".join(len(rec.data).to_bytes(4, "little") + rec.data
                        for rec, kp in zip(recs, keep) if kp)


def make_filter_tap(args):
    """The :class:`HostFilterTap` of a consensus command's
    ``--device-filter``, or None when it was not asked for. Raises
    ValueError on bad thresholds (the CLI reports it and exits 2)."""
    if not device_filter_requested(args):
        return None
    return HostFilterTap(filter_config_from_args(args),
                         args.filter_by_template)


def wrap_filter_writer(writer, tap):
    """``writer`` unchanged when ``tap`` is None, else the filtering
    wrapper (callers call ``.finish()`` after the last write)."""
    return writer if tap is None else FilterTapWriter(writer, tap)


class FilterTapWriter:
    """Writer wrapper routing every record or serialized chunk through a
    :class:`HostFilterTap` (the classic simplex engine's and duplex's
    ``--device-filter`` route)."""

    def __init__(self, writer, tap: HostFilterTap):
        self._writer = writer
        self.tap = tap

    def write_serialized(self, blob):
        self._writer.write_serialized(self.tap.feed(bytes(blob)))

    def write_record_bytes(self, rec):
        self.write_serialized(len(rec).to_bytes(4, "little") + bytes(rec))

    def finish(self):
        self._writer.write_serialized(self.tap.flush())
