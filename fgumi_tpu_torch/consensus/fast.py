"""Vectorized simplex consensus engine over RecordBatch inputs (the fast
engine).

Per-record work runs natively in batch (native/batch.py), per-family work on
numpy index slices, and the likelihood loop on the CUDA kernels: every
multi-read job of a batch goes out as ONE dense (N, L) segment dispatch —
K1 (``consensus_wire_full``), or K1-f (``consensus_wire_filter``) when a
``--device-filter`` stage is attached. Single-read jobs stay on the host
(their consensus is a table lookup).

Semantics contract: byte-identical records and identical rejection
statistics to VanillaConsensusCaller.call_groups (the classic engine) on the
same stream. Groups the vectorized path cannot express (quality trimming)
run the classic engine per group; groups that need the seeded downsample or
the most-common-alignment filter take the per-group array scan.
"""

import numpy as np

from ..core import cigar as cigar_utils
from ..io.bam import (FLAG_FIRST, FLAG_LAST, FLAG_MATE_UNMAPPED, FLAG_PAIRED,
                      FLAG_REVERSE, FLAG_SECONDARY, FLAG_SUPPLEMENTARY,
                      FLAG_UNMAPPED)
from ..native import batch as nb
from ..ops import oracle
from ..ops.kernel import pad_segments_gather
from .overlapping import (AGREEMENT_CODES, DISAGREEMENT_CODES,
                          add_native_overlap_stats)
from .simple_umi import consensus_umis_batch
from .vanilla import FRAGMENT, R1, R2, _TYPE_FLAGS, VanillaConsensusCaller

# read-type -> record flags as an indexable array (serialize is table-driven)
_TYPE_FLAGS_ARR = np.array([_TYPE_FLAGS[FRAGMENT], _TYPE_FLAGS[R1],
                            _TYPE_FLAGS[R2]], dtype=np.int32)
_CIGAR_OPS = "MIDNSHP=X"


def resolve_chunk(chunk) -> bytes:
    """Wire bytes of a process_batch output item (completes deferred device
    work: fetch, thresholds, serialize)."""
    return chunk if isinstance(chunk, bytes) else chunk.resolve()


def _ranges(lo, counts):
    """Concatenated arange(lo_i, lo_i + counts_i) without a Python loop."""
    counts = np.asarray(counts, dtype=np.int64)
    total = int(counts.sum())
    if total == 0:
        return np.empty(0, dtype=np.int64)
    lo = np.asarray(lo, dtype=np.int64)
    keep = counts > 0
    lo_k = lo[keep]
    c_k = counts[keep]
    step = np.ones(total, dtype=np.int64)
    firsts = np.concatenate(([0], np.cumsum(c_k)[:-1]))
    step[firsts] = lo_k
    # later range-starts jump from the previous range's last value
    step[firsts[1:]] -= lo_k[:-1] + c_k[:-1] - 1
    return np.cumsum(step)


class _JobTable:
    """Array-form job list for one batch span — no per-job Python objects.

    Jobs (consensus outputs) are rows of parallel arrays, in output order:
    per group, fragment first, then the R1/R2 pair. ``vlo``/``count`` slice
    the shared row pool: ``pool_rows`` holds span-relative row indices into
    the packed code/qual arrays, ``pool_span`` the same rows as absolute
    batch record indices (for RX lookups). ``mi_rec`` is the batch record
    whose MI tag value names the job (the group's first record).
    """

    __slots__ = ("count", "vlo", "read_type", "cons_len", "mi_rec",
                 "pool_rows", "pool_span")

    def __init__(self, count, vlo, read_type, cons_len, mi_rec, pool_rows,
                 pool_span):
        self.count = count
        self.vlo = vlo
        self.read_type = read_type
        self.cons_len = cons_len
        self.mi_rec = mi_rec
        self.pool_rows = pool_rows
        self.pool_span = pool_span

    def __len__(self):
        return len(self.count)

    def subset(self, keep_idx):
        """The kept jobs (the row pool is shared)."""
        return _JobTable(self.count[keep_idx], self.vlo[keep_idx],
                         self.read_type[keep_idx], self.cons_len[keep_idx],
                         self.mi_rec[keep_idx], self.pool_rows,
                         self.pool_span)


def _table_from_entries(entries, span):
    """_JobTable from (group_start, (read_type, rows, cons_len)) entries
    already in output order (the rejects-tracking per-group scan)."""
    J = len(entries)
    if J == 0:
        e64 = np.empty(0, dtype=np.int64)
        return _JobTable(e64, e64, np.empty(0, dtype=np.int8),
                         np.empty(0, dtype=np.int32), e64, e64, e64)
    counts = np.fromiter((len(jg[1]) for _, jg in entries), np.int64, J)
    vlo = np.concatenate(([0], np.cumsum(counts)[:-1]))
    rt = np.fromiter((jg[0] for _, jg in entries), np.int8, J)
    cl = np.fromiter((jg[2] for _, jg in entries), np.int32, J)
    mi = np.fromiter((span[s] for s, _ in entries), np.int64, J)
    pool = np.concatenate([jg[1] for _, jg in entries]).astype(np.int64)
    return _JobTable(counts, vlo, rt, cl, mi, pool, span[pool])


class _PendingChunk:
    """Deferred half of a batch: fetch the device results, apply the
    thresholds (or the fused filter), serialize."""

    __slots__ = ("fast", "batch", "jobs", "pending", "blocks")

    def __init__(self, fast, batch, jobs, pending, blocks0=()):
        self.fast = fast
        self.batch = batch
        self.jobs = jobs  # a _JobTable
        self.pending = pending
        # (job_idxs, bases, quals, depth32, errors32) row blocks; starts with
        # the host blocks (single-read jobs) from _dispatch_jobs
        self.blocks = list(blocks0)

    def resolve(self) -> bytes:
        fast = self.fast
        if fast.filter_stage is not None:
            return fast.filter_stage.resolve_chunk(self)
        if self.pending is not None:
            _, idxs, starts, codes_d, quals_d, dev = self.pending
            winner, qual, depth, errors = fast.caller.kernel.\
                resolve_segments_wire(dev, codes_d, quals_d, starts)
            self._assign(idxs, winner, qual, depth, errors)
        return fast._serialize_jobs(self.batch, self.jobs, self.blocks)

    def _assign(self, idxs, winner, qual, depth, errors):
        """Thresholds in one vectorized pass; rows go to the serializer as
        whole blocks."""
        opts = self.fast.caller.options
        bases_b, quals_b = oracle.apply_consensus_thresholds(
            winner, qual, depth, opts.min_reads,
            opts.min_consensus_base_quality)
        self.blocks.append((np.asarray(idxs, dtype=np.int64),
                            np.ascontiguousarray(bases_b),
                            np.ascontiguousarray(quals_b),
                            np.ascontiguousarray(depth, dtype=np.int32),
                            np.ascontiguousarray(errors, dtype=np.int32)))


class FastSimplexCaller:
    """Batch-vectorized simplex caller wrapping a VanillaConsensusCaller.

    The wrapped caller owns options, tables, kernel, stats and the record
    builder, and serves as the per-group classic path, so statistics and
    output bytes are shared by both paths.
    """

    def __init__(self, caller: VanillaConsensusCaller, tag: bytes = b"MI",
                 overlap_caller=None, filter_stage=None):
        """``filter_stage``: a consensus/device_filter.SimplexFilterStage —
        the fused consensus→filter route (--device-filter): outputs are
        filtered before serialization, multi-read batches through K1-f
        with a survivors-only fetch."""
        self.caller = caller
        self.tag = tag
        self.overlap_caller = overlap_caller
        self.filter_stage = filter_stage
        # conditions the vectorized conversion cannot express: quality
        # trimming, and methylation (the reference annotation needs each
        # read's CIGAR and position)
        opts = caller.options
        self._vector_ok = not opts.trim and not opts.methylation_mode
        self._carry = None  # (mi_bytes, [RawRecord]) spanning a batch edge
        self._palin_cache = {}  # cigar bytes -> simplified-CIGAR palindrome

    # ------------------------------------------------------------------ driver

    def process_batch(self, batch, allow_unmapped: bool = False,
                      final: bool = False):
        """Consume one RecordBatch -> list of output items (bytes or
        _PendingChunk; see :func:`resolve_chunk`).

        Groups are formed over records passing the consensus pre-group
        filter. The group spanning the batch boundary is carried (as
        RawRecords) until the next batch or ``final`` and runs the classic
        path, with overlap correction applied there, so pairs split across
        batches are still corrected.
        """
        flag = batch.flag
        keep = (flag & (FLAG_SECONDARY | FLAG_SUPPLEMENTARY)) == 0
        if not allow_unmapped:
            is_mapped = (flag & FLAG_UNMAPPED) == 0
            mapped_mate = ((flag & FLAG_PAIRED) != 0) \
                & ((flag & FLAG_MATE_UNMAPPED) == 0)
            keep &= is_mapped | mapped_mate
        idx = np.nonzero(keep)[0]
        if len(idx) == 0:
            return self.flush() if final else []

        # every tag this engine reads for the batch, one native aux scan
        batch.prefetch_tags([self.tag, b"MC", b"RX"])
        mi_off, mi_len, _ = batch.tag_locs(self.tag)
        starts = nb.group_starts(batch.buf, mi_off[idx], mi_len[idx])
        bounds = np.append(starts, len(idx))
        n_total = len(bounds) - 1

        # does the first group continue the carried group?
        first_mi = batch.tag_bytes(self.tag, int(idx[bounds[0]]))
        merge_carry = self._carry is not None and self._carry[0] == first_mi
        if merge_carry:
            # materialize before any in-place correction of this batch
            self._carry[1].extend(batch.raw_records(idx[bounds[0]:bounds[1]]))

        # groups [g0, g1) run the vectorized path this call; the last group
        # of a non-final batch is deferred (it may continue in the next)
        g0 = 1 if merge_carry else 0
        g1 = n_total if final else max(n_total - 1, g0)
        deferred = None
        if not final and n_total - 1 >= g0:
            last = idx[bounds[n_total - 1]:bounds[n_total]]
            # materialize before in-place correction: the deferred group is
            # corrected exactly once, on the classic path, when it completes
            deferred = (batch.tag_bytes(self.tag, int(last[0])),
                        batch.raw_records(last))

        out = []
        if self._carry is not None:
            # the carry completes unless the merged group is still the open
            # tail of a non-final batch (merge_carry and no group follows)
            if (not merge_carry) or final or n_total >= 2:
                out.extend(self._call_slow_group(*self._carry))
                self._carry = None

        if g1 > g0:
            if self.overlap_caller is not None:
                overlap_correct_span(batch, idx, bounds, g0, g1,
                                     self.overlap_caller)
            out.extend(self._process_groups(batch, idx, bounds, g0, g1))

        if deferred is not None:
            self._carry = deferred
        if final:
            out.extend(self.flush())
        return out

    def flush(self):
        """Emit any carried boundary group (call after the last batch)."""
        if self._carry is None:
            return []
        mi, recs = self._carry
        self._carry = None
        return self._call_slow_group(mi, recs)

    def _call_slow_group(self, mi_bytes, records):
        """Classic-path one group, with Python overlap correction first (the
        carried group's pairs may span batch buffers). Returns blobs."""
        if self.overlap_caller is not None:
            from .overlapping import apply_overlapping_consensus

            records = apply_overlapping_consensus(records, self.overlap_caller)
        recs = self.caller.call_groups([(mi_bytes.decode(), records)])
        if not recs:
            return []
        return self._post_slow(
            [b"".join(len(r).to_bytes(4, "little") + r for r in recs)])

    def _post_slow(self, chunks):
        """Fused-filter pass over classic-path blobs (complete groups);
        identity when no filter stage is attached."""
        if self.filter_stage is None or not chunks:
            return chunks
        out = [self.filter_stage.filter_records_blob(c) for c in chunks]
        return [c for c in out if c]

    # ------------------------------------------------------------------ groups

    def _process_groups(self, batch, idx, bounds, g0, g1):
        caller = self.caller
        opts = caller.options

        if not self._vector_ok:
            # trimming / methylation: whole-group classic path, stream order
            groups = []
            for g in range(g0, g1):
                members = idx[bounds[g]:bounds[g + 1]]
                mi = batch.tag_bytes(self.tag, int(members[0]))
                groups.append((mi.decode(), batch.raw_records(members)))
            recs = caller.call_groups(groups)
            if not recs:
                return []
            return self._post_slow(
                [b"".join(len(r).to_bytes(4, "little") + r for r in recs)])

        # batch-wide native prep over the kept records of the processed groups
        span = idx[bounds[g0]:bounds[g1]]
        mc_off, mc_len, _ = batch.tag_locs_str(b"MC")
        clips = nb.mate_clips(
            batch.buf, batch.cigar_off[span], batch.n_cigar[span],
            batch.flag[span], batch.ref_id[span], batch.pos[span],
            batch.next_ref_id[span], batch.next_pos[span], batch.tlen[span],
            mc_off[span], mc_len[span])
        # stride is a multiple of 32, so every consensus length fits
        stride = max(-(-int(batch.l_seq[span].max()) // 32) * 32, 32)
        reverse = ((batch.flag[span] & FLAG_REVERSE) != 0).astype(np.uint8)
        codes, quals, final_len = nb.pack_reads(
            batch.buf, batch.seq_off[span], batch.qual_off[span],
            batch.l_seq[span], reverse, clips, opts.min_input_base_quality,
            stride)

        # read type: fragment / R1 / R2; paired-but-neither drops silently
        # (the classic engine's subgroup dict semantics)
        flag_s = batch.flag[span]
        paired = (flag_s & FLAG_PAIRED) != 0
        rtype = np.full(len(span), -1, dtype=np.int8)
        rtype[~paired] = FRAGMENT
        rtype[paired & ((flag_s & FLAG_FIRST) != 0)] = R1
        rtype[paired & ((flag_s & FLAG_FIRST) == 0)
              & ((flag_s & FLAG_LAST) != 0)] = R2

        # span-wide CIGAR-equality runs: group g is CIGAR-uniform iff no run
        # boundary falls strictly inside it
        cig_runs = nb.group_starts(batch.buf, batch.cigar_off[span],
                                   4 * batch.n_cigar[span])
        rel_bounds = bounds - bounds[g0]
        runs_lo = np.searchsorted(cig_runs, rel_bounds[g0:g1], side="right")
        runs_hi = np.searchsorted(cig_runs, rel_bounds[g0 + 1:g1 + 1],
                                  side="left")
        group_uniform = runs_hi == runs_lo

        if caller.track_rejects:
            # the rejects stream needs each group's rejected rows: the
            # per-group scan, in output order
            entries = []
            for g in range(g0, g1):
                s, e = rel_bounds[g], rel_bounds[g + 1]
                jobs_g = []
                ordinal = caller._group_ordinal
                caller._group_ordinal += 1
                self._prepare_group_fast(batch, span, s, e, rtype, final_len,
                                         jobs_g, bool(group_uniform[g - g0]),
                                         ordinal)
                entries.extend((int(s), jg) for jg in jobs_g)
            table = _table_from_entries(entries, span)
        else:
            table = self._prepare_groups_vec(batch, span,
                                             rel_bounds[g0:g1 + 1], rtype,
                                             final_len, group_uniform)
        if len(table) == 0:
            return []
        pending, blocks0 = self._dispatch_jobs(codes, quals, table)
        return [_PendingChunk(self, batch, table, pending, blocks0)]

    def _prepare_groups_vec(self, batch, span, gb, rtype, final_len,
                            group_uniform):
        """Vectorized group preparation over all groups of the span.

        ``gb``: (nG+1,) span-relative group boundaries. Groups that need the
        seeded downsample or the most-common-alignment filter take the
        per-group scan (identical semantics); everything else — type
        subgrouping, min-reads/zero-length rejection, consensus length,
        orphan handling — happens in whole-span array passes.

        Returns a _JobTable (jobs in output order, arrays only).
        """
        caller = self.caller
        opts = caller.options
        stats = caller.stats
        min_reads = opts.min_reads
        nG = len(gb) - 1
        sizes = np.diff(gb)
        ord0 = caller._group_ordinal
        caller._group_ordinal += nG

        small = sizes < min_reads
        downs = (np.zeros(nG, dtype=bool) if opts.max_reads is None
                 else sizes > opts.max_reads)

        # candidate rows: valid type, in a group subject to seg analysis
        g_of_row = np.repeat(np.arange(nG), sizes)
        row_ok = (~small & ~downs)[g_of_row] & (rtype >= 0)
        er = np.nonzero(row_ok)[0]
        legacy_g = downs.copy()
        nseg = 0
        if len(er):
            key = g_of_row[er] * 4 + rtype[er]
            order = np.argsort(key, kind="stable")
            srows = er[order]          # seg-grouped; original order within
            skey = key[order]
            seg_first = np.concatenate(([True], skey[1:] != skey[:-1]))
            seg_of_row = np.cumsum(seg_first) - 1
            seg_key = skey[seg_first]
            nseg = len(seg_key)
            seg_g = seg_key >> 2
            seg_t = (seg_key & 3).astype(np.int8)
            c0 = np.bincount(seg_of_row, minlength=nseg)

            valid_row = final_len[srows] > 0
            c1 = np.bincount(seg_of_row[valid_row], minlength=nseg)
            alive0 = c0 >= min_reads
            alive = alive0 & (c1 >= min_reads)

            vrows = srows[valid_row]   # compacted valid rows, seg-grouped
            vstarts = np.concatenate(([0], np.cumsum(c1)))
            span_v = span[vrows]
            vlens = final_len[vrows]

            # a seg needs the alignment filter when its valid rows' CIGARs
            # differ, or are uniform but mixed-strand with a non-palindromic
            # simplified CIGAR
            guniform_seg = group_uniform[seg_g]
            need = np.zeros(nseg, dtype=bool)
            nonempty = c1 > 0
            first_valid = np.zeros(nseg, dtype=np.int64)
            first_valid[nonempty] = vrows[vstarts[:-1][nonempty]]
            check = alive & ~guniform_seg
            if check.any():
                co = batch.cigar_off
                cl = (4 * batch.n_cigar).astype(np.int32)
                rep_first = np.repeat(span[first_valid], c1)
                eq = nb.ranges_equal(batch.buf, co[span_v], cl[span_v],
                                     co[rep_first], cl[rep_first])
                seg_cig_uniform = np.ones(nseg, dtype=bool)
                seg_cig_uniform[nonempty] = np.minimum.reduceat(
                    eq, vstarts[:-1][nonempty]).astype(bool)
                need = check & ~seg_cig_uniform
                if need.any():
                    # all-single-op-M segs (ragged read lengths) are mutually
                    # prefix-compatible after simplify: the filter provably
                    # keeps every read, so skip it
                    row_sm = (batch.n_cigar[span_v] == 1) \
                        & ((batch.buf[co[span_v]] & 0xF) == 0)
                    seg_sm = np.zeros(nseg, dtype=bool)
                    seg_sm[nonempty] = np.minimum.reduceat(
                        row_sm.astype(np.uint8),
                        vstarts[:-1][nonempty]).astype(bool)
                    need &= ~seg_sm
            rev8 = ((batch.flag[span_v] & FLAG_REVERSE) != 0).astype(np.uint8)
            mixed = np.zeros(nseg, dtype=bool)
            if nonempty.any():
                mn = np.minimum.reduceat(rev8, vstarts[:-1][nonempty])
                mx = np.maximum.reduceat(rev8, vstarts[:-1][nonempty])
                mixed[nonempty] = (mn == 0) & (mx == 1)
            strand_check = alive & ~need & mixed & (c1 >= 2)
            if strand_check.any():
                # single-op CIGARs simplify to one run: always palindromic
                n1 = batch.n_cigar[span[first_valid]]
                for s in np.nonzero(strand_check & (n1 != 1))[0]:
                    rec_i = int(span[first_valid[s]])
                    cig_bytes = batch.buf[
                        batch.cigar_off[rec_i]:
                        batch.cigar_off[rec_i]
                        + 4 * batch.n_cigar[rec_i]].tobytes()
                    palin = self._palin_cache.get(cig_bytes)
                    if palin is None:
                        cig = cigar_utils.simplify(
                            self._decode_cigar(batch, rec_i))
                        palin = cig == list(reversed(cig))
                        if len(self._palin_cache) >= 4096:
                            self._palin_cache.clear()
                        self._palin_cache[cig_bytes] = palin
                    if not palin:
                        need[s] = True
            legacy_g[seg_g[need]] = True

        vec_g = ~legacy_g
        stats.add_input_reads(int(sizes[vec_g].sum()))
        n_small = int(sizes[small & vec_g].sum())
        if n_small:
            stats.reject("InsufficientReads", n_small)

        if nseg:
            seg_vec = vec_g[seg_g]
            dead0 = seg_vec & ~alive0
            if dead0.any():
                stats.reject("InsufficientReads", int(c0[dead0].sum()))
            zl = int((c0 - c1)[seg_vec & alive0].sum())
            if zl:
                stats.reject("ZeroLengthAfterTrimming", zl)
            dead1 = seg_vec & alive0 & ~alive & (c1 > 0)
            if dead1.any():
                stats.reject("InsufficientReads", int(c1[dead1].sum()))

            # consensus length: min_reads-th longest valid len per seg
            ord2 = np.lexsort((-vlens.astype(np.int64),
                               seg_of_row[valid_row]))
            lens_sorted = vlens[ord2]
            pick = np.minimum(vstarts[:-1] + (min_reads - 1),
                              np.maximum(len(lens_sorted) - 1, 0))
            cons_len = (lens_sorted[pick] if len(lens_sorted)
                        else np.zeros(nseg, dtype=vlens.dtype))

            live = alive & seg_vec
            seg_map = np.full((nG, 3), -1, dtype=np.int64)
            seg_map[seg_g[live], seg_t[live]] = np.nonzero(live)[0]
            # orphan R1/R2 rejection, aggregated
            have_r1 = seg_map[:, R1] >= 0
            have_r2 = seg_map[:, R2] >= 0
            lone_r1 = seg_map[:, R1][have_r1 & ~have_r2]
            lone_r2 = seg_map[:, R2][have_r2 & ~have_r1]
            n_orphan = int(c1[lone_r1].sum() + c1[lone_r2].sum())
            if n_orphan:
                stats.reject("OrphanConsensus", n_orphan)

        # legacy groups (downsample / alignment-filter / strand cases): the
        # per-group scan, collected as (order-key, group-start, job-tuple)
        legacy = []
        for g in np.nonzero(legacy_g)[0]:
            jobs_g = []
            self._prepare_group_fast(batch, span, gb[g], gb[g + 1], rtype,
                                     final_len, jobs_g,
                                     bool(group_uniform[g]),
                                     ordinal=ord0 + int(g))
            legacy.extend((int(g) * 3 + i, int(gb[g]), jg)
                          for i, jg in enumerate(jobs_g))

        # vectorized emission: seg_map columns are already in output order
        # (fragment, R1, R2 per group), so the row-major flatten index IS
        # the (group, slot) order key
        if nseg:
            flat = seg_map.copy()
            pair = (flat[:, R1] >= 0) & (flat[:, R2] >= 0)
            flat[~pair, R1] = -1
            flat[~pair, R2] = -1
            flat = flat.ravel()
            key_vec = np.nonzero(flat >= 0)[0]
            vseg = flat[key_vec]
        else:
            key_vec = np.empty(0, dtype=np.int64)
            vseg = np.empty(0, dtype=np.int64)
            vrows = np.empty(0, dtype=np.int64)
            span_v = np.empty(0, dtype=np.int64)
            c1 = np.empty(0, dtype=np.int64)
            vstarts = np.zeros(1, dtype=np.int64)
            seg_t = np.empty(0, dtype=np.int8)
            seg_g = np.empty(0, dtype=np.int64)
            cons_len = np.empty(0, dtype=np.int64)

        cnt_v = c1[vseg].astype(np.int64)
        vlo_v = vstarts[:-1][vseg].astype(np.int64)
        typ_v = seg_t[vseg].astype(np.int8)
        len_v = cons_len[vseg].astype(np.int32)
        mi_v = span[gb[seg_g[vseg]]].astype(np.int64)

        if not legacy:
            return _JobTable(cnt_v, vlo_v, typ_v, len_v, mi_v, vrows, span_v)

        nleg = len(legacy)
        cnt_l = np.fromiter((len(jg[1]) for _, _, jg in legacy),
                            np.int64, nleg)
        vlo_l = len(vrows) + np.concatenate(([0], np.cumsum(cnt_l)[:-1]))
        typ_l = np.fromiter((jg[0] for _, _, jg in legacy), np.int8, nleg)
        len_l = np.fromiter((jg[2] for _, _, jg in legacy), np.int32, nleg)
        mi_l = np.fromiter((span[s] for _, s, _ in legacy), np.int64, nleg)
        key_l = np.fromiter((k for k, _, _ in legacy), np.int64, nleg)
        aux = np.concatenate([jg[1] for _, _, jg in legacy])
        order = np.argsort(np.concatenate((key_vec, key_l)), kind="stable")
        return _JobTable(
            np.concatenate((cnt_v, cnt_l))[order],
            np.concatenate((vlo_v, vlo_l))[order],
            np.concatenate((typ_v, typ_l))[order],
            np.concatenate((len_v, len_l))[order],
            np.concatenate((mi_v, mi_l))[order],
            np.concatenate((vrows, aux)),
            np.concatenate((span_v, span[aux])))

    def _prepare_group_fast(self, batch, span, s, e, rtype, final_len, jobs,
                            group_uniform, ordinal):
        """One group's preparation on array slices (the classic engine's
        prepare_group): downsample, subgroup, zero-length and min-reads
        rejection, most-common-alignment filter, consensus length, orphan
        handling. ``ordinal`` is the group's downsample-RNG ordinal."""
        caller = self.caller
        opts = caller.options
        stats = caller.stats

        def rej(rows_arr):
            # rejects materialize as RawRecords only when tracking is on
            if caller.track_rejects and len(rows_arr):
                caller.rejected_reads.extend(
                    batch.raw_records(span[rows_arr]))

        n_records = e - s
        stats.add_input_reads(int(n_records))
        if n_records < opts.min_reads:
            stats.reject("InsufficientReads", int(n_records))
            rej(np.arange(s, e))
            return

        rows = np.arange(s, e)
        if opts.max_reads is not None and n_records > opts.max_reads:
            rng = np.random.Generator(
                np.random.Philox(key=(opts.seed or 0) + ordinal))
            perm = rng.permutation(n_records)[:opts.max_reads]
            rows = rows[perm]  # permuted order, like the classic downsample

        group_jobs = {}
        for read_type in (FRAGMENT, R1, R2):
            t_rows = rows[rtype[rows] == read_type]
            if len(t_rows) == 0:
                continue
            if len(t_rows) < opts.min_reads:
                stats.reject("InsufficientReads", int(len(t_rows)))
                rej(t_rows)
                continue
            lens = final_len[t_rows]
            ok = lens > 0
            zero_len = int((~ok).sum())
            if zero_len:
                stats.reject("ZeroLengthAfterTrimming", zero_len)
                rej(t_rows[~ok])
                t_rows = t_rows[ok]
                lens = lens[ok]
            if len(t_rows) < opts.min_reads:
                if len(t_rows):
                    stats.reject("InsufficientReads", int(len(t_rows)))
                    rej(t_rows)
                continue
            # identical simplified CIGARs always form a single compatibility
            # group -> keep all. Identical raw bytes imply that only when
            # strands agree or the simplified CIGAR is palindromic (reverse
            # reads use the reversed simplified CIGAR).
            if group_uniform:
                need_filter = False
            else:
                cig_off = batch.cigar_off[span[t_rows]]
                runs = nb.group_starts(batch.buf, cig_off,
                                       4 * batch.n_cigar[span[t_rows]])
                need_filter = len(runs) > 1
                if need_filter \
                        and (batch.n_cigar[span[t_rows]] == 1).all() \
                        and ((batch.buf[cig_off] & 0xF) == 0).all():
                    # all-single-op-M: mutually prefix-compatible
                    need_filter = False
            if not need_filter and len(t_rows) >= 2:
                revs = (batch.flag[span[t_rows]] & FLAG_REVERSE) != 0
                if revs.any() and not revs.all():
                    cig = cigar_utils.simplify(
                        self._decode_cigar(batch, int(span[t_rows[0]])))
                    need_filter = cig != list(reversed(cig))
            if need_filter:
                keep_rows = self._alignment_filter(batch, span, t_rows, lens)
                rejected = len(t_rows) - len(keep_rows)
                if rejected:
                    stats.reject("MinorityAlignment", rejected)
                    keep_set = set(keep_rows.tolist())
                    rej(np.array([r for r in t_rows if r not in keep_set],
                                 dtype=np.int64))
                t_rows = keep_rows
                lens = final_len[t_rows]
                if len(t_rows) < opts.min_reads:
                    if len(t_rows):
                        stats.reject("InsufficientReads", int(len(t_rows)))
                        rej(t_rows)
                    continue
            lens_sorted = np.sort(lens)[::-1]
            consensus_len = int(lens_sorted[opts.min_reads - 1])
            group_jobs[read_type] = (read_type, t_rows, consensus_len)

        # orphan R1/R2 handling: both or neither
        if FRAGMENT in group_jobs:
            jobs.append(group_jobs[FRAGMENT])
        r1, r2 = group_jobs.get(R1), group_jobs.get(R2)
        if r1 is not None and r2 is not None:
            jobs.extend([r1, r2])
        elif r1 is not None:
            stats.reject("OrphanConsensus", len(r1[1]))
            rej(r1[1])
        elif r2 is not None:
            stats.reject("OrphanConsensus", len(r2[1]))
            rej(r2[1])

    def _alignment_filter(self, batch, span, t_rows, lens):
        """Non-uniform CIGARs: decode + simplify + truncate per read, then
        the exact most-common-alignment filter."""
        entries = []
        for local, (row, ln) in enumerate(zip(t_rows, lens)):
            rec_i = int(span[row])
            cig = self._decode_cigar(batch, rec_i)
            simplified = cigar_utils.simplify(cig)
            if batch.flag[rec_i] & FLAG_REVERSE:
                simplified = cigar_utils.reverse(simplified)
            simplified = cigar_utils.truncate_to_query_length(
                simplified, int(ln))
            entries.append((local, int(ln), simplified))
        entries.sort(key=lambda t: -t[1])
        keep = cigar_utils.select_most_common_alignment_group(entries)
        keep_set = set(keep)
        return t_rows[[local in keep_set for local in range(len(t_rows))]]

    @staticmethod
    def _decode_cigar(batch, rec_i):
        off = batch.cigar_off[rec_i]
        n = batch.n_cigar[rec_i]
        # tobytes() realigns: a uint32 view of an odd-offset slice would fail
        raw = np.frombuffer(batch.buf[off: off + 4 * n].tobytes(),
                            dtype="<u4")
        return [(_CIGAR_OPS[v & 0xF], int(v) >> 4) for v in raw]

    # ------------------------------------------------------------------ device

    def _dispatch_jobs(self, codes, quals, table):
        """Single-read jobs on the host; ALL multi-read jobs of the batch as
        one dense (N, L) segment dispatch on the kernel's device. Returns
        (pending-or-None, host blocks)."""
        caller = self.caller
        opts = caller.options
        kernel = caller.kernel
        count = table.count
        blocks0 = []

        single = np.nonzero(count == 1)[0]
        if len(single):
            rows1 = table.pool_rows[table.vlo[single]]
            Lm = int(table.cons_len[single].max())
            b, q, d, e = oracle.single_read_consensus(
                codes[rows1, :Lm], quals[rows1, :Lm], caller.tables,
                opts.min_consensus_base_quality)
            blocks0.append((single, np.ascontiguousarray(b),
                            np.ascontiguousarray(q),
                            np.ascontiguousarray(d.astype(np.int32)),
                            np.ascontiguousarray(e.astype(np.int32))))

        multi = np.nonzero(count > 1)[0]
        if len(multi) == 0:
            return None, blocks0

        counts = count[multi]
        rows_all = table.pool_rows[_ranges(table.vlo[multi], counts)]
        # 4-multiple L >= every job's consensus length (<= the pack stride);
        # pad columns are N/Q0 from pack_reads
        L_max = -(-int(table.cons_len[multi].max()) // 4) * 4
        codes_d, quals_d, starts = pad_segments_gather(codes, quals, rows_all,
                                                       L_max, counts)
        # the fused route needs u16 depths (no family of 65536+ reads)
        fused = self.filter_stage is not None and counts.max() < 65536
        from ..ops.kernel import HOST_DISPATCH
        from ..ops.router import ROUTER

        # the offload router (ops/router.py): a host batch runs on the
        # native f64 engine at resolve time (full columns; a fused filter
        # stage then judges them on the host)
        if ROUTER.decide_batch(kernel, codes_d.shape[0], len(multi), L_max,
                               filtered=fused) == "host":
            return ("segw", multi, starts, codes_d, quals_d,
                    HOST_DISPATCH), blocks0
        if fused:
            ticket = kernel.device_call_segments_wire_filtered(
                codes_d, quals_d, starts, table.cons_len[multi],
                (opts.min_reads, opts.min_consensus_base_quality,
                 self.filter_stage.dev_params))
            return ("segwf", multi, starts, codes_d, quals_d,
                    ticket), blocks0
        dev = kernel.device_call_segments_wire(codes_d, quals_d, starts)
        return ("segw", multi, starts, codes_d, quals_d, dev), blocks0

    # ------------------------------------------------------------------ output

    def _serialize_jobs(self, batch, table, blocks=()) -> bytes:
        """Native batch serializer: all jobs -> one block_size-prefixed
        blob. ``blocks`` carries every job's result rows as whole blocks;
        MI bytes are pointers straight into the batch buffer."""
        caller = self.caller
        opts = caller.options
        J = len(table)
        lens = np.ascontiguousarray(table.cons_len, dtype=np.int32)
        flags = _TYPE_FLAGS_ARR[table.read_type]
        code_addr = np.empty(J, dtype=np.int64)
        qual_addr = np.empty(J, dtype=np.int64)
        depth_addr = np.empty(J, dtype=np.int64)
        err_addr = np.empty(J, dtype=np.int64)
        # every array an address points into stays referenced until the
        # native call returns
        keep_alive = []
        for idxs, b, q, d, e in blocks:
            keep_alive.append((b, q, d, e))
            fi = np.arange(len(idxs), dtype=np.int64)
            code_addr[idxs] = b.ctypes.data + fi * b.shape[1]
            qual_addr[idxs] = q.ctypes.data + fi * q.shape[1]
            depth_addr[idxs] = d.ctypes.data + fi * (4 * d.shape[1])
            err_addr[idxs] = e.ctypes.data + fi * (4 * e.shape[1])

        buf = batch.buf
        buf_base = buf.ctypes.data
        mi_vo, mi_vl, _ = batch.tag_locs(self.tag)
        mi_addr = buf_base + mi_vo[table.mi_rec]
        mi_len = mi_vl[table.mi_rec]

        # consensus RX from the surviving reads' RX tags: unanimity (the
        # common case) resolves natively to a pointer into the batch buffer;
        # only divergent families run the Python likelihood consensus
        rx_vo, rx_vl, _ = batch.tag_locs_str(b"RX")
        surv_counts = table.count
        surv_starts = np.concatenate(([0], np.cumsum(surv_counts)))
        surv_all = table.pool_span[_ranges(table.vlo, surv_counts)]
        rxo, rxl = nb.rx_unanimous(buf, rx_vo[surv_all], rx_vl[surv_all],
                                   surv_starts)
        rx_addr = np.where(rxo >= 0, buf_base + rxo, 0)
        rx_len = np.where(rxo >= 0, rxl, 0).astype(np.int32)
        divergent = np.nonzero(rxo == -2)[0]
        if len(divergent):
            fams = []
            for j in divergent:
                lo = int(table.vlo[j])
                hi = lo + int(table.count[j])
                fams.append(
                    [buf[rx_vo[i]: rx_vo[i] + rx_vl[i]].tobytes().decode()
                     for i in table.pool_span[lo:hi] if rx_vo[i] >= 0])
            for j, rx in zip(divergent, consensus_umis_batch(fams)):
                rx_arr = np.frombuffer(rx.encode(), dtype=np.uint8)
                keep_alive.append(rx_arr)
                rx_addr[j] = rx_arr.ctypes.data
                rx_len[j] = len(rx_arr)

        blob, _ = nb.build_consensus_records(
            code_addr, qual_addr, depth_addr, err_addr, lens, flags,
            caller.prefix.encode(), mi_addr, mi_len, rx_addr, rx_len,
            caller.read_group_id.encode(), opts.produce_per_base_tags)
        caller.stats.add_consensus_reads(J)
        del keep_alive
        return blob


def overlap_correct_span(batch, idx, bounds, g0, g1, oc):
    """In-place R1/R2 overlap correction over groups [g0, g1) of ``idx``.

    Pairs primary R1/R2 by name within each group; one native call.
    """
    flag = batch.flag
    span = idx[bounds[g0]:bounds[g1]]
    # fast path: the grouped-BAM layout keeps each template's primary R1
    # immediately followed by its R2; vectorized detection of (FIRST, LAST)
    # runs with equal names covers it, the per-group pairing is the general
    # fallback
    f_span = flag[span]
    # candidate adjacency: a FIRST record followed by a LAST-and-not-FIRST
    # one (a FIRST|LAST record sorts into the R1 slot of the per-group
    # pairing and never completes a pair — it must not here either)
    is_first = (f_span[:-1] & FLAG_FIRST) != 0
    next_last = ((f_span[1:] & FLAG_LAST) != 0) \
        & ((f_span[1:] & FLAG_FIRST) == 0)
    cand = np.nonzero(is_first & next_last)[0]
    # a pair must not straddle an MI-group boundary
    if len(cand) and g1 - g0 > 1:
        boundary = np.zeros(len(span) + 1, dtype=bool)
        boundary[bounds[g0 + 1:g1] - bounds[g0]] = True
        cand = cand[~boundary[cand + 1]]
    adjacent_ok = False
    # flag-level completeness precheck: every FIRST/LAST-flagged record must
    # sit in some candidate adjacency, else an orphan exists somewhere and
    # the per-group scan runs anyway
    first_or_last = (f_span & (FLAG_FIRST | FLAG_LAST)) != 0
    if len(cand):
        # candidates are never adjacent (cand i needs row i+1 to be LAST and
        # not FIRST, cand i+1 needs the same row to be FIRST), so the greedy
        # keep is the whole candidate set
        used = np.zeros(len(span), dtype=bool)
        used[cand] = True
        used[cand + 1] = True
        if bool(used[first_or_last].all()):
            keep = cand
            a, b = span[keep], span[keep + 1]
            name_off = batch.data_off + 32
            name_len = (batch.l_read_name - 1).astype(np.int32)
            same = nb.ranges_equal(batch.buf, name_off[a], name_len[a],
                                   name_off[b], name_len[b])
            # repeated names among kept pairs diverge from the per-group
            # pairing (last-writer-wins slots correct only one pair); hash
            # collisions only cause a safe fallback
            hashes = nb.hash_ranges(batch.buf, name_off[a], name_len[a])
            if same.all() and len(np.unique(hashes)) == len(hashes):
                adjacent_ok = True
                r1_offs = batch.data_off[a]
                r2_offs = batch.data_off[b]
    if not adjacent_ok:
        # vectorized (group, name-hash) pairing: keys with exactly one FIRST
        # and one LAST row pair directly (names confirmed by one batched
        # ranges_equal); any odd key shape sends just that group to the
        # per-record pairing, whose last-writer-wins semantics stay the
        # reference for unusual inputs
        r1_offs = []
        r2_offs = []
        bad_groups = set()
        rel_bounds = bounds[g0:g1 + 1] - bounds[g0]
        g_of = np.repeat(np.arange(g1 - g0), np.diff(rel_bounds))
        fl_first = (f_span & FLAG_FIRST) != 0
        fl_last = ((f_span & FLAG_LAST) != 0) & ~fl_first
        rid = np.nonzero(fl_first | fl_last)[0]
        if len(rid):
            name_off_s = batch.data_off[span[rid]] + 32
            name_len_s = (batch.l_read_name[span[rid]] - 1).astype(np.int32)
            h = nb.hash_ranges(batch.buf, name_off_s, name_len_s)
            o = np.lexsort((h, g_of[rid]))
            gg, hh = g_of[rid][o], h[o]
            newkey = np.concatenate(
                ([True], (gg[1:] != gg[:-1]) | (hh[1:] != hh[:-1])))
            kb = np.nonzero(np.concatenate((newkey, [True])))[0]
            sizes = np.diff(kb)
            two = np.nonzero(sizes == 2)[0]
            big = np.nonzero(sizes > 2)[0]
            if len(big):
                bad_groups.update(np.unique(gg[kb[big]]).tolist())
            if len(two):
                ra = rid[o[kb[two]]]
                rb = rid[o[kb[two] + 1]]
                one_first = fl_first[ra] ^ fl_first[rb]
                # orient: FIRST -> a slot, LAST -> b slot
                swap = ~fl_first[ra]
                ra2 = np.where(swap, rb, ra)
                rb2 = np.where(swap, ra, rb)
                a_rows = span[ra2]
                b_rows = span[rb2]
                same_name = nb.ranges_equal(
                    batch.buf, batch.data_off[a_rows] + 32,
                    (batch.l_read_name[a_rows] - 1).astype(np.int32),
                    batch.data_off[b_rows] + 32,
                    (batch.l_read_name[b_rows] - 1).astype(np.int32)
                ).astype(bool)
                ok = one_first & same_name
                pair_g = g_of[ra]
                bad_groups.update(np.unique(pair_g[~ok]).tolist())
                # a bad group's rows pair in the per-record scan below —
                # keeping its vectorized pairs would correct them twice
                if bad_groups:
                    bad_arr = np.fromiter(bad_groups, dtype=np.int64,
                                          count=len(bad_groups))
                    ok &= ~np.isin(pair_g, bad_arr)
                r1_offs = batch.data_off[a_rows[ok]]
                r2_offs = batch.data_off[b_rows[ok]]
        if bad_groups:
            extra_a = []
            extra_b = []
            for g_rel in sorted(bad_groups):
                g = g0 + int(g_rel)
                members = idx[bounds[g]:bounds[g + 1]]
                pairs = {}
                for i in members:
                    f = int(flag[i])
                    slot = pairs.setdefault(batch.name(int(i)), [None, None])
                    if f & FLAG_FIRST:
                        slot[0] = int(i)
                    elif f & FLAG_LAST:
                        slot[1] = int(i)
                for a, b in pairs.values():
                    if a is not None and b is not None:
                        extra_a.append(batch.data_off[a])
                        extra_b.append(batch.data_off[b])
            r1_offs = np.concatenate(
                [np.asarray(r1_offs, dtype=np.int64),
                 np.asarray(extra_a, dtype=np.int64)])
            r2_offs = np.concatenate(
                [np.asarray(r2_offs, dtype=np.int64),
                 np.asarray(extra_b, dtype=np.int64)])
    if len(r1_offs) == 0:
        return
    stats = nb.overlap_correct_pairs(
        batch.buf, np.asarray(r1_offs, dtype=np.int64),
        np.asarray(r2_offs, dtype=np.int64),
        AGREEMENT_CODES[oc.agreement], DISAGREEMENT_CODES[oc.disagreement])
    add_native_overlap_stats(oc.stats, stats)
