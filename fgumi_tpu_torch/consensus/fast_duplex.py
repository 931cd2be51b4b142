"""Vectorized duplex consensus engine over RecordBatch inputs (the fast
engine).

The duplex analog of consensus/fast.py: per-record work runs natively in
batch (native/batch.py), per-molecule work on numpy index slices, the
single-strand likelihood loop on the consensus kernel — every multi-read
strand family of a batch goes out as ONE dense (N, L) segment dispatch of
K1-r (``consensus_wire_resident``: K1's planes, with the thresholded
bases/quals and lane counts kept on the device) — the stage-2 strand
combine on the device (K5, ``ops/kernel.duplex_combine_device``) for every
row whose strands are both multi-read and free of oracle-patched positions
and as numpy (:func:`combine_rows_host`) for the rest, and record
serialization in one native call (``build_duplex_records``). There is no
host fallback: a failed launch raises.

Semantics contract: byte-identical records and identical rejection
statistics to DuplexConsensusCaller.call_groups (the classic engine) on the
same stream (reference duplex_caller.rs:1755-2268). Molecules the
vectorized path cannot express (FIRST|LAST-flagged reads, per-strand
downsampling, most-common-alignment filtering) take the classic caller per
molecule, in stream order.
"""

import threading
import time

import numpy as np

from ..constants import MAX_PHRED, MIN_PHRED, N_CODE
from ..core import cigar as cigar_utils
from ..io.bam import (FLAG_FIRST, FLAG_LAST, FLAG_MATE_UNMAPPED, FLAG_PAIRED,
                      FLAG_REVERSE, FLAG_SECONDARY, FLAG_SUPPLEMENTARY,
                      FLAG_UNMAPPED)
from ..native import batch as nb
from ..ops import oracle
from ..ops.kernel import duplex_combine_device, pad_segments
from .fast import FastSimplexCaller, _ranges, overlap_correct_span
from .simple_umi import _ACGTN_UPPER, consensus_umis_batch
from .vanilla import I16_MAX, R1, R2, _TYPE_FLAGS

# seg types within a molecule: (strand, read-type) -> 0..3
AB_R1, AB_R2, BA_R1, BA_R2 = 0, 1, 2, 3


def _flip_umi(value: str) -> str:
    """Dual-UMI strand reorientation (duplex_caller.rs:1226-1231)."""
    return "-".join(reversed(value.split("-")))


def combine_rows_host(tb, tq, codes2d, vstarts, a_rows, b_rows, lens):
    """The numpy strand combine of AB segs ``a_rows`` with BA segs
    ``b_rows`` (the reference's semantic route): tb, tq (S, L)
    thresholded single-strand bases/quals, ``codes2d`` the segs' packed
    source rows, seg s = rows [vstarts[s], vstarts[s+1]). Returns (out_b
    u8, out_q u8, out_e int32) (K, L); errors are each side's valid source
    observations that differ from the raw combined base (duplex.py
    duplex_combine), excluded where it is N or at or past ``lens``."""
    a_b = tb[a_rows].astype(np.int32)
    b_b = tb[b_rows].astype(np.int32)
    a_q = tq[a_rows].astype(np.int32)
    b_q = tq[b_rows].astype(np.int32)
    agree = a_b == b_b
    a_wins = (~agree) & (a_q > b_q)
    b_wins = (~agree) & (b_q > a_q)
    tie = (~agree) & (a_q == b_q)
    raw_base = np.where(agree | a_wins, a_b, b_b)
    raw_qual = np.where(
        agree, np.clip(a_q + b_q, MIN_PHRED, MAX_PHRED),
        np.where(a_wins, np.clip(a_q - b_q, MIN_PHRED, MAX_PHRED),
                 np.where(b_wins, np.clip(b_q - a_q, MIN_PHRED,
                                          MAX_PHRED), MIN_PHRED)))
    either_n = (a_b == N_CODE) | (b_b == N_CODE)
    mask = either_n | (raw_qual == MIN_PHRED) | tie
    in_len = np.arange(tb.shape[1])[None, :] < np.asarray(lens)[:, None]
    out_b = np.where(in_len & ~mask, raw_base, N_CODE)
    out_q = np.where(in_len & ~mask, raw_qual, MIN_PHRED)
    out_b = np.where(in_len, out_b, 0).astype(np.uint8)
    out_q = np.where(in_len, out_q, 0).astype(np.uint8)
    rb8 = np.ascontiguousarray(raw_base.astype(np.uint8))
    errs = np.zeros(a_b.shape, dtype=np.int32)
    for side in (a_rows, b_rows):
        # one native pass per side over each output's seg row range
        _, e_side = nb.segment_depth_errors_ranges(
            codes2d, rb8, vstarts[:-1][side], vstarts[1:][side])
        errs += e_side
    errs[rb8 == N_CODE] = 0
    errs[~in_len] = 0
    return out_b, out_q, np.minimum(errs, I16_MAX)


class _PendingChunk:
    """Deferred half of a duplex batch: the SS device fetch, the stage-2
    combine and serialization run at :func:`consensus.fast.resolve_chunk`
    time, on any thread and in any order (the stage runner's resolve
    workers)."""

    __slots__ = ("_fn",)

    def __init__(self, fn):
        self._fn = fn

    def resolve(self) -> bytes:
        return self._fn()


class FastDuplexCaller:
    """Batch-vectorized duplex caller wrapping a DuplexConsensusCaller.

    The wrapped caller owns options, stats and the kernel, and serves as
    the per-molecule path, so statistics and output bytes are shared by
    both paths.

    Pending chunks may resolve on other threads than the one that
    processes the batches, concurrently: the per-molecule path (the
    caller's ordinal counter, record builder and single-strand caller) runs
    under :attr:`slow_lock`, the combine counters under their own lock,
    and the caller's stats take theirs.
    """

    def __init__(self, caller, tag: bytes = b"MI", overlap_caller=None):
        self.caller = caller
        self.ss = caller.ss
        self.kernel = caller.ss.kernel
        self.tag = tag
        self.overlap_caller = overlap_caller
        self._carry = None  # (base_mi, [RawRecord] a, [RawRecord] b)
        #: held around every use of the wrapped caller's per-molecule path
        #: and its ordinal counter
        self.slow_lock = threading.Lock()
        self._combine_lock = threading.Lock()
        # seconds in the strand combine with its exact-error recount, device
        # (K5: index upload, combine, fetch) and host rows together
        self.combine_s = 0.0
        # combined output rows through K5 and through the numpy combine,
        # and the most rows one K5 call combined
        self.combine_device_rows = 0
        self.combine_host_rows = 0
        self.combine_device_largest = 0

    # ------------------------------------------------------------------ batches

    def process_batch(self, batch, allow_unmapped: bool = False,
                      final: bool = False):
        """Consume one RecordBatch -> list of output items (bytes, or a
        _PendingChunk whose stage 1 is in flight; see
        :func:`consensus.fast.resolve_chunk`). They may resolve in any
        order and on any thread; write them in order. The span's ordinals
        are reserved here, so MI numbering does not depend on when or
        where a chunk is resolved. The molecule spanning the batch
        boundary is carried as RawRecords and runs the classic path when
        it completes."""
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

        batch.prefetch_tags([self.tag, b"MC", b"RX"])
        mi_off, mi_len, _ = batch.tag_locs(self.tag)
        mo, ml = mi_off[idx], mi_len[idx]
        if (mo < 0).any():
            bad = int(idx[np.nonzero(mo < 0)[0][0]])
            raise ValueError(
                f"record {batch.name(bad)!r} missing {self.tag.decode()} tag")
        buf = batch.buf
        ok = (ml >= 3) & (buf[mo + ml - 2] == ord("/")) \
            & ((buf[mo + ml - 1] == ord("A")) | (buf[mo + ml - 1] == ord("B")))
        if not ok.all():
            bad = int(idx[np.nonzero(~ok)[0][0]])
            mi = batch.tag_bytes(self.tag, bad).decode()
            raise ValueError(
                f"Read has MI tag {mi!r} without /A or /B suffix. Duplex "
                "consensus requires input from `group --strategy paired`, "
                "which marks the source strand.")

        starts = nb.group_starts(buf, np.ascontiguousarray(mo),
                                 (ml - 2).astype(np.int32))
        bounds = np.append(starts, len(idx))
        n_total = len(bounds) - 1
        strand_b = buf[mo + ml - 1] == ord("B")  # per kept row

        def materialize(lo, hi):
            rows = idx[lo:hi]
            a = batch.raw_records(rows[~strand_b[lo:hi]])
            b = batch.raw_records(rows[strand_b[lo:hi]])
            return a, b

        first_base = self._base_mi(batch, int(idx[bounds[0]]))
        merge_carry = self._carry is not None and self._carry[0] == first_base
        if merge_carry:
            a, b = materialize(bounds[0], bounds[1])
            self._carry[1].extend(a)
            self._carry[2].extend(b)

        g0 = 1 if merge_carry else 0
        g1 = n_total if final else max(n_total - 1, g0)
        deferred = None
        if not final and n_total - 1 >= g0:
            a, b = materialize(bounds[n_total - 1], bounds[n_total])
            deferred = (self._base_mi(batch, int(idx[bounds[n_total - 1]])),
                        a, b)

        out = []
        if self._carry is not None:
            if (not merge_carry) or final or n_total >= 2:
                out.extend(self._call_slow_molecule(*self._carry))
                self._carry = None

        if g1 > g0:
            if self.overlap_caller is not None:
                self._overlap_correct(batch, idx, bounds, strand_b, g0, g1)
            out.extend(self._process_molecules(batch, idx, bounds, strand_b,
                                               g0, g1))

        if deferred is not None:
            self._carry = deferred
        if final:
            out.extend(self.flush())
        return out

    def flush(self):
        """Emit any carried boundary molecule (call after the last batch)."""
        if self._carry is None:
            return []
        base_mi, a, b = self._carry
        self._carry = None
        return self._call_slow_molecule(base_mi, a, b)

    def _base_mi(self, batch, i: int) -> str:
        return batch.tag_bytes(self.tag, i)[:-2].decode()

    # ------------------------------------------------------------ slow interop

    def _call_slow_molecule(self, base_mi, a_records, b_records,
                            corrected=False, ordinal=None):
        """One molecule through DuplexConsensusCaller (the semantic
        reference). Overlap correction applies here unless the records were
        already corrected in place natively. ``ordinal``: the molecule's
        reserved ordinal (a pending chunk's fallback molecule), else the
        caller's next one."""
        if self.overlap_caller is not None and not corrected \
                and a_records and b_records:
            from .overlapping import apply_overlapping_consensus

            a_records = apply_overlapping_consensus(a_records,
                                                    self.overlap_caller)
            b_records = apply_overlapping_consensus(b_records,
                                                    self.overlap_caller)
        caller = self.caller
        with self.slow_lock:
            if ordinal is None:
                recs = caller.call_groups([(base_mi, a_records, b_records)])
            else:
                # the counter is saved and restored, never rewound: the
                # processing thread may have reserved past this span
                saved = caller._ordinal
                caller._ordinal = ordinal
                try:
                    recs = caller.call_groups(
                        [(base_mi, a_records, b_records)])
                finally:
                    caller._ordinal = saved
        if not recs:
            return []
        return [b"".join(len(r).to_bytes(4, "little") + r for r in recs)]

    # ------------------------------------------------------------ overlap corr

    def _overlap_correct(self, batch, idx, bounds, strand_b, g0, g1):
        """Per (molecule, strand) correction for molecules with both strands
        (the command-level `a_recs and b_recs` gate, duplex.rs
        has_both_strands)."""
        nG = g1 - g0
        lo, hi = bounds[g0], bounds[g1]
        g_of_row = np.repeat(np.arange(nG), np.diff(bounds[g0:g1 + 1]))
        sb = strand_b[lo:hi]
        n_b = np.bincount(g_of_row, weights=sb, minlength=nG)
        n_a = np.bincount(g_of_row, weights=~sb, minlength=nG)
        both = (n_a > 0) & (n_b > 0)
        if not both.any():
            return
        rows_ok = both[g_of_row]
        er = np.nonzero(rows_ok)[0]
        key = g_of_row[er] * 2 + sb[er]
        order = np.argsort(key, kind="stable")
        idx2 = idx[lo:hi][er[order]]
        skey = key[order]
        seg_first = np.concatenate(([True], skey[1:] != skey[:-1]))
        bounds2 = np.append(np.nonzero(seg_first)[0], len(idx2))
        overlap_correct_span(batch, idx2, bounds2, 0, len(bounds2) - 1,
                             self.overlap_caller)

    # ------------------------------------------------------------- stage 1 + 2

    def _process_molecules(self, batch, idx, bounds, strand_b, g0, g1):
        caller = self.caller
        stats = caller.stats
        span = idx[bounds[g0]:bounds[g1]]
        nG = g1 - g0
        gb = bounds[g0:g1 + 1] - bounds[g0]
        sizes = np.diff(gb)
        g_of_row = np.repeat(np.arange(nG), sizes)
        sb = strand_b[bounds[g0]:bounds[g1]]

        flag_s = batch.flag[span]
        paired = (flag_s & FLAG_PAIRED) != 0
        first = (flag_s & FLAG_FIRST) != 0
        last = (flag_s & FLAG_LAST) != 0

        # molecule-level fallback: FIRST|LAST reads (they belong to both the
        # X and the Y set) and per-strand downsampling
        fallback = np.zeros(nG, dtype=bool)
        fl_both = paired & first & last
        fallback[g_of_row[fl_both]] = True
        max_rs = self.ss.options.max_reads
        if caller.track_rejects or self.ss.options.methylation_mode:
            # rejects need the raw records, and methylation each read's
            # CIGAR and position for the reference annotation: every
            # molecule takes the per-molecule path (as the simplex engine's
            # _vector_ok gate)
            fallback[:] = True

        # per-row seg type (AB_R1..BA_R2); fragments and paired-but-neither
        # get -1
        t = np.full(len(span), -1, dtype=np.int8)
        r1 = paired & first
        r2 = paired & last & ~first
        t[~sb & r1] = AB_R1
        t[~sb & r2] = AB_R2
        t[sb & r1] = BA_R1
        t[sb & r2] = BA_R2

        frag = ~paired
        n_frag = np.bincount(g_of_row[frag], minlength=nG)
        n_paired = sizes - n_frag
        num_a_r1 = np.bincount(g_of_row[~sb & r1], minlength=nG)
        num_b_r1 = np.bincount(g_of_row[sb & r1], minlength=nG)
        num_xy = np.maximum(num_a_r1, num_b_r1)
        num_yx = np.minimum(num_a_r1, num_b_r1)
        gate_ok = (caller.min_total <= num_xy + num_yx) \
            & (caller.min_xy <= num_xy) & (caller.min_yx <= num_yx)

        # strand-orientation validation (duplex_caller.rs:1830-1860): only
        # for molecules with paired rows on both strands; X = AB-R1 + BA-R2
        # and Y = AB-R2 + BA-R1 must each be strand-uniform
        n_pa = np.bincount(g_of_row[~sb & paired], minlength=nG)
        n_pb = np.bincount(g_of_row[sb & paired], minlength=nG)
        both_strands = (n_pa > 0) & (n_pb > 0)
        rev = (flag_s & FLAG_REVERSE) != 0
        is_x = (t == AB_R1) | (t == BA_R2)
        is_y = (t == AB_R2) | (t == BA_R1)
        coll = np.zeros(nG, dtype=bool)
        for setm in (is_x, is_y):
            gr = g_of_row[setm]
            rv = rev[setm]
            mn = np.full(nG, 2, dtype=np.int8)
            mx = np.full(nG, -1, dtype=np.int8)
            np.minimum.at(mn, gr, rv.astype(np.int8))
            np.maximum.at(mx, gr, rv.astype(np.int8))
            coll |= (mx - mn) > 0
        coll &= both_strands

        # native pack over all rows (clip/trim/RC/mask; fast.py discipline)
        mc_off, mc_len, _ = batch.tag_locs_str(b"MC")
        clips = nb.mate_clips(
            batch.buf, np.ascontiguousarray(batch.cigar_off[span]),
            batch.n_cigar[span], batch.flag[span], batch.ref_id[span],
            batch.pos[span], batch.next_ref_id[span], batch.next_pos[span],
            batch.tlen[span], np.ascontiguousarray(mc_off[span]),
            mc_len[span])
        stride = max(-(-int(batch.l_seq[span].max()) // 32) * 32, 32)
        codes, quals, final_len = nb.pack_reads(
            batch.buf, np.ascontiguousarray(batch.seq_off[span]),
            np.ascontiguousarray(batch.qual_off[span]), batch.l_seq[span],
            rev.astype(np.uint8), clips,
            self.ss.options.min_input_base_quality, stride)

        # seg construction over valid rows of live molecules (dead molecules
        # -- failed gates or validation -- need no conversion at all)
        live_mol = gate_ok & ~coll & (n_paired > 0) & ~fallback
        valid = (final_len > 0) & (t >= 0) & live_mol[g_of_row]
        er = np.nonzero(valid)[0]
        key = g_of_row[er] * 4 + t[er]
        order = np.argsort(key, kind="stable")
        vrows = er[order]
        skey = key[order]
        seg_first = np.concatenate(([True], skey[1:] != skey[:-1])) \
            if len(skey) else np.empty(0, dtype=bool)
        seg_of_row = (np.cumsum(seg_first) - 1) if len(skey) else skey
        seg_key = skey[seg_first] if len(skey) else skey
        nseg = len(seg_key)
        seg_g = seg_key >> 2
        seg_t = (seg_key & 3).astype(np.int8)
        c1 = np.bincount(seg_of_row, minlength=nseg).astype(np.int64)
        vstarts = np.concatenate(([0], np.cumsum(c1))).astype(np.int64)
        if max_rs is not None and nseg and (c1 > max_rs).any():
            fallback[seg_g[c1 > max_rs]] = True

        # alignment-filter analysis per X/Y set of each live molecule:
        # uniform CIGARs over the set's valid rows, with the mixed-strand
        # palindrome rule (fast.py _prepare_groups_vec)
        if nseg:
            self._need_filter_fallback(batch, span, vrows, g_of_row, t,
                                       fallback, nG)
        live_mol &= ~fallback

        # rejection tallies for non-fallback molecules
        vec = ~fallback
        stats.add_input_reads(int(sizes[vec].sum()))
        n_fr = int(n_frag[vec].sum())
        if n_fr:
            stats.reject("FragmentRead", n_fr)
        gate_dead = vec & ~gate_ok & (n_paired > 0)
        if gate_dead.any():
            stats.reject("InsufficientReads", int(n_paired[gate_dead].sum()))
        coll_dead = vec & gate_ok & coll
        if coll_dead.any():
            stats.reject("PotentialCollision", int(n_paired[coll_dead].sum()))

        # molecule -> seg map for live molecules
        seg_map = np.full((nG, 4), -1, dtype=np.int64)
        if nseg:
            lm = live_mol[seg_g]
            seg_map[seg_g[lm], seg_t[lm]] = np.nonzero(lm)[0]

        # reserve this span's ordinal range NOW (stream order), so deferred
        # stage-2 resolution cannot shift the classic fallback numbering
        with self.slow_lock:
            ord0 = caller._ordinal
            caller._ordinal = ord0 + nG

        seg_len = np.zeros(nseg, dtype=np.int64)
        if nseg:
            fl = final_len[vrows]
            np.maximum.at(seg_len, seg_of_row, fl)

        # SS consensus for every seg: one kernel dispatch for the multi-read
        # segs, one vectorized host pass for the single-read segs
        L_max = stride
        finish_ss = self._ss_consensus(codes, quals, vrows, c1, vstarts,
                                       nseg, L_max)

        def finish():
            tb, tq, d16, e16, codes2d, ctx = finish_ss()
            try:
                return b"".join(self._stage2(
                    batch, span, gb, sizes, n_paired, fallback, sb,
                    live_mol, seg_map, seg_len, tb, tq, d16, e16, codes2d,
                    vrows, vstarts, L_max, ord0, ctx))
            finally:
                if ctx is not None:
                    ctx["resident"].release()

        return [_PendingChunk(finish)]

    def _need_filter_fallback(self, batch, span, vrows, g_of_row, t,
                              fallback, nG):
        """Mark molecules whose X or Y set would engage the alignment
        filter."""
        tt = t[vrows]
        setid = np.where((tt == AB_R1) | (tt == BA_R2), 0, 1)
        key = g_of_row[vrows] * 2 + setid
        order = np.argsort(key, kind="stable")
        srows = vrows[order]
        skey = key[order]
        if not len(skey):
            return
        sfirst = np.concatenate(([True], skey[1:] != skey[:-1]))
        sstarts = np.append(np.nonzero(sfirst)[0], len(skey))
        set_g = skey[sfirst] >> 1
        co = batch.cigar_off
        cl = (4 * batch.n_cigar).astype(np.int32)
        firsts = srows[sstarts[:-1]]
        counts = np.diff(sstarts)
        rep_first = np.repeat(firsts, counts)
        eq = nb.ranges_equal(batch.buf, co[span[srows]], cl[span[srows]],
                             co[span[rep_first]], cl[span[rep_first]])
        uniform = np.minimum.reduceat(eq, sstarts[:-1]).astype(bool)
        rev8 = ((batch.flag[span[srows]] & FLAG_REVERSE) != 0) \
            .astype(np.uint8)
        mn = np.minimum.reduceat(rev8, sstarts[:-1])
        mx = np.maximum.reduceat(rev8, sstarts[:-1])
        mixed = (mn == 0) & (mx == 1) & (counts >= 2)
        need = ~uniform
        if need.any():
            # all-single-op-M sets (ragged read lengths) are mutually
            # prefix-compatible after simplify: the alignment filter
            # provably keeps every read, so non-uniform bytes alone do not
            # require the fallback (fast.py _prepare_groups_vec twin)
            row_sm = (batch.n_cigar[span[srows]] == 1) \
                & ((batch.buf[co[span[srows]]] & 0xF) == 0)
            set_sm = np.minimum.reduceat(
                row_sm.astype(np.uint8), sstarts[:-1]).astype(bool)
            need &= ~set_sm
        for s in np.nonzero(uniform & mixed)[0]:
            rec_i = int(span[firsts[s]])
            if batch.n_cigar[rec_i] == 1:
                continue  # single-op simplified CIGARs are palindromic
            cig = FastSimplexCaller._decode_cigar(batch, rec_i)
            simplified = cigar_utils.simplify(cig)
            if simplified != list(reversed(simplified)):
                need[s] = True
        fallback[set_g[need]] = True

    def _ss_consensus(self, codes, quals, vrows, c1, vstarts, nseg, L_max):
        """Every seg's single-strand consensus: thresholded bases/quals and
        i16-clamped depth/error arrays, (nseg, L_max) each.

        Dispatches the multi-read segs at once and returns ``finish() ->
        (tb, tq, d16, e16, codes2d, ctx)``, which fetches and completes
        them. ``ctx`` is the strand combine's context when stage 1 kept its
        outputs on the device (K1-r: the 1-byte wire layout and every
        family under 65,536 reads), else None: ``resident`` (the handles,
        released by the caller), ``suspect`` (the multi segs' oracle-
        patched positions) and ``seg_to_multi`` (seg -> row of the resident
        arrays, -1 for a single-read seg)."""
        opts = self.ss.options
        tb = np.zeros((nseg, L_max), dtype=np.uint8)
        tq = np.zeros((nseg, L_max), dtype=np.uint8)
        d16 = np.zeros((nseg, L_max), dtype=np.int32)
        e16 = np.zeros((nseg, L_max), dtype=np.int32)
        if not nseg:
            empty = (tb, tq, d16, e16, np.zeros((0, L_max), dtype=np.uint8),
                     None)
            return lambda: empty
        codes2d = np.ascontiguousarray(codes[vrows])
        quals2d = np.ascontiguousarray(quals[vrows])

        single = c1 == 1
        if single.any():
            rows = vrows[vstarts[:-1][single]]
            b, q, d, e = oracle.single_read_consensus(
                codes[rows], quals[rows], self.ss.tables,
                opts.min_consensus_base_quality)
            tb[single] = b
            tq[single] = q
            d16[single] = np.minimum(d, I16_MAX).astype(np.int32)
            # errors are zero for a single-read consensus
        multi = np.nonzero(~single)[0]
        if not len(multi):
            done = (tb, tq, d16, e16, codes2d, None)
            return lambda: done
        rows_m = _ranges(vstarts[:-1][multi], c1[multi])
        cm = np.ascontiguousarray(codes2d[rows_m])
        qm = np.ascontiguousarray(quals2d[rows_m])
        counts_m = c1[multi]
        # the full-column wire route, K1-r keeping the combine's arrays on
        # the device; a family of 65,536 reads or more takes K1, its u16
        # device depth/errors recounted on the host in resolve, and its
        # batch the host combine (fast_duplex.py:531-532 of the reference)
        # The offload router may send the batch to the native f64 engine
        # (no resident arrays: every row takes the host combine), and
        # FGUMI_TPU_DUPLEX_COMBINE=host asks for K1 without them
        from ..ops.kernel import HOST_DISPATCH
        from ..ops.router import ROUTER, combine_override

        cd, qd, starts_m = pad_segments(cm, qm, counts_m)
        override = combine_override("DUPLEX_COMBINE")
        resident = (opts.min_reads, opts.min_consensus_base_quality) \
            if counts_m.max() < 65536 and override != "host" else None
        if ROUTER.decide_batch(self.kernel, cd.shape[0], len(multi),
                               cd.shape[1]) == "host":
            dev = HOST_DISPATCH
        else:
            dev = self.kernel.device_call_segments_wire(
                cd, qd, starts_m, resident_thresholds=resident)

        def finish():
            *cols, extras = self.kernel.resolve_segments_wire(
                dev, cd, qd, starts_m, want_extras=True)
            w, q_, d, e = (a[:, :L_max] for a in cols)
            ctx = None
            if extras["resident"] is not None:
                seg_to_multi = np.full(nseg, -1, dtype=np.int64)
                seg_to_multi[multi] = np.arange(len(multi))
                ctx = {"resident": extras["resident"],
                       "suspect": extras["suspect"],
                       "seg_to_multi": seg_to_multi,
                       "override": override}
            b_m, q_m = oracle.apply_consensus_thresholds(
                w, q_, d, opts.min_reads, opts.min_consensus_base_quality)
            tb[multi] = b_m
            tq[multi] = q_m
            d16[multi] = np.minimum(d, I16_MAX).astype(np.int32)
            e16[multi] = np.minimum(e, I16_MAX).astype(np.int32)
            return tb, tq, d16, e16, codes2d, ctx

        return finish

    # ---------------------------------------------------------------- stage 2

    def _stage2(self, batch, span, gb, sizes, n_paired, fallback, sb,
                live_mol, seg_map, seg_len, tb, tq, d16, e16, codes2d,
                vrows, vstarts, L_max, ord0, combine_ctx=None):
        """Strand combination + serialization, molecule order kept.

        ord0: the first ordinal of this span's reserved range (set in
        _process_molecules before any deferral); each fallback molecule
        runs the classic path at its own ordinal in that range."""
        caller = self.caller
        stats = caller.stats
        nG = len(sizes)

        p = seg_map >= 0
        full = p.all(axis=1) & live_mol
        ab_only = p[:, AB_R1] & p[:, AB_R2] & ~p[:, BA_R1] & ~p[:, BA_R2] \
            & live_mol & (caller.min_yx == 0)
        ba_only = ~p[:, AB_R1] & ~p[:, AB_R2] & p[:, BA_R1] & p[:, BA_R2] \
            & live_mol & (caller.min_yx == 0)

        # per-seg aliveness: any positive depth within a length limit.
        # One vector pass finds each seg's first positive-depth column;
        # the per-output-read check (lengths differ per pairing) is then a
        # scalar compare instead of a numpy any() per molecule
        pos_depth = d16 > 0
        has_depth = pos_depth.any(axis=1)
        first_nz = np.where(has_depth, np.argmax(pos_depth, axis=1), 1 << 30)

        def seg_alive(s, limit):
            return first_nz[s] < limit

        # build output reads in molecule order: 2 per emitted molecule
        out_specs = []   # (mol, flags, aseg, bseg, kind) kind: 2=combined,
        #                   1=a-passthrough, 0=b-passthrough(is_ba_only)
        emitted = np.zeros(nG, dtype=bool)

        def classify(mol, a_s, b_s):
            """One output read's effective sides; None = dead molecule."""
            La, Lb = int(seg_len[a_s]) if a_s >= 0 else 0, \
                int(seg_len[b_s]) if b_s >= 0 else 0
            if a_s >= 0 and b_s >= 0:
                length = min(La, Lb)
                aa = seg_alive(a_s, length)
                ba = seg_alive(b_s, length)
                if aa and ba:
                    return (2, a_s, b_s, length)
                if aa:
                    return (1, a_s, -1, La)
                if ba:
                    return (0, b_s, -1, Lb)
                return None
            if a_s >= 0:
                return (1, a_s, -1, La) if seg_alive(a_s, La) else None
            if b_s >= 0:
                return (0, b_s, -1, Lb) if seg_alive(b_s, Lb) else None
            return None

        for g in np.nonzero(full | ab_only | ba_only)[0]:
            # rx1/rx2: the AB and BA segs contributing RX values per output
            # read — the reference folds in raws of BOTH segs even when one
            # strand's consensus is depth-dead (duplex.py _build_record
            # iterates raws_a + raws_b of the branch taken)
            if full[g]:
                spec1 = classify(g, seg_map[g, AB_R1], seg_map[g, BA_R2])
                spec2 = classify(g, seg_map[g, AB_R2], seg_map[g, BA_R1])
                rx1 = (seg_map[g, AB_R1], seg_map[g, BA_R2])
                rx2 = (seg_map[g, AB_R2], seg_map[g, BA_R1])
                if spec1 is None or spec2 is None:
                    continue
                # _has_min_reads on both output reads (duplex.py)
                okmin = True
                for spec in (spec1, spec2):
                    kind, s1, s2, length = spec
                    na = int(d16[s1, :length].max()) if length else 0
                    nb_ = int(d16[s2, :length].max()) if kind == 2 and length \
                        else 0
                    xy, yx = max(na, nb_), min(na, nb_)
                    if not (caller.min_total <= xy + yx
                            and caller.min_xy <= xy and caller.min_yx <= yx):
                        okmin = False
                if not okmin:
                    continue
            elif ab_only[g]:
                spec1 = classify(g, seg_map[g, AB_R1], -1)
                spec2 = classify(g, seg_map[g, AB_R2], -1)
                rx1 = (seg_map[g, AB_R1], -1)
                rx2 = (seg_map[g, AB_R2], -1)
                if spec1 is None or spec2 is None:
                    continue
            else:
                spec1 = classify(g, -1, seg_map[g, BA_R2])
                spec2 = classify(g, -1, seg_map[g, BA_R1])
                rx1 = (-1, seg_map[g, BA_R2])
                rx2 = (-1, seg_map[g, BA_R1])
                if spec1 is None or spec2 is None:
                    continue
            emitted[g] = True
            out_specs.append((g, _TYPE_FLAGS[R1]) + spec1 + rx1)
            out_specs.append((g, _TYPE_FLAGS[R2]) + spec2 + rx2)

        # InsufficientReads for live-but-unemitted molecules (the fallthrough
        # reject in duplex.py _combine_molecule)
        dead = live_mol & ~emitted
        if dead.any():
            stats.reject("InsufficientReads", int(n_paired[dead].sum()))

        K = len(out_specs)
        chunks = []
        fast_blob = b""
        rec_end = np.zeros(0, dtype=np.int64)
        if K:
            fast_blob, rec_end = self._serialize_outputs(
                batch, span, gb, out_specs, seg_map, seg_len, tb, tq, d16,
                e16, codes2d, vrows, vstarts, L_max, combine_ctx)
            stats.add_consensus_reads(K)

        # assemble in molecule order, interleaving fallback molecules
        fb_set = set(np.nonzero(fallback)[0].tolist())
        if not fb_set:
            return [fast_blob] if fast_blob else []
        out_i = 0
        pending_fast_start = 0
        for g in sorted(fb_set):
            # flush the fast run before this molecule
            while out_i < len(out_specs) and out_specs[out_i][0] < g:
                out_i += 2
            run_end = int(rec_end[out_i - 1]) if out_i else 0
            if run_end > pending_fast_start:
                chunks.append(fast_blob[pending_fast_start:run_end])
                pending_fast_start = run_end
            rows = span[gb[g]:gb[g + 1]]
            sb_g = sb[gb[g]:gb[g + 1]]
            a = batch.raw_records(rows[~sb_g])
            b = batch.raw_records(rows[sb_g])
            chunks.extend(self._call_slow_molecule(
                self._base_mi(batch, int(rows[0])), a, b, corrected=True,
                ordinal=ord0 + g))
        if len(fast_blob) > pending_fast_start:
            chunks.append(fast_blob[pending_fast_start:])
        return chunks

    def _serialize_outputs(self, batch, span, gb, out_specs, seg_map, seg_len,
                           tb, tq, d16, e16, codes2d, vrows, vstarts, L_max,
                           combine_ctx=None):
        """Combine + native-serialize the K fast output reads (order kept).

        A combined row goes through the device combine (K5, over the
        stage-1 resident arrays) when both its strands are multi-read segs
        and neither has an oracle-patched position (the resident arrays
        hold the pre-patch values); every other combined row, and every
        row of a batch without resident arrays, takes the numpy combine.
        The exact per-base errors of a host row are one native pass per
        side over the segs' packed rows."""
        caller = self.caller
        K = len(out_specs)
        mols = np.array([s[0] for s in out_specs], dtype=np.int64)
        flags = np.array([s[1] for s in out_specs], dtype=np.int32)
        kinds = np.array([s[2] for s in out_specs], dtype=np.int8)
        aseg = np.array([s[3] for s in out_specs], dtype=np.int64)
        bseg = np.array([s[4] for s in out_specs], dtype=np.int64)
        lens = np.array([s[5] for s in out_specs], dtype=np.int32)

        out_b = np.zeros((K, L_max), dtype=np.uint8)
        out_q = np.zeros((K, L_max), dtype=np.uint8)
        out_e = np.zeros((K, L_max), dtype=np.int32)

        comb = np.nonzero(kinds == 2)[0]
        t0 = time.monotonic()
        host = comb
        if len(comb) and combine_ctx is not None:
            s2m = combine_ctx["seg_to_multi"]
            ma, mb = s2m[aseg[comb]], s2m[bseg[comb]]
            # single-read segs have no resident row; a suspect position on
            # either strand sends the whole row to the host
            sus_row = combine_ctx["suspect"].any(axis=1)
            eligible = (ma >= 0) & (mb >= 0)
            eligible &= ~(sus_row[np.maximum(ma, 0)]
                          | sus_row[np.maximum(mb, 0)])
            cand = comb[eligible]
            host = comb[~eligible]
            if len(cand):
                from ..ops.router import DUPLEX_COMBINE, run_adaptive_stage

                def device_combine():
                    t_dev = time.monotonic()
                    ob, oq, oe = duplex_combine_device(
                        combine_ctx["resident"], ma[eligible], mb[eligible],
                        lens[cand])
                    # the resident width is the padded one: columns past
                    # L_max lie past every lens and are 0
                    out_b[cand] = ob[:, :L_max]
                    out_q[cand] = oq[:, :L_max]
                    out_e[cand] = oe[:, :L_max]
                    self.kernel.add_device_s(time.monotonic() - t_dev)

                def host_combine():
                    out_b[cand], out_q[cand], out_e[cand] = \
                        combine_rows_host(tb, tq, codes2d, vstarts,
                                          aseg[cand], bseg[cand], lens[cand])

                # FGUMI_TPU_DUPLEX_COMBINE: unset/device K5, auto the
                # router's chooser (the host side is the numpy combine)
                _, side = run_adaptive_stage(
                    DUPLEX_COMBINE, len(cand) * L_max,
                    combine_ctx.get("override", "device"), device_combine,
                    host_combine)
                with self._combine_lock:
                    if side == "device":
                        self.combine_device_rows += len(cand)
                        self.combine_device_largest = max(
                            self.combine_device_largest, len(cand))
                    else:
                        self.combine_host_rows += len(cand)
        if combine_ctx is not None:
            # the combine is done with the stage-1 resident arrays
            combine_ctx["resident"].release()
        if len(host):
            out_b[host], out_q[host], out_e[host] = combine_rows_host(
                tb, tq, codes2d, vstarts, aseg[host], bseg[host], lens[host])
        with self._combine_lock:
            self.combine_host_rows += len(host)
            self.combine_s += time.monotonic() - t0

        passthrough = np.nonzero(kinds != 2)[0]
        for k in passthrough:
            s = aseg[k]
            L = lens[k]
            out_b[k, :L] = tb[s, :L]
            out_q[k, :L] = tq[s, :L]
            out_e[k, :L] = e16[s, :L]

        # serializer strand inputs: 'a' side = dup.ab_consensus (the alive /
        # AB side, truncated to the combined length), 'b' side =
        # ba_consensus (combined case only)
        a_rows = aseg
        a_len = lens.astype(np.int32)
        b_present = (kinds == 2).astype(np.uint8)
        b_rows = np.where(kinds == 2, bseg, 0)
        b_len = np.where(kinds == 2, lens, 0).astype(np.int32)

        def row_addrs(arr, rows):
            return arr.ctypes.data + rows * arr.shape[1] * arr.itemsize

        # RX per output read (strand-reoriented consensus, duplex.py
        # _build_record)
        rx_addr, rx_len, keep_alive = self._output_rx(
            batch, span, out_specs, seg_map, vrows, vstarts)

        mi_off, mi_len, _ = batch.tag_locs(self.tag)
        first_rows = span[gb[mols]]
        mi_addr = batch.buf.ctypes.data + mi_off[first_rows]
        mi_l = (mi_len[first_rows] - 2).astype(np.int32)  # base MI, no /A|/B

        blob, rec_end = nb.build_duplex_records(
            row_addrs(out_b, np.arange(K)), row_addrs(out_q, np.arange(K)),
            row_addrs(out_e, np.arange(K)), lens, flags,
            caller.prefix.encode(), mi_addr, mi_l,
            row_addrs(tb, a_rows), row_addrs(tq, a_rows),
            row_addrs(d16, a_rows), row_addrs(e16, a_rows), a_len,
            row_addrs(tb, b_rows), row_addrs(tq, b_rows),
            row_addrs(d16, b_rows), row_addrs(e16, b_rows), b_len, b_present,
            rx_addr, rx_len, caller.read_group_id.encode(),
            caller.produce_per_base_tags)
        del keep_alive
        return blob, rec_end

    def _output_rx(self, batch, span, out_specs, seg_map, vrows, vstarts):
        """RX tag per output read: a-side values verbatim, b-side values
        strand-flipped, then the UMI consensus (unanimous fast path)."""
        rx_vo, rx_vl, _ = batch.tag_locs_str(b"RX")
        buf = batch.buf
        K = len(out_specs)
        rx_off_in_blob = np.zeros(K, dtype=np.int64)
        rx_len = np.zeros(K, dtype=np.int32)
        blob = bytearray()  # one allocation for all values, not one per emit

        span_v = span[vrows]
        una_off, una_len = nb.rx_unanimous(buf, rx_vo[span_v], rx_vl[span_v],
                                           vstarts)
        present = (rx_vo[span_v] >= 0).astype(np.int64)
        cnt = np.add.reduceat(present, vstarts[:-1]) \
            if len(span_v) else np.zeros(0, dtype=np.int64)

        # native fast path: every output whose contributing segs are
        # unanimous/absent resolves in one C pass (single-read verbatim /
        # all-equal uppercased, b-side flip on bytes); only divergent or
        # disagreeing outputs fall through to the Python likelihood loop
        a_arr = np.fromiter((s[6] for s in out_specs), np.int64, K)
        b_arr = np.fromiter((s[7] for s in out_specs), np.int64, K)
        n_off, n_len, n_blob, fb = nb.duplex_rx_fast(
            buf, una_off, una_len, cnt, a_arr, b_arr)
        n_blob_arr = n_blob if len(n_blob) else np.zeros(1, dtype=np.uint8)
        if len(fb) == 0:
            rx_addr = np.where(n_len > 0, n_blob_arr.ctypes.data + n_off, 0)
            return rx_addr, n_len, [n_blob_arr]
        fb_set = set(int(x) for x in fb)

        def seg_values(s):
            """Ordered present RX strings of seg s."""
            rows = span_v[vstarts[s]:vstarts[s + 1]]
            vals = []
            for i in rows:
                if rx_vo[i] >= 0:
                    vals.append(buf[rx_vo[i]:rx_vo[i] + rx_vl[i]]
                                .tobytes().decode())
            return vals

        def emit(k, rx):
            rx_off_in_blob[k] = len(blob)
            blob.extend(rx.encode())
            rx_len[k] = len(rx)

        fams = []
        fam_ks = []
        for k, spec in enumerate(out_specs):
            if k not in fb_set:
                continue  # resolved by the native fast path
            # AB-seg values verbatim, BA-seg values flipped — BOTH segs of
            # the branch contribute, independent of consensus aliveness
            a_s, b_s = spec[6], spec[7]
            # fast path: when every contributing seg is unanimous, the
            # family holds at most two distinct values — if they agree, the
            # consensus is that value (simple_umi's all-equal rule: verbatim
            # for a single read, ACGTN-uppercased otherwise), with no
            # per-read list or likelihood call. This is ~every real duplex
            # molecule (a-strand RX == flip(b-strand RX)).
            svals = []
            simple = True
            for s, flip in ((a_s, False), (b_s, True)):
                if s < 0 or una_off[s] == -1:
                    continue
                if una_off[s] == -2:
                    simple = False
                    break
                v = buf[una_off[s]:una_off[s] + una_len[s]].tobytes().decode()
                if flip:
                    v = _flip_umi(v)
                svals.append((v, int(cnt[s])))
            if simple:
                if not svals:
                    continue
                total = sum(c for _, c in svals)
                if total == 1:
                    emit(k, svals[0][0])
                    continue
                if all(v == svals[0][0] for v, _ in svals):
                    emit(k, svals[0][0].translate(_ACGTN_UPPER))
                    continue
            vals = []
            for s, flip in ((a_s, False), (b_s, True)):
                if s < 0:
                    continue
                if una_off[s] == -2:  # divergent: materialize + flip each
                    vs = seg_values(s)
                    if flip:
                        vs = [_flip_umi(v) for v in vs]
                elif una_off[s] >= 0:  # unanimous: decode (and flip) ONCE
                    v = buf[una_off[s]:una_off[s] + una_len[s]] \
                        .tobytes().decode()
                    if flip:
                        v = _flip_umi(v)
                    vs = [v] * int(cnt[s])
                else:
                    continue
                vals.extend(vs)
            if not vals:
                continue
            fams.append(vals)
            fam_ks.append(k)
        for k, rx in zip(fam_ks, consensus_umis_batch(fams)):
            emit(k, rx)
        blob_arr = np.frombuffer(bytes(blob) or b"\x00", dtype=np.uint8)
        # merge: python-resolved (fallback) outputs override the native
        # arena's entries; both arenas stay alive via the returned list
        py_mask = rx_len > 0
        rx_addr = np.where(
            py_mask, blob_arr.ctypes.data + rx_off_in_blob,
            np.where(n_len > 0, n_blob_arr.ctypes.data + n_off, 0))
        return (rx_addr, np.where(py_mask, rx_len, n_len),
                [blob_arr, n_blob_arr])
