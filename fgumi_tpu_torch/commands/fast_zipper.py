"""Batch zipper engine over RecordBatch pairs.

The port's copy of fgumi_tpu/commands/fast_zipper.py. The per-template
zipper (commands/zipper.py, whose bytes this engine must equal; the
reference is fgumi's zipper.rs merge_raw:397-545) spends its time in
per-tag Python: TagEditor walks, raw_tag_entries, per-record
RawRecord round trips. This engine processes the overwhelmingly common
template shapes — a fully mapped primary pair, or an unpaired fragment, with
no secondary/supplementary records and no tag-name collisions — as whole-batch
array passes plus three native ops:

- field patches (mate ref/pos/flags, TLEN, QC transfer) as vectorized writes
  into the batch buffer;
- the per-record append region (MQ/MC/ms entries, the unmapped record's aux
  bytes, normalized AS/XS) assembled by fgumi_concat_spans from a span table
  built entirely in numpy;
- record rebuild (prefix + surviving aux + appends) by
  fgumi_rebuild_aux_records, whose output order IS TagEditor.finish's order:
  surviving originals in place, appends at the end in staged order.

Secondary/supplementary rows vectorize too: supplementaries get
the opposite primary's mate pointers/MQ/MC/ms and the same-side tlen,
secondaries keep their mate fields, and both get the `tc`
template-coordinate B:i tag from the primaries' unclipped 5' coordinates
(zipper.rs:281-357, template.rs:459-605). Aligner-dropped templates queue
INSIDE the window so scattered passthroughs cannot fragment it.

Anything else (templates spanning batch buffers, half-mapped or unmapped
pairs, tag-name collisions with MQ/MC/ms/AS/XS/tc, active reverse/revcomp
tag sets on negative-strand reads) takes the per-template engine, as the
reference routes it (tests/test_torch_zipper.py runs both engines of both
packages on adversarial inputs).
"""

import numpy as np

from ..io.bam import (FLAG_FIRST, FLAG_MATE_REVERSE, FLAG_MATE_UNMAPPED,
                      FLAG_PAIRED, FLAG_QC_FAIL, FLAG_REVERSE, FLAG_SECONDARY,
                      FLAG_SUPPLEMENTARY, FLAG_UNMAPPED)
from ..native import batch as nb
from .zipper import MappedTemplate, merge_template

_SEC_SUPP = FLAG_SECONDARY | FLAG_SUPPLEMENTARY
# tag names whose presence on the unmapped record collides with the staged
# MQ/MC/ms/tc appends or the AS/XS normalization ordering: such a template
# takes the per-template engine
_RESERVED_U_TAGS = {b"MQ", b"MC", b"ms", b"AS", b"XS", b"tc"}
_INT_TYPES = frozenset(b"cCsSiI")


def _tag16(tag: bytes) -> int:
    return tag[0] | (tag[1] << 8)


def iter_template_windows(reader):
    """Yield ("batch", batch, bounds) for complete name groups within one
    RecordBatch (templates are bounds[j]..bounds[j+1] rows), and
    ("py", name, [RawRecord]) for groups spanning batch buffers (including
    the final group). Order is stream order."""
    carry = None  # (name, [RawRecord])
    for batch in reader:
        if batch.n == 0:
            continue
        name_off = batch.data_off + 32
        name_len = (batch.l_read_name - 1).astype(np.int64)
        starts = nb.group_starts(batch.buf, np.ascontiguousarray(name_off),
                                 name_len)
        bounds = np.append(starts, batch.n)
        n_groups = len(bounds) - 1
        first_name = bytes(batch.buf[name_off[0]:name_off[0] + name_len[0]])
        gi = 0
        if carry is not None and carry[0] == first_name:
            carry[1].extend(batch.raw_records(
                np.arange(bounds[0], bounds[1])))
            gi = 1
            if n_groups == 1:
                continue  # the whole batch is one open template
            yield ("py", carry[0], carry[1])
            carry = None
        elif carry is not None:
            yield ("py", carry[0], carry[1])
            carry = None
        if gi < n_groups - 1:
            yield ("batch", batch, bounds[gi:n_groups])
        lo, hi = bounds[n_groups - 1], bounds[n_groups]
        last_name = bytes(batch.buf[name_off[lo]:name_off[lo] + name_len[lo]])
        carry = (last_name, list(batch.raw_records(np.arange(lo, hi))))
    if carry is not None:
        yield ("py", carry[0], carry[1])


def iter_templates(reader):
    """Per-template items: (name, batch|None, lo, hi, records|None)."""
    for item in iter_template_windows(reader):
        if item[0] == "py":
            yield (item[1], None, 0, 0, item[2])
        else:
            _, batch, bounds = item
            name_off = batch.data_off + 32
            name_len = batch.l_read_name
            buf = batch.buf
            for j in range(len(bounds) - 1):
                lo = int(bounds[j])
                name = bytes(buf[name_off[lo]:name_off[lo]
                                 + name_len[lo] - 1])
                yield (name, batch, lo, int(bounds[j + 1]), None)


class FastZipper:
    """Window accumulator + vectorized processor (see module docstring)."""

    def __init__(self, tag_info, writer, skip_tc_tags=False):
        self.tag_info = tag_info
        self.writer = writer
        self.skip_tc = skip_tc_tags
        self._static_drop16 = np.array(
            sorted(_tag16(t.encode()) for t in tag_info.remove
                   if len(t) == 2), dtype=np.uint16)
        self._static_drop_b = {t.encode() for t in tag_info.remove
                               if len(t) == 2}
        self._has_transforms = bool(tag_info.reverse or tag_info.revcomp)
        self._reserved16 = np.array(
            sorted({_tag16(t) for t in _RESERVED_U_TAGS}
                   | set(self._static_drop16.tolist())), dtype=np.uint16)
        self._names_cache = None
        self.n_templates = 0
        self.n_records = 0
        # current window: same (m_batch, u_batch) run of simple candidates
        self._win = []
        self._win_batches = (None, None)

    # ------------------------------------------------------------- dispatch

    def passthrough(self, u):
        """Aligner-dropped template: the unmapped records pass through.

        Queued INSIDE an open window when it shares the unmapped batch:
        flushing here would fragment windows into slivers of a few
        templates on inputs with scattered dropped templates, multiplying
        the fixed cost of each vectorized pass."""
        name, ub, lo, hi, recs = u
        if recs is None and self._win and self._win_batches[1] is ub:
            self._win.append(("pass", u))
            return
        self._flush()
        if recs is None:
            w = b"".join(self._wire_rows(ub, lo, hi))
        else:
            w = b"".join(self._wire_rec(r.data) for r in recs)
        self.writer.write_serialized(w)
        self.n_templates += 1
        self.n_records += (hi - lo) if recs is None else len(recs)

    def pair(self, u, m):
        """One matched (unmapped, mapped) template."""
        if u[1] is None or m[1] is None:
            self._flush()
            self._classic(u, m)
            return
        if self._win_batches != (m[1], u[1]):
            self._flush()
            self._win_batches = (m[1], u[1])
        self._win.append(("pair", u, m))
        if len(self._win) >= 8192:
            self._flush()

    def finish(self):
        self._flush()

    # -------------------------------------------------------------- helpers

    @staticmethod
    def _wire_rows(batch, lo, hi):
        base = int(batch.rec_off[lo])
        end = int(batch.data_end[hi - 1])
        yield batch.buf[base:end].tobytes()

    @staticmethod
    def _wire_rec(data: bytes) -> bytes:
        return len(data).to_bytes(4, "little") + data

    def _classic(self, u, m):
        """The per-template engine (materialized RawRecords)."""
        name, ub, ulo, uhi, urecs = u
        if urecs is None:
            urecs = list(ub.raw_records(np.arange(ulo, uhi)))
        mname, mb, mlo, mhi, mrecs = m
        if mrecs is None:
            mrecs = list(mb.raw_records(np.arange(mlo, mhi)))
        t = MappedTemplate.from_records(mname, mrecs)
        out = merge_template(urecs, t, self.tag_info, self.skip_tc)
        self.writer.write_serialized(
            b"".join(self._wire_rec(d) for d in out))
        self.n_templates += 1
        self.n_records += len(out)

    # ----------------------------------------------------------- vectorized

    def _flush(self):
        items, self._win = self._win, []
        mb, ub = self._win_batches
        self._win_batches = (None, None)
        if not items:
            return
        win = [(it[1], it[2]) for it in items if it[0] == "pair"]
        if win:
            simple, order = self._classify(win, mb, ub)
        else:
            simple, order = None, ()
        blob = pos = None
        if simple is not None:
            blob, pos, row_of = simple
        # emit in stream order, interleaving queued passthroughs
        k = 0
        for it in items:
            if it[0] == "pass":
                _, pub, lo, hi, _ = it[1]
                self.writer.write_serialized(
                    b"".join(self._wire_rows(pub, lo, hi)))
                self.n_templates += 1
                self.n_records += hi - lo
                continue
            u, m = it[1], it[2]
            if order[k] >= 0:
                j0 = order[k]
                n_rows = m[3] - m[2]
                w = blob[pos[j0]:pos[j0 + n_rows]].tobytes()
                self.writer.write_serialized(w)
                self.n_templates += 1
                self.n_records += n_rows
            else:
                self._classic(u, m)
            k += 1

    def _classify(self, win, mb, ub):
        """Split the window into vectorizable rows and per-template ones.

        Returns ((wire blob, row positions, row map) | None,
        order[k] = first output-row index of template k, or -1 = classic)."""
        K = len(win)
        m_lo = np.array([m[2] for _, m in win])
        m_hi = np.array([m[3] for _, m in win])
        u_lo = np.array([u[2] for u, _ in win])
        u_hi = np.array([u[3] for u, _ in win])
        m_cnt = m_hi - m_lo
        u_cnt = u_hi - u_lo

        # per-template screens, vectorized over cumulative sums with
        # EXPLICIT [lo, hi) boundaries: template segments are monotone
        # within each batch but may have gaps (queued passthrough rows sit
        # between pair templates), so nothing here may assume the segments
        # tile the run
        def seg_any(values, lo, hi):
            csum = np.concatenate(([0], np.cumsum(values[lo[0]:hi[-1]])))
            return (csum[hi - lo[0]] - csum[lo - lo[0]]) > 0

        def seg_count(values, lo, hi):
            csum = np.concatenate(([0], np.cumsum(values[lo[0]:hi[-1]])))
            return csum[hi - lo[0]] - csum[lo - lo[0]]

        mflag = mb.flag.astype(np.int64)
        uflag = ub.flag.astype(np.int64)
        # secondary/supplementary mapped rows are vectorizable:
        # per-row routing below covers their mate/MQ/MC/ms/tc semantics;
        # only UNMAPPED mapped-side rows force the classic path
        bad_m = (mflag & FLAG_UNMAPPED) != 0
        bad_u = (uflag & _SEC_SUPP) != 0
        is_ss = (mflag & _SEC_SUPP) != 0
        n_ss = seg_count(is_ss, m_lo, m_hi)
        n_prim = m_cnt - n_ss
        ok = (n_prim == u_cnt) & ((n_prim == 1) | (n_prim == 2))
        ok &= ~seg_any(bad_m, m_lo, m_hi) & ~seg_any(bad_u, u_lo, u_hi)
        is_prim = ~is_ss
        m_paired = seg_count((mflag & FLAG_PAIRED) != 0, m_lo, m_hi)
        u_paired = seg_count((uflag & FLAG_PAIRED) != 0, u_lo, u_hi)
        m_first_p = seg_count(((mflag & FLAG_FIRST) != 0) & is_prim,
                              m_lo, m_hi)
        u_first = seg_count((uflag & FLAG_FIRST) != 0, u_lo, u_hi)
        # paired: both primaries present, one FIRST, and EVERY mapped row
        # (incl. sec/supp) paired so per-row FIRST/LAST routing is defined
        pair_ok = (u_paired == 2) & (m_first_p == 1) & (u_first == 1) \
            & (m_paired == m_cnt)
        frag_ok = (m_paired == 0) & (u_paired == 0)
        ok &= np.where(n_prim == 2, pair_ok, frag_ok)
        if self._has_transforms:
            ok &= ~seg_any((mflag & FLAG_REVERSE) != 0, m_lo, m_hi)

        # unmapped tag-name screen (native scan, cached per batch): any
        # reserved/static-dropped name or an overflowed scan takes the
        # per-template engine
        names, counts, row_bad = self._u_names(ub)
        ok &= ~seg_any(row_bad, u_lo, u_hi)

        order = np.full(K, -1, dtype=np.int64)
        sel = np.nonzero(ok)[0]
        if len(sel) == 0:
            return None, order
        # output rows: mapped rows of selected templates, in window order
        rows = np.concatenate([np.arange(m_lo[k], m_hi[k]) for k in sel])
        row_t = np.concatenate([np.full(m_hi[k] - m_lo[k], k) for k in sel])
        order[sel] = np.cumsum(
            np.concatenate(([0], (m_hi - m_lo)[sel[:-1]])))
        try:
            blob, pos = self._process_rows(mb, ub, rows, row_t,
                                           m_lo, m_hi, u_lo, u_hi,
                                           names, counts)
        except _FallbackBatch:
            return None, np.full(K, -1, dtype=np.int64)
        return (blob, pos, rows), order

    def _u5_of(self, mb):
        """Per-record unclipped 5' positions, cached per mapped batch."""
        cache = getattr(self, "_u5_cache", None)
        if cache is None or cache[0] is not mb:
            cache = (mb, nb.unclipped_5prime(mb))
            self._u5_cache = cache
        return cache[1]

    def _u_names(self, ub):
        cache = self._names_cache
        if cache is None or cache[0] is not ub:  # RecordBatch has __slots__
            names, counts = nb.tag_name_list(ub.buf, ub.aux_off, ub.data_end)
            col_ok = np.arange(names.shape[1]) < counts[:, None]
            row_bad = (counts < 0) \
                | (np.isin(names, self._reserved16) & col_ok).any(1)
            # zero the cells past each row's count once, so downstream
            # consumers can use the matrix without per-row slicing (a zero
            # cell matches no real tag name)
            names = np.where(col_ok, names, 0)
            cache = (ub, (names, counts, row_bad))
            self._names_cache = cache
        return cache[1]

    def _process_rows(self, mb, ub, rows, row_t, m_lo, m_hi, u_lo, u_hi,
                      u_names, u_counts):
        """The vectorized merge over selected mapped rows (see module doc)."""
        n = len(rows)
        buf = mb.buf
        do = mb.data_off[rows]
        flag = mb.flag[rows].astype(np.int64)
        paired = (flag & FLAG_PAIRED) != 0
        first = ((flag & FLAG_FIRST) != 0) | ~paired
        is_sec = (flag & FLAG_SECONDARY) != 0
        is_supp = (flag & FLAG_SUPPLEMENTARY) != 0
        ts = np.unique(row_t)
        big = np.int64(1 << 60)

        # primary FIRST/LAST rows per template (absolute ids) via
        # reduceat-min over the mapped run — the mate of every primary AND
        # supplementary row is the OPPOSITE side's primary
        # (template.rs:459-605); secondaries keep their mate fields
        m_base = int(m_lo[ts[0]])
        m_end = int(m_hi[ts[-1]])
        run = np.arange(m_base, m_end)
        rf = mb.flag[m_base:m_end].astype(np.int64)
        run_prim = (rf & _SEC_SUPP) == 0
        run_first = ((rf & FLAG_FIRST) != 0) | ((rf & FLAG_PAIRED) == 0)
        mseg = np.stack([m_lo[ts], m_hi[ts]], axis=1).ravel() - m_base
        p1_cand = np.append(np.where(run_prim & run_first, run, big), big)
        p2_cand = np.append(np.where(run_prim & ~run_first, run, big), big)
        p1_abs = np.minimum.reduceat(p1_cand, mseg)[::2]
        p2_abs = np.minimum.reduceat(p2_cand, mseg)[::2]  # big: fragment
        t_pos_m = np.searchsorted(ts, row_t)
        opp_abs = np.where(first, p2_abs[t_pos_m], p1_abs[t_pos_m])
        has_mate = (opp_abs < big) & ~is_sec
        mate = np.where(has_mate,
                        np.searchsorted(rows, np.minimum(opp_abs, big - 1)),
                        -1)

        # u primary row per output row: FIRST (or unpaired) -> u's
        # FIRST/unpaired record, else u's LAST record. Selected templates'
        # u rows form a contiguous run, but only SELECTED templates count,
        # so reduceat runs over the selected segments explicitly.
        u_base = int(u_lo[ts[0]])
        u_end = int(u_hi[ts[-1]])
        uf_run = ub.flag[u_base:u_end].astype(np.int64)
        is_first = ((uf_run & FLAG_FIRST) != 0) | ((uf_run & FLAG_PAIRED) == 0)
        idx = np.arange(u_base, u_end)
        # selected templates may be non-contiguous (classic ones interleave)
        # -> reduceat over explicit [lo, hi) boundary pairs, sentinel-padded
        # so hi == len is a valid index
        f_cand = np.append(np.where(is_first, idx, big), big)
        o_cand = np.append(np.where(~is_first, idx, big), big)
        seg = np.stack([u_lo[ts], u_hi[ts]], axis=1).ravel() - u_base
        fidx = np.minimum.reduceat(f_cand, seg)[::2]
        oidx = np.minimum.reduceat(o_cand, seg)[::2]
        oidx = np.where(oidx == big, fidx, oidx)
        u_row = np.where(first, fidx[t_pos_m], oidx[t_pos_m])

        # ---- field patches (in place on the mapped batch buffer; the
        # per-template engine recomputes identical values from the mate
        # records, so a window that later takes it is unaffected)
        mate_rows = rows[np.maximum(mate, 0)]
        mate_ref = mb.ref_id[mate_rows].astype(np.int64)
        mate_pos = mb.pos[mate_rows].astype(np.int64)
        mate_flag = mb.flag[mate_rows].astype(np.int64)
        ends = nb.ref_spans(buf, mb.cigar_off[rows], mb.n_cigar[rows],
                            mb.pos[rows])
        own_5p = np.where((flag & FLAG_REVERSE) != 0,
                          ends.astype(np.int64), mb.pos[rows] + 1)
        mate_5p = own_5p[np.maximum(mate, 0)]
        raw_t = mate_5p - own_5p
        # sign adjustment is decided from the FIRST read's perspective
        # (_insert_size: second_5p >= first_5p -> +1; R2 takes the negative)
        # so at an exact 5' tie R1 gets +1 and R2 gets -1
        adj = np.where(raw_t > 0, 1, np.where(raw_t < 0, -1,
                                              np.where(first, 1, -1)))
        tlen = raw_t + adj
        tlen = np.where(mb.ref_id[rows] == mate_ref, tlen, 0)
        tlen = np.where(has_mate, tlen, mb.tlen[rows])
        # supplementaries carry -(opposite primary's tlen) — which equals
        # the same-side primary's formula tlen (template.rs:513-605)
        tlen = np.where(is_supp & has_mate,
                        -tlen[np.maximum(mate, 0)], tlen)

        new_flag = flag.copy()
        nf = (flag & ~(FLAG_MATE_REVERSE | FLAG_MATE_UNMAPPED)) \
            | np.where((mate_flag & FLAG_REVERSE) != 0, FLAG_MATE_REVERSE, 0)
        new_flag = np.where(has_mate, nf, flag)
        u_qc = (ub.flag[u_row] & FLAG_QC_FAIL) != 0
        new_flag = np.where(u_qc, new_flag | FLAG_QC_FAIL,
                            new_flag & ~FLAG_QC_FAIL)

        def put_i32(field_off, values, mask=None):
            arr = values.astype("<i4").view(np.uint8).reshape(-1, 4)
            offs = do + field_off
            if mask is not None:
                arr, offs = arr[mask], offs[mask]
            buf[offs[:, None] + np.arange(4)] = arr

        put_i32(20, mate_ref, has_mate)
        put_i32(24, mate_pos, has_mate)
        put_i32(28, tlen, has_mate)
        buf[(do + 14)[:, None] + np.arange(2)] = \
            new_flag.astype("<u2").view(np.uint8).reshape(-1, 2)

        # ---- appends: scratch slots
        # [MQ 0:7 | ms 7:14 | AS 14:21 | XS 21:28 | tc 28:60]
        scratch = np.zeros(4 + n * 60, dtype=np.uint8)
        scratch[0:4] = np.frombuffer(b"MCZ\x00", dtype=np.uint8)
        slots = scratch[4:].reshape(n, 60)
        slots[:, 0:2] = np.frombuffer(b"MQ", np.uint8)
        slots[:, 2] = ord("i")
        slots[:, 3:7] = mb.mapq[mate_rows].astype("<i4").view(
            np.uint8).reshape(-1, 4)

        as_val, as_present = self._int_tag(mb, b"AS", rows)
        xs_val, xs_present = self._int_tag(mb, b"XS", rows)
        mate_as = as_val[np.maximum(mate, 0)]
        mate_as_present = as_present[np.maximum(mate, 0)] & has_mate
        slots[:, 7:9] = np.frombuffer(b"ms", np.uint8)
        slots[:, 9] = ord("i")
        slots[:, 10:14] = mate_as.astype("<i4").view(np.uint8).reshape(-1, 4)

        as_len = self._norm_entry(slots[:, 14:21], b"AS", as_val, as_present)
        xs_len = self._norm_entry(slots[:, 21:28], b"XS", xs_val, xs_present)

        # tc (B:i [tid1,pos1,neg1,tid2,pos2,neg2], lower coordinate first)
        # on secondary/supplementary rows (zipper.rs:281-357): values are
        # per template from the primaries' unclipped 5' coordinates
        tc_on = (is_sec | is_supp) if not self.skip_tc \
            else np.zeros(n, dtype=bool)
        if tc_on.any():
            u5 = self._u5_of(mb)
            p1t = np.minimum(p1_abs, len(u5) - 1).astype(np.int64)
            p2t = np.minimum(p2_abs, len(u5) - 1).astype(np.int64)
            have2 = p2_abs < big

            def pinfo(pt):
                return (mb.ref_id[pt].astype(np.int64), u5[pt],
                        ((mb.flag[pt] & FLAG_REVERSE) != 0).astype(np.int64))
            tid1, p51, ng1 = pinfo(p1t)
            tid2, p52, ng2 = pinfo(p2t)
            tid2 = np.where(have2, tid2, tid1)
            p52 = np.where(have2, p52, p51)
            ng2 = np.where(have2, ng2, ng1)
            swap = (tid2 < tid1) | ((tid2 == tid1) & (p52 < p51))
            vals = np.stack([np.where(swap, tid2, tid1),
                             np.where(swap, p52, p51),
                             np.where(swap, ng2, ng1),
                             np.where(swap, tid1, tid2),
                             np.where(swap, p51, p52),
                             np.where(swap, ng1, ng2)], axis=1)
            slots[:, 28:30] = np.frombuffer(b"tc", np.uint8)
            slots[:, 30] = ord("B")
            slots[:, 31] = ord("i")
            slots[:, 32:36] = np.frombuffer(
                np.array([6], dtype="<i4").tobytes(), np.uint8)
            slots[:, 36:60] = vals[t_pos_m].astype("<i4").view(
                np.uint8).reshape(-1, 24)
        tc_len = np.where(tc_on, 32, 0)

        # MC: mate cigar strings (omit when the mate has no cigar)
        cig_blob, cig_off = nb.cigar_strings(buf, mb.cigar_off[mate_rows],
                                             mb.n_cigar[mate_rows])
        mc_on = has_mate & (mb.n_cigar[mate_rows] > 0)
        mq_on = has_mate

        # unmapped aux copy spans (split around PG when the mapped row has
        # its own PG)
        u_aux0 = ub.aux_off[u_row]
        u_auxE = ub.data_end[u_row]
        m_pg_off, _, _ = mb.tag_locs(b"PG")
        has_pg = m_pg_off[rows] >= 0
        u_pg_off, u_pg_len, u_pg_typ = ub.tag_locs(b"PG")
        upg_off = u_pg_off[u_row]
        upg_present = upg_off >= 0
        z_like = (u_pg_typ[u_row] == ord("Z")) | (u_pg_typ[u_row] == ord("H"))
        upg_end = upg_off + u_pg_len[u_row] + np.where(z_like, 1, 0)
        split = has_pg & upg_present
        uA_off = u_aux0
        uA_len = np.where(split, (upg_off - 3) - u_aux0, u_auxE - u_aux0)
        uB_off = np.where(split, upg_end, 0)
        uB_len = np.where(split, u_auxE - upg_end, 0)

        # span table: 10 parts per row, sources 0=scratch 1=cig blob 2=u buf
        base = (np.arange(n, dtype=np.int64) * 60) + 4
        part_src = np.tile(np.array([0, 0, 1, 0, 0, 2, 2, 0, 0, 0],
                                    dtype=np.int32), n)
        part_off = np.stack([
            base + 0,                                   # MQ slot
            np.zeros(n, dtype=np.int64),                # "MCZ" const
            cig_off[:-1],                               # cigar string
            np.full(n, 3, dtype=np.int64),              # NUL const
            base + 7,                                   # ms slot
            uA_off, uB_off,
            base + 14, base + 21,
            base + 28], axis=1).ravel()                 # tc slot
        cig_len = (cig_off[1:] - cig_off[:-1])
        part_len = np.stack([
            np.where(mq_on, 7, 0),
            np.where(mc_on, 3, 0),
            np.where(mc_on, cig_len, 0),
            np.where(mc_on, 1, 0),
            np.where(mate_as_present, 7, 0),
            uA_len, uB_len,
            as_len, xs_len, tc_len], axis=1).ravel().astype(np.int64)
        if (part_len < 0).any():
            raise _FallbackBatch()
        appends, app_all = nb.concat_spans(
            [scratch, cig_blob, ub.buf], part_src, part_off, part_len)
        app_off = app_all[::10]

        # ---- drop lists: fixed-width per-record matrices (a zero cell
        # matches no real tag name, so unused slots need no compaction):
        # static + [MQ MC ms when mated] + [AS/XS when normalized] +
        # unmapped tag names (minus the skipped PG)
        ns = len(self._static_drop16)
        max_u = u_names.shape[1]
        width = ns + 6 + max_u
        dmat = np.zeros((n, width), dtype=np.uint16)
        if ns:
            dmat[:, :ns] = self._static_drop16
        dmat[:, ns + 0] = np.where(mq_on, _tag16(b"MQ"), 0)
        dmat[:, ns + 1] = np.where(has_mate, _tag16(b"MC"), 0)
        # ms is REPLACED only when the mate has an AS tag — classic keeps a
        # stale ms otherwise (fix_mate_info only calls set_i32 under p_as)
        dmat[:, ns + 2] = np.where(mate_as_present, _tag16(b"ms"), 0)
        dmat[:, ns + 3] = np.where(as_len > 0, _tag16(b"AS"), 0)
        dmat[:, ns + 4] = np.where(xs_len > 0, _tag16(b"XS"), 0)
        dmat[:, ns + 5] = np.where(tc_len > 0, _tag16(b"tc"), 0)
        ublock = u_names[u_row]  # (n, max_u), already zero-padded past count
        ublock = np.where(split[:, None] & (ublock == _PG16), 0, ublock)
        dmat[:, ns + 6:] = ublock
        drop = dmat.ravel()
        drop_off = np.arange(n + 1, dtype=np.int64) * width

        got = nb.rebuild_aux_records(buf, do, mb.aux_off[rows],
                                     mb.data_end[rows], drop, drop_off,
                                     appends, app_off)
        if got is None:
            raise _FallbackBatch()
        return got

    @staticmethod
    def _int_tag(batch, tag, rows):
        """(values int64, present bool) for an integer-typed tag."""
        vo, vl, vt = batch.tag_locs(tag)
        vo, vt = vo[rows], vt[rows]
        present = vo >= 0
        vals = np.zeros(len(rows), dtype=np.int64)
        buf = batch.buf
        for t, dt in ((ord("c"), "<i1"), (ord("C"), "<u1"),
                      (ord("s"), "<i2"), (ord("S"), "<u2"),
                      (ord("i"), "<i4"), (ord("I"), "<u4")):
            m = present & (vt == t)
            if m.any():
                w = np.dtype(dt).itemsize
                raw = buf[vo[m][:, None] + np.arange(w)]
                vals[m] = raw.reshape(-1, w).copy().view(dt).ravel()
        present &= np.isin(vt, np.frombuffer(b"cCsSiI", np.uint8))
        return vals, present

    @staticmethod
    def _norm_entry(slot, tag, values, present):
        """Write smallest-signed-int entries into 7-byte slots; returns
        per-row entry lengths (0 when absent or out of i32 range)."""
        n = len(values)
        lens = np.zeros(n, dtype=np.int64)
        in_range = present & (values >= -(2 ** 31)) & (values < 2 ** 31)
        small = in_range & (values >= -128) & (values <= 127)
        mid = in_range & ~small & (values >= -32768) & (values <= 32767)
        big = in_range & ~small & ~mid
        slot[:, 0:2] = np.frombuffer(tag, np.uint8)
        slot[small, 2] = ord("c")
        slot[small, 3] = values[small].astype("<i1").view(np.uint8)
        lens[small] = 4
        slot[mid, 2] = ord("s")
        slot[mid, 3:5] = values[mid].astype("<i2").view(np.uint8).reshape(-1, 2)
        lens[mid] = 5
        slot[big, 2] = ord("i")
        slot[big, 3:7] = values[big].astype("<i4").view(np.uint8).reshape(-1, 4)
        lens[big] = 7
        return lens


_PG16 = ord("P") | (ord("G") << 8)


class _FallbackBatch(Exception):
    """Raised when a vectorized window must re-run on the per-template
    engine (a malformed record, as the reference routes it)."""


def run_zipper_fast(mapped_reader, unmapped_reader, writer, tag_info, *,
                    skip_tc_tags=False, exclude_missing_reads=False):
    """Drop-in replacement for zipper.run_zipper over BamBatchReaders."""
    fz = FastZipper(tag_info, writer, skip_tc_tags)
    m_it = iter_templates(mapped_reader)
    u_it = iter_templates(unmapped_reader)
    m = next(m_it, None)
    n_missing = 0
    for u in u_it:
        if m is None or m[0] != u[0]:
            n_missing += 1
            if not exclude_missing_reads:
                fz.passthrough(u)
            continue
        fz.pair(u, m)
        m = next(m_it, None)
    fz.finish()
    if m is not None:
        raise ValueError(
            f"read '{m[0].decode(errors='replace')}' present in the mapped "
            "BAM but not in the unmapped BAM; inputs must share queryname "
            "ordering")
    return fz.n_templates, fz.n_records, n_missing
