"""Vectorized CODEC engine over RecordBatch inputs (the batch engine).

Replaces CodecConsensusCaller.prepare()'s record-level work (phases 1-5 of
codec_caller.rs:589-836) with batch arrays for the dominant CODEC shape —
every paired primary a single-op M CIGAR — where clip amounts, adjusted
positions, overlap geometry, and the phase checks are closed-form
arithmetic and the SourceRead conversion is one native pack. Molecules with
any other CIGAR shape run the classic prepare() unchanged, in stream order
(sharing the caller's stats and downsample RNG stream).

Stage 2 is one single-strand consensus dispatch a batch
(``ops/kernel.route_and_call_segments``: K1, or the packed2 route), the
strand placement as whole-batch gathers, the duplex combine as K6
(``ops/kernel.codec_combine_device``) on the kernel's device — the card on
``cuda``, the plain PyTorch version on CPU tensors on ``cpu`` — the quality
masks, and one native serialization (``build_codec_records``). The records
equal the classic caller's (``codec --classic``) byte for byte.
"""

import struct
import time

import numpy as np

from ..constants import (CODE_TO_BASE, N_CODE, NO_CALL_BASE,
                         NO_CALL_BASE_LOWER)
from ..io.bam import (FLAG_FIRST, FLAG_MATE_REVERSE, FLAG_MATE_UNMAPPED,
                      FLAG_PAIRED, FLAG_REVERSE, FLAG_SECONDARY,
                      FLAG_SUPPLEMENTARY, FLAG_UNMAPPED)
from ..native import batch as nb
from .codec import _ASCII_COMPLEMENT, _SS


class FastCodecCaller:
    """Batch CODEC engine wrapping a CodecConsensusCaller."""

    def __init__(self, caller, tag: bytes = b"MI"):
        self.caller = caller
        self.tag = tag
        self._carry = None  # (mi string, [RawRecord])
        # seconds in the duplex combine (K6: upload, combine, fetch), the
        # positions it combined and the most one call combined
        self.combine_s = 0.0
        self.combine_positions = 0
        self.combine_largest = 0

    # ---------------------------------------------------------------- batches

    def process_batch(self, batch, final: bool = False):
        """Consume one RecordBatch -> serialized consensus blobs.

        Each returned chunk carries its records' block_size prefixes
        (BamWriter.write_serialized framing)."""
        n = batch.n
        if n == 0:
            return self.flush() if final else []
        buf = batch.buf
        # Z/H-typed presence gate matches the classic get_str-based grouping
        mi_off, mi_len, _ = batch.tag_locs_str(self.tag)
        if (mi_off < 0).any():
            bad = int(np.nonzero(mi_off < 0)[0][0])
            raise ValueError(
                f"record {batch.name(bad)!r} missing {self.tag.decode()} tag")
        starts = nb.group_starts(buf, np.ascontiguousarray(mi_off),
                                 mi_len)
        bounds = np.append(starts, n)
        n_total = len(bounds) - 1

        first_mi = batch.tag_bytes(self.tag, int(bounds[0])).decode()
        merge_carry = self._carry is not None and self._carry[0] == first_mi
        if merge_carry:
            self._carry[1].extend(
                batch.raw_records(np.arange(bounds[0], bounds[1])))

        g0 = 1 if merge_carry else 0
        g1 = n_total if final else max(n_total - 1, g0)
        deferred = None
        if not final and n_total - 1 >= g0:
            lo, hi = bounds[n_total - 1], bounds[n_total]
            deferred = (batch.tag_bytes(self.tag, int(lo)).decode(),
                        batch.raw_records(np.arange(lo, hi)))

        molecules = []
        if self._carry is not None:
            if (not merge_carry) or final or n_total >= 2:
                mi, recs = self._carry
                self._carry = None
                mol = self.caller.prepare(recs, umi=mi)
                if mol is not None:
                    molecules.append(mol)

        codes_pk = quals_pk = None
        if g1 > g0:
            span_mols, codes_pk, quals_pk = self._prepare_span(batch, bounds,
                                                               g0, g1)
            molecules.extend(span_mols)

        if deferred is not None:
            self._carry = deferred

        out = self._run(molecules, codes_pk, quals_pk)
        if final:
            out.extend(self.flush())
        return out

    def flush(self):
        if self._carry is None:
            return []
        mi, recs = self._carry
        self._carry = None
        mol = self.caller.prepare(recs, umi=mi)
        return self._run([mol] if mol is not None else [])

    def _run(self, molecules, codes_pk=None, quals_pk=None):
        """One SS device pass + batched finish.

        Vec-prepared molecules (strand rows resident in the pack arrays)
        land in the dense layout via ONE gather from codes_pk/quals_pk —
        the same pad_segments/device_call_segments/thresholds sequence as
        VanillaConsensusCaller._run_jobs, minus the per-read row repack.
        Classic-prepared molecules (carry/fallback ConsensusJobs) repack
        their few rows into the same layout, so every batch costs exactly
        one device execution.
        """
        from ..ops import oracle

        caller = self.caller
        ss = caller.ss
        if not molecules:
            return []
        strand_res = {}  # (mol_idx, strand) -> (bases, quals, depths, errs)

        vec_multi = []       # (mol_idx, strand, base_row, count, cl)
        classic_multi = []   # (mol_idx, strand, job)
        for i, m in enumerate(molecules):
            if "job_r1" in m:
                # carry/fallback molecules: the same dispatch, rows repacked
                # below (a separate _run_jobs call would cost a second
                # device execution on essentially every streamed batch)
                for s, job in enumerate((m["job_r1"], m["job_r2"])):
                    cl = job.consensus_len
                    if len(job.codes) == 1:
                        strand_res[(i, s)] = oracle.single_read_consensus(
                            job.codes[0][:cl], job.quals[0][:cl], ss.tables,
                            ss.options.min_consensus_base_quality)
                    else:
                        classic_multi.append((i, s, job))
                continue
            base = m["pk0"]
            for s, (b0, cnt, flens) in enumerate(
                    ((base, m["n_r1"], m["r1_flens"]),
                     (base + m["n_r1"], m["n_r2"], m["r2_flens"]))):
                cl = int(flens.max())
                if cnt == 1:
                    strand_res[(i, s)] = oracle.single_read_consensus(
                        codes_pk[b0, :cl], quals_pk[b0, :cl], ss.tables,
                        ss.options.min_consensus_base_quality)
                else:
                    vec_multi.append((i, s, b0, cnt, cl))

        if vec_multi or classic_multi:
            cls = [(i, s, job.consensus_len, job)
                   for i, s, job in classic_multi]
            all_cl = [v[4] for v in vec_multi] + [c[2] for c in cls]
            L_max = max(-(-max(all_cl) // 16) * 16, 16)
            counts = np.array([v[3] for v in vec_multi]
                              + [len(c[3].codes) for c in cls],
                              dtype=np.int64)
            n_vec_rows = int(sum(v[3] for v in vec_multi))
            N = int(counts.sum())
            codes2d = np.full((N, L_max), N_CODE, dtype=np.uint8)
            quals2d = np.zeros((N, L_max), dtype=np.uint8)
            if vec_multi:
                rows_idx = np.concatenate(
                    [np.arange(b0, b0 + cnt)
                     for _, _, b0, cnt, _ in vec_multi])
                # pack rows are N/Q0-padded past each read's final length,
                # so a single fancy-index gather IS the dense job layout.
                # A carry molecule's longer reads can push L_max past the
                # span's pack stride; vec flens never exceed the stride, so
                # clamping the gather width keeps the tail at N/Q0.
                wv = min(L_max, codes_pk.shape[1])
                codes2d[:n_vec_rows, :wv] = codes_pk[rows_idx, :wv]
                quals2d[:n_vec_rows, :wv] = quals_pk[rows_idx, :wv]
            row = n_vec_rows
            for _, _, _, job in cls:
                for c, q in zip(job.codes, job.quals):
                    k = min(len(c), L_max)
                    codes2d[row, :k] = c[:k]
                    quals2d[row, :k] = q[:k]
                    row += 1
            # one full-column dispatch on the kernel's device
            from ..ops.kernel import route_and_call_segments

            starts = np.concatenate(([0], np.cumsum(counts)))
            w, q_, d, e = route_and_call_segments(ss.kernel, codes2d,
                                                  quals2d, counts, starts)
            slots = [(v[0], v[1], v[4]) for v in vec_multi] \
                + [(c[0], c[1], c[2]) for c in cls]
            # thresholds are elementwise: one vectorized pass over the whole
            # (F, L) batch, then per-slot length slicing (positions past a
            # slot's consensus length are computed and discarded)
            b_all, q_all = oracle.apply_consensus_thresholds(
                w, q_, d, ss.options.min_reads,
                ss.options.min_consensus_base_quality)
            for fi, (i, s, cl) in enumerate(slots):
                strand_res[(i, s)] = ("slot", fi, cl)
            slot_mats = (b_all, q_all, d, e)
        else:
            slot_mats = None
        return self._finish_batch(molecules, strand_res, slot_mats)

    @staticmethod
    def _strand_len(entry) -> int:
        # slot refs are ("slot", row, len) 3-tuples; materialized strands
        # are (bases, quals, depths, errors) 4-tuples of arrays
        return entry[2] if len(entry) == 3 else len(entry[0])

    def _finish_batch(self, molecules, strand_res, slot_mats):
        """Batched `_finish` (codec.py:527-568): strand geometry lands in
        concatenated position arrays, the duplex combine + quality-mask math
        of codec.py:360-456 runs once over all molecules (each molecule's
        slice is element-identical to the per-molecule version), and records
        serialize per molecule. Stats totals match the sequential path.

        Strand results arrive either as ("slot", row, len) references into
        the batch (F, L) result matrices (the common case — the whole
        orient/pad placement runs as ONE gather+scatter instead of 2 numpy
        calls per molecule) or as materialized arrays (single-read and
        classic-carry strands), placed scalarly."""
        from .vanilla import I16_MAX

        caller = self.caller
        st, opts = caller.stats, caller.options
        keep = []
        for i, mol in enumerate(molecules):
            en1, en2 = strand_res[(i, 0)], strand_res[(i, 1)]
            L = mol["consensus_length"]
            if L < self._strand_len(en1) or L < self._strand_len(en2):
                st.reject("ClipOverlapFailed", mol["n_r1"] + mol["n_r2"])
                continue
            keep.append((mol, en1, en2))
        if not keep:
            return []
        J = len(keep)
        # ONE pass over the kept molecules collects every per-molecule
        # scalar the batched placement/serialization needs (this loop ran
        # five times before: lengths, two placement passes, rc flags,
        # rejects)
        Ls = np.empty(J, dtype=np.int64)
        r1n = np.empty(J, dtype=bool)
        r2n = np.empty(J, dtype=bool)
        slot_j = ([], [])
        slot_row = ([], [])
        slot_k = ([], [])
        arr_items = []  # (side, j, en) — materialized strands, placed scalarly
        for j, (mol, en1, en2) in enumerate(keep):
            Ls[j] = mol["consensus_length"]
            r1n[j] = mol["r1_is_negative"]
            r2n[j] = mol["r2_is_negative"]
            for side, en in ((0, en1), (1, en2)):
                if len(en) == 3:
                    slot_j[side].append(j)
                    slot_row[side].append(en[1])
                    slot_k[side].append(en[2])
                else:
                    arr_items.append((side, j, en))
        offs = np.zeros(J + 1, dtype=np.int64)
        np.cumsum(Ls, out=offs[1:])
        T = int(offs[-1])

        # oriented + padded strands (pad = lowercase n / Q0 / depth 0)
        b1 = np.full(T, NO_CALL_BASE_LOWER, np.uint8)
        b2 = np.full(T, NO_CALL_BASE_LOWER, np.uint8)
        q1 = np.zeros(T, np.uint8)
        q2 = np.zeros(T, np.uint8)
        # int32: every value here is pre-capped at I16_MAX, and the combine's
        # sums stay well under 2^31 — int64 was pure memory traffic
        d1 = np.zeros(T, np.int32)
        d2 = np.zeros(T, np.int32)
        e1 = np.zeros(T, np.int32)
        e2 = np.zeros(T, np.int32)

        def place_arr(bases_c, quals, dep, err, rc, pad_left, o, L,
                      b, q, d, e):
            bases = CODE_TO_BASE[np.minimum(bases_c, N_CODE)]
            k = len(bases)
            sl = slice(o + L - k, o + L) if pad_left else slice(o, o + k)
            if rc:
                b[sl] = _ASCII_COMPLEMENT[bases[::-1]]
                q[sl] = quals[::-1]
                d[sl] = np.minimum(dep[::-1], I16_MAX)
                e[sl] = np.minimum(err[::-1], I16_MAX)
            else:
                b[sl] = bases
                q[sl] = quals
                d[sl] = np.minimum(dep, I16_MAX)
                e[sl] = np.minimum(err, I16_MAX)

        def place_side(side, bt, qt, dt, et):
            """One side's placement: slot-backed strands in one vectorized
            gather+scatter; array-backed strands scalarly (collected by the
            single pass above)."""
            for aside, j, en in arr_items:
                if aside != side:
                    continue
                rc = r1n[j] if side == 0 else not r1n[j]
                pl = r1n[j] if side == 0 else r2n[j]
                place_arr(en[0], en[1], en[2], en[3], bool(rc), bool(pl),
                          int(offs[j]), int(Ls[j]), bt, qt, dt, et)
            if not slot_j[side]:
                return
            b_all, q_all, dmat, emat = slot_mats
            jarr = np.asarray(slot_j[side], np.int64)
            rows = np.asarray(slot_row[side], np.int64)
            ks = np.asarray(slot_k[side], np.int64)
            os_ = offs[jarr]
            rcs = r1n[jarr] if side == 0 else ~r1n[jarr]
            pls = r1n[jarr] if side == 0 else r2n[jarr]
            base = os_ + np.where(pls, Ls[jarr] - ks, 0)
            n_obs = int(ks.sum())
            within = np.arange(n_obs, dtype=np.int64) \
                - np.repeat(np.concatenate(([0], np.cumsum(ks)[:-1]))
                            if len(ks) else np.zeros(0, np.int64), ks)
            tgt = np.repeat(base, ks) + within
            rc_rep = np.repeat(rcs, ks)
            src_col = np.where(rc_rep, np.repeat(ks, ks) - 1 - within,
                               within)
            src_row = np.repeat(rows, ks)
            bb = CODE_TO_BASE[np.minimum(b_all[src_row, src_col], N_CODE)]
            bt[tgt] = np.where(rc_rep, _ASCII_COMPLEMENT[bb], bb)
            qt[tgt] = q_all[src_row, src_col]
            dt[tgt] = np.minimum(dmat[src_row, src_col], I16_MAX)
            et[tgt] = np.minimum(emat[src_row, src_col], I16_MAX)

        place_side(0, b1, q1, d1, e1)
        place_side(1, b2, q2, d2, e2)

        # ---- duplex combine, one pass over the concatenated strands: K6
        # on the kernel's device, byte-identical to the classic
        # combine_arrays (FGUMI_TPU_CODEC_COMBINE: unset or ``device`` K6,
        # ``host`` the numpy combine, ``auto`` the router's chooser; the
        # host route of FGUMI_TPU_ROUTE=host keeps the card idle)
        from ..ops.kernel import codec_combine_device
        from ..ops.router import (CODEC_COMBINE, combine_override,
                                  run_adaptive_stage)
        from .codec import combine_arrays

        kernel = caller.ss.kernel
        override = combine_override("CODEC_COMBINE")
        t0 = time.monotonic()
        if T > 0 and override != "host" and not kernel.host_mode():
            res, side = run_adaptive_stage(
                CODEC_COMBINE, T, override,
                lambda: codec_combine_device(kernel.device, b1, b2, q1, q2,
                                             d1, d2, e1, e2),
                lambda: combine_arrays(b1, b2, q1, q2, d1, d2, e1, e2))
        else:
            res, side = combine_arrays(b1, b2, q1, q2, d1, d2, e1,
                                       e2), "host"
        dt = time.monotonic() - t0
        self.combine_s += dt
        self.combine_positions += T
        self.combine_largest = max(self.combine_largest, T)
        if kernel.device.type == "cuda" and side == "device":
            kernel.add_device_s(dt)
        cb, cq, cd, ce, both, disag = res

        # per-molecule disagreement thresholds (recoverable rejects)
        def seg_sum(x):
            cs = np.zeros(T + 1, np.int64)
            np.cumsum(x, out=cs[1:])
            return cs[offs[1:]] - cs[offs[:-1]]

        duplex_bases = seg_sum(both)
        disagreements = seg_sum(disag)
        st.consensus_duplex_bases_emitted += int(duplex_bases.sum())
        st.duplex_disagreement_base_count += int(disagreements.sum())
        nz = duplex_bases > 0
        bad = np.zeros(J, dtype=bool)
        if opts.max_duplex_disagreements is not None:
            bad |= nz & (disagreements > opts.max_duplex_disagreements)
        rate = np.divide(disagreements.astype(np.float64), duplex_bases,
                         out=np.zeros(J, np.float64), where=nz)
        bad |= nz & (rate > opts.max_duplex_disagreement_rate)

        # ---- quality masks (codec.py _mask_quals: outer bands, then SS)
        if (opts.outer_bases_length > 0
                and opts.outer_bases_qual is not None) \
                or opts.single_strand_qual is not None:
            if opts.outer_bases_length > 0 \
                    and opts.outer_bases_qual is not None:
                pos = np.arange(T, dtype=np.int64) \
                    - np.repeat(offs[:-1], Ls)
                l_rep = np.repeat(Ls, Ls)
                n_rep = np.minimum(opts.outer_bases_length, l_rep)
                cq[(pos < n_rep) | (pos >= l_rep - n_rep)] = \
                    opts.outer_bases_qual
            if opts.single_strand_qual is not None:
                is_n = lambda x: ((x == NO_CALL_BASE)
                                  | (x == NO_CALL_BASE_LOWER))
                cq[is_n(b1) | is_n(b2)] = opts.single_strand_qual

        # ---- record serialization
        good = []
        for j, (mol, _, _) in enumerate(keep):
            if bad[j]:
                st.reject("HighDuplexDisagreement",
                          mol["n_r1"] + mol["n_r2"])
                st.consensus_reads_rejected_hdd += 1
            else:
                good.append(j)
        if not good:
            return []

        if opts.cell_tag is not None:
            # rare option: the cell tag needs per-record raw scans, so build
            # through the classic RecordBuilder path
            out = []
            for j in good:
                mol = keep[j][0]
                sl = slice(int(offs[j]), int(offs[j] + Ls[j]))
                rc = mol["r1_is_negative"]

                def ss_of(b, q, d, e, count):
                    if rc:
                        return _SS(_ASCII_COMPLEMENT[b[sl][::-1]],
                                   q[sl][::-1], d[sl][::-1], e[sl][::-1],
                                   count)
                    return _SS(b[sl], q[sl], d[sl], e[sl], count)

                rec = caller._build_record(
                    ss_of(cb, cq, cd, ce, mol["n_r1"] + mol["n_r2"]),
                    ss_of(b1, q1, d1, e1, mol["n_r1"]),
                    ss_of(b2, q2, d2, e2, mol["n_r2"]),
                    mol["umi"], mol["source_raws"], mol["records"],
                    rx_umis=mol.get("rx_umis"))
                out.append(struct.pack("<I", len(rec)) + rec)
            return out

        return self._serialize_native(keep, good, offs, Ls, r1n, cb, cq,
                                      np.ascontiguousarray(ce,
                                                           dtype=np.int64),
                                      b1, q1, d1, e1, b2, q2, d2, e2)

    def _serialize_native(self, keep, good, offs, Ls, r1n, cb, cq, ce,
                          b1, q1, d1, e1, b2, q2, d2, e2):
        """One native serialization pass (codec.py _build_record byte-exact).

        The final reverse-complement for r1-negative molecules is a single
        vectorized gather (consensus errors stay unreversed: they only feed
        the cE sum and have no per-base tag); names/MI/RX pack into one blob
        and all rows pass to C as raw addresses.
        """
        from .simple_umi import consensus_umis_batch

        caller = self.caller
        st, opts = caller.stats, caller.options
        T = int(offs[-1])
        pos = np.arange(T, dtype=np.int64) - np.repeat(offs[:-1], Ls)
        rc_rep = np.repeat(r1n, Ls)
        src = np.where(rc_rep,
                       np.repeat(offs[:-1] + Ls - 1, Ls) - pos,
                       np.arange(T, dtype=np.int64))

        def gath(a, comp=False, dtype=None):
            # dtype=int64 where the native builder reads 8-byte elements
            # (the combine math upstream runs in int32; widening costs a
            # second copy of the gathered temp, cheap next to the combine)
            g = np.ascontiguousarray(a[src], dtype=dtype)
            if comp:
                g[rc_rep] = _ASCII_COMPLEMENT[g[rc_rep]]
            return g

        seq = gath(cb, comp=True)
        qual = gath(cq)
        a_b = gath(b1, comp=True)
        a_q = gath(q1)
        a_d = gath(d1, dtype=np.int64)
        a_e = gath(e1, dtype=np.int64)
        b_b = gath(b2, comp=True)
        b_q = gath(q2)
        b_d = gath(d2, dtype=np.int64)
        b_e = gath(e2, dtype=np.int64)

        # RX consensus per molecule, all non-trivial families in one pass
        fams = []
        for j in good:
            mol = keep[j][0]
            ru = mol.get("rx_umis")
            if ru is None:  # classic-prepared molecule: scan its records
                ru = [u for u in (r.get_str(b"RX") for r in mol["records"])
                      if u]
            fams.append(ru)
        nonempty = [i for i, f in enumerate(fams) if f]
        consensi = consensus_umis_batch([fams[i] for i in nonempty]) \
            if nonempty else []
        rx_strs = [None] * len(fams)
        for i, cu in zip(nonempty, consensi):
            if cu:
                rx_strs[i] = cu.encode()

        # names / MI / RX share one blob; addresses point into it
        G = len(good)
        blob = bytearray()
        name_off = np.empty(G, np.int64)
        name_len = np.empty(G, np.int32)
        mi_off = np.zeros(G, np.int64)
        mi_len = np.full(G, -1, np.int32)
        rx_off = np.zeros(G, np.int64)
        rx_len = np.zeros(G, np.int32)
        prefix = caller.prefix
        for k, j in enumerate(good):
            umi = keep[j][0]["umi"]
            caller._counter += 1
            name = (f"{prefix}:{umi}" if umi
                    else f"{prefix}:{caller._counter}").encode()
            name_off[k] = len(blob)
            name_len[k] = len(name)
            blob.extend(name)
            if umi:
                mi = umi.encode()
                mi_off[k] = len(blob)
                mi_len[k] = len(mi)
                blob.extend(mi)
            if rx_strs[k] is not None:
                rx_off[k] = len(blob)
                rx_len[k] = len(rx_strs[k])
                blob.extend(rx_strs[k])
        blob_arr = np.frombuffer(bytes(blob), dtype=np.uint8)
        base = blob_arr.ctypes.data if len(blob_arr) else 0

        gi = np.asarray(good, dtype=np.int64)
        og = offs[:-1][gi]
        wire, rec_end = nb.build_codec_records(
            seq.ctypes.data + og, qual.ctypes.data + og,
            ce.ctypes.data + 8 * og,
            a_b.ctypes.data + og, a_q.ctypes.data + og,
            a_d.ctypes.data + 8 * og, a_e.ctypes.data + 8 * og,
            b_b.ctypes.data + og, b_q.ctypes.data + og,
            b_d.ctypes.data + 8 * og, b_e.ctypes.data + 8 * og,
            Ls[gi], base + name_off, name_len,
            np.where(mi_len >= 0, base + mi_off, 0), mi_len,
            np.where(rx_len > 0, base + rx_off, 0), rx_len,
            caller.read_group_id.encode(), FLAG_UNMAPPED,
            opts.produce_per_base_tags)
        st.consensus_reads_generated += G
        return [wire]  # records carry their block_size prefixes

    # ---------------------------------------------------------------- prepare

    def _prepare_span(self, batch, bounds, g0, g1):
        """Vectorized prepare for complete groups [g0, g1); shape-ineligible
        molecules run the classic prepare in stream order."""
        caller = self.caller
        buf = batch.buf
        lo, hi = int(bounds[g0]), int(bounds[g1])
        span = np.arange(lo, hi)
        flag = batch.flag
        l_seq = batch.l_seq

        # single-op all-M CIGAR covering the whole read
        co = batch.cigar_off
        v = np.zeros(len(span), dtype=np.uint32)
        for j in range(4):
            v |= buf[co[span] + j].astype(np.uint32) << (8 * j)
        m_only = ((batch.n_cigar[span] == 1) & ((v & 0xF) == 0)
                  & ((v >> 4) == l_seq[span]) & (l_seq[span] > 0))
        fl = flag[span]
        paired_primary = ((fl & FLAG_PAIRED) != 0) \
            & ((fl & (FLAG_SECONDARY | FLAG_SUPPLEMENTARY)) == 0)
        row_ok = m_only | ~paired_primary
        g_of_row = np.repeat(np.arange(g1 - g0),
                             np.diff(bounds[g0:g1 + 1]))
        grp_ok = np.ones(g1 - g0, dtype=bool)
        np.logical_and.at(grp_ok, g_of_row, row_ok)

        # phases 1-2 (primary-pair formation by name + clip closed forms)
        # run once over the whole eligible span, then phases 3-4 (overlap
        # geometry + verdicts) as one array pass (_geometry_vec);
        # hash-collision groups fall back to the per-molecule python
        # pairing, downsampled groups to the per-molecule geometry
        pair_of_group, py_groups, geom = self._pair_span(
            batch, span, g_of_row, grp_ok, fl, paired_primary)

        # bulk pack layout of the geometry-ok groups occupies [0, pk_base);
        # per-molecule fallbacks append after it
        st = caller.stats
        nG = g1 - g0
        loc = np.full(nG, -1, dtype=np.int64)
        if geom is not None:
            loc[geom["gid"]] = np.arange(len(geom["gid"]))
        pk_base = len(geom["pack0"]) if geom is not None else 0

        mols = []
        pack_rows = []     # per-molecule fallback rows, after the bulk block
        pack_clips = []
        pending = []       # (kind, payload) preserving stream order
        for g in range(g0, g1):
            rows = np.arange(int(bounds[g]), int(bounds[g + 1]))
            mi = batch.tag_bytes(self.tag, int(rows[0])).decode()
            if not grp_ok[g - g0]:
                # classic prepare runs HERE, in stream order — the shared
                # downsample RNG stream must see molecules in input order
                mol = caller.prepare(batch.raw_records(rows), umi=mi)
                pending.append(("mol", mol) if mol is not None
                               else ("none", None))
                continue
            if (g - g0) in py_groups:
                prep = self._prepare_molecule_vec(batch, rows, mi, pack_rows,
                                                  pack_clips, pk_base)
            else:
                k = int(loc[g - g0])
                if k < 0:
                    prep = None  # no surviving FR pair in this group
                elif geom["small"][k]:
                    st.reject("InsufficientReads", 2 * int(geom["n_g"][k]))
                    prep = None
                elif geom["downs"][k]:
                    # downsample consumes the shared RNG stream — the
                    # per-molecule reference path runs, in stream order
                    prep = self._finish_molecule_vec(
                        rows, mi, pair_of_group.get(g - g0), pack_rows,
                        pack_clips, pk_base)
                elif geom["short"][k]:
                    st.reject("InsufficientOverlap", 2 * int(geom["n_g"][k]))
                    prep = None
                elif geom["indel"][k]:
                    st.reject("IndelErrorBetweenStrands",
                              2 * int(geom["n_g"][k]))
                    prep = None
                else:
                    s_, e_ = int(geom["starts"][k]), int(geom["ends"][k])
                    prep = {
                        "mi": mi, "rows": rows,
                        "pk0": int(geom["pk0_seg"][k]),
                        "r1_rows": geom["r1"][s_:e_],
                        "r2_rows": geom["r2"][s_:e_],
                        "r1_flens": geom["flen1"][s_:e_],
                        "r2_flens": geom["flen2"][s_:e_],
                        "r1_neg": bool(geom["r1_neg"][k]),
                        "r2_neg": bool(geom["r2_neg"][k]),
                        "consensus_length":
                            int(geom["consensus_length"][k]),
                    }
            pending.append(("vec", prep) if prep is not None
                           else ("none", None))

        codes_pk = quals_pk = None
        if pk_base or pack_rows:
            parts_r = []
            parts_c = []
            if pk_base:
                parts_r.append(geom["pack0"])
                parts_c.append(geom["clips0"])
            if pack_rows:
                parts_r.append(np.asarray(pack_rows, dtype=np.int64))
                parts_c.append(np.asarray(pack_clips, dtype=np.int64))
            rows_arr = np.concatenate(parts_r)
            clips_arr = np.concatenate(parts_c)
            stride = max(-(-int(l_seq[rows_arr].max()) // 32) * 32, 32)
            rev = ((flag[rows_arr] & FLAG_REVERSE) != 0).astype(np.uint8)
            codes_pk, quals_pk, _ = nb.pack_reads(
                buf, np.ascontiguousarray(batch.seq_off[rows_arr]),
                np.ascontiguousarray(batch.qual_off[rows_arr]),
                l_seq[rows_arr], rev,
                clips_arr.astype(np.int32), 0, stride, mode=3)

        for item in pending:
            if item[0] == "mol":
                mols.append(item[1])
            elif item[0] == "vec":
                mols.append(self._finalize_vec(batch, item[1]))
        return [m for m in mols if m is not None], codes_pk, quals_pk

    def _pair_span(self, batch, span, g_of_row, grp_ok, fl_span, pp_span):
        """Phases 1-2 for every eligible group in one pass: primary FR
        pairing by read name (FNV hash buckets, byte-verified) plus the
        clip/adjusted-position closed forms, all as span-wide array math.
        fl_span / pp_span are the caller's per-span flag values and
        paired-primary mask (shared, not recomputed).

        Returns ({local_g: per-pair arrays}, {local_g needing the python
        pairing}). The second set holds groups where two distinct names
        share a hash (byte-verify failed) — their stats are untouched here
        so the per-molecule path recounts them exactly.
        """
        st = self.caller.stats
        flag = batch.flag
        l_seq = batch.l_seq
        pos = batch.pos
        buf = batch.buf
        elig = grp_ok[g_of_row]
        rows = span[elig]
        g_of = g_of_row[elig]
        if len(rows) == 0:
            return {}, set(), None

        paired = (fl_span[elig] & FLAG_PAIRED) != 0
        ppm = pp_span[elig]
        pr = rows[ppm]
        pg = g_of[ppm]

        # name buckets within each group (classic by_name first-appearance
        # dict, fast_codec _prepare_molecule_vec phase 2)
        noff = (batch.data_off[pr] + 32).astype(np.int64)
        nlen = batch.l_read_name[pr].astype(np.int32) - 1
        h = nb.hash_ranges(buf, noff, nlen)
        order = np.lexsort((np.arange(len(pr)), h, pg))
        sp, sg, sh = pr[order], pg[order], h[order]
        so, sno, snl = order, noff[order], nlen[order]
        new_b = np.ones(len(sp), dtype=bool)
        if len(sp) > 1:
            new_b[1:] = (sg[1:] != sg[:-1]) | (sh[1:] != sh[:-1])
        b_start = np.nonzero(new_b)[0]
        b_size = np.diff(np.append(b_start, len(sp)))
        # collision guard: every bucket member must byte-match its head
        head = np.repeat(b_start, b_size)
        same = nb.ranges_equal(buf, sno, snl, sno[head], snl[head])
        py_groups = set(int(g) for g in np.unique(sg[same == 0]))

        ok_mask = np.ones(len(b_start), dtype=bool)
        if py_groups:
            bg_all = sg[b_start]
            ok_mask = ~np.isin(bg_all, np.fromiter(py_groups, dtype=sg.dtype,
                                                   count=len(py_groups)))
        # stats for the groups resolved here (python-fallback groups excluded)
        if py_groups:
            keep_rows = ~np.isin(g_of, np.fromiter(py_groups, dtype=g_of.dtype,
                                                   count=len(py_groups)))
            st.total_input_reads += int(keep_rows.sum())
            frag = int((~paired[keep_rows]).sum())
        else:
            st.total_input_reads += len(rows)
            frag = int((~paired).sum())
        if frag:
            st.reject("FragmentRead", frag)

        two = ok_mask & (b_size == 2)
        odd_total = int(b_size[ok_mask & ~two].sum())

        ia = sp[b_start[two]]
        ib = sp[b_start[two] + 1]
        bg = sg[b_start[two]]
        first_orig = so[b_start[two]]  # classic bucket order: name appearance

        # is_primary_fr_pair, vectorized (overlap.py:96-156 for all-M rows)
        fa, fb = flag[ia], flag[ib]
        ok = ((fa | fb) & (FLAG_UNMAPPED | FLAG_MATE_UNMAPPED)) == 0
        ok &= batch.ref_id[ia] == batch.ref_id[ib]
        a_rev = (fa & FLAG_REVERSE) != 0
        ok &= a_rev != ((fb & FLAG_REVERSE) != 0)
        r = np.where(a_rev, ia, ib)
        rf = flag[r]
        ok &= batch.ref_id[r] == batch.next_ref_id[r]
        ok &= ((rf & FLAG_REVERSE) != 0) != ((rf & FLAG_MATE_REVERSE) != 0)
        start = pos[r].astype(np.int64) + 1
        mate_start = batch.next_pos[r].astype(np.int64) + 1
        rrev = (rf & FLAG_REVERSE) != 0
        end = start + np.maximum(l_seq[r].astype(np.int64) - 1, 0)
        pos5 = np.where(rrev, mate_start, start)
        neg5 = np.where(rrev, end, start + batch.tlen[r].astype(np.int64))
        ok &= pos5 < neg5

        n_failed = int((~ok).sum())
        if odd_total or n_failed:
            st.reject("NotPrimaryFrPair", odd_total + 2 * n_failed)

        ia, ib, bg, first_orig = ia[ok], ib[ok], bg[ok], first_orig[ok]
        a_first = (flag[ia] & FLAG_FIRST) != 0
        r1 = np.where(a_first, ia, ib)
        r2 = np.where(a_first, ib, ia)

        # clip_vs closed forms, both directions (all-M geometry)
        def clips(ra, rb):
            ms = pos[rb].astype(np.int64) + 1
            me = pos[rb].astype(np.int64) + l_seq[rb]
            p1 = pos[ra].astype(np.int64) + 1
            L = l_seq[ra].astype(np.int64)
            d = ms - p1
            c_rev = np.where((p1 <= ms) & (d < L), d, 0)
            end1 = p1 - 1 + L
            bp = np.where((me < p1) | (me >= p1 + L), 0, me - p1 + 1)
            c_fwd = np.where(end1 >= me, np.maximum(L - bp, 0), 0)
            return np.where((flag[ra] & FLAG_REVERSE) != 0, c_rev, c_fwd)

        def info(rr, clip):
            rev = (flag[rr] & FLAG_REVERSE) != 0
            L = l_seq[rr].astype(np.int64)
            flen = np.maximum(L - clip, 0)
            adj = pos[rr].astype(np.int64) + 1 \
                + np.where(rev, np.minimum(clip, L), 0)
            return clip.astype(np.int64), rev, flen, adj

        c1, rev1, flen1, adj1 = info(r1, clips(r1, r2))
        c2, rev2, flen2, adj2 = info(r2, clips(r2, r1))

        # classic pair order within a group = first appearance of the name
        po = np.lexsort((first_orig, bg))
        arrs = (r1[po], c1[po], rev1[po], flen1[po], adj1[po],
                r2[po], c2[po], rev2[po], flen2[po], adj2[po])
        bg = bg[po]
        geom = self._geometry_vec(arrs, bg)
        # per-group pair tuples only for the groups that still take the
        # per-molecule path (downsampling consumes the shared RNG stream);
        # slicing them for every group was a measurable per-group loop
        out = {}
        if geom is not None and geom["downs"].any():
            starts, ends, gid = geom["starts"], geom["ends"], geom["gid"]
            for k in np.nonzero(geom["downs"])[0]:
                out[int(gid[k])] = tuple(a[starts[k]:ends[k]] for a in arrs)
        return out, py_groups, geom

    def _geometry_vec(self, arrs, bg):
        """Phases 3-4 for EVERY paired group in one array pass: the
        per-group verdict (ok / too-small / short-overlap / indel /
        needs-per-molecule-downsample), the overlap geometry of the ok
        groups, and their bulk pack layout (r1 block then r2 block per
        group, group order) — semantically identical to running
        _finish_molecule_vec per group, which remains the reference
        implementation used by the downsample fallback."""
        P = len(bg)
        if P == 0:
            return None
        opts = self.caller.options
        (r1, c1, rev1, flen1, adj1, r2, c2, rev2, flen2, adj2) = arrs
        starts = np.nonzero(np.concatenate(([True], bg[1:] != bg[:-1])))[0]
        ends = np.append(starts[1:], P)
        gid = bg[starts]
        nseg = len(gid)
        n_g = ends - starts
        seg_of_pair = np.repeat(np.arange(nseg), n_g)

        # first-occurrence argmax of each strand's clipped lengths
        pidx = np.arange(P)
        m1 = np.maximum.reduceat(flen1, starts)
        i1 = np.minimum.reduceat(
            np.where(flen1 == m1[seg_of_pair], pidx, P), starts)
        m2 = np.maximum.reduceat(flen2, starts)
        i2 = np.minimum.reduceat(
            np.where(flen2 == m2[seg_of_pair], pidx, P), starts)

        r1_neg = rev1[i1]
        r2_neg = rev2[i2]
        L1f, L1a = flen1[i1], adj1[i1]
        L2f, L2a = flen2[i2], adj2[i2]
        Lpf = np.where(r1_neg, L2f, L1f)
        Lpa = np.where(r1_neg, L2a, L1a)
        Lnf = np.where(r1_neg, L1f, L2f)
        Lna = np.where(r1_neg, L1a, L2a)
        overlap_start = Lna
        pos_end = Lpa + np.maximum(Lpf - 1, 0)
        duplex_length = pos_end - overlap_start + 1

        def rp(adj, cl, p):
            return p - adj + 1, (adj <= p) & (p <= adj + cl - 1)

        r1s, ok1s = rp(L1a, L1f, overlap_start)
        r2s, ok2s = rp(L2a, L2f, overlap_start)
        r1e, ok1e = rp(L1a, L1f, pos_end)
        r2e, ok2e = rp(L2a, L2f, pos_end)
        pv, okp = rp(Lpa, Lpf, pos_end)
        nv, okn = rp(Lna, Lnf, pos_end)
        indel = ~(ok1s & ok2s & ok1e & ok2e) \
            | ((r1s - r2s) != (r1e - r2e)) | ~okp | ~okn
        consensus_length = pv + Lnf - nv

        small = n_g < opts.min_reads_per_strand
        max_pairs = opts.max_reads_per_strand
        downs = (n_g > max_pairs) & ~small if max_pairs is not None \
            else np.zeros(nseg, dtype=bool)
        short = duplex_length < opts.min_duplex_length
        okg = ~small & ~downs & ~short & ~indel

        # bulk pack layout for ok groups: [r1 block, r2 block] per group
        n_s = n_g[okg]
        excl = (np.concatenate(([0], np.cumsum(n_s)[:-1]))
                if len(n_s) else np.zeros(0, np.int64)).astype(np.int64)
        off = 2 * excl
        pk0_seg = np.full(nseg, -1, dtype=np.int64)
        pk0_seg[okg] = off
        total = int(2 * n_s.sum())
        sel = okg[seg_of_pair]
        within = np.arange(int(n_s.sum()), dtype=np.int64) \
            - np.repeat(excl, n_s)
        r1_t = np.repeat(off, n_s) + within
        r2_t = np.repeat(off + n_s, n_s) + within
        pack0 = np.empty(total, dtype=np.int64)
        clips0 = np.empty(total, dtype=np.int64)
        pack0[r1_t] = r1[sel]
        pack0[r2_t] = r2[sel]
        clips0[r1_t] = c1[sel]
        clips0[r2_t] = c2[sel]

        return {"gid": gid, "starts": starts, "ends": ends,
                "n_g": n_g, "small": small, "downs": downs, "short": short,
                "indel": indel, "okg": okg, "r1_neg": r1_neg,
                "r2_neg": r2_neg, "consensus_length": consensus_length,
                "pk0_seg": pk0_seg, "pack0": pack0, "clips0": clips0,
                "r1": r1, "r2": r2, "flen1": flen1, "flen2": flen2}

    def _finish_molecule_vec(self, rows, mi, pairs, pack_rows, pack_clips,
                             pk_base=0):
        """Phases 3-5 for one group given its span-paired arrays; returns a
        partial mol (pack rows staged) or None with classic reject stats."""
        caller = self.caller
        st = caller.stats
        opts = caller.options
        if pairs is None:  # no surviving FR pair in this group
            return None
        (r1, c1, rev1, flen1, adj1, r2, c2, rev2, flen2, adj2) = pairs
        n = len(r1)
        if n < opts.min_reads_per_strand:
            st.reject("InsufficientReads", 2 * n)
            return None
        max_pairs = opts.max_reads_per_strand
        if max_pairs is not None and n > max_pairs:
            idxs = np.sort(caller._rng.permutation(n)[:max_pairs])
            (r1, c1, rev1, flen1, adj1, r2, c2, rev2, flen2, adj2) = (
                a[idxs] for a in pairs)
            n = max_pairs
        n_filtered = 2 * n

        # phase 4: overlap geometry on the longest strands (first max)
        i1, i2 = int(np.argmax(flen1)), int(np.argmax(flen2))
        r1_neg, r2_neg = bool(rev1[i1]), bool(rev2[i2])
        L1 = (int(flen1[i1]), int(adj1[i1]))
        L2 = (int(flen2[i2]), int(adj2[i2]))
        Lpos, Lneg = (L2, L1) if r1_neg else (L1, L2)
        overlap_start = Lneg[1]
        pos_end = Lpos[1] + max(Lpos[0] - 1, 0)
        duplex_length = pos_end - overlap_start + 1
        if duplex_length < opts.min_duplex_length:
            st.reject("InsufficientOverlap", n_filtered)
            return None

        def rp(i, p):
            flen, adj = i
            if adj <= p <= adj + flen - 1:
                return p - adj + 1
            return None

        r1s, r2s = rp(L1, overlap_start), rp(L2, overlap_start)
        r1e, r2e = rp(L1, pos_end), rp(L2, pos_end)
        if None in (r1s, r2s, r1e, r2e) or (r1s - r2s) != (r1e - r2e):
            st.reject("IndelErrorBetweenStrands", n_filtered)
            return None
        p = rp(Lpos, pos_end)
        n_ = rp(Lneg, pos_end)
        if p is None or n_ is None:
            st.reject("IndelErrorBetweenStrands", n_filtered)
            return None
        consensus_length = p + Lneg[0] - n_

        pk0 = pk_base + len(pack_rows)
        pack_rows.extend(r1.tolist())
        pack_clips.extend(c1.tolist())
        pack_rows.extend(r2.tolist())
        pack_clips.extend(c2.tolist())
        return {
            "mi": mi, "rows": rows, "pk0": pk0,
            "r1_rows": r1, "r2_rows": r2,
            "r1_flens": flen1, "r2_flens": flen2,
            "r1_neg": r1_neg, "r2_neg": r2_neg,
            "consensus_length": consensus_length,
        }

    def _prepare_molecule_vec(self, batch, rows, mi, pack_rows, pack_clips,
                              pk_base=0):
        """Phases 1-4 on arrays; returns a partial mol (pack indices staged)
        or None (rejected, reasons recorded like classic prepare)."""
        caller = self.caller
        st = caller.stats
        opts = caller.options
        flag = batch.flag
        l_seq = batch.l_seq
        pos = batch.pos
        st.total_input_reads += len(rows)

        fl = flag[rows]
        frag = int(((fl & FLAG_PAIRED) == 0).sum())
        if frag:
            st.reject("FragmentRead", frag)
        pp = rows[((fl & FLAG_PAIRED) != 0)
                  & ((fl & (FLAG_SECONDARY | FLAG_SUPPLEMENTARY)) == 0)]
        if len(pp) == 0:
            return None

        # phase 2: first-appearance name buckets, one FR pair per template
        by_name = {}
        for k in range(len(pp)):
            by_name.setdefault(batch.name(int(pp[k])), []).append(k)
        pairs = []  # (r1_row, r2_row)
        for name, bucket in by_name.items():
            if len(bucket) != 2 or not self._is_primary_fr_pair(
                    batch, int(pp[bucket[0]]), int(pp[bucket[1]])):
                st.reject("NotPrimaryFrPair", len(bucket))
                continue
            ra, rb = int(pp[bucket[0]]), int(pp[bucket[1]])
            pairs.append((ra, rb) if flag[ra] & FLAG_FIRST else (rb, ra))
        if not pairs:
            return None
        if len(pairs) < opts.min_reads_per_strand:
            st.reject("InsufficientReads", 2 * len(pairs))
            return None

        max_pairs = opts.max_reads_per_strand
        if max_pairs is not None and len(pairs) > max_pairs:
            idxs = sorted(caller._rng.permutation(len(pairs))[:max_pairs])
            pairs = [pairs[i] for i in idxs]

        # clip + adjusted position + clipped length (all-M closed forms)
        def clip_vs(ra, rb):
            ms = pos[rb] + 1
            me = pos[rb] + l_seq[rb]
            p1 = pos[ra] + 1
            L = int(l_seq[ra])
            if flag[ra] & FLAG_REVERSE:
                if p1 <= ms:
                    d = int(ms - p1)
                    return d if d < L else 0
                return 0
            end1 = p1 - 1 + L
            if end1 >= me:
                if me < p1 or me >= p1 + L:
                    bp = 0
                else:
                    bp = int(me - p1 + 1)
                return max(L - bp, 0)
            return 0

        def info(r, clip):
            rev = bool(flag[r] & FLAG_REVERSE)
            ref_consumed = min(clip, int(l_seq[r]))
            adj = int(pos[r]) + 1 + (ref_consumed if rev else 0)
            return (r, clip, rev, max(int(l_seq[r]) - clip, 0), adj)

        r1i = []
        r2i = []
        for ra, rb in pairs:
            r1i.append(info(ra, clip_vs(ra, rb)))
            r2i.append(info(rb, clip_vs(rb, ra)))
        # phase 3 (most-common-alignment filter): single-op M CIGARs always
        # form one prefix-compatible group -> keep all, no rejects
        n_filtered = len(r1i) + len(r2i)

        # phase 4: overlap geometry on the longest strands (first max)
        cl1 = np.array([i[3] for i in r1i])
        cl2 = np.array([i[3] for i in r2i])
        L1 = r1i[int(np.argmax(cl1))]
        L2 = r2i[int(np.argmax(cl2))]
        r1_neg, r2_neg = L1[2], L2[2]
        Lpos, Lneg = (L2, L1) if r1_neg else (L1, L2)
        overlap_start = Lneg[4]
        pos_end = Lpos[4] + max(Lpos[3] - 1, 0)
        duplex_length = pos_end - overlap_start + 1
        if duplex_length < opts.min_duplex_length:
            st.reject("InsufficientOverlap", n_filtered)
            return None

        def rp(i, p):
            adj, cl = i[4], i[3]
            if adj <= p <= adj + cl - 1:
                return p - adj + 1
            return None

        r1s, r2s = rp(L1, overlap_start), rp(L2, overlap_start)
        r1e, r2e = rp(L1, pos_end), rp(L2, pos_end)
        if None in (r1s, r2s, r1e, r2e) or (r1s - r2s) != (r1e - r2e):
            st.reject("IndelErrorBetweenStrands", n_filtered)
            return None
        p = rp(Lpos, pos_end)
        n_ = rp(Lneg, pos_end)
        if p is None or n_ is None:
            st.reject("IndelErrorBetweenStrands", n_filtered)
            return None
        consensus_length = p + Lneg[3] - n_

        # stage the pack rows (r1 strand then r2 strand, pair order)
        pk0 = pk_base + len(pack_rows)
        for i in r1i:
            pack_rows.append(i[0])
            pack_clips.append(i[1])
        for i in r2i:
            pack_rows.append(i[0])
            pack_clips.append(i[1])
        return {
            "mi": mi, "rows": rows, "pk0": pk0,
            "r1_rows": np.array([i[0] for i in r1i], dtype=np.int64),
            "r2_rows": np.array([i[0] for i in r2i], dtype=np.int64),
            "r1_flens": np.array([i[3] for i in r1i], dtype=np.int64),
            "r2_flens": np.array([i[3] for i in r2i], dtype=np.int64),
            "r1_neg": r1_neg, "r2_neg": r2_neg,
            "consensus_length": consensus_length,
        }

    def _finalize_vec(self, batch, prep):
        """Phase 5: the mol dict for the dense dispatch in _run.

        No SS jobs are materialized — the strand rows stay resident in the
        span's pack arrays and _run gathers them directly (the SS caller's
        min_reads=1 / max_reads=None construction makes per-strand
        consensus_len = longest clipped read, carried via the flens).
        """
        caller = self.caller
        f1, f2 = prep["r1_flens"], prep["r2_flens"]
        umi = prep["mi"]
        if caller.options.cell_tag is not None:
            # only the cell-tag fallback reads raw records back
            records = batch.raw_records(prep["rows"])
            row_to_rec = {int(r): rec
                          for r, rec in zip(prep["rows"], records)}
            source_raws = [row_to_rec[int(r)] for r in
                           np.concatenate([prep["r1_rows"], prep["r2_rows"]])]
        else:
            records, source_raws = None, None
        # RX strings for the whole group from the batch tag scan (same Z/H
        # gate and lenient decode as RawRecord.get_str; codec.py RX consensus)
        rx_off, rx_len, _ = batch.tag_locs_str(b"RX")
        buf = batch.buf
        rx_umis = []
        for r in prep["rows"]:
            o, ln = int(rx_off[r]), int(rx_len[r])
            if o >= 0 and ln > 0:
                rx_umis.append(buf[o:o + ln].tobytes().decode(errors="replace"))
        return {
            "umi": umi, "records": records,
            "pk0": prep["pk0"], "r1_flens": f1, "r2_flens": f2,
            "n_r1": len(f1), "n_r2": len(f2),
            "r1_is_negative": prep["r1_neg"],
            "r2_is_negative": prep["r2_neg"],
            "consensus_length": prep["consensus_length"],
            "source_raws": source_raws,
            "rx_umis": rx_umis,
        }

    @staticmethod
    def _is_primary_fr_pair(batch, ia, ib):
        """is_primary_fr_pair + is_fr_pair for all-M records (overlap.py:96-156)."""
        flag = batch.flag
        fa, fb = int(flag[ia]), int(flag[ib])
        if (fa | fb) & (FLAG_UNMAPPED | FLAG_MATE_UNMAPPED):
            return False
        if batch.ref_id[ia] != batch.ref_id[ib]:
            return False
        a_rev = bool(fa & FLAG_REVERSE)
        if a_rev == bool(fb & FLAG_REVERSE):
            return False
        r = ia if a_rev else ib
        rf = int(flag[r])
        if batch.ref_id[r] != batch.next_ref_id[r]:
            return False
        if bool(rf & FLAG_REVERSE) == bool(rf & FLAG_MATE_REVERSE):
            return False
        # is_fr_pair on the reverse-strand record (M-only: ref_len == l_seq)
        start = int(batch.pos[r]) + 1
        mate_start = int(batch.next_pos[r]) + 1
        if rf & FLAG_REVERSE:
            end = start + max(int(batch.l_seq[r]) - 1, 0)
            positive_5p, negative_5p = mate_start, end
        else:
            positive_5p, negative_5p = start, start + int(batch.tlen[r])
        return positive_5p < negative_5p
