"""Batch engine for the `correct` command.

The port's copy of fgumi_tpu/commands/fast_correct.py. The per-template
loop (commands/correct.py run_correct; the reference is fgumi's
correct.rs) walks every record through
BamReader + find_tag; per-template work is tiny (a cached whitelist match),
so the wall time is pure per-record Python. This engine reuses the batch
template-window machinery (commands/fast_zipper.iter_template_windows) and
rebuilds corrected records with the native aux editor:

- one hash pass groups rows into templates and verifies per-template UMI
  consistency (mixed presence/value raises exactly like the classic path);
- corrections compute once per DISTINCT observed UMI (dict cache in front
  of the segment-level matcher cache);
- all written rows of a window rebuild in one fgumi_rebuild_aux_records
  call — rows needing no correction carry empty drop/append spans and copy
  through verbatim, corrected rows drop RX (and OX) and append the staged
  OX/RX entries in apply_correction's order.

tests/test_torch_correct.py holds both engines to the JAX package's.
"""

import numpy as np

from ..io.bam import RawRecord
from ..native import batch as nb
from .correct import (TARGET_TAGS, CorrectStats, _credit,
                      compute_template_correction, extract_template_umi)
from .fast_zipper import iter_template_windows


def _tag_entry(tag: bytes, value: bytes) -> bytes:
    return tag + b"Z" + value + b"\x00"


def run_correct_fast(reader, writer, matcher, umi_length: int, *,
                     target: str = "umi", revcomp: bool = False,
                     store_original: bool = True,
                     rejects_writer=None) -> CorrectStats:
    """Drop-in replacement for run_correct over a BamBatchReader."""
    umi_tag, original_tag = TARGET_TAGS[target]
    stats = CorrectStats()
    unmatched_umi = "N" * umi_length
    corr_cache = {}

    def correction_for(umi: str):
        corr = corr_cache.get(umi)
        if corr is None:
            corr = compute_template_correction(umi, umi_length, revcomp,
                                               matcher)
            corr_cache[umi] = corr
        return corr

    def handle_py(records):
        """The per-template path (templates across batch buffers)."""
        stats.templates += 1
        umi = extract_template_umi(records, umi_tag)
        if umi is None:
            stats.missing_umis += len(records)
            if rejects_writer is not None:
                for rec in records:
                    rejects_writer.write_record_bytes(rec.data)
            return
        corr = correction_for(umi)
        if corr.matches:
            _credit(stats.umi_metrics, corr.matches, len(records),
                    unmatched_umi)
        if corr.matched:
            from .correct import apply_correction

            for rec in records:
                writer.write_record_bytes(apply_correction(
                    rec, corr, umi_tag, original_tag, store_original))
                stats.records_written += 1
        else:
            if corr.rejection == "wrong_length":
                stats.wrong_length += len(records)
            else:
                stats.mismatched += len(records)
            if rejects_writer is not None:
                for rec in records:
                    rejects_writer.write_record_bytes(rec.data)

    for item in iter_template_windows(reader):
        if item[0] == "py":
            handle_py(item[2])
            continue
        _, batch, bounds = item
        buf = batch.buf
        vo, vl, _vt = batch.tag_locs_str(umi_tag)
        nT = len(bounds) - 1
        lo = bounds[:-1].astype(np.int64)
        hi = bounds[1:].astype(np.int64)
        present = vo >= 0

        # per-template presence/value consistency (extract_template_umi):
        # every row must agree with the template's first row. The window's
        # bounds may start past row 0 (earlier groups were carried), so all
        # comparisons run over the window's row range only.
        rep = lo
        rows_w = np.arange(int(bounds[0]), int(bounds[-1]))
        rep_of_row = np.repeat(rep, hi - lo)
        p_row = present[rows_w]
        p_rep = present[rep_of_row]
        row_ok = p_row == p_rep
        eq = nb.ranges_equal(buf, vo[rows_w], np.where(p_row, vl[rows_w], 0),
                             vo[rep_of_row],
                             np.where(p_rep, vl[rep_of_row], 0))
        row_ok &= ~p_row | eq.astype(bool)
        if not row_ok.all():
            # the per-template error text for the first bad template
            bad_row = int(rows_w[np.nonzero(~row_ok)[0][0]])
            bt = int(np.searchsorted(hi, bad_row, side="right"))
            extract_template_umi(
                list(batch.raw_records(np.arange(lo[bt], hi[bt]))), umi_tag)
            raise ValueError("template has inconsistent UMIs")  # unreachable

        # template UMI strings in one gather (blank for missing)
        offs = vo[rep]
        lens = np.where(offs >= 0, vl[rep], 0).astype(np.int64)
        blob, boff = nb.concat_spans([buf], np.zeros(nT, np.int32), offs,
                                     lens)
        s = blob.tobytes().decode()
        bo = boff.tolist()

        write_rows = []
        drops = []
        appends = []
        app_scratch = bytearray()
        for t in range(nT):
            stats.templates += 1
            n_recs = int(hi[t] - lo[t])
            if offs[t] < 0:
                stats.missing_umis += n_recs
                if rejects_writer is not None:
                    base = int(batch.rec_off[lo[t]])
                    rejects_writer.write_serialized(
                        buf[base:int(batch.data_end[hi[t] - 1])].tobytes())
                continue
            corr = correction_for(s[bo[t]:bo[t + 1]])
            if corr.matches:
                _credit(stats.umi_metrics, corr.matches, n_recs,
                        unmatched_umi)
            if not corr.matched:
                if corr.rejection == "wrong_length":
                    stats.wrong_length += n_recs
                else:
                    stats.mismatched += n_recs
                if rejects_writer is not None:
                    base = int(batch.rec_off[lo[t]])
                    rejects_writer.write_serialized(
                        buf[base:int(batch.data_end[hi[t] - 1])].tobytes())
                continue
            if corr.needs_correction:
                add_ox = store_original and corr.has_mismatches
                entry = b""
                if add_ox:
                    entry += _tag_entry(original_tag,
                                        corr.original_umi.encode())
                entry += _tag_entry(umi_tag, corr.corrected_umi.encode())
                a0 = len(app_scratch)
                app_scratch += entry
                drop = (umi_tag, original_tag) if add_ox else (umi_tag,)
                for r in range(int(lo[t]), int(hi[t])):
                    write_rows.append((r, corr))
                    drops.append(drop)
                    appends.append((a0, len(entry)))
            else:
                for r in range(int(lo[t]), int(hi[t])):
                    write_rows.append((r, None))
                    drops.append(())
                    appends.append((0, 0))
            stats.records_written += n_recs

        if not write_rows:
            continue
        rows = np.asarray([r for r, _ in write_rows], dtype=np.int64)
        width = 2
        dmat = np.zeros((len(rows), width), dtype=np.uint16)
        for i, d in enumerate(drops):
            for k, tg in enumerate(d):
                dmat[i, k] = tg[0] | (tg[1] << 8)
        drop_off = np.arange(len(rows) + 1, dtype=np.int64) * width
        app = np.asarray(appends, dtype=np.int64)
        # concat the per-row append spans into a dense blob + offsets
        scratch = np.frombuffer(bytes(app_scratch) or b"\x00", dtype=np.uint8)
        dense, dense_off = nb.concat_spans(
            [scratch], np.zeros(len(rows), np.int32), app[:, 0], app[:, 1])
        got = nb.rebuild_aux_records(
            buf, batch.data_off[rows], batch.aux_off[rows],
            batch.data_end[rows], dmat.ravel(), drop_off, dense, dense_off)
        if got is None:
            # malformed aux: apply per record, as the reference does (the
            # stats are already counted; only serialization remains)
            from .correct import apply_correction

            for r, corr in write_rows:
                rec = RawRecord(bytes(buf[batch.data_off[r]:
                                          batch.data_end[r]]))
                data = rec.data if corr is None else apply_correction(
                    rec, corr, umi_tag, original_tag, store_original)
                writer.write_record_bytes(data)
            continue
        wire, _pos = got
        writer.write_serialized(wire.tobytes())
    return stats
