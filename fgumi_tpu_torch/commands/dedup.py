"""UMI-aware duplicate marking (``dedup``), the per-template engine
(``dedup --classic``; the batch engine is ``commands/fast_group.FastDedup``).

The reference's dedup.rs:
- template-coordinate sorted input, with ``tc`` tags on secondary and
  supplementary reads from zipper (dedup.rs:1196-1210);
- position groups (secondary and supplementary records included), the
  template filters of ``group``, counted per template, with templates of no
  mapped read dropped or, under ``--include-unmapped``, passed through
  verbatim (dedup.rs:455-480, 800-815);
- UMI clustering per position group through the strategy assigners, whose
  groups of at least ``DEVICE_THRESHOLD`` distinct UMIs compute their
  distances on ``device`` (kernel K4 on ``cuda``); non-paired strategies
  split by strand of origin unless ``--no-umi``, which groups
  orientation-agnostically as Picard MarkDuplicates does
  (dedup.rs:640-660);
- cell barcodes: a position's reads split by their CB tag, so different
  cells never dedup against each other;
- Picard SUM_OF_BASE_QUALITIES: per primary read the sum of quals >= 15,
  capped at Short.MAX_VALUE / 2, a QC-fail read discounted by
  Short.MIN_VALUE / 2 (score_template, dedup.rs:222-290);
- the best-scoring template of a UMI family is kept; every record of the
  others gets the 0x400 flag, or is dropped under ``--remove-duplicates``
  (mark_duplicates_in_family, dedup.rs:700-775);
- MI:Z tags from the assigners' counters in stream order, on every record
  of an assigned template;
- metrics: template and read totals, duplicate rate, secondary and
  supplementary counts, missing ``tc`` tags and the family-size histogram
  (DedupMetricsOutput, dedup.rs:119-152).
"""

import logging
import struct
from dataclasses import dataclass, field

import numpy as np

from ..core.template import iter_templates, library_lookup_from_header
from ..io.bam import (FLAG_DUPLICATE, FLAG_MATE_UNMAPPED, FLAG_PAIRED,
                      FLAG_QC_FAIL, FLAG_SECONDARY, FLAG_SUPPLEMENTARY,
                      FLAG_UNMAPPED, RawRecord)
from ..umi.assigners import make_assigner
from .group import FilterMetrics, assign_group, iter_position_groups

log = logging.getLogger("fgumi_tpu_torch")

# Picard/HTSJDK DuplicateScoringStrategy constants (dedup.rs:222-245): the
# 15 is a threshold (the full value counted above it, not a cap), the
# per-read cap keeps two mates' scores summable in a short, and the QC-fail
# discount keeps a QC-fail read from ever winning the representative.
PICARD_MIN_BASE_QUALITY = 15
PICARD_MAX_SCORE_PER_READ = 32767 // 2
PICARD_QC_FAIL_DISCOUNT = -32768 // 2


@dataclass
class DedupMetrics:
    total_templates: int = 0
    unique_templates: int = 0
    duplicate_templates: int = 0
    total_reads: int = 0
    unique_reads: int = 0
    duplicate_reads: int = 0
    secondary_reads: int = 0
    supplementary_reads: int = 0
    missing_tc_tag: int = 0
    filter: FilterMetrics = field(default_factory=FilterMetrics)

    def duplicate_rate(self) -> float:
        if self.total_templates == 0:
            return 0.0
        return self.duplicate_templates / self.total_templates


def score_template(t) -> int:
    """Picard SUM_OF_BASE_QUALITIES over the primary reads
    (dedup.rs:246-290)."""
    score = 0
    for rec in (t.r1, t.r2, t.fragment):
        if rec is None:
            continue
        quals = rec.quals()
        read_sum = int(quals[quals >= PICARD_MIN_BASE_QUALITY]
                       .sum(dtype=np.int64))
        read_score = min(read_sum, PICARD_MAX_SCORE_PER_READ)
        if rec.flag & FLAG_QC_FAIL:
            read_score += PICARD_QC_FAIL_DISCOUNT
        score += read_score
    return score


def filter_dedup_template(t, *, umi_tag: bytes, min_mapq: int,
                          include_non_pf: bool, min_umi_length, no_umi: bool,
                          metrics: FilterMetrics) -> bool:
    """filter_template (dedup.rs:330-450): like group's filter, counted per
    template (not per read), both-unmapped always fails here — the
    --include-unmapped pass-through is split off before filtering."""
    metrics.total_templates += 1
    primaries = [r for r in (t.r1, t.r2, t.fragment) if r is not None]
    if not primaries:
        metrics.poor_alignment += 1
        return False
    if all(r.flag & FLAG_UNMAPPED for r in primaries):
        metrics.poor_alignment += 1
        return False
    for r in primaries:
        if not include_non_pf and r.flag & FLAG_QC_FAIL:
            metrics.non_pf += 1
            return False
        if not r.flag & FLAG_UNMAPPED and r.mapq < min_mapq:
            metrics.poor_alignment += 1
            return False
    for r in primaries:
        if r.flag & FLAG_PAIRED and not r.flag & FLAG_MATE_UNMAPPED:
            mq = r.get_int(b"MQ")
            # signed compare, so MQ:c:-1 fails rather than wrapping
            # (dedup.rs:412-420)
            if mq is not None and mq < min_mapq:
                metrics.poor_alignment += 1
                return False
        if no_umi:
            continue
        umi = r.get_str(umi_tag)
        if umi is None:
            metrics.poor_alignment += 1
            return False
        if "N" in umi.upper():
            metrics.ns_in_umi += 1
            return False
        if min_umi_length is not None:
            bases = sum(len(seg) for seg in umi.split("-"))
            if bases < min_umi_length:
                metrics.umi_too_short += 1
                return False
    metrics.accepted += 1
    return True


def is_unmapped_passthrough(t) -> bool:
    """template_is_unmapped_passthrough (dedup.rs:455-480): no mapped
    primary."""
    primaries = [r for r in (t.r1, t.r2, t.fragment) if r is not None]
    if not primaries:
        return False
    return all(r.flag & FLAG_UNMAPPED for r in primaries)


def _family_key(mi):
    """Sort and group key of an assigned MoleculeId: /A and /B strands are
    separate families (dedup.rs to_vec_index ordering)."""
    return (mi.id, mi.kind)


def _record_with_flag_and_mi(rec: RawRecord, is_dup: bool, mi_str,
                             assigned_tag: bytes) -> bytes:
    flag = (rec.flag & ~FLAG_DUPLICATE) | (FLAG_DUPLICATE if is_dup else 0)
    if mi_str is None:
        data = bytearray(rec.data)
    else:
        data = bytearray(rec.data_without_tag(assigned_tag))
        data += assigned_tag + b"Z" + mi_str.encode() + b"\x00"
    struct.pack_into("<H", data, 14, flag)
    return bytes(data)


def _cell_partitions(templates):
    """Partition a position group's templates by CB cell barcode
    (deterministic order: by barcode, the barcodeless group first)."""
    by_cell = {}
    for t in templates:
        r = t.primary_r1 or t.r2
        cb = r.get_str(b"CB") if r is not None else None
        by_cell.setdefault(cb or "", []).append(t)
    return [by_cell[k] for k in sorted(by_cell)]


def process_group(templates, assigner, *, umi_tag: bytes, min_umi_length,
                  no_umi: bool, metrics: DedupMetrics):
    """Assign UMIs and mark duplicates in one position group, in place
    (process_position_group, dedup.rs:780-940). Returns family-size
    counts."""
    family_sizes = {}
    for cell_templates in _cell_partitions(templates):
        if no_umi:
            # orientation-agnostic identity grouping (Picard semantics):
            # bypass assign_group's strand-of-origin split entirely
            assignments = assigner.assign([""] * len(cell_templates))
            for t, mi in zip(cell_templates, assignments):
                t.mi = mi
        else:
            assign_group(cell_templates, assigner, umi_tag, min_umi_length,
                         False)
        ordered = sorted(cell_templates,
                         key=lambda t: (_family_key(t.mi), t.name))
        i = 0
        while i < len(ordered):
            j = i
            while j < len(ordered) and \
                    _family_key(ordered[j].mi) == _family_key(ordered[i].mi):
                j += 1
            family = ordered[i:j]
            family_sizes[len(family)] = family_sizes.get(len(family), 0) + 1
            if len(family) == 1:
                # singleton fast path: no scoring needed (dedup.rs:707-712)
                best = 0
            else:
                scores = [score_template(t) for t in family]
                best = max(range(len(family)),
                           key=lambda k: (scores[k], -k))
            for k, t in enumerate(family):
                t.is_duplicate = k != best
                metrics.total_templates += 1
                if t.is_duplicate:
                    metrics.duplicate_templates += 1
                else:
                    metrics.unique_templates += 1
            i = j
    return family_sizes


def run_dedup(reader, writer, *, strategy: str = "adjacency", edits: int = 1,
              umi_tag: bytes = b"RX", assigned_tag: bytes = b"MI",
              min_mapq: int = 0, include_non_pf: bool = False,
              min_umi_length=None, no_umi: bool = False,
              include_unmapped: bool = False, remove_duplicates: bool = False,
              device="cuda"):
    """Stream reader -> writer marking or removing duplicates; position
    groups at K4's sizes compute their UMI distances on ``device``.
    Returns (metrics, family sizes)."""
    if no_umi and strategy == "paired":
        raise ValueError("--no-umi cannot be used with --strategy paired")
    if min_umi_length is not None and strategy == "paired":
        raise ValueError(
            "Paired strategy cannot be used with --min-umi-length")
    if no_umi:
        strategy, edits = "identity", 0
    assigner = make_assigner(strategy, edits, device)
    library_of = library_lookup_from_header(reader.header.text)
    metrics = DedupMetrics()
    family_sizes = {}

    def count_read(rec, is_dup: bool):
        metrics.total_reads += 1
        if is_dup:
            metrics.duplicate_reads += 1
        sec = rec.flag & FLAG_SECONDARY
        sup = rec.flag & FLAG_SUPPLEMENTARY
        if sec:
            metrics.secondary_reads += 1
        if sup:
            metrics.supplementary_reads += 1
        if (sec or sup) and rec.find_tag(b"tc") is None:
            metrics.missing_tc_tag += 1

    for group in iter_position_groups(iter_templates(reader), library_of):
        passthrough, candidates = [], group
        if include_unmapped:
            passthrough, candidates = [], []
            for t in group:
                (passthrough if is_unmapped_passthrough(t)
                 else candidates).append(t)
        kept = [t for t in candidates
                if filter_dedup_template(
                    t, umi_tag=umi_tag, min_mapq=min_mapq,
                    include_non_pf=include_non_pf,
                    min_umi_length=min_umi_length, no_umi=no_umi,
                    metrics=metrics.filter)]
        if kept:
            sizes = process_group(kept, assigner, umi_tag=umi_tag,
                                  min_umi_length=min_umi_length,
                                  no_umi=no_umi, metrics=metrics)
            for size, count in sizes.items():
                family_sizes[size] = family_sizes.get(size, 0) + count
        for t in kept:
            mi_str = t.mi.render() if t.mi is not None else None
            for rec in t.all_records():
                count_read(rec, t.is_duplicate)
                if remove_duplicates and t.is_duplicate:
                    continue
                writer.write_record_bytes(
                    _record_with_flag_and_mi(rec, t.is_duplicate, mi_str,
                                             assigned_tag))
        # pass-through templates are written verbatim: never marked, never
        # MI-tagged, counted as unique (dedup.rs:915-935)
        for t in passthrough:
            metrics.total_templates += 1
            metrics.unique_templates += 1
            for rec in t.all_records():
                count_read(rec, False)
                writer.write_record_bytes(rec.data)
    metrics.unique_reads = metrics.total_reads - metrics.duplicate_reads
    return metrics, dict(sorted(family_sizes.items()))


_METRIC_COLUMNS = [
    "total_templates", "unique_templates", "duplicate_templates",
    "duplicate_rate", "total_reads", "unique_reads", "duplicate_reads",
    "secondary_reads", "supplementary_reads", "missing_tc_tag",
]


def write_metrics(metrics: DedupMetrics, path: str):
    """DedupMetricsOutput TSV (dedup.rs:119-152)."""
    row = {c: getattr(metrics, c) for c in _METRIC_COLUMNS
           if c != "duplicate_rate"}
    row["duplicate_rate"] = f"{metrics.duplicate_rate():.6f}"
    from ..utils.atomic import open_output

    with open_output(path, "w") as f:
        f.write("\t".join(_METRIC_COLUMNS) + "\n")
        f.write("\t".join(str(row[c]) for c in _METRIC_COLUMNS) + "\n")


def write_family_size_histogram(family_sizes: dict, path: str):
    from ..utils.atomic import open_output

    with open_output(path, "w") as f:
        f.write("family_size\tcount\n")
        for size, count in family_sizes.items():
            f.write(f"{size}\t{count}\n")
