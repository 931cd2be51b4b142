"""Shared infrastructure for the duplex-metrics / simplex-metrics commands.

Mirrors src/lib/commands/shared_metrics.rs: template streaming
from a grouped BAM, ReadInfoKey coordinate grouping, interval filtering
(BED / Picard interval list), deterministic Murmur3 downsampling scores, and
the 20-level downsampling fraction ladder.
"""

from dataclasses import dataclass
from typing import Optional

from ..core.template import iter_name_groups, unclipped_5prime
from ..io.bam import (FLAG_FIRST, FLAG_LAST, FLAG_PAIRED, FLAG_REVERSE,
                      FLAG_SECONDARY, FLAG_SUPPLEMENTARY, FLAG_UNMAPPED,
                      FLAG_MATE_UNMAPPED, BamReader, RawRecord)
from ..metrics import compute_hash_fraction

# 5%, 10%, ..., 100% (shared_metrics.rs:24-28)
DOWNSAMPLING_FRACTIONS = [round(0.05 * i, 2) for i in range(1, 21)]


@dataclass
class Interval:
    """0-based half-open genomic interval (shared_metrics.rs:33-42)."""

    ref_name: str
    start: int
    end: int


@dataclass
class TemplateInfo:
    """Per-template info for grouping + downsampling (shared_metrics.rs:45-62)."""

    mi: str
    rx: str
    ref_name: Optional[str]
    position: Optional[int]  # 1-based insert start
    end_position: Optional[int]  # 1-based inclusive insert end
    r1_positive: bool
    hash_fraction: float


@dataclass
class TemplateMetadata:
    """MI parsed into base UMI + strand (shared_metrics.rs:91-103, 434-448)."""

    template: TemplateInfo
    base_umi: str
    is_a_strand: bool
    is_b_strand: bool


def compute_template_metadata(group) -> list:
    out = []
    for t in group:
        if t.mi.endswith("/A"):
            out.append(TemplateMetadata(t, t.mi[:-2], True, False))
        elif t.mi.endswith("/B"):
            out.append(TemplateMetadata(t, t.mi[:-2], False, True))
        else:
            out.append(TemplateMetadata(t, t.mi, False, False))
    return out


def parse_intervals(path: str) -> list:
    """BED (0-based half-open) or Picard interval list (1-based closed),
    auto-detected by '@' header lines (shared_metrics.rs:213-272)."""
    intervals = []
    is_interval_list = False
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            if line.startswith("@"):
                is_interval_list = True
                continue
            parts = line.split("\t", 3)
            if len(parts) < 3:
                raise ValueError(
                    f"Invalid {'interval list' if is_interval_list else 'BED'} "
                    f"line (needs at least 3 fields): {line}")
            ref_name, start_s, end_s = parts[0], parts[1], parts[2]
            start = int(start_s)
            end = int(end_s)
            if is_interval_list:
                start -= 1  # 1-based closed -> 0-based half-open
            intervals.append(Interval(ref_name, start, end))
    return intervals


def overlaps_intervals(template: TemplateInfo, intervals: list) -> bool:
    """Insert-vs-interval overlap (shared_metrics.rs:276-303)."""
    if not intervals:
        return True
    if template.ref_name is None or template.position is None \
            or template.end_position is None:
        return False
    start, end = template.position, template.end_position
    return any(iv.ref_name == template.ref_name
               and start <= iv.end and iv.start < end
               for iv in intervals)


def validate_not_consensus_bam(path: str):
    """Reject consensus BAM input by checking the first primary paired R1 for
    consensus tags (shared_metrics.rs:316-360)."""
    with BamReader(path) as reader:
        for rec in reader:
            flg = rec.flag
            if not flg & FLAG_PAIRED or not flg & FLAG_FIRST:
                continue
            if flg & (FLAG_SECONDARY | FLAG_SUPPLEMENTARY):
                continue
            for tag in (b"cD", b"cM", b"cE", b"aD", b"bD"):
                if rec.find_tag(tag) is not None:
                    raise ValueError(
                        "input appears to be a consensus BAM (found "
                        f"{tag.decode()} tag); metrics tools take grouped raw "
                        "reads, not consensus output")
            return


def _template_filter(rec: RawRecord, want_first: bool) -> bool:
    """fgbio R1/R2 filter: paired, both mapped, primary (shared_metrics.rs:499-509)."""
    flg = rec.flag
    seg = FLAG_FIRST if want_first else FLAG_LAST
    return bool(flg & FLAG_PAIRED) and not flg & FLAG_UNMAPPED \
        and not flg & FLAG_MATE_UNMAPPED and bool(flg & seg) \
        and not flg & (FLAG_SECONDARY | FLAG_SUPPLEMENTARY)


def _library_index(header_text: str) -> dict:
    """RG id -> LB library string from the header (read_info.rs LibraryIndex)."""
    out = {}
    for line in header_text.splitlines():
        if not line.startswith("@RG"):
            continue
        rg_id = lb = None
        for field in line.split("\t")[1:]:
            if field.startswith("ID:"):
                rg_id = field[3:]
            elif field.startswith("LB:"):
                lb = field[3:]
        if rg_id is not None:
            out[rg_id] = lb or ""
    return out


def process_templates_from_bam(path: str, intervals: list, num_fractions: int,
                               process_group):
    """Stream templates, group by ReadInfo coordinate key, dispatch each group.

    `process_group(group: [TemplateInfo], fraction_counts: [int])` is called
    once per coordinate group. Returns (total_templates, fraction_counts).
    Mirrors shared_metrics.rs:473-620.
    """
    total = 0
    fraction_counts = [0] * num_fractions
    with BamReader(path) as reader:
        libraries = _library_index(reader.header.text)
        ref_names = reader.header.ref_names
        current_key = None
        current_group = []

        for _name, records in iter_name_groups(reader):
            if len(records) < 2:
                continue
            r1 = next((r for r in records if _template_filter(r, True)), None)
            r2 = next((r for r in records if _template_filter(r, False)), None)
            if r1 is None or r2 is None:
                continue
            mi = r1.get_str(b"MI")
            rx = r1.get_str(b"RX")
            if mi is None or rx is None:
                missing = "MI" if mi is None else "RX"
                raise ValueError(
                    f"record {r1.name!r} missing required {missing} tag")
            if r1.ref_id < 0 or r2.ref_id < 0:
                continue

            s1, s2 = unclipped_5prime(r1), unclipped_5prime(r2)
            strand1 = bool(r1.flag & FLAG_REVERSE)
            strand2 = bool(r2.flag & FLAG_REVERSE)
            rg = r1.get_str(b"RG")
            library = libraries.get(rg, "") if rg else ""
            cb = r1.get_str(b"CB")

            # order the two ends so the earlier-mapping one comes first
            end1 = (r1.ref_id, s1, strand1)
            end2 = (r2.ref_id, s2, strand2)
            key = (*min(end1, end2), *max(end1, end2), library, cb)

            same_ref = r1.ref_id == r2.ref_id
            r1_start, r2_start = r1.pos + 1, r2.pos + 1
            r1_end = r1.pos + r1.reference_length()
            r2_end = r2.pos + r2.reference_length()
            if same_ref:
                position = min(r1_start, r2_start)
                end_position = max(r1_end, r2_end)
            else:
                position, end_position = r1_start, r1_end

            info = TemplateInfo(
                mi=mi, rx=rx,
                ref_name=ref_names[r1.ref_id] if r1.ref_id < len(ref_names) else None,
                position=position, end_position=end_position,
                r1_positive=not strand1,
                hash_fraction=compute_hash_fraction(r1.name.decode()),
            )
            if not overlaps_intervals(info, intervals):
                continue
            total += 1

            if key != current_key:
                if current_group:
                    process_group(current_group, fraction_counts)
                current_key = key
                current_group = []
            current_group.append(info)

        if current_group:
            process_group(current_group, fraction_counts)
    return total, fraction_counts
