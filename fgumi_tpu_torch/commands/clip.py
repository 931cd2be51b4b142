"""clip: overlapping-pair clipping + fixed-end clipping + tag repair.

Mirrors src/lib/commands/clip.rs:
- query-grouped input required (clipping is template-based);
- per template: optional --upgrade-clipping pre-pass over EVERY read
  (including secondary/supplementary, ClipBam.scala:123), then clip the
  primary pair/fragment found by SAM flags (find_primary_pair_indices,
  clip.rs:1023-1050; duplicate primaries are an error), then repair mate info
  on the pair (set_mate_info_raw, clip.rs:926-990) and on supplementary
  alignments (fix_supplemental_mate_info, clip.rs:1054-1080);
- fixed 5'/3' clipping per read with R1/R2 thresholds routed by first/last
  segment flags (clip_pair, clip.rs:390-480);
- overlap clipping (FR midpoint) and extending-past-mate clipping;
- NM/UQ/MD regeneration against the reference FASTA for every record
  (clip.rs:649,763);
- a lone primary R2 or an all-secondary template passes through untouched
  (fgbio ClipBam case _ => ());
- metrics: per-read-type clipped-bases and clipped-read counts.
"""

from dataclasses import dataclass, field

from ..core.alignment_tags import regenerate_alignment_tags
from ..core.clipper import MutableRecord, RecordClipper, clipped_bases
from ..core.template import iter_name_groups
from ..io.bam import (FLAG_FIRST, FLAG_LAST, FLAG_MATE_REVERSE,
                      FLAG_MATE_UNMAPPED, FLAG_PAIRED, FLAG_SECONDARY,
                      FLAG_SUPPLEMENTARY)
from ..utils.atomic import open_output


@dataclass
class ClipParams:
    clipping_mode: str = "hard"
    clip_overlapping_reads: bool = False
    clip_extending_past_mate: bool = False
    read_one_five_prime: int = 0
    read_one_three_prime: int = 0
    read_two_five_prime: int = 0
    read_two_three_prime: int = 0
    upgrade_clipping: bool = False
    auto_clip_attributes: bool = False

    def any_clipping(self) -> bool:
        return (self.upgrade_clipping or self.clip_overlapping_reads
                or self.clip_extending_past_mate or self.read_one_five_prime > 0
                or self.read_one_three_prime > 0 or self.read_two_five_prime > 0
                or self.read_two_three_prime > 0)


@dataclass
class ClipTypeMetrics:
    """Per read-type clipping counters (metrics/clip.rs analog)."""
    reads: int = 0
    reads_unmapped: int = 0
    reads_clipped_pre: int = 0
    reads_clipped_five_prime: int = 0
    reads_clipped_three_prime: int = 0
    reads_clipped_overlapping: int = 0
    reads_clipped_extending: int = 0
    bases: int = 0
    bases_clipped_pre: int = 0
    bases_clipped_five_prime: int = 0
    bases_clipped_three_prime: int = 0
    bases_clipped_overlapping: int = 0
    bases_clipped_extending: int = 0

    def update(self, rec: MutableRecord, prior: int, five: int, three: int,
               overlapping: int = 0, extending: int = 0):
        self.reads += 1
        self.bases += len(rec.seq)
        if rec.is_unmapped():
            self.reads_unmapped += 1
        for count, rattr, battr in (
                (prior, "reads_clipped_pre", "bases_clipped_pre"),
                (five, "reads_clipped_five_prime", "bases_clipped_five_prime"),
                (three, "reads_clipped_three_prime", "bases_clipped_three_prime"),
                (overlapping, "reads_clipped_overlapping", "bases_clipped_overlapping"),
                (extending, "reads_clipped_extending", "bases_clipped_extending")):
            if count > 0:
                setattr(self, rattr, getattr(self, rattr) + 1)
                setattr(self, battr, getattr(self, battr) + count)


@dataclass
class ClipMetrics:
    templates: int = 0
    overlap_clipped: int = 0
    extend_clipped: int = 0
    fragment: ClipTypeMetrics = field(default_factory=ClipTypeMetrics)
    read_one: ClipTypeMetrics = field(default_factory=ClipTypeMetrics)
    read_two: ClipTypeMetrics = field(default_factory=ClipTypeMetrics)


def find_primary_pair(records):
    """(i1, i2) indices of the primary R1 (or fragment) and R2 by SAM flags;
    duplicates are an error (clip.rs:1023-1050)."""
    i1 = i2 = None
    for i, rec in enumerate(records):
        if rec.flag & (FLAG_SECONDARY | FLAG_SUPPLEMENTARY):
            continue
        if not rec.flag & FLAG_PAIRED or rec.flag & FLAG_FIRST:
            if i1 is not None:
                raise ValueError(
                    f"Multiple non-secondary, non-supplemental R1s for "
                    f"{records[i].name.decode(errors='replace')}")
            i1 = i
        elif rec.flag & FLAG_LAST:
            if i2 is not None:
                raise ValueError(
                    f"Multiple non-secondary, non-supplemental R2s for "
                    f"{records[i].name.decode(errors='replace')}")
            i2 = i
    return i1, i2


def _insert_size(r1: MutableRecord, r2: MutableRecord) -> int:
    """htsjdk computeInsertSize on the post-clip pair (5'-to-5', signed)."""
    if r1.ref_id != r2.ref_id:
        return 0
    pos1 = r1.alignment_end() + 1 if r1.is_reverse() else r1.pos + 1
    pos2 = r2.alignment_end() + 1 if r2.is_reverse() else r2.pos + 1
    adjustment = 1 if pos2 >= pos1 else -1
    return pos2 - pos1 + adjustment


def _set_mate_flags(rec: MutableRecord, mate_reverse: bool, mate_unmapped: bool):
    rec.flag &= ~(FLAG_MATE_REVERSE | FLAG_MATE_UNMAPPED)
    if mate_reverse:
        rec.flag |= FLAG_MATE_REVERSE
    if mate_unmapped:
        rec.flag |= FLAG_MATE_UNMAPPED


def _set_mate_mq_mc(rec: MutableRecord, mate: MutableRecord):
    rec.set_int_tag(b"MQ", mate.mapq)
    cig = mate.cigar_string()
    if cig != "*":
        rec.set_str_tag(b"MC", cig.encode())
    else:
        rec.remove_tag(b"MC")


def set_mate_info(r1: MutableRecord, r2: MutableRecord):
    """set_mate_info_raw (clip.rs:926-990): refresh mate pointers after
    clipping may have moved/unmapped either read."""
    u1, u2 = r1.is_unmapped(), r2.is_unmapped()
    if not u1 and not u2:
        for rec, mate in ((r1, r2), (r2, r1)):
            rec.next_ref_id = mate.ref_id
            rec.next_pos = mate.pos
            _set_mate_flags(rec, mate.is_reverse(), False)
            _set_mate_mq_mc(rec, mate)
        tlen = _insert_size(r1, r2)
        r1.tlen, r2.tlen = tlen, -tlen
    elif u1 and u2:
        for rec, mate in ((r1, r2), (r2, r1)):
            rec.ref_id = rec.next_ref_id = -1
            rec.pos = rec.next_pos = -1
            _set_mate_flags(rec, mate.is_reverse(), True)
            rec.remove_tag(b"MQ")
            rec.remove_tag(b"MC")
            rec.tlen = 0
    else:
        mapped, unmapped = (r2, r1) if u1 else (r1, r2)
        unmapped.ref_id = unmapped.next_ref_id = mapped.ref_id
        unmapped.pos = unmapped.next_pos = mapped.pos
        _set_mate_flags(unmapped, mapped.is_reverse(), False)
        _set_mate_mq_mc(unmapped, mapped)
        unmapped.tlen = 0
        mapped.next_ref_id = mapped.ref_id
        mapped.next_pos = mapped.pos
        _set_mate_flags(mapped, unmapped.is_reverse(), True)
        mapped.remove_tag(b"MQ")
        mapped.remove_tag(b"MC")
        mapped.tlen = 0


def fix_supplemental_mate_info(records, i1, i2):
    """Supplementals point at the opposite primary (clip.rs:1054-1080)."""
    for rec in records:
        if not rec.flag & FLAG_SUPPLEMENTARY:
            continue
        if not rec.flag & FLAG_PAIRED or rec.flag & FLAG_FIRST:
            mate_i = i2
        elif rec.flag & FLAG_LAST:
            mate_i = i1
        else:
            continue
        if mate_i is None:
            continue
        mate = records[mate_i]
        rec.next_ref_id = mate.ref_id
        rec.next_pos = mate.pos
        _set_mate_flags(rec, mate.is_reverse(), mate.is_unmapped())
        rec.tlen = -mate.tlen
        if mate.is_unmapped():
            rec.remove_tag(b"MC")
        else:
            rec.set_str_tag(b"MC", mate.cigar_string().encode())
        rec.set_int_tag(b"MQ", mate.mapq)


def clip_template(records, clipper: RecordClipper, params: ClipParams,
                  metrics: ClipMetrics):
    """Clip one template's primary reads in place; returns
    (overlap_clipped, extend_clipped)."""
    if params.upgrade_clipping:
        for rec in records:
            clipper.upgrade_all_clipping(rec)
    i1, i2 = find_primary_pair(records)
    if i1 is not None and i2 is not None:
        r1, r2 = records[i1], records[i2]
        outcome = _clip_pair(clipper, params, r1, r2, metrics)
        set_mate_info(r1, r2)
        fix_supplemental_mate_info(records, i1, i2)
        return outcome
    if i1 is not None:
        _clip_fragment(clipper, params, records[i1], metrics)
    return (False, False)


def _clip_fragment(clipper, params, rec, metrics: ClipMetrics):
    prior = clipped_bases(rec)
    five = (clipper.clip_5_prime_end_of_read(rec, params.read_one_five_prime)
            if params.read_one_five_prime > 0 else 0)
    three = (clipper.clip_3_prime_end_of_read(rec, params.read_one_three_prime)
             if params.read_one_three_prime > 0 else 0)
    metrics.fragment.update(rec, prior, five, three)


def _clip_pair(clipper, params, r1, r2, metrics: ClipMetrics):
    prior1, prior2 = clipped_bases(r1), clipped_bases(r2)
    is_r1_first = bool(r1.flag & FLAG_FIRST) or not r1.flag & FLAG_PAIRED
    is_r2_last = bool(r2.flag & FLAG_LAST)

    def fixed(rec, first_thresholds):
        five_t, three_t = first_thresholds
        five = clipper.clip_5_prime_end_of_read(rec, five_t) if five_t > 0 else 0
        three = clipper.clip_3_prime_end_of_read(rec, three_t) if three_t > 0 else 0
        return five, three

    one = (params.read_one_five_prime, params.read_one_three_prime)
    two = (params.read_two_five_prime, params.read_two_three_prime)
    five1, three1 = fixed(r1, one if is_r1_first else two)
    five2, three2 = fixed(r2, two if is_r2_last else one)

    if params.clip_overlapping_reads:
        over1, over2 = clipper.clip_overlapping_reads(r1, r2)
    else:
        over1 = over2 = 0
    if params.clip_extending_past_mate:
        ext1, ext2 = clipper.clip_extending_past_mate_ends(r1, r2)
    else:
        ext1 = ext2 = 0

    (metrics.read_one if is_r1_first else metrics.read_two).update(
        r1, prior1, five1, three1, over1, ext1)
    (metrics.read_two if is_r2_last else metrics.read_one).update(
        r2, prior2, five2, three2, over2, ext2)
    return (over1 > 0 or over2 > 0, ext1 > 0 or ext2 > 0)


def run_clip(reader, writer, reference, params: ClipParams):
    """Stream reader -> writer clipping templates; returns ClipMetrics."""
    clipper = RecordClipper(params.clipping_mode, params.auto_clip_attributes)
    metrics = ClipMetrics()
    ref_names = reader.header.ref_names
    for _name, raw_records in iter_name_groups(reader):
        records = [MutableRecord.from_raw(r) for r in raw_records]
        metrics.templates += 1
        overlap, extend = clip_template(records, clipper, params, metrics)
        if overlap:
            metrics.overlap_clipped += 1
        if extend:
            metrics.extend_clipped += 1
        for rec in records:
            regenerate_alignment_tags(rec, ref_names, reference)
            writer.write_record_bytes(rec.encode())
    return metrics


_METRIC_COLUMNS = [
    "read_type", "reads", "reads_unmapped", "reads_clipped_pre",
    "reads_clipped_five_prime", "reads_clipped_three_prime",
    "reads_clipped_overlapping", "reads_clipped_extending", "bases",
    "bases_clipped_pre", "bases_clipped_five_prime",
    "bases_clipped_three_prime", "bases_clipped_overlapping",
    "bases_clipped_extending",
]


def write_clip_metrics(metrics: ClipMetrics, path: str):
    with open_output(path, "w") as f:
        f.write("\t".join(_METRIC_COLUMNS) + "\n")
        for read_type, m in (("fragment", metrics.fragment),
                             ("read_one", metrics.read_one),
                             ("read_two", metrics.read_two)):
            row = [read_type] + [str(getattr(m, c)) for c in _METRIC_COLUMNS[1:]]
            f.write("\t".join(row) + "\n")
